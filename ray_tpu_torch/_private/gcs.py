"""GCS: the cluster control plane.

Role-equivalent to the reference's GCS server
(reference: src/ray/gcs/gcs_server/gcs_server.h:77) collapsed into one
Python service: node membership (gcs_node_manager.h:41), actor directory +
scheduling (gcs_actor_manager.h:281, gcs_actor_scheduler.h:111), placement
groups (gcs_placement_group_manager.h:223), internal KV + function store
(gcs_kv_manager.h:101, function_manager.py:56), task scheduling with
resource accounting (the reference splits this between GCS and raylets;
here the GCS owns the authoritative resource view and leases tasks to node
managers), the object directory (ownership_based_object_directory.h:37), and
task events (gcs_task_manager.h:61).

Threading model: handlers run on per-connection listener threads; state is
sharded into four independently-locked domains (the reference instead runs
one asio loop, common/asio/ — here domain shards let KV reads, refcount
flushes, object-directory updates, and scheduling proceed in parallel):

  rank 0  ``_sched_lock``  nodes ledger + resource accounting, task queues,
                           running tasks, worker leases, clients/jobs
  rank 1  ``_actor_lock``  actor directory + lifecycle, placement groups
  rank 2  ``_obj_lock``    object directory, dep-waiting tasks, refcounts,
                           task-arg pins, lineage, parked object waiters
  rank 3  ``_kv_lock``     function store, KV, metrics table, task events,
                           pubsub subscriptions

Lock discipline (witnessed at run time by ``_private/lockdep.py`` when
``RAY_TPU_TORCH_LOCKDEP_ENABLED=1``): a thread holding a shard lock may
only acquire a HIGHER rank shard lock (sched -> actor -> obj -> kv),
never a lower one — all
edges point rank-forward, so the acquisition graph cannot cycle. Handlers
acquire their primary shard(s) up front in canonical order (``with
self._sched_lock, self._obj_lock:``); helpers may nest forward. The few
genuinely cross-domain paths (node death, driver exit, actor restart) take
every shard they touch up front, again in canonical order. Paths that
would need a LOWER-rank lock run two-phase instead: collect under the
higher shard, release, then act under the lower one (e.g. lease-path
object reports waking dep-parked tasks).

Routing reads — looking up a node's conn/address purely to SEND it a
message — read the ``_nodes``/``_clients`` dicts without a lock (atomic
under the GIL; entries are never mutated in place for routing fields, and
a stale conn surfaces as the caught ConnectionClosed every send site
already handles). Resource accounting always runs under ``_sched_lock``.

Pubsub publishes and death notifications never happen under any shard
lock: ``_publish`` records into an outbox drained by a dedicated
publisher thread (record-then-publish).

Handlers never block while holding a lock — deferred replies are parked
and fulfilled by later events or the timer thread.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import pickle
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import inline_objects, profiler, protocol
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, PlacementGroupID, TaskID
from ray_tpu_torch.util import metrics as metrics_util
from ray_tpu_torch._private.task_spec import (
    ActorCreationSpec,
    ActorTaskSpec,
    Bundle,
    PlacementGroupSpec,
    ResourceSet,
    TaskSpec,
    demand_overlaps,
    pinned_deps,
)

logger = logging.getLogger("ray_tpu_torch.gcs")

# Pseudo client id under which a standalone GCS process files its own
# metric samples in the metrics table (no CoreWorker exists there to run
# the usual reporter push); exempt from the conn-liveness expiry.
_GCS_SELF_CLIENT = "gcs-self"

_os_getpid = os.getpid


def _os_sysconf(name: str):
    try:
        return int(os.sysconf(name))
    except (ValueError, OSError, AttributeError):
        return None


# Actor lifecycle states (reference: gcs.proto ActorTableData.ActorState)
DEPENDENCIES_UNREADY = "DEPENDENCIES_UNREADY"
PENDING_CREATION = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


@dataclass
class NodeEntry:
    node_id: str
    address: str                      # node manager server address (pull/push)
    store_path: str
    conn: protocol.Conn
    total: ResourceSet
    available: ResourceSet
    labels: Dict[str, str] = field(default_factory=dict)
    is_head: bool = False
    alive: bool = True
    hw: Dict[str, Any] = field(default_factory=dict)  # reporter sample
    started_at: float = field(default_factory=time.time)
    last_heartbeat: float = field(default_factory=time.time)
    # Resources held by the node manager's OWN lease grants (local-first
    # scheduling) — the GCS never acquired these; the aggregate arrives
    # asynchronously on heartbeats and is subtracted from ``available``
    # for every central placement decision (reference: the raylet
    # resource reports feeding cluster_resource_scheduler).
    local_held: ResourceSet = field(default_factory=ResourceSet)
    local_held_seq: int = -1  # highest report version applied (NM-local)

    def effective_available(self) -> ResourceSet:
        """GCS-accounted availability minus locally-held resources (the
        view central placement must use; negatives clamp to zero)."""
        if self.local_held.is_zero():
            return self.available
        return self.available.minus_clamped(self.local_held)


@dataclass
class ActorEntry:
    spec: ActorCreationSpec
    state: str = DEPENDENCIES_UNREADY
    node_id: Optional[str] = None
    restarts_left: int = 0
    num_restarts: int = 0
    death_cause: str = ""
    waiters: List[Tuple[protocol.Conn, int]] = field(default_factory=list)
    pending_tasks: List[ActorTaskSpec] = field(default_factory=list)
    # Decentralized creation: the node manager placed this actor from
    # its OWN ledger (resources ride the local_held heartbeat aggregate,
    # never acquired centrally) — GCS release paths must skip the
    # central ledger for it. Cleared the moment the GCS re-places the
    # actor itself (restart after node death).
    local_placement: bool = False


@dataclass
class PgEntry:
    spec: PlacementGroupSpec
    state: str = "PENDING"            # PENDING | CREATED | REMOVED
    waiters: List[Tuple[protocol.Conn, int]] = field(default_factory=list)
    # index -> ResourceSet of remaining bundle capacity
    bundle_available: Dict[int, ResourceSet] = field(default_factory=dict)


@dataclass
class _ObjWaiter:
    conn: protocol.Conn
    msg_id: int
    pending: Set[bytes]               # object ids not yet ready
    num_needed: int                   # how many of the original set must be ready
    ready: Set[bytes] = field(default_factory=set)
    failed: Set[bytes] = field(default_factory=set)
    deadline: Optional[float] = None


class _ShapeQueues:
    """Ready queue indexed by scheduling shape (reference:
    ``raylet/scheduling/cluster_task_manager.h:42`` — tasks grouped by
    SchedulingClass so one infeasibility verdict skips the whole class).

    Scheduling cost per event is O(shapes x nodes + dispatched), not
    O(queue): a bucket whose head can't place is skipped in one check,
    even with a million tasks queued behind it. FIFO order holds within
    a shape (the reference makes the same trade).
    """

    def __init__(self):
        self._buckets: Dict[Any, collections.deque] = \
            collections.OrderedDict()
        self._count = 0

    @staticmethod
    def shape_key(spec) -> Any:
        if isinstance(spec, _ActorCreationShim):
            # Each pending actor is its own bucket: one unplaceable actor
            # must not shadow differently-shaped ones.
            return ("actor", spec.actor_id.binary())
        res = getattr(spec, "resources", None) or {}
        strat = getattr(spec, "scheduling_strategy", None)
        pg = getattr(spec, "placement_group_id", None)
        return ("task", tuple(sorted(res.items())), repr(strat),
                pg.binary() if pg is not None else None,
                getattr(spec, "placement_group_bundle_index", -1))

    def append(self, spec) -> None:
        self._buckets.setdefault(
            self.shape_key(spec), collections.deque()).append(spec)
        self._count += 1

    def appendleft(self, spec) -> None:
        self._buckets.setdefault(
            self.shape_key(spec), collections.deque()).appendleft(spec)
        self._count += 1

    def extend(self, specs) -> None:
        for s in specs:
            self.append(s)

    def buckets(self):
        return list(self._buckets.items())

    def pop_head(self, key):
        q = self._buckets.get(key)
        if not q:
            return None
        self._count -= 1
        spec = q.popleft()
        if not q:
            self._buckets.pop(key, None)
        return spec

    def remove_task(self, tid: bytes) -> None:
        for key, q in list(self._buckets.items()):
            kept = collections.deque(
                s for s in q if s.task_id.binary() != tid)
            self._count -= len(q) - len(kept)
            if kept:
                self._buckets[key] = kept
            else:
                self._buckets.pop(key, None)

    def __iter__(self):
        for q in self._buckets.values():
            yield from q

    def __len__(self) -> int:
        return self._count


class GcsServer:
    """The head control-plane service."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 storage_path: Optional[str] = None):
        from ray_tpu_torch._private.config import config as _cfg

        # Domain shard locks — canonical rank order (see module
        # docstring): sched < actor < obj < kv. Acquire forward only.
        self._sched_lock = threading.RLock()
        self._actor_lock = threading.RLock()
        self._obj_lock = threading.RLock()
        self._kv_lock = threading.RLock()
        # Durable table storage (reference: redis_store_client.h:28 +
        # GcsInitData restore). Enabled by passing storage_path or setting
        # gcs_storage=file + gcs_file_storage_path.
        if storage_path is None and _cfg.gcs_storage == "file":
            storage_path = _cfg.gcs_file_storage_path or None
        self._storage = None
        if storage_path:
            from ray_tpu_torch._private.gcs_storage import GcsStorage

            self._storage = GcsStorage(storage_path)
        # Actors restored from storage that await their node's re-report.
        self._recovering_actors: Dict[bytes, float] = {}
        self._last_tick = time.time()
        self._nodes: Dict[str, NodeEntry] = {}
        self._clients: Dict[str, protocol.Conn] = {}
        self._client_jobs: Dict[str, JobID] = {}
        self._jobs: Dict[str, dict] = {}  # job hex -> info (state API)
        self._metrics: Dict[str, dict] = {}  # client_id -> latest samples
        self._spilled_objects: Dict[bytes, dict] = {}  # oid -> node/url
        self._next_job = 0

        # function / class store + generic KV (namespaced)
        self._functions: Dict[str, bytes] = {}
        self._kv: Dict[str, Dict[bytes, bytes]] = collections.defaultdict(dict)

        # task scheduling
        self._queued_tasks = _ShapeQueues()
        self._waiting_tasks: Dict[bytes, List[TaskSpec]] = collections.defaultdict(list)
        self._running_tasks: Dict[bytes, Tuple[TaskSpec, str]] = {}  # task_id -> (spec, node)
        self._cancelled_tasks: Set[bytes] = set()

        # actors
        self._actors: Dict[bytes, ActorEntry] = {}
        self._named_actors: Dict[Tuple[str, str], bytes] = {}
        # Kill-before-placement tombstones (decentralized creation race:
        # ray.kill can reach the GCS before the NM's actor_placed report
        # does). Bounded FIFO; actor_placed completes the kill.
        self._killed_before_placed: "collections.OrderedDict[bytes, float]" \
            = collections.OrderedDict()

        # placement groups
        self._pgs: Dict[bytes, PgEntry] = {}
        self._named_pgs: Dict[str, bytes] = {}
        # Groups made while their resources were taken, retried whenever
        # scheduling runs (_try_schedule), in the order they were made.
        self._pending_pgs: Dict[bytes, PgEntry] = {}
        self._placing_pgs = False

        # Inline-object table (inline_objects.py): the cluster-visible
        # copy of in-band small returns, listed in the directory under
        # the pseudo node ::inline; per-job byte-bounded, with pressure
        # materializing the oldest entries into a real node's store.
        # Guarded by _obj_lock alongside the directory (the table's own
        # lock is a leaf for the lock-free stats read).
        self._inline_tbl = inline_objects.InlineTable(
            int(_cfg.gcs_inline_table_bytes))
        # Objects freed while a store_inline_objects materialization was
        # in flight: oid -> (target node, freed-at). The target is not
        # in the directory yet, so the free's delete fan-out misses it;
        # the late add_object_locations confirm consults this tombstone
        # and queues a delete instead of resurrecting the object.
        # Guarded by _obj_lock; expired by the housekeeping timer.
        self._freed_mid_spill: Dict[bytes, Tuple[str, float]] = {}
        # Per-node delete notifications queued under _obj_lock (sends
        # must not run under a shard lock); drained by the timer.
        self._deferred_deletes: Dict[str, List[bytes]] = {}
        # object directory: object_id bytes -> set(node_id); sizes for stats
        self._obj_locations: Dict[bytes, Set[str]] = collections.defaultdict(set)
        self._obj_sizes: Dict[bytes, int] = {}
        self._failed_objects: Dict[bytes, Any] = {}
        self._obj_waiters: List[_ObjWaiter] = []
        # object_id -> task that produces it (for "will it ever be ready"
        # and for lineage reconstruction)
        self._producing_task: Dict[bytes, bytes] = {}

        # Distributed refcounting (reference: reference_count.h:61, here
        # GCS-aggregated): oid -> {client_id: net count}. An object whose
        # aggregate count reaches zero (and isn't pinned as a queued/running
        # task argument) is freed after a short grace window.
        self._refcounts: Dict[bytes, Dict[str, int]] = {}
        self._client_refs: Dict[str, Set[bytes]] = collections.defaultdict(set)
        self._pending_free: Dict[bytes, float] = {}       # oid -> deadline
        self._task_arg_pins: Dict[bytes, int] = collections.defaultdict(int)
        self._pinned_tasks: Set[bytes] = set()   # task or actor ids holding pins
        # Rerouted actor-task specs whose args the GCS pins until done.
        self._actor_task_pins: Dict[bytes, Any] = {}
        # Lineage: retained specs for resubmission + attempt caps.
        self._task_specs: Dict[bytes, TaskSpec] = {}
        # Last processed ring-relay batch seq per ring path (bounded;
        # see _h_submit_task_batch): exact drop of retried relay batches.
        self._ring_relay_seqs: Dict[str, int] = {}
        self._reconstructions: Dict[bytes, int] = {}      # task_id -> attempts

        # Worker leases for the direct task transport (reference:
        # direct_task_transport.h:75): lease_id -> holder/placement. A
        # lease holds its shape's resources until returned (or its client
        # or node dies, or the GCS revokes it for classic-queue fairness).
        self._leases: Dict[bytes, Dict[str, Any]] = {}
        self._last_lease_revoke = 0.0
        # Capacity-denied lease requests double as autoscaler demand
        # (the caller's queued lease tasks are otherwise invisible here):
        # shape key -> (resources, last_denied_ts), TTL'd out of
        # pending_demand (reference: LoadMetrics pending resource demand).
        self._lease_demand: Dict[tuple, Tuple[Dict[str, float], float]] = {}

        # task events ring buffer (reference: gcs_task_manager.h bounded store)
        self._task_events: collections.deque = collections.deque(maxlen=100_000)

        # Record-then-publish outbox (kv domain's background work):
        # lifecycle paths record (channel, message) — often while holding
        # a shard lock — and the publisher thread fans out to
        # subscribers, so no pubsub notify ever runs under a GCS state
        # lock (a slow subscriber socket can no longer stall the
        # control plane).
        self._pub_q: collections.deque = collections.deque()
        self._pub_ev = threading.Event()

        self._shutdown = threading.Event()
        # Process self-stats (pid/rss/cpu/listener threads), sampled by
        # the timer thread at the shard-metrics cadence and served via
        # control_plane_stats. Standalone mode (main() below — the GCS
        # as its own process) additionally pushes the samples into the
        # metrics table so /metrics keeps carrying them across the
        # process boundary (no CoreWorker lives in the GCS process to
        # run the usual reporter push).
        self._standalone = False
        self._self_stats: Dict[str, Any] = {"pid": _os_getpid()}
        self._proc_cpu_prev: Optional[Tuple[float, float]] = None
        if self._storage is not None:
            self._load_from_storage()
        self.server = protocol.Server(self._handle, host=host, port=port,
                                      name="gcs")
        self.server.on_disconnect = self._on_disconnect
        self.address = self.server.address
        self._timer = threading.Thread(target=self._timer_loop, daemon=True,
                                       name="rtpu-gcs-timer")
        self._timer.start()
        self._publisher = threading.Thread(target=self._publisher_loop,
                                           daemon=True, name="rtpu-gcs-pub")
        self._publisher.start()
        # Always-on sampling profiler (profiler_always_on): the GCS's
        # process samples from the start, whether it is a subprocess of
        # its own or shares the driver's (one idempotent sampler a
        # process; the driver's disconnect or the process's exit ends it).
        profiler.maybe_start_always_on()

    # ------------------------------------------------------------------ util

    def close(self):
        self._shutdown.set()
        self._pub_ev.set()
        # Tell node managers to tear down their worker pools.
        with self._sched_lock:
            nodes = list(self._nodes.values())
        for n in nodes:
            try:
                n.conn.notify("shutdown")
            except Exception:
                pass
        self.server.close()
        if self._storage is not None:
            self._storage.close()

    def crash_for_test(self):
        """Chaos hook: die like ``kill -9`` — stop serving and drop every
        connection WITHOUT the graceful shutdown notifications (nodes keep
        their worker pools and rejoin the restarted head). Reference role:
        the GCS-failover release tests killing gcs_server."""
        self._shutdown.set()
        self._pub_ev.set()
        self.server.close()
        if self._storage is not None:
            self._storage.close()

    def _timer_loop(self):
        while not self._shutdown.wait(0.05):
            now = time.time()
            # Object-domain housekeeping: waiter deadlines + deferred
            # frees. Delete notifications collected under the lock go
            # out after it is released.
            deletes: Dict[str, List[bytes]] = {}
            with self._obj_lock:
                expired = [w for w in self._obj_waiters
                           if w.deadline is not None and now >= w.deadline]
                for w in expired:
                    self._obj_waiters.remove(w)
                due = [o for o, t in self._pending_free.items() if now >= t]
                if due:
                    deletes = self._free_now(due)
                if self._deferred_deletes:
                    for nid, oids in self._deferred_deletes.items():
                        deletes.setdefault(nid, []).extend(oids)
                    self._deferred_deletes.clear()
                if self._freed_mid_spill:
                    # A confirm that never arrives (NM died with the
                    # store copy) must not pin the tombstone forever —
                    # 60 s far exceeds the spill retry window. Stamps
                    # are monotonic (the timer's ``now`` is wall time).
                    mono = time.monotonic()
                    for o in [o for o, (_n, t)
                              in self._freed_mid_spill.items()
                              if mono - t >= 60.0]:
                        del self._freed_mid_spill[o]
            self._send_deletes(deletes)
            # Scheduling-domain housekeeping. Health checks / recovering-
            # actor expiry nest actor (and obj, for node death) forward.
            with self._sched_lock:
                self._check_health(now)
                if self._recovering_actors:
                    self._expire_recovering_actors(now)
                if len(self._queued_tasks) and now - getattr(
                        self, "_last_queue_retry", 0.0) >= 0.2:
                    # Stuck-queue retry: with local-first traffic the GCS
                    # may see no scheduling-relevant events for a while;
                    # this keeps revocation/fairness progressing.
                    self._last_queue_retry = now
                    self._try_schedule()
            self._sample_shard_metrics(now)
            self._sample_self_stats(now)
            if now - getattr(self, "_last_spill_sweep", 0.0) >= \
                    inline_objects.InlineTable.SPILL_RETRY_S:
                # Inline-table pressure retry: re-select spills for any
                # still-over-budget job. insert() only re-selects when
                # the SAME job inserts again, so a store_inline_objects
                # notify lost to NM death/send failure after a job went
                # quiet would otherwise hold its over-budget bytes
                # forever. Table lock is a leaf; runs outside shards.
                self._last_spill_sweep = now
                overdue = self._inline_tbl.pressure_spills()
                if overdue:
                    self._send_inline_spills(overdue)
            for w in expired:
                try:
                    w.conn.reply(w.msg_id, {
                        "ready": list(w.ready), "timeout": True,
                        "failed": {o: self._failed_objects.get(o)
                                   for o in w.failed},
                    })
                except Exception:
                    pass

    # --------------------------------------------- per-shard observability

    _SHARD_SAMPLE_PERIOD_S = 1.0

    def _sample_shard_metrics(self, now: float) -> None:
        """Sampled shard-contention probe (timer thread, ~1/s): time a
        fresh acquire of each shard lock into
        ``gcs_shard_lock_wait_seconds`` and export per-domain queue
        depths as ``gcs_shard_queue_depth``. Sampling — rather than
        per-acquire instrumentation — keeps metric bookkeeping entirely
        off the handler hot paths; under contention the probe's own
        acquire waits exactly like a handler would, which is the signal
        we want."""
        if now - getattr(self, "_last_shard_sample", 0.0) < \
                self._SHARD_SAMPLE_PERIOD_S:
            return
        self._last_shard_sample = now
        try:
            wait_h, depth_g = _shard_metrics()[:2]
        except Exception:
            return

        def depth_sched():
            return len(self._queued_tasks)

        def depth_actor():
            return sum(1 for e in self._actors.values()
                       if e.state in (PENDING_CREATION, RESTARTING)
                       and e.node_id is None)

        def depth_obj():
            return len(self._obj_waiters) + len(self._pending_free)

        def depth_kv():
            return len(self._pub_q)

        for name, lock, depth in (
                ("sched", self._sched_lock, depth_sched),
                ("actor", self._actor_lock, depth_actor),
                ("obj", self._obj_lock, depth_obj),
                ("kv", self._kv_lock, depth_kv)):
            t0 = time.perf_counter()
            with lock:
                wait_h.observe(time.perf_counter() - t0,
                               tags={"shard": name})
                depth_g.set(float(depth()), tags={"shard": name})
        try:
            _n, b_inline = self._inline_tbl.stats()
            _inline_metrics()[1].set(float(b_inline))
        except Exception:
            pass

    @staticmethod
    def _read_self_rss() -> Optional[int]:
        """Resident set size of THIS process from /proc/self/statm."""
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            return pages * (_os_sysconf("SC_PAGE_SIZE") or 4096)
        except (OSError, ValueError, IndexError):
            return None

    @staticmethod
    def _read_self_cpu() -> Optional[Tuple[float, float]]:
        """(cpu_seconds, wall_ts) for THIS process from /proc/self/stat."""
        try:
            with open("/proc/self/stat") as f:
                # comm may contain spaces; fields after ')' are fixed.
                rest = f.read().rsplit(")", 1)[1].split()
            hz = _os_sysconf("SC_CLK_TCK") or 100
            return (int(rest[11]) + int(rest[12])) / hz, time.time()
        except (OSError, ValueError, IndexError):
            return None

    def _sample_self_stats(self, now: float) -> None:
        """GCS-process self observability (pid, rss, cpu%, listener
        threads, outbox depth), sampled on the shard-metrics cadence.
        The dict is replaced wholesale so control_plane_stats can read
        it lock-free (routing-read discipline)."""
        if now - getattr(self, "_last_self_sample", 0.0) < \
                self._SHARD_SAMPLE_PERIOD_S:
            return
        self._last_self_sample = now
        cpu = self._read_self_cpu()
        cpu_percent = None
        prev = self._proc_cpu_prev
        if cpu is not None and prev is not None and cpu[1] > prev[1]:
            cpu_percent = round(
                100.0 * (cpu[0] - prev[0]) / (cpu[1] - prev[1]), 1)
        if cpu is not None:
            self._proc_cpu_prev = cpu
        listener_threads = sum(
            1 for t in threading.enumerate()
            if t.name.startswith("rtpu-conn-gcs"))
        self._self_stats = {
            "pid": _os_getpid(),
            "rss_bytes": self._read_self_rss(),
            "cpu_percent": cpu_percent,
            "listener_threads": listener_threads,
            "outbox_depth": len(self._pub_q),
            "out_of_process": self._standalone,
        }
        try:
            _wait_h, _depth_g, rss_g, cpu_g, thr_g = _shard_metrics()
        except Exception:
            return
        st = self._self_stats
        if st["rss_bytes"] is not None:
            rss_g.set(float(st["rss_bytes"]))
        if cpu_percent is not None:
            cpu_g.set(float(cpu_percent))
        thr_g.set(float(listener_threads))
        if self._standalone:
            # No CoreWorker in this process to push samples: the GCS IS
            # the metrics table, so insert its own group directly.
            from ray_tpu_torch.util import metrics as metrics_mod

            samples = metrics_mod.collect_samples()
            with self._kv_lock:
                self._metrics[_GCS_SELF_CLIENT] = {
                    "samples": samples, "ts": now,
                    "period_s": self._SHARD_SAMPLE_PERIOD_S * 3}

    def _publisher_loop(self):
        """Drain the record-then-publish outbox: snapshot each message's
        subscriber set under the kv shard, send outside every lock."""
        while not self._shutdown.is_set():
            # raylint: disable-next=unbounded-wait (dedicated publisher
            # thread parked for outbox work; close() sets the event)
            self._pub_ev.wait()
            self._pub_ev.clear()
            while self._pub_q:
                try:
                    channel, message = self._pub_q.popleft()
                except IndexError:
                    break
                with self._kv_lock:
                    targets = [c for c in list(self._clients.values())
                               if channel in c.meta.get("subscriptions", ())]
                    targets += [n.conn for n in list(self._nodes.values())
                                if n.alive and channel in
                                n.conn.meta.get("subscriptions", ())]
                for c in targets:
                    try:
                        c.notify("pubsub", {"channel": channel,
                                            "message": message})
                    except Exception:
                        pass

    # ------------------------------------------- persistence + fault tolerance

    def _persist(self, table: str, key: bytes, value: Any):
        if self._storage is not None:
            try:
                self._storage.put(table, key, value)
            except Exception:
                logger.exception("gcs storage put failed (%s)", table)

    def _persist_delete(self, table: str, key: bytes):
        if self._storage is not None:
            try:
                self._storage.delete(table, key)
            except Exception:
                pass

    def _persist_actor(self, aid: bytes):
        entry = self._actors.get(aid)
        if entry is None or self._storage is None:
            return
        self._persist("actors", aid, {
            "spec": entry.spec, "state": entry.state,
            "node_id": entry.node_id, "restarts_left": entry.restarts_left,
            "num_restarts": entry.num_restarts,
            "death_cause": entry.death_cause,
            "local_placement": entry.local_placement,
        })

    def _load_from_storage(self):
        """Rebuild tables after a head restart (reference: GcsInitData).

        Actors that were ALIVE/pending are marked RESTARTING and wait a
        grace period for their node to re-register and re-report them; a
        node that never rejoins is treated as dead (restart budget applies).
        """
        from ray_tpu_torch._private.config import config as _cfg

        st = self._storage
        for key, value in st.load_table("kv").items():
            ns, _, k = key.partition(b"\x00")
            self._kv[ns.decode()][k] = value
        self._functions.update(
            {k.decode(): v for k, v in st.load_table("functions").items()})
        for k, v in st.load_table("jobs").items():
            self._jobs[k.decode()] = v
            try:
                self._next_job = max(self._next_job,
                                     int.from_bytes(bytes.fromhex(
                                         v["job_id"]), "little"))
            except Exception:
                pass
        grace = time.time() + float(
            getattr(_cfg, "gcs_recovery_grace_s", 10.0))
        for aid, snap in st.load_table("actors").items():
            entry = ActorEntry(
                spec=snap["spec"], state=snap["state"],
                node_id=None, restarts_left=snap["restarts_left"],
                num_restarts=snap["num_restarts"],
                death_cause=snap["death_cause"],
                local_placement=bool(snap.get("local_placement")))
            if entry.state not in (DEAD,):
                entry.state = RESTARTING
                self._recovering_actors[aid] = grace
                self._pin_actor_args(entry.spec, True)
            self._actors[aid] = entry
            if entry.spec.name and entry.state != DEAD:
                self._named_actors[(entry.spec.namespace,
                                    entry.spec.name)] = aid
        if self._actors:
            logger.info(
                "gcs restart: restored %d actors (%d awaiting node "
                "re-report), %d kv namespaces, %d functions",
                len(self._actors), len(self._recovering_actors),
                len(self._kv), len(self._functions))

    def _check_health(self, now: float):
        """Active failure detection (reference:
        gcs_health_check_manager.h:39): a node whose heartbeats stop for
        threshold*period while its socket stays open is marked dead."""
        from ray_tpu_torch._private.config import config as _cfg

        period = _cfg.raylet_heartbeat_period_ms / 1000.0
        budget = max(_cfg.health_check_failure_threshold *
                     (_cfg.health_check_period_ms / 1000.0), 2.0)
        # If the GCS itself was descheduled (compile pauses in test
        # processes), don't blame the nodes for the gap.
        gap = now - self._last_tick
        if gap > 2 * period:
            for n in self._nodes.values():
                n.last_heartbeat += gap
        self._last_tick = now
        for node_id, n in list(self._nodes.items()):
            if n.alive and now - n.last_heartbeat > budget:
                logger.warning("node %s failed health checks "
                               "(no heartbeat for %.1fs)", node_id,
                               now - n.last_heartbeat)
                self._mark_node_dead(node_id)

    @staticmethod
    def _merge_local_held(node: NodeEntry, p: dict) -> bool:
        """Apply a node's local_held report (heartbeat OR actor_placed —
        both ends of the protocol share this rule). Reports are sent
        outside the NM's lock, so they can arrive out of order: the seq
        keeps a stale (older) snapshot from overwriting a fresher one.
        Returns True when held resources SHRANK (capacity came back).
        Caller holds _sched_lock."""
        seq = p.get("local_held_seq", -1)
        if not (seq == -1 or seq > node.local_held_seq):
            return False
        node.local_held_seq = max(seq, node.local_held_seq)
        new = ResourceSet(p["local_held"])
        old = node.local_held.to_dict()
        node.local_held = new
        return any(new.get(k) < v for k, v in old.items())

    def _h_heartbeat(self, conn: protocol.Conn, p, msg_id):
        freed = False
        with self._sched_lock:
            node = self._nodes.get(p["node_id"])
            if node is not None:
                node.last_heartbeat = time.time()
                if "oom_kills" in p:
                    node.labels["oom_kills"] = str(p["oom_kills"])
                if "hw" in p:
                    node.hw = p["hw"]
                if "local_held" in p:
                    # Async resource delta from the node's local-first
                    # scheduler: reconcile the central view. Held
                    # resources shrinking means capacity came back —
                    # queued central work may now place.
                    freed = self._merge_local_held(node, p)
            if freed:
                self._try_schedule()

    def _expire_recovering_actors(self, now: float):
        # Caller holds _sched_lock; actor nests forward.
        with self._actor_lock:
            due = [aid for aid, t in self._recovering_actors.items()
                   if now >= t]
            for aid in due:
                self._recovering_actors.pop(aid, None)
                entry = self._actors.get(aid)
                if entry is not None and entry.state == RESTARTING \
                        and entry.node_id is None:
                    # Node never rejoined: equivalent to node death.
                    # raylint: disable-next=lock-order (actor→obj here
                    # vs obj→actor in _h_task_done via _release_for's PG
                    # branch: every path to either order holds
                    # _sched_lock first, and _apply_task_done_records
                    # takes _actor_lock before _obj_lock whenever a record
                    # releases a bundle, so the inversion is never taken)
                    if not self._schedule_actor(entry):
                        self._queued_tasks.append(_ActorCreationShim(entry))
                    self._persist_actor(aid)

    # ------------------------------------------------------------- dispatch

    def _handle(self, conn: protocol.Conn, mtype: str, payload: Any,
                msg_id: int):
        try:
            fn = getattr(self, "_h_" + mtype, None)
            if fn is None:
                conn.reply_error(msg_id, f"gcs: unknown message {mtype}")
                return
            fn(conn, payload, msg_id)
        except Exception as e:
            logger.exception("gcs handler %s failed", mtype)
            try:
                conn.reply_error(msg_id, f"{type(e).__name__}: {e}")
            except Exception:
                pass

    def _on_disconnect(self, conn: protocol.Conn):
        """Deferred to a fresh thread: conn.close() fires this callback
        INLINE from whatever thread noticed the failure — including a
        handler that is holding a high-rank shard lock (e.g. a waiter
        reply under _obj_lock hitting a dead socket). Running the
        cross-shard cleanup there would acquire rank-backward; the old
        global RLock masked exactly this via reentrancy. Disconnects are
        rare (node/client death), so a short-lived thread is cheap."""
        threading.Thread(target=self._handle_disconnect, args=(conn,),
                         daemon=True, name="rtpu-gcs-disc").start()

    def _handle_disconnect(self, conn: protocol.Conn):
        """Cross-shard path (ordered protocol): node/driver death touches
        scheduling, actors, and object state — acquire every shard it
        needs up front, in canonical rank order."""
        role = conn.meta.get("role")
        if role == "node":
            node_id = conn.meta.get("node_id")
            with self._sched_lock:
                self._mark_node_dead(node_id)
        elif role in ("driver", "worker"):
            cid = conn.meta.get("client_id")
            with self._sched_lock:
                with self._actor_lock, self._obj_lock:
                    self._clients.pop(cid, None)
                    self._drop_client_refs(cid)
                    self._release_client_leases_locked(cid)
                    if role == "driver":
                        self._on_driver_exit(cid)
                self._try_schedule()

    def _on_driver_exit(self, client_id: str):
        """Kill this driver's non-detached actors (job cleanup)."""
        job = self._client_jobs.get(client_id)
        if job is not None and job.hex() in self._jobs:
            self._jobs[job.hex()]["state"] = "FINISHED"
            self._jobs[job.hex()]["end_time"] = time.time()
        for aid, entry in list(self._actors.items()):
            if (entry.spec.caller_id == client_id
                    and entry.spec.lifetime != "detached"
                    and entry.state not in (DEAD,)):
                self._kill_actor_locked(aid, no_restart=True,
                                        cause="owner driver exited")

    def _mark_node_dead(self, node_id: Optional[str]):
        """Cross-shard path (ordered protocol). Caller holds _sched_lock;
        actor + obj are taken here, rank-forward, for the whole teardown
        so no handler observes a node half-dead."""
        node = self._nodes.get(node_id) if node_id else None
        if node is None or not node.alive:
            return
        with self._actor_lock, self._obj_lock:
            node.alive = False
            logger.warning("node %s died", node_id)
            self._drop_client_refs(f"node:{node_id[:12]}")
            # Leases on the dead node die with it (resources went with the
            # node; holders notice their direct conns closing and fall
            # back). The node manager's own local-first grants die the
            # same way — clear the held aggregate so fairness never
            # chases a dead node.
            node.local_held = ResourceSet()
            for lid, lease in list(self._leases.items()):
                if lease["node_id"] == node_id:
                    self._leases.pop(lid, None)
            # Drop object locations on that node. For objects whose LAST
            # copy just died and that something still wants (live refs,
            # task-arg pins, or parked waiters), re-run the producing
            # task — lineage reconstruction (reference:
            # object_recovery_manager.h:41).
            for oid, locs in list(self._obj_locations.items()):
                locs.discard(node_id)
                sp = self._spilled_objects.get(oid)
                if sp is not None and sp.get("node_id") == node_id:
                    self._spilled_objects.pop(oid, None)
                if not locs:
                    wanted = (
                        (self._refcount_total(oid) or 0) > 0
                        or self._task_arg_pins.get(oid)
                        or any(oid in w.pending for w in self._obj_waiters))
                    if wanted:
                        self._try_reconstruct(oid)
            # Fail running tasks on that node (retry if budget remains).
            for tid, (spec, n) in list(self._running_tasks.items()):
                if n == node_id:
                    del self._running_tasks[tid]
                    self._handle_task_failure(spec, "node died")
            # Restart / fail actors on that node.
            for aid, entry in self._actors.items():
                if entry.node_id == node_id and \
                        entry.state in (ALIVE, PENDING_CREATION):
                    self._on_actor_down(aid, "node died")
        # Retried tasks and restarting actors were re-enqueued above —
        # dispatch them onto the surviving nodes now, with actor+obj
        # released (the scheduler re-nests them rank-forward; caller
        # still holds _sched_lock).
        self._try_schedule()

    # --------------------------------------------------------- registration

    def _h_register_client(self, conn: protocol.Conn, p, msg_id):
        with self._sched_lock:
            cid = p["client_id"]
            conn.meta["role"] = p["role"]
            conn.meta["client_id"] = cid
            conn.meta["log_to_driver"] = bool(p.get("log_to_driver"))
            self._clients[cid] = conn
            if p["role"] == "driver" and p.get("existing_job") is not None:
                # Reconnect after a GCS restart: keep the same job identity.
                job = p["existing_job"]
                self._client_jobs[cid] = job
                self._jobs.setdefault(job.hex(), {
                    "job_id": job.hex(), "driver_client_id": cid,
                    "state": "RUNNING", "start_time": time.time(),
                    "end_time": None,
                })
            elif p["role"] == "driver":
                self._next_job += 1
                job = JobID.from_int(self._next_job)
                self._client_jobs[cid] = job
                self._jobs[job.hex()] = {
                    "job_id": job.hex(), "driver_client_id": cid,
                    "state": "RUNNING", "start_time": time.time(),
                    "end_time": None,
                }
                self._persist("jobs", job.hex().encode(),
                              self._jobs[job.hex()])
            else:
                job = p.get("job_id")
            head = next((n for n in self._nodes.values() if n.is_head), None)
            conn.reply(msg_id, {
                "job_id": job,
                "head_store_path": head.store_path if head else None,
                "head_node_id": head.node_id if head else None,
            })

    def _h_register_node(self, conn: protocol.Conn, p, msg_id):
        # Cross-shard: node join re-reports actors (actor shard) and
        # store contents (obj shard) atomically with the ledger entry.
        with self._sched_lock, self._actor_lock:
            self._h_register_node_inner(conn, p, msg_id)
            self._try_schedule()
            self._try_schedule_pgs()

    def _h_register_node_inner(self, conn: protocol.Conn, p, msg_id):
        # Caller holds _sched_lock + _actor_lock; obj nests forward.
        with self._obj_lock:
            entry = NodeEntry(
                node_id=p["node_id"],
                address=p["address"],
                store_path=p["store_path"],
                conn=conn,
                total=ResourceSet(p["resources"]),
                available=ResourceSet(p["resources"]),
                labels=p.get("labels", {}),
                is_head=p.get("is_head", False),
                local_held=ResourceSet(p.get("local_held") or {}),
                local_held_seq=p.get("local_held_seq", -1),
            )
            conn.meta["role"] = "node"
            conn.meta["node_id"] = p["node_id"]
            self._nodes[p["node_id"]] = entry
            # Rejoin after a GCS restart: the node re-reports its store
            # contents and the actors still alive in its worker pool, so
            # restored RESTARTING actors snap back to ALIVE without losing
            # their state (reference: gcs_actor_manager.h restart recovery).
            for oid, size in p.get("objects", []):
                self._add_location(oid, p["node_id"], size)
            for aid in p.get("actors", []):
                a = self._actors.get(aid)
                if a is not None and a.state != DEAD and a.node_id is None:
                    a.state = ALIVE
                    a.node_id = p["node_id"]
                    if a.restarts_left == 0:
                        self._pin_actor_args(a.spec, False)
                    if not a.local_placement:
                        # NM-placed actors' resources arrive in the
                        # node's local_held aggregate, never centrally.
                        entry.available.acquire(a.spec.resources)
                    self._recovering_actors.pop(aid, None)
                    self._persist_actor(aid)
                    self._reply_actor_waiters(a)
            conn.reply(msg_id, {"ok": True})

    def _h_nodes(self, conn: protocol.Conn, p, msg_id):
        with self._sched_lock:
            out = []
            for n in self._nodes.values():
                out.append({
                    "NodeID": n.node_id,
                    "Alive": n.alive,
                    "NodeManagerAddress": n.address,
                    "StorePath": n.store_path,
                    "Resources": n.total.to_dict(),
                    "Available": n.effective_available().to_dict(),
                    "LocallyHeld": n.local_held.to_dict(),
                    "Labels": dict(n.labels),
                    "IsHead": n.is_head,
                    "Hardware": dict(n.hw),
                })
            conn.reply(msg_id, out)

    def _h_cluster_resources(self, conn: protocol.Conn, p, msg_id):
        with self._sched_lock:
            total = ResourceSet()
            for n in self._nodes.values():
                if n.alive:
                    total.add(n.total.to_dict())
            conn.reply(msg_id, total.to_dict())

    def _h_available_resources(self, conn: protocol.Conn, p, msg_id):
        with self._sched_lock:
            total = ResourceSet()
            for n in self._nodes.values():
                if n.alive:
                    total.add(n.effective_available().to_dict())
            conn.reply(msg_id, total.to_dict())

    # ------------------------------------------------------ function store

    def _h_put_function(self, conn: protocol.Conn, p, msg_id):
        with self._kv_lock:
            if p["key"] not in self._functions:
                self._functions[p["key"]] = p["blob"]
                self._persist("functions", p["key"].encode(), p["blob"])
        conn.reply(msg_id, True)

    def _h_get_function(self, conn: protocol.Conn, p, msg_id):
        with self._kv_lock:
            blob = self._functions.get(p["key"])
        conn.reply(msg_id, blob)

    # ----------------------------------------------------------------- KV

    def _h_kv_put(self, conn: protocol.Conn, p, msg_id):
        with self._kv_lock:
            ns = self._kv[p.get("ns", "")]
            if not p.get("overwrite", True) and p["key"] in ns:
                conn.reply(msg_id, False)
                return
            ns[p["key"]] = p["value"]
            self._persist("kv", p.get("ns", "").encode() + b"\x00" + p["key"],
                          p["value"])
        conn.reply(msg_id, True)

    def _h_kv_get(self, conn: protocol.Conn, p, msg_id):
        with self._kv_lock:
            conn.reply(msg_id, self._kv[p.get("ns", "")].get(p["key"]))

    def _h_kv_del(self, conn: protocol.Conn, p, msg_id):
        with self._kv_lock:
            existed = self._kv[p.get("ns", "")].pop(p["key"], None) is not None
            if existed:
                self._persist_delete(
                    "kv", p.get("ns", "").encode() + b"\x00" + p["key"])
            conn.reply(msg_id, existed)

    def _h_kv_exists(self, conn: protocol.Conn, p, msg_id):
        with self._kv_lock:
            conn.reply(msg_id, p["key"] in self._kv[p.get("ns", "")])

    def _h_kv_keys(self, conn: protocol.Conn, p, msg_id):
        pref = p.get("prefix", b"")
        with self._kv_lock:
            conn.reply(msg_id, [k for k in self._kv[p.get("ns", "")]
                                if k.startswith(pref)])

    # ------------------------------------------------------ task scheduling

    def _deps_ready(self, deps: List[ObjectID]) -> bool:
        # Caller holds _obj_lock.
        return all(d.binary() in self._obj_locations
                   and self._obj_locations[d.binary()] for d in deps)

    def _unready_deps(self, deps: List[ObjectID]):
        # Caller holds _obj_lock.
        return [d for d in deps
                if not self._obj_locations.get(d.binary())]

    def _h_submit_task(self, conn: protocol.Conn, spec: TaskSpec, msg_id):
        # obj closes before _try_schedule: the scheduler acquires the
        # actor shard for pending creations, and actor ranks BELOW obj —
        # never acquire rank-backward (see module docstring).
        with self._sched_lock:
            with self._obj_lock:
                spec.retries_left = spec.max_retries
                # Retain the spec for lineage reconstruction; pin its
                # args so refcount-zero deps can't be freed out from
                # under it. The table is LRU-bounded: evicting old
                # lineage turns a later reconstruction attempt into a
                # clean ObjectLost error (reference: lineage eviction
                # once refs go out of scope).
                self._retain_spec_locked(spec)
                self._pin_task_args(spec)
                self._enqueue_task(spec)
            self._try_schedule()

    def _h_submit_tasks(self, conn: protocol.Conn,
                        specs: List[TaskSpec], msg_id):
        """Batched submission (the lease manager's fallback wave with
        batch frames off): one lock acquisition + one scheduling pass per
        batch, so a 100k-task burst drains in hundreds of handler
        invocations instead of 100k — the probe RPC queued behind it
        waits milliseconds, not seconds."""
        with self._sched_lock:
            with self._obj_lock:
                for spec in specs:
                    spec.retries_left = spec.max_retries
                    self._retain_spec_locked(spec)
                    self._pin_task_args(spec)
                    self._enqueue_task(spec)
            self._try_schedule()

    def _h_submit_task_batch(self, conn: protocol.Conn,
                             blobs: List[bytes], msg_id):
        """Batched submission of PRE-PICKLED spec blobs — the frame the
        driver's classic-path coalescer and the node managers' submit-
        ring relays ship (the relay never unpickles; this is the first
        decode). Same-conn FIFO keeps batch frames ordered with any
        single-spec frames on the same connection.

        Dedup on task id: the ring is at-least-once (the NM advances the
        consumer head only after its relay lands, and the driver
        recovers + resubmits unconsumed records when an NM dies), so a
        spec can legitimately arrive twice — a task id already retained
        in the lineage table was submitted, not lost, and is dropped."""
        if isinstance(blobs, dict):
            # Ring-relay framing: retried (timeout-but-landed) batches
            # carry the same (src, seq) and are dropped EXACTLY here —
            # one int of state per ring, no per-task table churn.
            src, seq = blobs.get("src"), blobs.get("seq")
            payload_blobs = blobs["blobs"]
            if src is not None and seq is not None \
                    and self._ring_relay_seqs.get(src, 0) >= seq:
                conn.reply(msg_id, True)   # duplicate: re-ack only
                return
            blobs = payload_blobs
        else:
            src = seq = None
        specs = []
        for b in blobs:
            try:
                specs.append(pickle.loads(b))
            except Exception:
                logger.exception("submit_task_batch: undecodable spec blob")
        with self._sched_lock:
            with self._obj_lock:
                for spec in specs:
                    # Per-task dedup (best effort, lineage-LRU-bounded):
                    # relay RETRIES are dropped exactly by the seq check
                    # above; this catches driver-side ring RECOVERY
                    # resubmitting a batch whose ack died with the NM —
                    # ≤ one relay batch per NM death. If the LRU has
                    # churned past the originals by then, those tasks
                    # re-execute: the same at-least-once window task
                    # retries already imply.
                    if spec.task_id.binary() in self._task_specs:
                        continue   # duplicate delivery (ring recovery)
                    spec.retries_left = spec.max_retries
                    self._retain_spec_locked(spec)
                    self._pin_task_args(spec)
                    self._enqueue_task(spec)
            self._try_schedule()
        # Record the relay seq only AFTER the batch processed: a
        # mid-batch exception must leave the seq unrecorded so the NM's
        # retry of the same (src, seq) is reprocessed, not dropped.
        if src is not None and seq is not None:
            self._ring_relay_seqs[src] = seq
            if len(self._ring_relay_seqs) > 4096:
                self._ring_relay_seqs.pop(next(iter(self._ring_relay_seqs)))
        # ACK so ring relays can commit; a notify sender's msg_id is 0,
        # and a reply-to-0 resolves nothing at the receiver (harmless).
        conn.reply(msg_id, True)

    def _enqueue_task(self, spec: TaskSpec):
        # Caller holds _sched_lock; obj nests forward for the dep check
        # (check-and-park is atomic under _obj_lock, so a concurrent
        # location add can't slip between the check and the parking).
        with self._obj_lock:
            unready = self._unready_deps(spec.arg_deps)
            if unready:
                for d in unready:
                    self._waiting_tasks[d.binary()].append(spec)
                return
        self._queued_tasks.append(spec)

    def _pick_node(self, resources: Dict[str, float],
                   strategy: Any = None,
                   preferred: Optional[str] = None) -> Optional[NodeEntry]:
        """Hybrid scheduling policy (reference:
        raylet/scheduling/policy/hybrid_scheduling_policy.h:50): prefer the
        caller's node while its utilization is below 0.5, else best-fit the
        least-utilized feasible node. NodeAffinity / spread strategies
        override."""
        alive = [n for n in self._nodes.values() if n.alive]
        if isinstance(strategy, str):
            strategy = None if strategy == "DEFAULT" else _SpreadShim() \
                if strategy == "SPREAD" else None
        if strategy is not None:
            kind = getattr(strategy, "kind", None)
            if kind == "node_affinity":
                n = self._nodes.get(strategy.node_id)
                if n is not None and n.alive and (
                        strategy.soft
                        or n.effective_available().fits(resources)):
                    if n.effective_available().fits(resources):
                        return n
                    return None  # hard affinity, wait for capacity
                if not strategy.soft:
                    return None
            elif kind == "spread":
                feas = [n for n in alive
                        if n.effective_available().fits(resources)]
                if not feas:
                    return None
                return min(feas, key=lambda n:
                           n.effective_available().utilization(n.total))
        if preferred is not None:
            pn = self._nodes.get(preferred)
            if (pn is not None and pn.alive
                    and pn.effective_available().fits(resources)
                    and pn.effective_available().utilization(pn.total) < 0.5):
                return pn
        feasible = [n for n in alive
                    if n.effective_available().fits(resources)]
        if not feasible:
            return None
        return min(feasible,
                   key=lambda n: n.effective_available().utilization(n.total))

    def _acquire_for(self, spec, node: NodeEntry) -> bool:
        """Reserve resources on a node (or its PG bundle). Caller holds
        _sched_lock; the PG branch nests the actor shard forward."""
        if spec.placement_group_id is not None:
            with self._actor_lock:
                pg = self._pgs.get(spec.placement_group_id.binary())
                if pg is None or pg.state != "CREATED":
                    return False
                idx = spec.placement_group_bundle_index
                if idx < 0:
                    # any bundle on this node with capacity
                    for i, avail in pg.bundle_available.items():
                        if (pg.spec.bundles[i].node_id == node.node_id
                                and avail.fits(spec.resources)):
                            idx = i
                            break
                    else:
                        return False
                    spec.placement_group_bundle_index = idx
                return pg.bundle_available[idx].acquire(spec.resources)
        return node.available.acquire(spec.resources)

    def _release_for(self, spec, node_id: str):
        # Caller holds _sched_lock; PG branch nests actor forward.
        if spec.placement_group_id is not None:
            with self._actor_lock:
                pg = self._pgs.get(spec.placement_group_id.binary())
                if pg is not None and \
                        spec.placement_group_bundle_index >= 0:
                    avail = pg.bundle_available.get(
                        spec.placement_group_bundle_index)
                    if avail is not None:
                        avail.release(spec.resources)
            return
        node = self._nodes.get(node_id)
        if node is not None:
            node.available.release(spec.resources)

    def _node_for_pg_task(self, spec) -> Optional[NodeEntry]:
        # Caller holds _sched_lock; actor nests forward for the PG table.
        with self._actor_lock:
            pg = self._pgs.get(spec.placement_group_id.binary())
            if pg is None or pg.state != "CREATED":
                return None
            idx = spec.placement_group_bundle_index
            for i, b in enumerate(pg.spec.bundles):
                if idx >= 0 and i != idx:
                    continue
                if (b.node_id in self._nodes
                        and pg.bundle_available[i].fits(spec.resources)):
                    return self._nodes[b.node_id]
        return None

    def _try_schedule(self):
        """Drain the ready queue onto nodes with capacity.

        The queue is indexed by scheduling shape: when a bucket's head
        can't place (no feasible node), the WHOLE bucket is skipped in
        that one check — cost per event is O(shapes x nodes +
        dispatched), independent of how many tasks are queued (reference:
        cluster_task_manager.h:42 scheduling classes).

        Caller holds _sched_lock; actor nests forward for pending actor
        creations / PG tasks, obj for failing cancelled specs.
        """
        if not self._nodes:
            return
        if self._pending_pgs and not self._placing_pgs:
            # Capacity that came back (a group removed, an actor gone,
            # leases returned) may now fit a group that could not place
            # when it was made: retry those before queued tasks take it.
            # The reference retries them only when a node registers.
            self._placing_pgs = True
            try:
                with self._actor_lock:
                    self._try_schedule_pgs()
            finally:
                self._placing_pgs = False
        stuck_demands: List[Dict[str, float]] = []
        for key, _q in self._queued_tasks.buckets():
            while True:
                spec = self._queued_tasks.pop_head(key)
                if spec is None:
                    break
                if isinstance(spec, _ActorCreationShim):
                    stuck = False
                    with self._actor_lock:
                        entry = self._actors.get(spec.actor_id.binary())
                        if entry is not None and entry.node_id is None \
                                and entry.state in (PENDING_CREATION,
                                                    DEPENDENCIES_UNREADY,
                                                    RESTARTING):
                            if not self._schedule_actor(entry):
                                self._queued_tasks.appendleft(spec)
                                stuck_demands.append(entry.spec.resources)
                                stuck = True
                    if stuck:
                        break  # this actor can't place now
                    continue
                if spec.task_id.binary() in self._cancelled_tasks:
                    # e.g. a retry re-enqueued after a force-cancel: fail
                    # its returns and release its arg pins instead of
                    # silently dropping (pins would leak forever).
                    self._fail_task_objects(spec, "cancelled")
                    continue
                if spec.placement_group_id is not None:
                    node = self._node_for_pg_task(spec)
                else:
                    node = self._pick_node(spec.resources,
                                           spec.scheduling_strategy,
                                           preferred=spec.owner_node)
                if node is None or not self._acquire_for(spec, node):
                    # Head of this shape can't place -> nothing behind it
                    # in the same shape can either; skip the bucket.
                    self._queued_tasks.appendleft(spec)
                    stuck_demands.append(spec.resources)
                    break
                self._running_tasks[spec.task_id.binary()] = (spec,
                                                              node.node_id)
                try:
                    node.conn.notify("lease_task", spec)
                except Exception:
                    self._running_tasks.pop(spec.task_id.binary(), None)
                    self._release_for(spec, node.node_id)
                    self._queued_tasks.appendleft(spec)
                    break
        if stuck_demands:
            self._maybe_revoke_lease_locked(stuck_demands)

    def _feasible_anywhere_locked(self, demand: Dict[str, float]) -> bool:
        """Could this demand EVER place on a live node's total resources?
        Infeasible demand (typo'd custom resource, demand parked for the
        autoscaler) is kept out of lease fairness entirely — the
        reference parks such tasks in a separate infeasible queue that
        blocks nothing (cluster_task_manager.h:42)."""
        return any(n.alive and n.total.fits(demand)
                   for n in self._nodes.values())

    # Shared with the node manager's backoff/revoke targeting: both ends
    # of the lease-fairness protocol must use the same predicate.
    _demand_overlaps = staticmethod(demand_overlaps)

    def _maybe_revoke_lease_locked(self, stuck_demands):
        """Classic-queue fairness: when scheduled work cannot place while
        worker leases hold capacity, revoke one lease (rate-limited).
        Only a lease whose held resources actually compete with a stuck
        (and feasible-on-some-node) demand is revoked; the holder drains
        it gracefully (lease.py revoke). Covers both GCS-brokered leases
        and node managers' local-first grants (revoked via the NM)."""
        if not self._leases and all(
                n.local_held.is_zero() for n in self._nodes.values()):
            return
        feasible = [d for d in stuck_demands
                    if self._feasible_anywhere_locked(d)]
        if not feasible:
            return
        now = time.time()
        if now - self._last_lease_revoke < 0.2:
            return
        target = None
        for lid, lease in self._leases.items():
            if any(self._demand_overlaps(d, lease["resources"])
                   for d in feasible):
                target = lid
                break
        if target is None:
            # No GCS-brokered lease competes — but a node manager's OWN
            # grants (local-first scheduling) might. Ask one such node to
            # revoke a local lease; the freed capacity arrives on its
            # eager resource report and _try_schedule fires then.
            for node in self._nodes.values():
                if node.alive and not node.local_held.is_zero() and any(
                        self._demand_overlaps(d, node.local_held.to_dict())
                        for d in feasible):
                    self._last_lease_revoke = now
                    try:
                        node.conn.notify(protocol.REVOKE_LOCAL_LEASE,
                                         {"demands": feasible})
                    except Exception:
                        pass
                    return
            return
        self._last_lease_revoke = now
        lease = self._leases[target]
        conn = self._clients.get(lease["client_id"])
        self._release_lease_locked(target)
        if conn is not None:
            try:
                conn.notify("revoke_lease", {"lease_id": target})
            except Exception:
                pass

    def _inline_insert_locked(self, oid: bytes, blob: bytes,
                              node_id: str) -> Tuple[bool, List[tuple]]:
        """Register an in-band return in the inline table (caller holds
        _obj_lock). Returns (registered, spills): ``registered`` False
        means a copy (inline or store) already exists — the caller must
        NOT add a ::inline directory entry for it, or a redelivered
        completion landing AFTER a spill-confirm would register a
        phantom ::inline location with no backing table entry (which
        also suppresses lineage reconstruction when the store copy's
        node later dies). ``spills`` are the entries the insertion
        pushed over the producing job's byte budget, shipped via
        _send_inline_spills AFTER releasing the shard locks."""
        if self._obj_locations.get(oid):
            return False, []   # a copy (inline or store) already exists
        try:
            job = ObjectID(oid).job_id().binary()
        except Exception:
            job = b""
        return True, self._inline_tbl.insert(oid, blob, job, node_id)

    def _send_inline_spills(self, spills) -> None:
        """Materialize pressure-evicted inline entries into a node's
        store (store_inline_objects). Runs outside every shard lock;
        node lookups are routing reads. The table entry is dropped only
        when the node's add_object_locations confirms the store copy."""
        if not spills:
            return
        by_node: Dict[str, List[Tuple[bytes, bytes]]] = {}
        for oid, blob, node_id in spills:
            by_node.setdefault(node_id, []).append((oid, blob))
        sent = 0
        for node_id, objs in by_node.items():
            node = self._nodes.get(node_id)
            if node is None or not node.alive:
                # Producer gone: any live node's store serves reads.
                node = next((n for n in list(self._nodes.values())
                             if n.alive), None)
            if node is None:
                continue   # no nodes: retried on the next pressure tick
            if node.node_id != node_id:
                # Re-targeted: the confirm will come from THIS node, so
                # retries and free-tombstones must name it, not the
                # dead producer.
                for oid, _blob in objs:
                    if not self._inline_tbl.note_spill_target(
                            oid, node.node_id):
                        # Freed while the spill was in flight: point
                        # the tombstone at the real target.
                        with self._obj_lock:
                            tomb = self._freed_mid_spill.get(oid)
                            if tomb is not None:
                                self._freed_mid_spill[oid] = \
                                    (node.node_id, tomb[1])
            try:
                node.conn.notify("store_inline_objects", {"objects": objs})
                sent += len(objs)
            except Exception:
                continue
        if sent:
            try:
                _inline_metrics()[0].inc(sent)
            except Exception:
                pass

    def _apply_task_done_locked(self, p: dict, node_id: str,
                                new_oids: Set[bytes],
                                spills: list) -> None:
        """Apply one completion record. Caller holds _sched_lock +
        _obj_lock; locations are registered QUIETLY — the caller owes
        one _fulfill_obj_waiters_many(new_oids) pass for the whole
        batch — and inline-table pressure spills accumulate into
        ``spills`` for post-lock dispatch."""
        tid = p["task_id"]
        entry = self._running_tasks.pop(tid, None)
        if entry is not None:
            spec, run_node = entry
            self._release_for(spec, run_node)
        pinned_spec = self._actor_task_pins.pop(tid, None)
        if pinned_spec is not None:
            self._unpin_task_args(pinned_spec)
        inline = p.get("inline") or {}
        for oid, size in p.get("objects", []):
            if oid in inline:
                # In-band return: the GCS inline table IS the copy; the
                # directory lists it under the ::inline pseudo node.
                registered, sp = self._inline_insert_locked(
                    oid, inline[oid], node_id)
                if not registered:
                    # Redelivery after the object is already resolvable
                    # (table entry or a spilled store copy): adding a
                    # location would orphan ::inline from the table.
                    continue
                spills.extend(sp)
                loc = inline_objects.INLINE_LOCATION
            else:
                loc = node_id
            for spec2 in self._add_location_obj_quiet(oid, loc, size):
                self._enqueue_task(spec2)
            new_oids.add(oid)
        if entry is not None and \
                getattr(entry[0], "num_returns", None) == "dynamic":
            # Dynamic yields are reconstructable: re-running the
            # generator re-stores every index idempotently.
            for oid, _size in p.get("objects", []):
                self._producing_task[oid] = tid
        if p["status"] == "crashed" and entry is not None:
            self._handle_task_failure(entry[0],
                                      p.get("error", "worker died"))
        elif entry is not None:
            self._unpin_task_args(entry[0])

    def _releases_bundle_locked(self, records) -> bool:
        """Caller holds _sched_lock: True if completing one of
        ``records`` frees a placement-group bundle. ``_release_for``
        then takes _actor_lock, which ranks below _obj_lock, so the
        caller must take it before _obj_lock (a PG task's completion
        under _obj_lock alone closed obj -> actor -> obj against
        ``_h_register_node``'s actor -> obj)."""
        for r in records:
            entry = self._running_tasks.get(r["task_id"])
            if entry is not None and \
                    entry[0].placement_group_id is not None:
                return True
        return False

    def _h_task_done(self, conn: protocol.Conn, p, msg_id):
        """Node manager reports task completion (success or failure)."""
        self._apply_task_done_records([p], p["node_id"])

    def _apply_task_done_records(self, records, node_id: str) -> None:
        new_oids: Set[bytes] = set()
        spills: list = []
        with self._sched_lock:
            with contextlib.ExitStack() as held:
                if self._releases_bundle_locked(records):
                    held.enter_context(self._actor_lock)
                with self._obj_lock:
                    for r in records:
                        self._apply_task_done_locked(r, node_id, new_oids,
                                                     spills)
                    if new_oids:
                        self._fulfill_obj_waiters_many(new_oids)
            self._try_schedule()
        self._send_inline_spills(spills)

    def _h_task_done_batch(self, conn: protocol.Conn, p, msg_id):
        """Batched completions relayed by a node manager as pre-pickled
        records (the completion twin of _h_submit_task_batch: the worker
        pickled each record, the NM relayed the blobs untouched, this is
        the first decode). One shard-lock acquisition, ONE parked-waiter
        pass, and one scheduling pass per batch — a 64-task batch wakes
        get() waiters once, not 64 times."""
        node_id = p["node_id"]
        records = []
        for b in p["blobs"]:
            try:
                records.append(pickle.loads(b))
            except Exception:
                # Per-blob guard: one undecodable record must not drop
                # the rest of the batch.
                logger.exception("task_done_batch: undecodable record")
        if not records:
            return
        try:
            _inline_metrics()[2].observe(float(len(records)))
        except Exception:
            pass
        self._apply_task_done_records(records, node_id)

    # ------------------------------------------------- worker leases
    # (direct task transport, reference: direct_task_transport.h:75 —
    # the GCS only brokers leases; leased-task submission/completion
    # flows caller -> worker directly and is reported back in batches.)

    def _queued_blocks_lease_locked(self, resources) -> bool:
        """True if some queued classic-path shape is (a) feasible on at
        least one live node's total resources and (b) competing with the
        requested lease shape for a resource."""
        for _key, q in self._queued_tasks.buckets():
            if not q:
                continue
            head = q[0]
            if isinstance(head, _ActorCreationShim):
                with self._actor_lock:
                    entry = self._actors.get(head.actor_id.binary())
                    demand = entry.spec.resources \
                        if entry is not None else None
                if demand is None:
                    continue
            else:
                demand = head.resources
            if not self._demand_overlaps(demand, resources):
                continue
            if self._feasible_anywhere_locked(demand):
                return True
        return False

    def _h_request_worker_lease(self, conn: protocol.Conn, p, msg_id):
        """Grant (or deny) a worker lease for a scheduling shape.

        A grant acquires the shape's resources on the chosen node until
        ``return_lease``. Denial (None reply) means no capacity now; the
        caller falls back to the classic scheduled path.
        """
        import os as _os

        with self._sched_lock:
            resources = p["resources"]
            # Fairness: while classic-path work (tasks, actor creations)
            # that COMPETES for these resources is queued, leases may not
            # grab more capacity — the classic queue drains first (see
            # also _maybe_revoke_lease_locked). Queued work that is
            # infeasible on every live node, or that needs disjoint
            # resources, does not block the grant.
            if self._queued_blocks_lease_locked(resources):
                conn.reply(msg_id, None)
                return
            node = self._pick_node(resources, None,
                                   preferred=p.get("owner_node"))
            # _pick_node already filtered on effective_available().fits()
            # (which implies available fits — effective <= available).
            if node is None or not node.available.acquire(resources):
                shape = tuple(sorted(resources.items()))
                self._lease_demand[shape] = (
                    dict(resources), time.time(),
                    max(1, int(p.get("backlog", 1))))
                conn.reply(msg_id, None)
                return
            lease_id = _os.urandom(16)
            self._leases[lease_id] = {
                "client_id": p["client_id"],
                "node_id": node.node_id,
                "resources": dict(resources),
            }
            conn.reply(msg_id, {
                "lease_id": lease_id,
                "node_id": node.node_id,
                "node_address": node.address,
            })

    def _h_return_lease(self, conn: protocol.Conn, p, msg_id):
        with self._sched_lock:
            self._release_lease_locked(p["lease_id"])
            self._try_schedule()

    def _release_lease_locked(self, lease_id: bytes):
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return
        node = self._nodes.get(lease["node_id"])
        if node is not None and node.alive:
            node.available.release(lease["resources"])

    def _release_client_leases_locked(self, client_id: str):
        for lid, lease in list(self._leases.items()):
            if lease["client_id"] == client_id:
                self._release_lease_locked(lid)

    def _retain_spec_locked(self, spec: TaskSpec):
        """Retain a spec for lineage reconstruction (LRU-bounded)."""
        from ray_tpu_torch._private.config import config as _cfg

        for rid in spec.return_ids():
            self._producing_task[rid.binary()] = spec.task_id.binary()
        self._task_specs[spec.task_id.binary()] = spec
        cap = int(_cfg.max_lineage_entries)
        while len(self._task_specs) > cap:
            old_tid, old_spec = next(iter(self._task_specs.items()))
            del self._task_specs[old_tid]
            self._reconstructions.pop(old_tid, None)
            for rid in old_spec.return_ids():
                self._producing_task.pop(rid.binary(), None)

    def _h_lease_task_events(self, conn: protocol.Conn, p, msg_id):
        """Batched completion report for lease-path tasks: registers
        object locations (so other clients' get/wait resolve) and retains
        specs for lineage — the deferred, amortized equivalent of what
        submit_task + task_done do synchronously on the classic path.

        Object-shard only on the common path: the scheduling shard is
        touched (two-phase, after obj releases) only when a location
        unblocked dep-parked tasks — lease completions never contend
        with placement otherwise."""
        node_id = p["node_id"]
        woken: List[Any] = []
        new_oids: Set[bytes] = set()
        spills: list = []
        with self._obj_lock:
            for t in p["tasks"]:
                spec = t.get("spec")
                if spec is not None:
                    # Lease specs never went through _h_submit_task, so
                    # arm the retry budget here: a later reconstruction
                    # re-run gets the same retries the classic path would.
                    if getattr(spec, "retries_left", None) in (None, 0):
                        spec.retries_left = spec.max_retries
                    self._retain_spec_locked(spec)
                inline = t.get("inline") or {}
                for oid, size in t.get("objects", ()):
                    if oid in inline:
                        # In-band lease return: the blob was delivered
                        # to the submitting driver at completion; this
                        # flush makes the GCS table the cluster-visible
                        # copy (other clients resolve it through
                        # object_locations, no node hop).
                        registered, sp = self._inline_insert_locked(
                            oid, inline[oid], node_id)
                        if not registered:
                            continue   # redelivery: already resolvable
                        spills.extend(sp)
                        loc = inline_objects.INLINE_LOCATION
                    else:
                        loc = node_id
                    woken.extend(
                        self._add_location_obj_quiet(oid, loc, size))
                    new_oids.add(oid)
                if spec is not None and \
                        getattr(spec, "num_returns", None) == "dynamic":
                    for oid, _size in t.get("objects", ()):
                        self._producing_task[oid] = \
                            spec.task_id.binary()
            if new_oids:
                # One parked-waiter pass per report batch.
                self._fulfill_obj_waiters_many(new_oids)
        if woken:
            with self._sched_lock:
                for spec in woken:
                    self._enqueue_task(spec)
                self._try_schedule()
        self._send_inline_spills(spills)

    def _handle_task_failure(self, spec: TaskSpec, reason: str):
        """System failure (worker/node death): retry or store error objects."""
        if spec.retries_left > 0:
            spec.retries_left -= 1
            logger.info("retrying task %s (%s); %d retries left",
                        spec.name, reason, spec.retries_left)
            self._enqueue_task(spec)
        else:
            self._fail_task_objects(spec, reason)

    def _fail_task_objects(self, spec, reason: str):
        """Ask the owner's node to materialize error objects for the
        returns. Acquires _obj_lock itself (reentrant under callers that
        hold it); callable from any shard at rank <= obj. Node lookup is
        a routing read."""
        ids = [r.binary() for r in spec.return_ids()]
        with self._obj_lock:
            self._unpin_task_args(spec)
            self._actor_task_pins.pop(spec.task_id.binary(), None)
            for oid in ids:
                self._failed_objects[oid] = reason
        owner_node = self._nodes.get(getattr(spec, "owner_node", None)) \
            or next((n for n in list(self._nodes.values()) if n.alive), None)
        if owner_node is not None:
            try:
                owner_node.conn.notify("store_error_objects", {
                    "object_ids": ids,
                    "error": reason,
                    "kind": p_kind(spec),
                    "name": getattr(spec, "name", ""),
                })
            except Exception:
                pass

    def _h_cancel_task(self, conn: protocol.Conn, p, msg_id):
        tid = p["task_id"]
        with self._sched_lock, self._obj_lock:
            self._cancelled_tasks.add(tid)
            # Capture the spec BEFORE removing it from the queues — the
            # not-running branch below must fail its return objects, and
            # a removed spec can no longer be found.
            spec = self._spec_for_task(tid)
            self._queued_tasks.remove_task(tid)
            for lst in self._waiting_tasks.values():
                lst[:] = [s for s in lst if s.task_id.binary() != tid]
            running = self._running_tasks.get(tid)
            if running is not None:
                rspec, node_id = running
                node = self._nodes.get(node_id)
                if node is not None:
                    node.conn.notify("cancel_task", {
                        "task_id": tid, "force": p.get("force", False)})
            else:
                # Cancelled before dispatch: fail its return objects
                # (also releases its arg pins via _fail_task_objects).
                if spec is None:
                    spec = self._task_specs.get(tid)
                if spec is not None:
                    self._fail_task_objects(spec, "cancelled")
        conn.reply(msg_id, True)

    def _spec_for_task(self, tid: bytes):
        for s in self._queued_tasks:
            if s.task_id.binary() == tid:
                return s
        for lst in self._waiting_tasks.values():
            for s in lst:
                if s.task_id.binary() == tid:
                    return s
        return None

    # ------------------------------------------------------------- objects

    def _add_location(self, oid: bytes, node_id: str, size: int = 0):
        """Register a copy and wake dep-parked tasks inline. Caller holds
        _sched_lock AND _obj_lock; callers holding only _obj_lock use
        _add_location_obj and enqueue the returned specs under
        _sched_lock after releasing obj (two-phase — never acquire
        rank-backward)."""
        for spec in self._add_location_obj(oid, node_id, size):
            self._enqueue_task(spec)

    def _add_location_obj(self, oid: bytes, node_id: str,
                          size: int = 0) -> List[Any]:
        """Object-shard half: directory entry, waiter fulfillment;
        returns the dep-parked specs this copy unblocked (some may still
        wait on other deps — _enqueue_task re-parks those). Caller holds
        _obj_lock."""
        woken = self._add_location_obj_quiet(oid, node_id, size)
        self._fulfill_obj_waiters(oid, failed=False)
        return woken

    def _add_location_obj_quiet(self, oid: bytes, node_id: str,
                                size: int = 0) -> List[Any]:
        """_add_location_obj WITHOUT the waiter pass — batched
        completion handlers register a whole batch of locations first
        and fulfill parked waiters once (_fulfill_obj_waiters_many),
        so a 64-task batch costs one waiter scan, not 64. Caller holds
        _obj_lock and owes a fulfillment pass for the oid."""
        if self._freed_mid_spill:
            tomb = self._freed_mid_spill.get(oid)
            if tomb is not None and tomb[0] == node_id:
                # Pressure-spill confirm for an object freed while the
                # materialization was in flight: the store copy must
                # die, not enter the directory.
                del self._freed_mid_spill[oid]
                self._deferred_deletes.setdefault(
                    node_id, []).append(oid)
                return []
        if oid in self._inline_tbl and \
                node_id != inline_objects.INLINE_LOCATION:
            # A store copy materialized (pressure spill confirmed, or a
            # retry re-ran the task): the directory now points at a real
            # node, the table entry retires.
            self._inline_tbl.drop(oid)
            self._obj_locations[oid].discard(
                inline_objects.INLINE_LOCATION)
        self._obj_locations[oid].add(node_id)
        if size:
            self._obj_sizes[oid] = size
        return self._waiting_tasks.pop(oid, None) or []

    def _fulfill_obj_waiters(self, oid: bytes, failed: bool):
        done = []
        for w in self._obj_waiters:
            if oid in w.pending:
                w.pending.discard(oid)
                (w.failed if failed else w.ready).add(oid)
                if len(w.ready) + len(w.failed) >= w.num_needed or not w.pending:
                    done.append(w)
        self._reply_done_waiters(done)

    def _fulfill_obj_waiters_many(self, oids: Set[bytes]):
        """One waiter pass for a whole completion batch (the per-batch
        wakeup of parked get()/wait() callers). Caller holds _obj_lock."""
        done = []
        for w in self._obj_waiters:
            hit = w.pending & oids
            if not hit:
                continue
            w.pending -= hit
            w.ready |= hit
            if len(w.ready) + len(w.failed) >= w.num_needed or not w.pending:
                done.append(w)
        self._reply_done_waiters(done)

    def _reply_done_waiters(self, done: List[_ObjWaiter]):
        for w in done:
            self._obj_waiters.remove(w)
            try:
                w.conn.reply(w.msg_id, {
                    "ready": list(w.ready),
                    "failed": {o: self._failed_objects.get(o, "failed")
                               for o in w.failed},
                    "timeout": False,
                })
            except Exception:
                pass

    def _h_add_object_locations(self, conn: protocol.Conn, p, msg_id):
        with self._sched_lock:
            with self._obj_lock:
                for oid, size in p["objects"]:
                    self._add_location(oid, p["node_id"], size)
            self._try_schedule()

    def _h_remove_object_location(self, conn: protocol.Conn, p, msg_id):
        with self._obj_lock:
            locs = self._obj_locations.get(p["object_id"])
            if locs is not None:
                locs.discard(p["node_id"])

    def _h_object_locations(self, conn: protocol.Conn, p, msg_id):
        # Node entries resolve via routing reads; only the directory
        # needs the object shard.
        with self._obj_lock:
            out = {}
            for oid in p["object_ids"]:
                nodes = [self._nodes[n] for n in self._obj_locations.get(oid, ())
                         if n in self._nodes and self._nodes[n].alive]
                ent = {
                    "locations": [(n.node_id, n.address) for n in nodes],
                    "size": self._obj_sizes.get(oid, 0),
                    "failed": self._failed_objects.get(oid),
                }
                blob = self._inline_tbl.get(oid)
                if blob is not None:
                    # In-band object: the directory lookup IS the
                    # transfer — the reply carries the value, and the
                    # client parks it in its local inline cache.
                    ent["inline"] = blob
                out[oid] = ent
            conn.reply(msg_id, out)

    def _h_wait_for_objects(self, conn: protocol.Conn, p, msg_id):
        """Park until num_returns of object_ids are ready (or
        failed/timeout). Takes sched+obj: lost objects found here kick
        lineage reconstruction, which enqueues onto the task queues; the
        scheduler pass itself runs after obj releases (it nests the
        actor shard, which ranks below obj)."""
        with self._sched_lock:
            with self._obj_lock:
                ids: List[bytes] = p["object_ids"]
                ready = {o for o in ids if self._obj_locations.get(o)}
                failed = {o for o in ids
                          if o in self._failed_objects} - ready
                need = p.get("num_returns", len(ids))
                if len(ready) + len(failed) >= need:
                    conn.reply(msg_id, {
                        "ready": list(ready),
                        "failed": {o: self._failed_objects.get(o, "failed")
                                   for o in failed},
                        "timeout": False,
                    })
                    return
                timeout = p.get("timeout")
                w = _ObjWaiter(
                    conn=conn, msg_id=msg_id,
                    pending=set(ids) - ready - failed,
                    num_needed=need, ready=ready, failed=failed,
                    deadline=(time.time() + timeout)
                    if timeout is not None else None,
                )
                self._obj_waiters.append(w)
                # Produced-then-lost objects (location set exists but is
                # empty: every copy died) get lineage reconstruction.
                # Never-produced objects are simply not ready yet — their
                # producer (task or actor call) is still in flight.
                kicked = False
                for o in list(w.pending):
                    if o in self._obj_locations                             and not self._obj_locations[o]:
                        self._try_reconstruct(o)
                        kicked = True
            if kicked:
                self._try_schedule()

    def _h_free_objects(self, conn: protocol.Conn, p, msg_id):
        with self._obj_lock:
            deletes = self._free_now(p["object_ids"])
        self._send_deletes(deletes)
        conn.reply(msg_id, True)

    def _free_now(self, ids: List[bytes]) -> Dict[str, List[bytes]]:
        """Drop an object cluster-wide: directory entry, node copies, and —
        once every return of the producing task is gone — its lineage spec.
        Called with _obj_lock held (explicit ``free`` and the zero-ref
        deferred-free timer both land here). Returns the per-node delete
        map; the caller sends the delete notifications AFTER releasing
        the lock (_send_deletes)."""
        by_node: Dict[str, List[bytes]] = collections.defaultdict(list)
        for oid in ids:
            spill_target = self._inline_tbl.spill_inflight(oid)
            if spill_target is not None:
                # A materialization is mid-flight to a node that is not
                # in the directory yet: tombstone so its confirm report
                # deletes the store copy instead of re-registering it.
                self._freed_mid_spill[oid] = (spill_target,
                                              time.monotonic())
            self._inline_tbl.drop(oid)
            for nid in self._obj_locations.pop(oid, ()):  # noqa: B909
                if nid == inline_objects.INLINE_LOCATION:
                    continue   # the table entry above WAS the copy
                by_node[nid].append(oid)
            self._obj_sizes.pop(oid, None)
            self._pending_free.pop(oid, None)
            self._spilled_objects.pop(oid, None)
            for cid in [c for c, s in self._client_refs.items() if oid in s]:
                self._client_refs[cid].discard(oid)
            self._refcounts.pop(oid, None)
            # Lineage (_producing_task/_task_specs) is deliberately kept:
            # a freed object may still be an input of a downstream task's
            # reconstruction; the spec table is bounded by tasks submitted.
        return by_node

    def _send_deletes(self, by_node: Dict[str, List[bytes]]) -> None:
        """Ship delete_objects notifications collected by _free_now.
        Runs outside every shard lock; node lookup is a routing read."""
        for nid, oids in by_node.items():
            node = self._nodes.get(nid)
            if node is not None and node.alive:
                try:
                    node.conn.notify("delete_objects",
                                     {"object_ids": oids})
                except Exception:
                    pass

    # ------------------------------------------------------ ref counting

    def _h_update_refcounts(self, conn: protocol.Conn, p, msg_id):
        """Batched ref-count deltas from one client (reference role:
        core_worker/reference_count.h:61 owner tables + borrower
        registration, aggregated at the GCS here). Object shard only —
        refcount churn never contends with scheduling."""
        cid = p["client_id"]
        with self._obj_lock:
            for oid, delta in p["deltas"].items():
                counts = self._refcounts.setdefault(oid, {})
                if delta:
                    counts[cid] = counts.get(cid, 0) + delta
                    if counts[cid] == 0:
                        del counts[cid]
                    self._client_refs[cid].add(oid)
                self._maybe_schedule_free(oid)

    def _refcount_total(self, oid: bytes) -> Optional[int]:
        counts = self._refcounts.get(oid)
        if counts is None:
            return None  # never tracked: not eligible for auto-free
        return sum(counts.values())

    def _maybe_schedule_free(self, oid: bytes):
        """Schedule (or cancel) the deferred free for one object."""
        total = self._refcount_total(oid)
        if total is None:
            return
        if total <= 0 and not self._task_arg_pins.get(oid):
            from ray_tpu_torch._private.config import config

            self._pending_free.setdefault(
                oid, time.time() + config.free_grace_s)
        else:
            self._pending_free.pop(oid, None)

    def _drop_client_refs(self, client_id: str):
        """A client process died: discard its contribution to every count."""
        for oid in self._client_refs.pop(client_id, ()):  # noqa: B909
            counts = self._refcounts.get(oid)
            if counts is not None and counts.pop(client_id, None) is not None:
                self._maybe_schedule_free(oid)

    @staticmethod
    def _pin_key(spec) -> bytes:
        """A spec's key in ``_pinned_tasks``: its task id, or an actor
        creation's actor id."""
        tid = getattr(spec, "task_id", None)
        return (tid if tid is not None else spec.actor_id).binary()

    def _pin_task_args(self, spec):
        tid = self._pin_key(spec)
        if tid in self._pinned_tasks:
            return
        self._pinned_tasks.add(tid)
        for d in pinned_deps(spec):
            self._task_arg_pins[d.binary()] += 1
            self._pending_free.pop(d.binary(), None)

    def _unpin_task_args(self, spec):
        tid = self._pin_key(spec)
        if tid not in self._pinned_tasks:
            return
        self._pinned_tasks.discard(tid)
        for d in pinned_deps(spec):
            oid = d.binary()
            n = self._task_arg_pins.get(oid, 0) - 1
            if n <= 0:
                self._task_arg_pins.pop(oid, None)
            else:
                self._task_arg_pins[oid] = n
            self._maybe_schedule_free(oid)

    # ---------------------------------------------- lineage reconstruction

    def _producer_in_flight(self, tid: bytes) -> bool:
        if tid in self._running_tasks:
            return True
        if any(s.task_id.binary() == tid for s in self._queued_tasks):
            return True
        return any(s.task_id.binary() == tid
                   for lst in self._waiting_tasks.values() for s in lst)

    def _try_reconstruct(self, oid: bytes, depth: int = 0) -> bool:
        """Re-run the task that produced a lost object (reference:
        core_worker/object_recovery_manager.h:41 + task resubmit,
        task_manager.h:151). Returns False when the object is
        unrecoverable (and marks it failed)."""
        if self._obj_locations.get(oid) or depth > 16:
            return True
        if oid in self._failed_objects:
            return False
        tid = self._producing_task.get(oid)
        spec = self._task_specs.get(tid) if tid else None
        if spec is None:
            # put() objects / actor-task returns have no replayable lineage.
            self._failed_objects[oid] = (
                "object lost (all copies died) and no lineage is available "
                "to reconstruct it")
            self._fulfill_obj_waiters(oid, failed=True)
            return False
        if self._producer_in_flight(tid):
            return True
        from ray_tpu_torch._private.config import config

        attempts = self._reconstructions.get(tid, 0)
        if attempts >= config.max_lineage_reconstructions:
            self._failed_objects[oid] = (
                f"object lost; reconstruction limit "
                f"({config.max_lineage_reconstructions}) exhausted")
            self._fulfill_obj_waiters(oid, failed=True)
            return False
        self._reconstructions[tid] = attempts + 1
        logger.info("reconstructing object %s by re-running task %s "
                    "(attempt %d)", oid.hex()[:16],
                    getattr(spec, "name", "") or tid.hex()[:16], attempts + 1)
        # Rebuild lost inputs first; _enqueue_task parks on unready deps.
        # Recurse only into deps that are genuinely gone (empty location set
        # = every copy died; key absent but lineage known = freed earlier).
        # A dep with no entry and no lineage has an in-flight producer.
        for d in spec.arg_deps:
            db = d.binary()
            if ((db in self._obj_locations and not self._obj_locations[db])
                    or (db not in self._obj_locations
                        and db in self._producing_task)):
                self._try_reconstruct(db, depth + 1)
        # A hard affinity to a node that no longer exists would wedge the
        # rebuild forever; recovering the data beats honoring a placement
        # hint whose target is gone.
        strat = spec.scheduling_strategy
        if getattr(strat, "kind", None) == "node_affinity":
            n = self._nodes.get(strat.node_id)
            if n is None or not n.alive:
                logger.info("reconstruction of %s: dropping affinity to "
                            "dead node %s", getattr(spec, "name", ""),
                            strat.node_id[:12])
                spec.scheduling_strategy = None
        self._pin_task_args(spec)
        self._enqueue_task(spec)
        return True

    # -------------------------------------------------------------- actors

    def _h_create_actor(self, conn: protocol.Conn,
                        spec: ActorCreationSpec, msg_id):
        # Placement mutates the node ledger: sched+actor, rank order.
        with self._sched_lock, self._actor_lock:
            existing_entry = self._actors.get(spec.actor_id.binary())
            if existing_entry is not None and existing_entry.state != DEAD:
                # Duplicate create (driver NM-death recovery racing a
                # late actor_placed): first registration wins.
                conn.reply(msg_id, {"ok": True, "existing": True})
                return
            if spec.name:
                key = (spec.namespace, spec.name)
                existing = self._named_actors.get(key)
                if existing is not None and \
                        self._actors[existing].state != DEAD:
                    conn.reply_error(
                        msg_id, f"actor name '{spec.name}' already taken")
                    return
                self._named_actors[key] = spec.actor_id.binary()
            entry = ActorEntry(spec=spec, restarts_left=spec.max_restarts)
            self._actors[spec.actor_id.binary()] = entry
            self._pin_actor_args(spec, True)
            if not self._schedule_actor(entry):
                self._queued_tasks.append(_ActorCreationShim(entry))
            self._persist_actor(spec.actor_id.binary())
            conn.reply(msg_id, {"ok": True})

    def _schedule_actor(self, entry: ActorEntry) -> bool:
        """Try to place the actor now. Returns True if dispatched (or parked
        on unready dependencies); False if it must wait for capacity.
        Caller holds _sched_lock + _actor_lock; obj nests forward for
        the dependency check."""
        spec = entry.spec
        with self._obj_lock:
            unready = self._unready_deps(spec.arg_deps)
            if unready:
                entry.state = DEPENDENCIES_UNREADY
                # Park on the first unready dep; re-enqueued via
                # _add_location.
                self._waiting_tasks[unready[0].binary()].append(
                    _ActorCreationShim(entry))
                return True
        if spec.placement_group_id is not None:
            pg = self._pgs.get(spec.placement_group_id.binary())
            node = None
            if pg is not None and pg.state == "CREATED":
                node = self._node_for_pg_task(spec)
        else:
            node = self._pick_node(spec.resources, spec.scheduling_strategy)
        if node is None or not self._acquire_for(spec, node):
            entry.state = PENDING_CREATION
            entry.node_id = None
            return False
        entry.state = PENDING_CREATION
        entry.node_id = node.node_id
        entry.local_placement = False   # centrally acquired from here on
        node.conn.notify("create_actor", spec)
        return True

    def _h_actor_placed(self, conn: protocol.Conn, p, msg_id):
        """A node manager placed an actor from its OWN ledger
        (decentralized creation). Register the directory entry the NM's
        later lifecycle reports will update — the NM sends this on the
        same conn BEFORE any actor_state for the actor, so the entry
        always exists by the time ALIVE/DEAD arrives. Resources are NOT
        acquired centrally: they ride the node's local_held aggregate."""
        spec = p["spec"]
        aid = spec.actor_id.binary()
        with self._sched_lock, self._actor_lock:
            node = self._nodes.get(p["node_id"])
            if node is not None and "local_held" in p:
                # The report doubles as an eager resource report (same
                # seq-versioned merge rule as heartbeats).
                self._merge_local_held(node, p)
            if aid in self._actors and self._actors[aid].state != DEAD:
                return   # duplicate (driver recovery raced the report)
            entry = ActorEntry(spec=spec, state=PENDING_CREATION,
                               node_id=p["node_id"],
                               restarts_left=spec.max_restarts,
                               local_placement=True)
            self._actors[aid] = entry
            self._pin_actor_args(spec, True)
            if spec.name:
                self._named_actors.setdefault(
                    (spec.namespace, spec.name), aid)
            self._persist_actor(aid)
            if self._killed_before_placed.pop(aid, None) is not None:
                # ray.kill beat the placement report here: finish it.
                self._kill_actor_locked(
                    aid, True, "ray.kill (before placement report)")

    def _h_actor_state(self, conn: protocol.Conn, p, msg_id):
        """Node manager reports actor lifecycle transitions."""
        with self._sched_lock, self._actor_lock:
            aid = p["actor_id"]
            entry = self._actors.get(aid)
            if entry is None:
                return
            state = p["state"]
            if state == ALIVE:
                entry.state = ALIVE
                if entry.restarts_left == 0:
                    # The constructor has run and will not run again.
                    self._pin_actor_args(entry.spec, False)
                self._persist_actor(aid)
                self._reply_actor_waiters(entry)
                self._publish("actor_state", {
                    "actor_id": aid.hex(), "state": ALIVE,
                    "class_name": entry.spec.class_name})
            elif state == DEAD:
                if p.get("creation_failed"):
                    # __init__ raised: actor is permanently dead
                    entry.state = DEAD
                    entry.death_cause = p.get("error", "creation failed")
                    self._pin_actor_args(entry.spec, False)
                    if entry.node_id and not entry.local_placement:
                        # (NM-placed: the node's own ledger releases.)
                        self._release_for(entry.spec, entry.node_id)
                    self._reply_actor_waiters(entry)
                else:
                    self._on_actor_down(aid, p.get("error", "actor exited"),
                                        expected=p.get("expected", False))
            self._try_schedule()

    def _on_actor_down(self, aid: bytes, cause: str, expected: bool = False):
        # Caller holds _sched_lock + _actor_lock.
        entry = self._actors.get(aid)
        if entry is None or entry.state == DEAD:
            return
        if entry.node_id:
            if not entry.local_placement:
                self._release_for(entry.spec, entry.node_id)
            entry.node_id = None
            entry.local_placement = False
        if not expected and entry.restarts_left != 0:
            if entry.restarts_left > 0:
                entry.restarts_left -= 1
            entry.num_restarts += 1
            entry.state = RESTARTING   # (its args are still pinned)
            logger.info("restarting actor %s (%s)", entry.spec.class_name, cause)
            if not self._schedule_actor(entry):
                self._queued_tasks.append(_ActorCreationShim(entry))
        else:
            entry.state = DEAD
            entry.death_cause = cause
            self._pin_actor_args(entry.spec, False)
            self._reply_actor_waiters(entry)
        self._persist_actor(aid)
        self._publish("actor_state", {
            "actor_id": aid.hex(), "state": entry.state,
            "class_name": entry.spec.class_name,
            "death_cause": entry.death_cause})

    def _pin_actor_args(self, spec: ActorCreationSpec, pin: bool):
        """Pin (or release) the objects an actor's constructor takes, its
        top-level args and the refs nested in them, from registration
        until the constructor has run for the last time (ALIVE with no
        restart left) or the actor is dead: an actor that waits for a
        place, or for a place to restart in, past ``free_grace_s`` still
        finds them. Pinning is idempotent per actor. Caller holds
        _sched_lock + _actor_lock (or is the constructor restoring
        tables); obj nests forward."""
        with self._obj_lock:
            (self._pin_task_args if pin else self._unpin_task_args)(spec)

    def _reply_actor_waiters(self, entry: ActorEntry):
        waiters, entry.waiters = entry.waiters, []
        info = self._actor_info(entry)
        for conn, msg_id in waiters:
            try:
                conn.reply(msg_id, info)
            except Exception:
                pass
        # Flush (or fail) actor tasks parked while the actor was transitioning.
        pending, entry.pending_tasks = entry.pending_tasks, []
        if not pending:
            return
        if entry.state == ALIVE and entry.node_id in self._nodes:
            node = self._nodes[entry.node_id]
            for spec in pending:
                try:
                    node.conn.notify("submit_actor_task", spec)
                except Exception:
                    pass
        else:
            for spec in pending:
                self._fail_task_objects(
                    spec, entry.death_cause or "actor died")

    def _h_reroute_actor_task(self, conn: protocol.Conn,
                              spec: ActorTaskSpec, msg_id):
        """An actor task arrived at a node no longer hosting the actor.

        The spec's args are pinned here (the rerouting caller released
        its pin) until the task completes — _h_task_done unpins via
        _actor_task_pins — or fails (_fail_task_objects unpins)."""
        with self._actor_lock, self._obj_lock:
            entry = self._actors.get(spec.actor_id.binary())
            if entry is None or entry.state == DEAD:
                cause = entry.death_cause if entry else "actor not found"
                self._fail_task_objects(spec, cause or "actor died")
            else:
                self._pin_task_args(spec)
                self._actor_task_pins[spec.task_id.binary()] = spec
                if entry.state == ALIVE and entry.node_id in self._nodes:
                    self._nodes[entry.node_id].conn.notify(
                        "submit_actor_task", spec)
                else:
                    entry.pending_tasks.append(spec)

    def _actor_info(self, entry: ActorEntry) -> dict:
        node = self._nodes.get(entry.node_id) if entry.node_id else None
        return {
            "actor_id": entry.spec.actor_id,
            "state": entry.state,
            "node_id": entry.node_id,
            "node_address": node.address if node else None,
            "death_cause": entry.death_cause,
            "num_restarts": entry.num_restarts,
            "class_name": entry.spec.class_name,
            "name": entry.spec.name,
            "namespace": entry.spec.namespace,
            "class_key": entry.spec.class_key,
            "max_task_retries": entry.spec.max_task_retries,
            "is_async": entry.spec.is_async,
            "max_concurrency": entry.spec.max_concurrency,
        }

    def _h_resolve_actor(self, conn: protocol.Conn, p, msg_id):
        """Reply with the actor's location; parks while PENDING/RESTARTING."""
        with self._actor_lock:
            entry = self._actors.get(p["actor_id"])
            if entry is None:
                conn.reply_error(msg_id, "actor not found")
                return
            if entry.state in (ALIVE, DEAD):
                conn.reply(msg_id, self._actor_info(entry))
            else:
                entry.waiters.append((conn, msg_id))

    def _h_get_actor_by_name(self, conn: protocol.Conn, p, msg_id):
        with self._actor_lock:
            aid = self._named_actors.get((p.get("namespace", "default"),
                                          p["name"]))
            entry = self._actors.get(aid) if aid else None
            if entry is None or entry.state == DEAD:
                conn.reply(msg_id, None)
            else:
                conn.reply(msg_id, self._actor_info(entry))

    def _h_list_named_actors(self, conn: protocol.Conn, p, msg_id):
        with self._actor_lock:
            out = []
            for (ns, name), aid in self._named_actors.items():
                e = self._actors.get(aid)
                if e is not None and e.state != DEAD:
                    if p.get("all_namespaces") or ns == p.get("namespace",
                                                             "default"):
                        out.append({"name": name, "namespace": ns})
            conn.reply(msg_id, out)

    def _h_kill_actor(self, conn: protocol.Conn, p, msg_id):
        # Kill may restart-or-bury the actor (_on_actor_down releases
        # node resources / re-places): sched+actor in rank order.
        with self._sched_lock, self._actor_lock:
            aid = p["actor_id"]
            if aid not in self._actors and p.get("no_restart", True):
                # Decentralized-creation race: the kill can overtake the
                # NM's actor_placed report. Tombstone it — actor_placed
                # completes the kill on arrival (bounded FIFO).
                self._killed_before_placed[aid] = time.time()
                while len(self._killed_before_placed) > 1024:
                    self._killed_before_placed.popitem(last=False)
            self._kill_actor_locked(aid, p.get("no_restart", True),
                                    "ray.kill")
        conn.reply(msg_id, True)

    def _kill_actor_locked(self, aid: bytes, no_restart: bool, cause: str):
        # Caller holds _sched_lock + _actor_lock.
        entry = self._actors.get(aid)
        if entry is None or entry.state == DEAD:
            return
        if no_restart:
            entry.restarts_left = 0
        node = self._nodes.get(entry.node_id) if entry.node_id else None
        if node is not None and node.alive:
            node.conn.notify("kill_actor", {"actor_id": aid,
                                            "no_restart": no_restart})
        else:
            self._on_actor_down(aid, cause, expected=no_restart)

    def _h_list_actors(self, conn: protocol.Conn, p, msg_id):
        with self._actor_lock:
            conn.reply(msg_id, [self._actor_info(e)
                                for e in self._actors.values()])

    # ----------------------------------------------------- placement groups

    def _h_create_pg(self, conn: protocol.Conn,
                     spec: PlacementGroupSpec, msg_id):
        # Bundle placement reserves node resources: sched+actor.
        with self._sched_lock, self._actor_lock:
            if spec.name:
                if spec.name in self._named_pgs:
                    conn.reply_error(msg_id,
                                     f"placement group '{spec.name}' exists")
                    return
                self._named_pgs[spec.name] = spec.pg_id.binary()
            entry = PgEntry(spec=spec)
            self._pgs[spec.pg_id.binary()] = entry
            if not self._try_place_pg(entry):
                self._pending_pgs[spec.pg_id.binary()] = entry
            conn.reply(msg_id, {"ok": True})

    def _try_place_pg(self, entry: PgEntry) -> bool:
        """Bundle placement (reference:
        raylet/scheduling/policy/bundle_scheduling_policy.h:31). All-or-
        nothing: trial-reserve, commit on success. Caller holds
        _sched_lock + _actor_lock (node ledger + PG tables)."""
        spec = entry.spec
        alive = [n for n in self._nodes.values() if n.alive]
        if not alive:
            return False
        # GPU topology awareness (a gang's bundles should map onto ONE
        # NVLink domain — cross-slice collectives fall off NVLink onto
        # the network). When every bundle wants GPUs and nodes carry a
        # "slice" label, try slice-local placement first: attempt the
        # whole PG inside each slice (least-loaded slice first) and only
        # then fall back to the topology-blind node set.
        wants_gpu = all(b.resources.get("GPU", 0) > 0 for b in spec.bundles) \
            and bool(spec.bundles)
        slices: Dict[str, list] = {}
        for n in alive:
            sl = n.labels.get("slice")
            if sl:
                slices.setdefault(sl, []).append(n)
        if wants_gpu and slices and len(slices) > 1:
            def slice_load(nodes):
                return sum(n.effective_available().utilization(n.total)
                           for n in nodes) / len(nodes)

            for _, members in sorted(slices.items(),
                                     key=lambda kv: slice_load(kv[1])):
                if self._place_pg_on(entry, members):
                    return True
            # fall through: try all nodes (single-slice PGs that don't fit
            # one slice stay PENDING via the normal path below)
        return self._place_pg_on(entry, alive)

    def _place_pg_on(self, entry: PgEntry, alive: list) -> bool:
        spec = entry.spec
        if not alive:
            return False
        # Work on copies of availability for atomicity (locally-held
        # resources excluded: the NM's grants own that capacity).
        avail = {n.node_id: ResourceSet(n.effective_available().to_dict())
                 for n in alive}
        placement: Dict[int, str] = {}
        strategy = spec.strategy

        def nodes_sorted():
            return sorted(alive, key=lambda n: avail[n.node_id].utilization(
                n.total))

        ok = True
        if strategy in ("PACK", "STRICT_PACK"):
            order = sorted(alive, key=lambda n: avail[n.node_id].utilization(
                n.total))
            if strategy == "STRICT_PACK":
                # all bundles on ONE node
                ok = False
                for n in order:
                    a = ResourceSet(avail[n.node_id].to_dict())
                    if all(a.acquire(b.resources) for b in spec.bundles):
                        for b in spec.bundles:
                            placement[b.index] = n.node_id
                        avail[n.node_id] = a
                        ok = True
                        break
            else:
                for b in spec.bundles:
                    placed = False
                    for n in order:
                        if avail[n.node_id].acquire(b.resources):
                            placement[b.index] = n.node_id
                            placed = True
                            break
                    if not placed:
                        ok = False
                        break
        elif strategy in ("SPREAD", "STRICT_SPREAD"):
            used_nodes: Set[str] = set()
            for b in spec.bundles:
                cands = nodes_sorted()
                placed = False
                for n in cands:
                    if strategy == "STRICT_SPREAD" and n.node_id in used_nodes:
                        continue
                    if avail[n.node_id].acquire(b.resources):
                        placement[b.index] = n.node_id
                        used_nodes.add(n.node_id)
                        placed = True
                        break
                if not placed:
                    ok = False
                    break
        else:
            ok = False
        if not ok:
            return False
        # Commit.
        for b in spec.bundles:
            nid = placement[b.index]
            b.node_id = nid
            self._nodes[nid].available.acquire(b.resources)
            entry.bundle_available[b.index] = ResourceSet(b.resources)
        entry.state = "CREATED"
        self._pending_pgs.pop(spec.pg_id.binary(), None)
        waiters, entry.waiters = entry.waiters, []
        for conn, msg_id in waiters:
            try:
                conn.reply(msg_id, {"state": "CREATED"})
            except Exception:
                pass
        self._try_schedule()
        return True

    def _try_schedule_pgs(self):
        # Caller holds _sched_lock + _actor_lock.
        for entry in list(self._pending_pgs.values()):
            if entry.state == "PENDING":
                self._try_place_pg(entry)

    def _h_wait_pg_ready(self, conn: protocol.Conn, p, msg_id):
        with self._actor_lock:
            entry = self._pgs.get(p["pg_id"])
            if entry is None:
                conn.reply_error(msg_id, "placement group not found")
            elif entry.state == "CREATED":
                conn.reply(msg_id, {"state": "CREATED"})
            else:
                entry.waiters.append((conn, msg_id))

    def _h_remove_pg(self, conn: protocol.Conn, p, msg_id):
        # Returns bundle capacity to the node ledger: sched+actor.
        with self._sched_lock, self._actor_lock:
            entry = self._pgs.get(p["pg_id"])
            if entry is not None and entry.state == "CREATED":
                # return bundle capacity to nodes
                for b in entry.spec.bundles:
                    node = self._nodes.get(b.node_id)
                    if node is not None:
                        # release only the unused part plus used part: the
                        # whole bundle reservation goes back
                        node.available.release(b.resources)
                entry.state = "REMOVED"
                if entry.spec.name:
                    self._named_pgs.pop(entry.spec.name, None)
            elif entry is not None and entry.state == "PENDING":
                # Never placed: it must not place later. Its waiters learn
                # it is gone.
                entry.state = "REMOVED"
                self._pending_pgs.pop(p["pg_id"], None)
                if entry.spec.name:
                    self._named_pgs.pop(entry.spec.name, None)
                waiters, entry.waiters = entry.waiters, []
                for wconn, wid in waiters:
                    try:
                        wconn.reply_error(wid, "placement group removed")
                    except Exception:
                        pass
            self._try_schedule()
        conn.reply(msg_id, True)

    def _h_pg_table(self, conn: protocol.Conn, p, msg_id):
        with self._actor_lock:
            out = {}
            for pid, e in self._pgs.items():
                out[pid] = {
                    "name": e.spec.name,
                    "strategy": e.spec.strategy,
                    "state": e.state,
                    "bundles": [
                        {"index": b.index, "resources": b.resources,
                         "node_id": b.node_id} for b in e.spec.bundles],
                }
            conn.reply(msg_id, out)

    def _h_dump_stacks(self, conn: protocol.Conn, p, msg_id):
        """Fan a stack-dump request out to every node (reference: the
        `ray stack` CLI, scripts.py; dumps surface via the log stream).
        Legacy SIGUSR2 path; the in-band data path is collect_stacks."""
        with self._sched_lock:
            nodes = [n for n in self._nodes.values() if n.alive]
        for n in nodes:
            try:
                n.conn.notify("dump_stacks")
            except Exception:
                pass
        conn.reply(msg_id, len(nodes))

    # ------------------------------------------- per-node agent fan-in
    # (reference: dashboard/state_aggregator fan-out to per-node agents;
    # here the GCS holds the node conns, so it IS the fan-in hop)

    def _agent_nodes(self, node_filter: Optional[str]):
        with self._sched_lock:
            return [(n.node_id, n.conn) for n in self._nodes.values()
                    if n.alive and (not node_filter
                                    or n.node_id.startswith(node_filter))]

    def _agent_fanout(self, conn, msg_id, mtype: str, payload: dict,
                      nodes, timeout_s: float):
        """Fan ``mtype`` out to the node managers and reply with the
        collected per-node results. Runs OFF the caller conn's serve
        thread (node replies take up to ``timeout_s``), with every
        per-node wait bounded."""
        def run():
            out = []
            for nid, ok, reply in protocol.fanout_requests(
                    nodes, mtype, payload, timeout_s + 2.0):
                out.append(reply if ok else
                           {"node_id": nid, "error": reply})
            try:
                conn.reply(msg_id, out)
            except Exception:
                pass

        threading.Thread(target=run, daemon=True,
                         name="rtpu-gcs-agent").start()

    def _h_collect_stacks(self, conn: protocol.Conn, p, msg_id):
        """Cluster-wide in-band stack capture: every node agent snapshots
        ``sys._current_frames()`` across its workers and the results fan
        back in as data (`ray_tpu_torch stack` — no signals, no log scraping)."""
        p = p or {}
        from ray_tpu_torch._private.config import config as _cfg

        timeout_s = float(p.get("timeout_s")
                          or _cfg.agent_stack_timeout_s)
        nodes = self._agent_nodes(p.get("node_id"))
        self._agent_fanout(conn, msg_id, "collect_stacks",
                           {"timeout_s": timeout_s}, nodes, timeout_s)

    def _h_agent_logs(self, conn: protocol.Conn, p, msg_id):
        """Per-worker log tail/listing with head fan-in. An actor_id
        filter routes to the hosting node only; everything else fans to
        all nodes and lets each agent match locally."""
        p = dict(p or {})
        nodes = self._agent_nodes(p.pop("node_id", None))
        aid = p.get("actor_id")
        if aid:
            with self._actor_lock:
                homes = {e.node_id for a, e in self._actors.items()
                         if a.hex().startswith(aid) and e.node_id}
            if homes:
                nodes = [(nid, c) for nid, c in nodes if nid in homes]
        self._agent_fanout(conn, msg_id, "agent_logs", p, nodes,
                           timeout_s=10.0)

    def _h_profile(self, conn: protocol.Conn, p, msg_id):
        """Cluster-wide sampling-profile capture (`ray_tpu_torch profile`):
        fan the ``profile`` verb out to every node agent (each samples
        its node manager + workers) AND every connected driver, while
        the GCS-hosting process samples ITSELF — all windows run
        concurrently, so a whole-cluster capture costs one window of
        wall time. Replies with a FLAT list of per-process profiles the
        CLI/dashboard merge into one speedscope document.

        Filters: ``node_id`` narrows the node fan-out; ``worker_id``/
        ``actor_id`` narrow to matching workers (and skip drivers/GCS);
        ``driver`` limits to driver processes; ``gcs`` to the GCS's own
        process (the latter also serves a bare bootstrap-address conn —
        the GCS-subprocess self-profile path needs no registration)."""
        p = dict(p or {})
        duration_s = min(600.0, max(0.05,
                                    float(p.get("duration_s", 5.0))))
        payload = {"duration_s": duration_s, "hz": p.get("hz"),
                   "mode": p.get("mode", "wall")}
        worker_scoped = bool(p.get("worker_id") or p.get("actor_id"))
        only_driver = bool(p.get("driver"))
        only_gcs = bool(p.get("gcs"))
        targets = []
        if not only_driver and not only_gcs:
            # Same payload OBJECT as the driver fan-out when no worker
            # filter applies: payloads group by identity below, and two
            # groups would fan out sequentially — two windows of wall
            # time instead of one. (With a worker filter, drivers are
            # excluded entirely, so there is only ever one group.)
            node_payload = payload
            if worker_scoped:
                node_payload = dict(payload)
                for k in ("worker_id", "actor_id"):
                    if p.get(k):
                        node_payload[k] = p[k]
            for nid, nconn in self._agent_nodes(p.get("node_id")):
                targets.append((("node", nid, node_payload), nconn))
        if not worker_scoped and not only_gcs \
                and not p.get("node_id"):
            with self._sched_lock:
                drivers = [(c.meta.get("client_id"), c)
                           for c in self._clients.values()
                           if c.meta.get("role") == "driver"
                           and not c.closed]
            for cid, dconn in drivers:
                targets.append((("driver", cid, payload), dconn))
        include_self = only_gcs or (not worker_scoped and not only_driver
                                    and not p.get("node_id"))

        def run():
            self_box: Dict[str, Any] = {}
            self_thread = None
            if include_self:
                def self_profile():
                    self_box["out"] = profiler.profile_self(
                        duration_s=duration_s, hz=payload["hz"],
                        mode=payload["mode"], kind="gcs")

                self_thread = threading.Thread(
                    target=self_profile, daemon=True,
                    name="rtpu-gcs-selfprof")
                self_thread.start()
            out: List[Dict[str, Any]] = []
            # Per-target payloads differ (worker filters ride the node
            # fan-out only), so group by payload identity; in practice
            # that is at most two groups, fanned out back to back under
            # one shared deadline budget. 3x duration: the in-process
            # topology shares ONE profiler between GCS, NM, and driver,
            # and their self-windows serialize.
            grouped: Dict[int, list] = {}
            for (kind, key, pl), c in targets:
                grouped.setdefault(id(pl), (pl, []))[1].append(
                    ((kind, key), c))
            for pl, group in grouped.values():
                for (kind, key), ok, reply in protocol.fanout_requests(
                        group, "profile", pl,
                        3.0 * duration_s + 20.0):
                    if not ok:
                        out.append({"kind": kind,
                                    "node_id" if kind == "node"
                                    else "client_id": key,
                                    "error": reply})
                    elif kind == "node":
                        out.extend((reply or {}).get("processes") or [])
                    else:
                        out.append(reply or {})
            if self_thread is not None:
                self_thread.join(timeout=3.0 * duration_s + 15.0)
                if self_box.get("out"):
                    out.insert(0, self_box["out"])
            try:
                conn.reply(msg_id, out)
            except Exception:
                pass

        # Off this conn's serve thread: the fan-out blocks for the whole
        # profile window.
        threading.Thread(target=run, daemon=True,
                         name="rtpu-gcs-profile").start()

    def _h_flight_dump(self, conn: protocol.Conn, p, msg_id):
        """Trigger a flight-recorder dump on every node (the gang
        supervisor calls this when it declares slice death, so each
        restart leaves per-node postmortem artifacts)."""
        nodes = self._agent_nodes((p or {}).get("node_id"))
        for _nid, nconn in nodes:
            try:
                nconn.notify("flight_dump",
                             {"reason": (p or {}).get("reason")})
            except Exception:
                pass
        conn.reply(msg_id, len(nodes))

    # --------------------------------------------------------------- pubsub

    def _h_subscribe(self, conn: protocol.Conn, p, msg_id):
        """Subscribe this connection to a channel (reference:
        src/ray/pubsub/publisher.h GcsPublisher channels — actor state,
        logs, errors; here one generic channel table)."""
        with self._kv_lock:
            conn.meta.setdefault("subscriptions", set()).add(p["channel"])
        conn.reply(msg_id, True)

    def _h_unsubscribe(self, conn: protocol.Conn, p, msg_id):
        with self._kv_lock:
            conn.meta.setdefault("subscriptions", set()).discard(
                p["channel"])
        conn.reply(msg_id, True)

    def _h_publish(self, conn: protocol.Conn, p, msg_id):
        self._publish(p["channel"], p["message"])

    def _publish(self, channel: str, message):
        """Record-then-publish: enqueue on the outbox and wake the
        publisher thread, which snapshots the subscriber set and sends
        OUTSIDE every shard lock — lifecycle paths (actor death, node
        death) can publish from under their locks without a slow
        subscriber socket stalling the control plane. Dead conns are
        skipped at send time (their subscriptions die with the
        connection)."""
        self._pub_q.append((channel, message))
        self._pub_ev.set()

    # ----------------------------------------------------------- worker logs

    def _h_worker_logs(self, conn: protocol.Conn, p, msg_id):
        """Fan worker log lines out to drivers that registered with
        log_to_driver (reference: log_monitor publishing via GCS pubsub,
        _private/log_monitor.py:104)."""
        with self._sched_lock:
            targets = [c for c in self._clients.values()
                       if c.meta.get("log_to_driver")]
        for c in targets:
            try:
                c.notify("driver_logs", p)
            except Exception:
                pass

    # ------------------------------------------------------- task events

    def _h_task_events(self, conn: protocol.Conn, p, msg_id):
        with self._kv_lock:
            self._task_events.extend(p)

    def _h_task_events_b(self, conn: protocol.Conn, p, msg_id):
        """Blob-framed variant: the NM relays each worker's event batch
        as the single pre-pickled frame the worker shipped (one worker
        send feeds both the flight recorder and this timeline)."""
        try:
            events = pickle.loads(p)
        except Exception:
            return
        with self._kv_lock:
            self._task_events.extend(events)

    # ------------------------------------------------- state API (reference:
    # dashboard/state_aggregator.py:134 StateAPIManager fan-out; here the
    # GCS holds all tables, so listing is a straight read)

    def _h_list_tasks(self, conn: protocol.Conn, p, msg_id):
        limit = (p or {}).get("limit", 1000)
        # State-API read spanning three shards: canonical rank order.
        with self._sched_lock, self._obj_lock, self._kv_lock:
            out = []
            for tid, (spec, node_id) in self._running_tasks.items():
                out.append({"task_id": tid.hex(),
                            "name": getattr(spec, "name", ""),
                            "state": "RUNNING", "node_id": node_id})
            for spec in self._queued_tasks:
                out.append({"task_id": spec.task_id.hex(),
                            "name": getattr(spec, "name", ""),
                            "state": "PENDING_NODE_ASSIGNMENT",
                            "node_id": None})
            for lst in self._waiting_tasks.values():
                for spec in lst:
                    out.append({"task_id": spec.task_id.hex(),
                                "name": getattr(spec, "name", ""),
                                "state": "PENDING_ARGS_AVAIL",
                                "node_id": None})
            listed = {t["task_id"] for t in out}
            for ev in reversed(self._task_events):
                if len(out) >= limit:
                    break
                # Intra-task spans (serve hops, collectives, device
                # transfers) share the event stream but are not tasks.
                if ev.get("kind") not in ("task", "actor_task"):
                    continue
                if ev["task_id"] in listed:
                    continue
                listed.add(ev["task_id"])
                out.append({"task_id": ev["task_id"], "name": ev["name"],
                            "state": "FINISHED" if ev["status"] == "ok"
                            else "FAILED",
                            "node_id": ev.get("node_id"),
                            "start": ev.get("start"), "end": ev.get("end")})
            conn.reply(msg_id, out[:limit])

    def _h_list_objects(self, conn: protocol.Conn, p, msg_id):
        limit = (p or {}).get("limit", 1000)
        with self._obj_lock:
            out = []
            for oid, nodes in itertools.islice(
                    self._obj_locations.items(), limit):
                spill = self._spilled_objects.get(oid)
                out.append({"object_id": oid.hex(),
                            "locations": sorted(nodes),
                            "size": self._obj_sizes.get(oid, 0),
                            "failed": oid in self._failed_objects,
                            "spilled_url": spill["url"] if spill else None,
                            "refcount": self._refcount_total(oid),
                            "pinned_by_tasks":
                                self._task_arg_pins.get(oid, 0)})
            conn.reply(msg_id, out)

    def _h_list_jobs(self, conn: protocol.Conn, p, msg_id):
        with self._sched_lock:
            conn.reply(msg_id, list(self._jobs.values()))

    def _h_object_spilled(self, conn: protocol.Conn, p, msg_id):
        """A node spilled an object to its disk; the node keeps serving it
        (restore-on-fetch), so its location entry stays (reference:
        spilled-URL tracking in the ownership directory)."""
        with self._obj_lock:
            self._spilled_objects[p["object_id"]] = {
                "node_id": p["node_id"], "url": p["url"]}
            self._obj_locations[p["object_id"]].add(p["node_id"])

    def _h_report_metrics(self, conn: protocol.Conn, p, msg_id):
        """Store a process's latest metric samples (reference: per-node
        MetricsAgent aggregation, _private/metrics_agent.py:375)."""
        stale_cutoff = time.time() - 300
        with self._kv_lock:
            self._metrics[p["client_id"]] = {
                "samples": p["samples"], "ts": p["ts"],
                "period_s": p.get("period_s")}
            # Prune long-dead reporters so the table stays bounded.
            for cid in [c for c, m in self._metrics.items()
                        if m["ts"] < stale_cutoff]:
                del self._metrics[cid]

    def _h_get_metrics(self, conn: protocol.Conn, p, msg_id):
        """Live sample groups only. A client's series expire once it
        missed ≥3 of its own reporting periods OR its connection is gone
        (worker death / replica downscale) — a killed LLM replica's
        gauges must not report stale queue depths forever."""
        now = time.time()
        # _clients membership is a routing read; the table is kv-shard.
        with self._kv_lock:
            groups = []
            for cid, m in list(self._metrics.items()):
                period = float(m.get("period_s") or 5.0)
                if (cid != _GCS_SELF_CLIENT
                        and cid not in self._clients) or \
                        now - m["ts"] > 3.0 * period:
                    del self._metrics[cid]
                    continue
                groups.append(m["samples"])
            conn.reply(msg_id, groups)

    def _h_control_plane_stats(self, conn: protocol.Conn, p, msg_id):
        """O(1) per-shard backlog gauges (bench drain barriers, CLI
        debugging) — the cheap counterpart of the O(queue)
        pending_demand payload. Shards are read sequentially, never
        nested."""
        out = {}
        with self._sched_lock:
            out["queued_tasks"] = len(self._queued_tasks)
            out["running_tasks"] = len(self._running_tasks)
            out["leases"] = len(self._leases)
            out["nodes_alive"] = sum(1 for n in self._nodes.values()
                                     if n.alive)
        with self._actor_lock:
            out["actors"] = len(self._actors)
            out["actors_pending"] = sum(
                1 for e in self._actors.values()
                if e.state in (PENDING_CREATION, RESTARTING))
        with self._obj_lock:
            out["obj_waiters"] = len(self._obj_waiters)
            out["pending_free"] = len(self._pending_free)
            out["tracked_objects"] = len(self._obj_locations)
            n_inline, b_inline = self._inline_tbl.stats()
            out["inline_objects"] = n_inline
            out["inline_bytes"] = b_inline
        with self._kv_lock:
            out["publish_outbox"] = len(self._pub_q)
        # GCS-process self stats (pid/rss/cpu/listener threads): sampled
        # by the timer thread, replaced wholesale — lock-free read.
        out["gcs_process"] = dict(self._self_stats)
        conn.reply(msg_id, out)

    def _h_pending_demand(self, conn: protocol.Conn, p, msg_id):
        """Unplaceable resource demand, for the autoscaler (reference:
        LoadMetrics fed from GCS resource reports —
        autoscaler/_private/load_metrics.py; demand =
        resource_demand_scheduler.py:171 input)."""
        with self._sched_lock, self._actor_lock:
            demand: List[Dict[str, float]] = []
            for spec in self._queued_tasks:
                r = getattr(spec, "resources", None)
                if r:
                    demand.append(dict(r))
            for entry in self._actors.values():
                if entry.state == PENDING_CREATION and entry.node_id is None:
                    r = getattr(entry.spec, "resources", None)
                    if r:
                        demand.append(dict(r))
            now = time.time()
            for shape, (res, ts, count) in list(
                    self._lease_demand.items()):
                if now - ts > 5.0:
                    del self._lease_demand[shape]
                else:
                    demand.extend(dict(res) for _ in range(count))
            pg_demand: List[List[Dict[str, float]]] = []
            for e in self._pgs.values():
                if e.state == "PENDING":
                    pg_demand.append([dict(b.resources)
                                      for b in e.spec.bundles])
            conn.reply(msg_id, {"tasks": demand, "pg_bundles": pg_demand})

    def _h_summarize_tasks(self, conn: protocol.Conn, p, msg_id):
        with self._sched_lock, self._kv_lock:
            by_name: Dict[str, Dict[str, int]] = {}
            for ev in self._task_events:
                if ev.get("kind") not in ("task", "actor_task"):
                    continue   # span events are not tasks
                d = by_name.setdefault(ev["name"], {})
                k = "FINISHED" if ev["status"] == "ok" else "FAILED"
                d[k] = d.get(k, 0) + 1
            for _, (spec, _n) in self._running_tasks.items():
                d = by_name.setdefault(getattr(spec, "name", ""), {})
                d["RUNNING"] = d.get("RUNNING", 0) + 1
            for spec in self._queued_tasks:
                d = by_name.setdefault(getattr(spec, "name", ""), {})
                d["PENDING"] = d.get("PENDING", 0) + 1
            conn.reply(msg_id, by_name)

    def _h_get_timeline(self, conn: protocol.Conn, p, msg_id):
        with self._kv_lock:
            conn.reply(msg_id, list(self._task_events))

    # ------------------------------------------------------------ shutdown

    def _h_shutdown_cluster(self, conn: protocol.Conn, p, msg_id):
        conn.reply(msg_id, True)
        threading.Thread(target=self.close, daemon=True).start()


class _SpreadShim:
    kind = "spread"


class _ActorCreationShim:
    """Lets pending actor creations ride the task queue/dep machinery."""

    __slots__ = ("actor_id", "task_id", "arg_deps", "placement_group_id")

    def __init__(self, entry: ActorEntry):
        self.actor_id = entry.spec.actor_id
        self.task_id = TaskID.for_actor_creation(entry.spec.actor_id)
        self.arg_deps = entry.spec.arg_deps
        self.placement_group_id = None


# Shard observability metrics (lazy_metrics: building them starts the
# reporter thread; deferred to the GCS timer's first sample).


def _build_inline_metrics():
    """(spills counter, table-occupancy gauge, completion-batch-size
    histogram)."""
    from ray_tpu_torch.util import metrics

    spills = metrics.Counter(
        "worker_inline_spills_total",
        "Inline returns materialized into a node's object "
        "store under GCS inline-table pressure")
    occupancy = metrics.Gauge(
        "gcs_inline_table_bytes",
        "Bytes held by the GCS inline-object table across "
        "all jobs (per-job bound: gcs_inline_table_bytes "
        "config knob)")
    batch_h = metrics.Histogram(
        "task_done_batch_size",
        "Completion records per task_done_batch frame "
        "(worker -> NM -> GCS)",
        boundaries=[1, 2, 4, 8, 16, 32, 64, 128])
    return (spills, occupancy, batch_h)


def _build_shard_metrics():
    from ray_tpu_torch.util import metrics

    wait_h = metrics.Histogram(
        "gcs_shard_lock_wait_seconds",
        "Sampled GCS shard-lock acquire wait (timer probe)",
        boundaries=[0.0001, 0.00025, 0.0005, 0.001, 0.0025,
                    0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0],
        tag_keys=("shard",))
    depth_g = metrics.Gauge(
        "gcs_shard_queue_depth",
        "Per-domain GCS backlog (queued tasks / pending "
        "actors / parked waiters+frees / publish outbox)",
        tag_keys=("shard",))
    rss_g = metrics.Gauge(
        "gcs_process_rss_bytes",
        "Resident memory of the process hosting the GCS")
    cpu_g = metrics.Gauge(
        "gcs_process_cpu_percent",
        "CPU utilization of the process hosting the GCS "
        "(sampled over the shard-metrics period)")
    thr_g = metrics.Gauge(
        "gcs_listener_threads",
        "Per-connection GCS listener threads currently alive")
    return (wait_h, depth_g, rss_g, cpu_g, thr_g)


_inline_metrics_lazy = metrics_util.lazy_metrics(_build_inline_metrics)
_shard_metrics_lazy = metrics_util.lazy_metrics(_build_shard_metrics)


# Typed accessors over the lazy families: the return annotations are
# what lets the static lock-order pass see the metric objects behind the
# closure (``lazy_metrics`` returns an untypeable nested function).

def _inline_metrics() -> "Tuple[metrics_util.Counter, metrics_util.Gauge, metrics_util.Histogram]":  # noqa: E501
    return _inline_metrics_lazy()


def _shard_metrics() -> "Tuple[metrics_util.Histogram, metrics_util.Gauge, metrics_util.Gauge, metrics_util.Gauge, metrics_util.Gauge]":  # noqa: E501
    return _shard_metrics_lazy()


def p_kind(spec) -> str:
    return "actor" if isinstance(spec, (ActorCreationSpec, ActorTaskSpec)) \
        else "task"


# ------------------------------------------------- standalone entrypoint
# ``python -m ray_tpu_torch._private.gcs``: the GCS as its own process with its
# own interpreter/GIL (reference: the gcs_server binary started beside
# the raylet by _private/node.py / services.py). The spawner
# (gcs_launcher.GcsProcess) waits on the bootstrap file handshake; the
# process serves until SIGTERM (graceful drain via GcsServer.close) or
# until its spawning parent disappears.


def _write_bootstrap(path: str, address: str) -> None:
    """Atomic write (tmp + rename): the spawner polls for this file and
    must never observe a torn read."""
    import json as _json

    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        _json.dump({"address": address, "pid": os.getpid()}, f)
    os.replace(tmp, path)


def main(argv=None) -> int:
    import argparse
    import signal

    ap = argparse.ArgumentParser(prog="python -m ray_tpu_torch._private.gcs")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--storage-path", default="")
    ap.add_argument("--bootstrap-file", required=True)
    ap.add_argument("--system-config", default="",
                    help="JSON config blob shipped by the spawner "
                         "(its non-default knobs)")
    ap.add_argument("--check-parent-pid", type=int, default=0,
                    help="exit when this process is no longer our "
                         "parent (spawner died without cleanup)")
    args = ap.parse_args(argv)

    from ray_tpu_torch._private.config import config as _cfg

    if args.system_config:
        _cfg.apply_system_config(args.system_config)
    # Lockdep must wrap the shard locks at creation: install (knob- or
    # env-driven) BEFORE the server is constructed.
    from ray_tpu_torch._private import lockdep

    lockdep.maybe_install()
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    server = GcsServer(host=args.host, port=args.port,
                       storage_path=args.storage_path or None)
    server._standalone = True
    server._self_stats["out_of_process"] = True
    _write_bootstrap(args.bootstrap_file, server.address)
    logger.info("gcs serving at %s (pid %d)", server.address, os.getpid())

    stop = threading.Event()

    def _on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    while not stop.wait(0.5):
        if args.check_parent_pid and os.getppid() != args.check_parent_pid:
            logger.warning("gcs parent process %d disappeared; draining",
                           args.check_parent_pid)
            break
    # Graceful drain: notify node managers, close the listener, flush
    # durable storage. The bootstrap file is removed so a later spawn in
    # the same session dir can't read a stale handshake.
    server.close()
    try:
        os.unlink(args.bootstrap_file)
    except OSError:
        pass
    if lockdep.installed():
        found = lockdep.take_violations()
        if found:
            for v in found:
                print(f"gcs lockdep: {v}", file=sys.stderr)
            return 3
    return 0


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(main())
