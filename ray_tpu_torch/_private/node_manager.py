"""Node manager: the per-node daemon.

Role-equivalent to the reference's raylet
(reference: src/ray/raylet/node_manager.h:115): owns the node's shared-memory
object store, manages the worker pool (reference: raylet/worker_pool.h:156),
executes task leases granted by the GCS scheduler, serves cross-node object
pulls (reference: src/ray/object_manager/object_manager.h:117), and
supervises actor workers.

GPU deltas vs the reference raylet (where the JAX package has TPU chips):
- GPUs are whole schedulable devices; the node manager owns the GPU-id free
  list and exports ``CUDA_VISIBLE_DEVICES`` to workers it spawns for GPU
  tasks (reference: python/ray/_private/worker.py:855-878), assigned at
  spawn time because a CUDA context binds its devices at init.
- GPU tasks and actors always get freshly spawned workers, never a fork of
  the zygote, so each worker's CUDA context sees exactly its assigned GPUs.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import profiler, protocol, serialization
from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.ids import NodeID, WorkerID
from ray_tpu_torch._private.task_spec import (
    GPU,
    ActorCreationSpec,
    ActorTaskSpec,
    ResourceSet,
    TaskSpec,
    demand_overlaps,
    pinned_deps,
)
from ray_tpu_torch.object_store import plasma

logger = logging.getLogger("ray_tpu_torch.node")



def _drop_tpu_env(env: Dict[str, str]) -> None:
    """Remove the JAX/TPU stack's variables (``TPU_*``, ``JAX_*``,
    ``PALLAS_*``, ``XLA_FLAGS``, ``ALLOW_MULTIPLE_LIBTPU_LOAD``) from a
    worker's environment: a worker of the port never inherits them."""
    for k in [k for k in env if k.startswith(("TPU_", "JAX_", "PALLAS_"))
              or k in ("XLA_FLAGS", "ALLOW_MULTIPLE_LIBTPU_LOAD")]:
        del env[k]


def visible_gpu_tokens() -> Optional[List[str]]:
    """The entries of ``CUDA_VISIBLE_DEVICES`` in this process, or None
    when it is unset. An empty value, or one starting at ``-1``, hides
    every GPU."""
    raw = os.environ.get("CUDA_VISIBLE_DEVICES")
    if raw is None:
        return None
    tokens = []
    for tok in raw.split(","):
        tok = tok.strip()
        if not tok or tok == "-1":
            break
        tokens.append(tok)
    return tokens


# Lazy: register the ring-full counter (and spin the metrics reporter)
# only once a completion ring actually declines an append.
_comp_ring_metrics = None
_comp_ring_metrics_lock = threading.Lock()


def _comp_ring_full_counter():
    global _comp_ring_metrics
    if _comp_ring_metrics is None:
        with _comp_ring_metrics_lock:
            if _comp_ring_metrics is None:
                from ray_tpu_torch.util import metrics

                _comp_ring_metrics = metrics.Counter(
                    "driver_completion_ring_full_total",
                    "Completion records the NM could not append to a "
                    "same-node driver's shm completion ring (ring "
                    "full); the unconditional GCS relay still delivers "
                    "them")
                metrics.start_reporter()
    return _comp_ring_metrics


IDLE = "idle"
BUSY = "busy"
STARTING = "starting"
ACTOR = "actor"
LEASED = "leased"   # checked out to a caller's direct task transport


def _file_size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


class _SpawningProc:
    """Placeholder proc for a WorkerHandle recorded before its process
    exists (pre-fork registration): alive-but-starting to every
    liveness check; kill/wait are no-ops (the real proc replaces this
    within one spawn call)."""

    pid = -1

    def poll(self):
        return None

    def kill(self):
        pass

    terminate = kill

    def wait(self, timeout=None):
        return 0


_SPAWNING = _SpawningProc()


class _ForkedProc:
    """``subprocess.Popen``-compatible shim for zygote-forked workers.
    The zygote is the parent: its SIGCHLD reaper writes an exit-marker
    file per dead child, which makes poll() authoritative (a bare
    kill(pid, 0) is fooled by PID reuse / other-user PIDs)."""

    def __init__(self, pid: int, exit_dir: str):
        self.pid = pid
        self._exit_marker = os.path.join(exit_dir, str(pid))
        self._rc: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self._rc is None:
            if os.path.exists(self._exit_marker):
                self._rc = -1
            else:
                try:
                    os.kill(self.pid, 0)
                except ProcessLookupError:
                    self._rc = -1
                except PermissionError:
                    # PID recycled to another user's process: ours is
                    # gone (the marker race window is one reaper tick).
                    self._rc = -1
        return self._rc

    def kill(self) -> None:
        try:
            os.kill(self.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    terminate = kill

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.time() + timeout
        while self.poll() is None:
            if deadline is not None and time.time() > deadline:
                raise subprocess.TimeoutExpired("forked-worker",
                                                timeout or 0)
            time.sleep(0.02)
        return self._rc  # type: ignore[return-value]


@dataclass
class WorkerHandle:
    worker_id: bytes
    proc: subprocess.Popen
    state: str = STARTING
    conn: Optional[protocol.Conn] = None
    current_tasks: Dict[bytes, Any] = field(default_factory=dict)
    actor_id: Optional[bytes] = None
    actor_spec: Optional[ActorCreationSpec] = None
    gpu_ids: List[int] = field(default_factory=list)
    dedicated: bool = False        # not returned to the pool
    env_key: Optional[tuple] = None  # spawn-time env_extra fingerprint
    gpu_idle_since: float = 0.0    # parked in the GPU-bound idle pool
    idle_since: float = 0.0        # parked in the CPU idle pool
    isolated: bool = False         # runtime-env cwd/sys.path: never pooled
    pending_pushes: List[tuple] = field(default_factory=list)
    killed_by_us: bool = False
    no_restart_kill: bool = False
    log_paths: Dict[str, str] = field(default_factory=dict)   # stream -> path
    log_offsets: Dict[str, int] = field(default_factory=dict)
    logs_done: bool = False        # dead + fully drained
    busy_since: float = 0.0        # when the current task started
    death_reason: str = ""         # e.g. set by the memory monitor
    direct_address: Optional[str] = None  # worker's own task server
    direct_address_ux: Optional[str] = None  # same, AF_UNIX (same-node)
    lease_reply: Optional[tuple] = None   # (conn, msg_id) awaiting register
    leased_conn: Optional[protocol.Conn] = None  # caller conn holding lease
    lease_tag: Optional[bytes] = None     # lease_id of the checkout
    # GCS-brokered checkout: the shape held on the local ledger until return
    lease_resources: Optional[Dict[str, float]] = None
    # Local grant: extra fields merged into the deferred register reply
    lease_grant: Optional[dict] = None


class NodeManager:
    """One per node; embeddable in the head process or standalone."""

    def __init__(
        self,
        gcs_address: str,
        session_dir: str,
        num_cpus: float,
        num_gpus: float = 0,
        resources: Optional[Dict[str, float]] = None,
        object_store_memory: int = 1 << 30,
        is_head: bool = False,
        node_name: str = "node",
        labels: Optional[Dict[str, str]] = None,
    ):
        self.node_id = NodeID.from_random().hex()
        self.gcs_address = gcs_address
        self.session_dir = session_dir
        os.makedirs(session_dir, exist_ok=True)
        self.store_path = os.path.join(
            session_dir, f"store_{self.node_id[:12]}")
        self._log_dir = os.path.join(session_dir, "logs")
        os.makedirs(self._log_dir, exist_ok=True)
        plasma.create_store(self.store_path, object_store_memory)
        self.store = plasma.PlasmaClient(self.store_path)

        self._lock = threading.RLock()
        self._workers: Dict[bytes, WorkerHandle] = {}
        self._actors: Dict[bytes, WorkerHandle] = {}      # actor_id -> worker
        self._idle: List[WorkerHandle] = []
        self._task_queue: List[TaskSpec] = []
        self._num_cpus = num_cpus
        self._max_pool = max(1, int(num_cpus))
        # Elastic pool ceiling: queue-depth pressure may grow the shared
        # CPU pool to this many workers (num_workers_soft_limit; -1 =
        # base pool + small headroom); idle workers above the base pool
        # retire after worker_idle_timeout_s, so a burst's extra workers
        # don't linger as resident interpreters.
        soft = int(config.num_workers_soft_limit)
        self._pool_cap = soft if soft > 0 else self._max_pool + 2
        # A ceiling below the base pool bounds the base pool too:
        # prestart/refill/shrink all track _max_pool, and a stated
        # limit of 2 on an 8-CPU node must not keep 8 interpreters
        # resident.
        self._max_pool = min(self._max_pool, self._pool_cap)
        if num_gpus != int(num_gpus) or num_gpus < 0:
            raise ValueError(f"num_gpus must be whole, got {num_gpus!r}")
        self._free_gpus: Set[int] = set(range(int(num_gpus)))
        # GPU id i is the i-th device this process sees: a worker's
        # CUDA_VISIBLE_DEVICES names the parent's token for it.
        tokens = visible_gpu_tokens() or []
        self._gpu_tokens = [tokens[i] if i < len(tokens) else str(i)
                            for i in range(int(num_gpus))]
        # GPU-bound workers parked between GPU tasks, keyed by
        # (gpu_count, env_key): a second same-shape GPU task reuses the
        # worker and skips a torch import and CUDA init
        # (reference: worker_pool.h:156 pools workers by runtime-env
        # hash; here the "hash" is the GPU shape + spawn env).
        self._gpu_idle: Dict[tuple, List[WorkerHandle]] = {}
        self._shutdown = False

        total = dict(resources or {})
        total.setdefault("CPU", float(num_cpus))
        if num_gpus:
            total.setdefault("GPU", float(num_gpus))
        total.setdefault("node:" + self.node_id[:12], 1.0)
        self._total_resources = total

        # ---- local-first scheduler state (reference:
        # raylet/scheduling/policy/hybrid_scheduling_policy.h:50 — the
        # raylet grants leases from its own resource view; the GCS is the
        # spillback path). ``_local_avail`` mirrors this node's free
        # resources: local grants acquire from it directly; GCS-driven
        # consumption (classic task dispatches, actor creations, brokered
        # lease checkouts) is force-subtracted as it arrives so the two
        # schedulers can never jointly oversubscribe the node by more
        # than one report interval.
        self._local_avail = ResourceSet(total)
        # lease_id -> {"resources", "conn", "client_id"}; the aggregate
        # rides heartbeats to the GCS as ``local_held``.
        self._local_held = ResourceSet()
        # Monotonic version of _local_held: reports are sent outside the
        # lock, so without it a release's (emptier) snapshot racing past
        # an earlier grant's would leave stale phantom holds at the GCS
        # until the next heartbeat.
        self._local_held_seq = 0
        self._local_grants: Dict[bytes, Dict[str, Any]] = {}
        self._res_held_tasks: Dict[bytes, Dict[str, float]] = {}
        self._res_held_actors: Dict[bytes, Dict[str, float]] = {}
        # Classic-queue fairness: after a GCS revoke_local_lease signal,
        # overlapping local grants are declined until this deadline.
        self._local_backoff_until = 0.0
        self._local_backoff_demands: List[Dict[str, float]] = []
        self.local_grants_total = 0
        self.local_spillbacks_total = 0
        # Actors this NM placed from its OWN ledger (decentralized actor
        # creation): their resources ride the local_held aggregate — the
        # GCS never acquired them centrally — so the death/failure paths
        # must subtract them from local_held too.
        self._local_actor_ids: Set[bytes] = set()
        self.local_actor_grants_total = 0
        self.local_actor_spillbacks_total = 0

        # Per-node observability agent (reference: dashboard/agent.py —
        # the per-node DashboardAgent beside every raylet). Served over
        # THIS server + the GCS conn; no separate process or port.
        from ray_tpu_torch.dashboard.agent import NodeAgent

        self.agent = NodeAgent(
            self, ring_size=int(config.flight_recorder_events))

        # Decentralized actor creations run here, off conn serve threads
        # (each one may fork a worker; bursts overlap instead of
        # serializing behind the conn).
        import concurrent.futures as _cf

        self._actor_exec = _cf.ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="rtpu-nm-actor")

        # Shared-memory submit rings (SCALE_r08 stage 3): per-client SPSC
        # rings of pre-pickled task-spec blobs this NM drains and relays
        # to the GCS in submit_task_batch frames — the same-node driver
        # submits with a memcpy + doorbell instead of a socket frame.
        # conn -> [{reader, thread, stop}]; cleaned up on disconnect.
        self._submit_rings: Dict[Any, List[dict]] = {}

        # Shared-memory completion rings (SCALE_r10 stage 2, the submit
        # ring's return-path twin): per-driver SPSC rings this NM
        # APPENDS worker task_done_batch record blobs into (never
        # unpickling them) so the same-node driver learns completions
        # with a memcpy + doorbell; the GCS relay stays unconditional
        # and authoritative. conn -> [{producer, client_id}]; cleaned
        # up on disconnect or consumer-heartbeat staleness.
        self._completion_rings: Dict[Any, List[dict]] = {}

        # Worker->driver completion segments: workers report
        # each segment file they create so this NM can unlink leftovers
        # if the worker dies without its own close running (SIGKILL
        # between create and the driver mapping it — the driver's
        # force-unlink only covers segments it mapped). conn -> {path}.
        self._worker_segments: Dict[Any, set] = {}

        # The zygote pool's table exists before the node can be asked for
        # a worker: the GCS may push a task as soon as the node registers
        # below, before _start_zygotes runs (a spawn then takes the
        # classic path).
        self._zygotes: List[dict] = []   # {proc, sock_path, io, lock}
        self._zygote_rr = itertools.count()

        # Server for workers, remote pullers, and actor-task callers.
        self.server = protocol.Server(self._handle_server, name=f"nm-{node_name}")
        self.server.on_disconnect = self._on_server_disconnect
        self.address = self.server.address

        # Client connection to the GCS.
        self._labels = labels or {}
        # Label the node with its GPU slice (gpu_topology) so the PG
        # scheduler can keep all-GPU gangs slice-local.
        if "slice" not in self._labels:
            slice_id = config.gpu_topology or None
            if slice_id and num_gpus:
                self._labels["slice"] = str(slice_id)
        self._is_head = is_head
        self._node_name = node_name
        self.gcs = protocol.connect(gcs_address, handler=self._handle_gcs,
                                    name=f"nm-gcs-{node_name}")
        self.gcs.request("register_node", {
            "node_id": self.node_id,
            "address": self.address,
            "store_path": self.store_path,
            "resources": total,
            "labels": self._labels,
            "is_head": is_head,
            "local_held": self._local_held.to_dict(),
            "local_held_seq": self._local_held_seq,
        }, timeout=float(config.gcs_rpc_timeout_s))
        # Rejoin a restarted GCS (reference: raylet re-registration after
        # GCS failover): on conn drop, redial the same address and
        # re-register with a re-report of live actors + store contents.
        self.gcs.on_close = self._on_gcs_disconnect
        # Object spilling (reference: LocalObjectManager spill/restore,
        # raylet/local_object_manager.h:41 + _private/external_storage.py).
        from ray_tpu_torch._private.external_storage import create_storage

        self.external_storage = create_storage(
            None, os.path.join(session_dir,
                               f"spill_{self.node_id[:12]}"))
        self._spilled: Dict[bytes, str] = {}   # object_id -> url
        self._spill_lock = threading.Lock()
        # Spill-before-evict: with spilling on, the store refuses
        # pressure evictions (data loss) and creators call spill_now
        # instead (reference: CreateRequestQueue + LocalObjectManager).
        if float(config.object_spilling_threshold) > 0:
            self.store.set_allow_evict(False)
            # The NM's own creates (restores, error objects) spill inline.
            self.store.on_full = lambda needed: bool(
                self._spill_bytes(int(needed) * 2))

        # Worker fork-server: CPU workers fork from a pre-imported
        # zygote instead of paying interpreter start per spawn (see
        # worker_zygote.py; reference analog: prestart amortization,
        # worker_pool.h:344 — this removes the cost rather than hiding
        # it).
        # Zygote POOL: K independent fork-servers, each with its own
        # socket conversation lock — worker spawns under an actor-churn
        # or scale-out burst parallelize across them instead of
        # convoying behind ONE ~10-30ms fork conversation (fork of a
        # torch-preloaded image is page-table-bound; K forks on K cores
        # multiply spawn throughput by K).
        self._start_zygotes()
        # Always-on sampling profiler (profiler_always_on): one
        # idempotent sampler a process, as the GCS's.
        profiler.maybe_start_always_on()

        # Prestart the pool (reference: worker_pool.h:245 PrestartWorkers).
        for _ in range(self._max_pool):
            self._spawn_worker()
        self._reaper = threading.Thread(target=self._reap_loop, daemon=True,
                                        name="rtpu-nm-reaper")
        self._reaper.start()
        self._spiller = threading.Thread(target=self._spill_loop,
                                         daemon=True,
                                         name="rtpu-nm-spill")
        self._spiller.start()
        self._heartbeater = threading.Thread(target=self._heartbeat_loop,
                                             daemon=True,
                                             name="rtpu-nm-heartbeat")
        self._heartbeater.start()
        self._log_watch: Dict[bytes, WorkerHandle] = {}
        self._log_monitor = threading.Thread(target=self._log_monitor_loop,
                                             daemon=True,
                                             name="rtpu-nm-logmon")
        self._log_monitor.start()
        self.oom_kills = 0
        if config.memory_monitor_refresh_ms > 0:
            self._mem_monitor = threading.Thread(
                target=self._memory_monitor_loop, daemon=True,
                name="rtpu-nm-memmon")
            self._mem_monitor.start()

    # ------------------------------------------------------------ lifecycle

    def shutdown(self):
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            workers = list(self._workers.values())
        for w in workers:
            try:
                w.proc.kill()
            except Exception:
                pass
        for w in workers:
            try:
                w.proc.wait(timeout=5)
            except Exception:
                pass
        for z in self._zygotes:
            try:
                z["proc"].kill()
            except Exception:
                pass
            try:
                os.unlink(z["sock_path"])
            except OSError:
                pass
        # The spiller and heartbeater touch the store (stats() reads the
        # mmap'd arena through ctypes); let them observe _shutdown before
        # the store handle goes away (segfault otherwise).
        spiller = getattr(self, "_spiller", None)
        if spiller is not None:
            spiller.join(timeout=2)
        heartbeater = getattr(self, "_heartbeater", None)
        if heartbeater is not None:
            heartbeater.join(timeout=2)
        self._actor_exec.shutdown(wait=False)
        # Flag every completion-ring producer closed so still-draining
        # drivers exit their consumer loops (never unlinks: the driver
        # owns the files).
        with self._lock:
            comp_ents = [e for lst in self._completion_rings.values()
                         for e in lst]
            self._completion_rings.clear()
        for ent in comp_ents:
            try:
                ent["producer"].close()
            except Exception:
                pass
        # Worker completion segments: the workers just got SIGKILLed
        # above, so their own close never ran — unlink every file still
        # registered (idempotent vs driver force-unlink).
        with self._lock:
            seg_paths = [p for paths in self._worker_segments.values()
                         for p in paths]
            self._worker_segments.clear()
        for p in seg_paths:
            try:
                os.unlink(p)
            except OSError:
                pass
        self.server.close()
        try:
            self.gcs.close()
        except Exception:
            pass
        try:
            self.store.close()
        except Exception:
            pass
        try:
            os.unlink(self.store_path)
        except OSError:
            pass

    def _log_monitor_loop(self):
        """Tail worker log files and stream new lines to the GCS
        (reference: _private/log_monitor.py:104 LogMonitor)."""
        while not self._shutdown:
            time.sleep(0.2)
            with self._lock:
                for w in self._workers.values():
                    self._log_watch.setdefault(w.worker_id, w)
            entries = []
            for wid, w in list(self._log_watch.items()):
                dead = w.proc.poll() is not None
                for stream, path in w.log_paths.items():
                    try:
                        size = os.path.getsize(path)
                    except OSError:
                        continue
                    off = w.log_offsets.get(stream, 0)
                    if size <= off:
                        continue
                    try:
                        with open(path, "rb") as f:
                            f.seek(off)
                            data = f.read(min(size - off, 1 << 20))
                    except OSError:
                        continue
                    # Only complete lines; leave the partial tail for later.
                    cut = data.rfind(b"\n")
                    if cut < 0 and not dead:
                        continue
                    chunk = data if dead else data[:cut + 1]
                    w.log_offsets[stream] = off + len(chunk)
                    lines = [ln.decode("utf-8", "replace")
                             for ln in chunk.splitlines()]
                    if lines:
                        entries.append({"pid": w.proc.pid,
                                        "worker_id": wid.hex()[:12],
                                        "stream": stream, "lines": lines})
                if dead and all(
                        w.log_offsets.get(st, 0) >= _file_size(pa)
                        for st, pa in w.log_paths.items()):
                    self._log_watch.pop(wid, None)
            if entries:
                try:
                    self.gcs.notify("worker_logs", {
                        "node_id": self.node_id, "entries": entries})
                except Exception:
                    pass

    # -------------------------------------------------------- memory monitor

    @staticmethod
    def _proc_rss(pid: int) -> int:
        try:
            with open(f"/proc/{pid}/statm") as f:
                return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")
        except (OSError, ValueError, IndexError):
            return 0

    def _memory_budget(self) -> int:
        limit = int(config.memory_limit_bytes)
        if limit > 0:
            return limit
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        return int(line.split()[1]) * 1024
        except OSError:
            pass
        return 0

    def _memory_monitor_loop(self):
        """Sample worker RSS + store usage; over the threshold, kill the
        newest retriable task's worker (reference: memory_monitor.h:52 +
        worker_killing_policy.h:34 RetriableFIFO policy). Killed tasks go
        through the normal crash path, so retry budgets apply and the
        OOM cause reaches the caller's error."""
        period = max(0.05, config.memory_monitor_refresh_ms / 1000.0)
        while not self._shutdown:
            time.sleep(period)
            budget = self._memory_budget()
            if budget <= 0:
                continue
            threshold = budget * float(config.memory_usage_threshold)
            with self._lock:
                workers = [w for w in self._workers.values()
                           if w.proc.poll() is None]
            usage = sum(self._proc_rss(w.proc.pid) for w in workers)
            try:
                usage += self.store.stats().get("used_bytes", 0)
            except Exception:
                pass
            if usage <= threshold:
                continue
            victim = self._pick_oom_victim(workers)
            if victim is None:
                continue
            rss = self._proc_rss(victim.proc.pid)
            reason = (
                f"killed by the memory monitor (OOM): node usage "
                f"{usage >> 20} MiB over threshold "
                f"{int(threshold) >> 20} MiB; worker rss {rss >> 20} MiB")
            logger.warning("%s (pid %d)", reason, victim.proc.pid)
            with self._lock:
                victim.death_reason = reason
                leased_conn = victim.leased_conn \
                    if victim.state == LEASED else None
            if leased_conn is not None:
                # Tell the lease holder WHY before the conn drops, so its
                # fallback/error path can surface the OOM cause.
                try:
                    leased_conn.notify("leased_worker_killed", {
                        "worker_id": victim.worker_id, "reason": reason})
                except protocol.ConnectionClosed:
                    pass
            self.oom_kills += 1
            self.agent.record_event(
                "oom_kill", worker_id=victim.worker_id.hex(),
                pid=victim.proc.pid, detail=reason)
            try:
                self.gcs.notify("task_events", [{
                    "task_id": tid.hex(),
                    "name": getattr(spec, "name",
                                    getattr(spec, "method_name", "")),
                    "kind": "task", "node_id": self.node_id,
                    "worker_id": victim.worker_id.hex(),
                    "pid": victim.proc.pid, "start": victim.busy_since,
                    "end": time.time(), "status": "oom_killed",
                } for tid, spec in victim.current_tasks.items()])
            except Exception:
                pass
            try:
                victim.proc.kill()
            except Exception:
                pass

    def _pick_oom_victim(self, workers) -> Optional[WorkerHandle]:
        """RetriableFIFO: newest retriable plain-task worker first, then
        newest non-retriable plain-task worker; actors are spared (their
        restart blast radius is larger — reference
        worker_killing_policy.h:34 prefers retriable tasks too)."""
        def newest(cands):
            return max(cands, key=lambda w: w.busy_since, default=None)

        task_workers = [w for w in workers
                        if w.actor_id is None and w.current_tasks]
        # Leased workers run direct-transport tasks the NM cannot see;
        # their holders own retry/fallback, so they count as retriable
        # victims (the holder resubmits or surfaces a clean error).
        leased = [w for w in workers
                  if w.actor_id is None and w.state == LEASED]
        retriable = [w for w in task_workers
                     if any(getattr(s, "retries_left",
                                    getattr(s, "max_retries", 0))
                            for s in w.current_tasks.values())]
        return newest(retriable + leased) or newest(task_workers)

    def _heartbeat_loop(self):
        """Periodic liveness report (reference: raylet heartbeats feeding
        gcs_health_check_manager.h:39). A wedged-but-connected node stops
        heartbeating and the GCS declares it dead.

        Each heartbeat carries a hardware sample — the per-node reporter
        agent (reference: dashboard/modules/reporter/reporter_agent.py:253
        collecting CPU/mem/GPU per node; here CPU/mem/object-store/GPU
        stats, surfaced via the nodes API and /metrics gauges)."""
        period = max(0.05, config.raylet_heartbeat_period_ms / 1000.0)
        prev_cpu = self._read_proc_stat()
        while not self._shutdown:
            time.sleep(period)
            try:
                cur_cpu = self._read_proc_stat()
                hw = self._sample_hardware(prev_cpu, cur_cpu)
                prev_cpu = cur_cpu
                # Metric snapshots join the flight-recorder ring: a
                # postmortem shows resource pressure alongside the task
                # events that hit it.
                self.agent.record_event("hw_sample", hw=hw)
                with self._lock:
                    local_held = self._local_held.to_dict()
                    held_seq = self._local_held_seq
                self.gcs.notify("heartbeat", {
                    "node_id": self.node_id,
                    "oom_kills": getattr(self, "oom_kills", 0),
                    "local_held": local_held,
                    "local_held_seq": held_seq,
                    "hw": hw})
            except Exception:
                pass  # disconnected; the rejoin path owns recovery

    @staticmethod
    def _read_proc_stat():
        """(busy_jiffies, total_jiffies) from /proc/stat, or None."""
        try:
            with open("/proc/stat") as f:
                parts = f.readline().split()[1:]
            vals = [int(x) for x in parts[:8]]
            total = sum(vals)
            idle = vals[3] + (vals[4] if len(vals) > 4 else 0)
            return (total - idle, total)
        except Exception:
            return None

    def _sample_hardware(self, prev_cpu, cur_cpu) -> Dict[str, Any]:
        """One reporter sample. The GPU free-list is what this process
        authoritatively owns, so it is always present (free == idle GPUs;
        a fully-busy node shows 0 free)."""
        cpu_percent = None
        if prev_cpu and cur_cpu and cur_cpu[1] > prev_cpu[1]:
            cpu_percent = round(100.0 * (cur_cpu[0] - prev_cpu[0])
                                / (cur_cpu[1] - prev_cpu[1]), 1)
        mem_total = mem_avail = None
        try:
            with open("/proc/meminfo") as f:
                info = {}
                for line in f:
                    k, v = line.split(":", 1)
                    info[k] = int(v.split()[0]) * 1024
            mem_total = info.get("MemTotal")
            mem_avail = info.get("MemAvailable")
        except Exception:
            pass
        if self._shutdown:
            # stats() reads the mmap'd arena via ctypes: touching it
            # while shutdown unmaps is a segfault, not an exception.
            store = {}
        else:
            try:
                # stats_ex: includes the O(max_objects) pin scan — this
                # is the 1/s heartbeat, the one caller that wants it.
                store = self.store.stats_ex()
            except Exception:
                store = {}
        with self._lock:
            # Parked GPU-bound workers count as free capacity: their
            # GPUs are reclaimed (or the worker reused) on demand.
            free_gpus = len(self._free_gpus) + sum(
                len(w.gpu_ids)
                for pool in self._gpu_idle.values() for w in pool)
            workers = len(self._workers)
        total_gpus = int(self._total_resources.get("GPU", 0))
        return {
            "cpu_percent": cpu_percent,
            "mem_total_bytes": mem_total,
            "mem_available_bytes": mem_avail,
            "sched_local_grants_total": self.local_grants_total,
            "sched_spillbacks_total": self.local_spillbacks_total,
            "store_used_bytes": store.get("used_bytes"),
            "store_capacity_bytes": store.get("capacity_bytes"),
            "store_objects": store.get("num_objects"),
            # Pin + device-staging accounting (store.cpp rtpu_stats_ex):
            # pinned bytes are the store's non-reclaimable floor (held by
            # zero-copy readers); staged bytes meter device-array DMA
            # traffic into this node's arena.
            "store_pinned_objects": store.get("pinned_objects"),
            "store_pinned_bytes": store.get("pinned_bytes"),
            "device_staged_bytes": store.get("device_staged_bytes"),
            "gpus_total": total_gpus,
            "gpus_free": free_gpus,
            "workers": workers,
            "ts": time.time(),
        }

    def _on_gcs_disconnect(self, conn):
        if self._shutdown:
            return
        threading.Thread(target=self._rejoin_gcs, daemon=True,
                         name="rtpu-nm-rejoin").start()

    def _rejoin_gcs(self):
        # Redial with exponential backoff: a restarting GCS process
        # (out-of-process mode: real process death, not just a dropped
        # socket) takes spawn + storage-restore time to come back —
        # hammering the dead port at a fixed cadence buys nothing, and
        # with every node redialing at once the backoff also spreads the
        # re-registration stampede.
        deadline = time.time() + 300.0
        backoff = 0.2
        while not self._shutdown and time.time() < deadline:
            try:
                conn = protocol.connect(self.gcs_address,
                                        handler=self._handle_gcs,
                                        name=f"nm-gcs-{self._node_name}",
                                        timeout=5.0)
            except ConnectionError:
                time.sleep(backoff)
                backoff = min(backoff * 1.6, 5.0)
                continue
            with self._lock:
                alive_actors = [aid for aid, w in self._actors.items()
                                if w.proc.poll() is None]
            try:
                objects = [(oid, 0) for oid in self.store.list_objects()]
            except Exception:
                objects = []
            try:
                with self._lock:
                    local_held = self._local_held.to_dict()
                    held_seq = self._local_held_seq
                conn.request("register_node", {
                    "node_id": self.node_id,
                    "address": self.address,
                    "store_path": self.store_path,
                    "resources": dict(self._total_resources),
                    "labels": self._labels,
                    "is_head": self._is_head,
                    "actors": alive_actors,
                    "objects": objects,
                    "local_held": local_held,
                    "local_held_seq": held_seq,
                }, timeout=30)
            except Exception:
                try:
                    conn.close()
                except Exception:
                    pass
                time.sleep(backoff)
                backoff = min(backoff * 1.6, 5.0)
                continue
            conn.on_close = self._on_gcs_disconnect
            self.gcs = conn
            # Re-send the placement report for every live locally-placed
            # actor: an ACTOR_PLACED notify lost to the dying conn left
            # the GCS permanently blind to it (register_node's actor
            # re-report can only patch entries the GCS already has —
            # it carries ids, not specs). Idempotent at the GCS.
            with self._lock:
                placed = [(aid, self._actors[aid].actor_spec)
                          for aid in self._local_actor_ids
                          if aid in self._actors
                          and self._actors[aid].actor_spec is not None
                          and self._actors[aid].proc.poll() is None]
                held = self._local_held.to_dict()
                held_seq = self._local_held_seq
            for _aid, spec in placed:
                try:
                    conn.notify(protocol.ACTOR_PLACED, {
                        "spec": spec, "node_id": self.node_id,
                        "local_held": held, "local_held_seq": held_seq})
                except Exception:
                    break   # conn died again; the next rejoin re-sends
            logger.info("node %s rejoined gcs (%d actors, %d objects "
                        "re-reported)", self.node_id[:12], len(alive_actors),
                        len(objects))
            return
        if not self._shutdown:
            logger.error("node %s could not rejoin the gcs; shutting down",
                         self.node_id[:12])
            self.shutdown()

    def _reap_loop(self):
        """Detect dead worker processes even if their socket lingers;
        retire GPU-bound workers parked past their idle timeout; bound
        how long a deferred lease reply can wait on a worker that hangs
        during startup (alive, never registers) — past the worker-start
        timeout the worker is killed, which errors the deferred reply so
        the lease caller falls back to the GCS-brokered path instead of
        wedging that shape's pipeline (r7 finding a)."""
        gpu_idle_timeout = float(config.gpu_worker_idle_timeout_s)
        while not self._shutdown:
            time.sleep(0.2)
            start_timeout = float(config.worker_start_timeout_s)
            hung: List[WorkerHandle] = []
            with self._lock:
                dead = [w for w in self._workers.values()
                        if w.proc.poll() is not None and w.state != "dead"]
                now = time.time()
                for w in self._workers.values():
                    if (w.state == STARTING and w.lease_reply is not None
                            and w.busy_since
                            and now - w.busy_since > start_timeout
                            and w.proc.poll() is None):
                        # Kill under the lock: registration (serve
                        # thread) also runs under it, so a worker that
                        # registers at the timeout boundary can't be
                        # killed after its grant was already handed out.
                        w.killed_by_us = True
                        try:
                            w.proc.kill()
                        except Exception:
                            pass
                        hung.append(w)
                expired: List[WorkerHandle] = []
                for key, pool in list(self._gpu_idle.items()):
                    keep = []
                    for w in pool:
                        if now - w.gpu_idle_since > gpu_idle_timeout:
                            for c in w.gpu_ids:
                                self._free_gpus.add(c)
                            w.gpu_ids = []
                            expired.append(w)
                        else:
                            keep.append(w)
                    if keep:
                        self._gpu_idle[key] = keep
                    else:
                        self._gpu_idle.pop(key, None)
                # Elastic-pool shrink: idle CPU workers above the base
                # pool retire after worker_idle_timeout_s (growth was
                # queue-pressure-driven; the base pool stays warm).
                idle_timeout = float(config.worker_idle_timeout_s)
                n_pool = len([x for x in self._workers.values()
                              if not x.dedicated and x.state != "dead"])
                if n_pool > self._max_pool:
                    for w in list(self._idle):
                        if n_pool <= self._max_pool:
                            break
                        if (w.state == IDLE and w.idle_since
                                and now - w.idle_since > idle_timeout):
                            self._idle.remove(w)
                            w.killed_by_us = True
                            expired.append(w)
                            n_pool -= 1
            for w in hung:
                logger.warning(
                    "worker %s hung during startup for a pending lease "
                    "(> %.0fs); killed it so the caller falls back",
                    w.worker_id.hex()[:12], start_timeout)
            for w in dead:
                try:
                    self._on_worker_death(w)
                except Exception:
                    # The reap thread is the node's death detector: one
                    # handler failure must not terminate it.
                    logger.exception("worker death handling failed")
            for w in expired:
                try:
                    w.conn.notify("exit")
                except (protocol.ConnectionClosed, AttributeError):
                    pass

    # ---------------------------------------------------------- worker pool

    def _start_zygotes(self) -> None:
        if not config.worker_zygote_enabled:
            return
        count = max(1, int(config.worker_zygote_count))
        env = dict(os.environ)
        # CPU-only stack in the zygote: no GPU (GPU-bound workers keep
        # the classic spawn path; a CUDA context does not survive a
        # fork), no JAX/TPU variables, no stale per-worker identity.
        env["CUDA_VISIBLE_DEVICES"] = ""
        _drop_tpu_env(env)
        for k in [k for k in env if k.startswith("RAY_TPU_TORCH_")]:
            env.pop(k, None)
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        for i in range(count):
            sock_path = os.path.join(
                self.session_dir, f"zyg{i}_{self.node_id[:12]}.sock")
            zenv = dict(env)
            zenv["RAY_TPU_TORCH_ZYGOTE_SOCKET"] = sock_path
            log = os.path.join(log_dir,
                               f"zygote{i}-{self.node_id[:12]}.log")
            try:
                with open(log, "ab") as f:
                    proc = subprocess.Popen(
                        [sys.executable, "-m",
                         "ray_tpu_torch._private.worker_zygote"],
                        env=zenv, stdout=f, stderr=f)
            except OSError:
                continue
            self._zygotes.append({"proc": proc, "sock_path": sock_path,
                                  "io": None, "lock": threading.Lock()})

    def _zygote_fork(self, req: dict) -> Optional[_ForkedProc]:
        """Ask a fork-server for a forked worker; None falls back to the
        classic spawn (zygotes still starting, or all dead). Picks an
        UNCONTENDED zygote when one exists (try-acquire sweep), else
        round-robins — concurrent spawns fan out across the pool."""
        live = [z for z in self._zygotes
                if z["proc"].poll() is None]
        if not live:
            return None
        target = None
        for z in live:
            if z["lock"].acquire(False):
                target = z
                break
        if target is None:
            target = live[next(self._zygote_rr) % len(live)]
            # In-process lock, held only around a 10s-bounded socket
            # conversation — a bounded wait, not a park.
            target["lock"].acquire()
        try:
            return self._zygote_fork_locked(target, req)
        finally:
            target["lock"].release()

    def _zygote_fork_locked(self, z: dict,
                            req: dict) -> Optional[_ForkedProc]:
        # The zygote's conversation lock is held: the socket IO below is
        # the exact resource the lock serializes, bounded by a 10s
        # settimeout so a dead zygote cannot wedge spawners.
        try:
            if z["io"] is None:
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.settimeout(10.0)
                s.connect(z["sock_path"])
                z["io"] = (s, s.makefile("rwb"))
            _, f = z["io"]
            f.write((json.dumps(req) + "\n").encode())
            f.flush()
            # The socket carries a 10s settimeout from connect time, so
            # this read is bounded.
            line = f.readline()
            if not line:
                raise OSError("zygote connection closed")
            return _ForkedProc(int(json.loads(line)["pid"]),
                               z["sock_path"] + ".exits")
        except (OSError, ValueError, KeyError):
            io, z["io"] = z["io"], None
            if io is not None:
                try:
                    io[0].close()
                except OSError:
                    pass
            return None

    def _spawn_worker(self, dedicated: bool = False,
                      env_extra: Optional[Dict[str, str]] = None,
                      gpu_ids: Optional[List[int]] = None,
                      cwd: Optional[str] = None,
                      extra_pythonpath: Optional[List[str]] = None
                      ) -> WorkerHandle:
        worker_id = WorkerID.from_random().binary()
        # Identity vars every worker needs. The zygote fast path ships
        # ONLY these + the import roots (the zygote already holds the
        # base environment) — assembling a full os.environ copy per
        # spawn showed up in head-process profiles under actor churn;
        # the classic path builds it lazily below.
        ident = {
            "RAY_TPU_TORCH_WORKER_ID": worker_id.hex(),
            "RAY_TPU_TORCH_NM_ADDRESS": self.address,
            "RAY_TPU_TORCH_GCS_ADDRESS": self.gcs_address,
            "RAY_TPU_TORCH_STORE_PATH": self.store_path,
            "RAY_TPU_TORCH_NODE_ID": self.node_id,
            "RAY_TPU_TORCH_SESSION_DIR": self.session_dir,
        }
        # Ship this NM's non-default config to the worker (the analog of
        # serve.start shipping _system_config to worker actors): zygote-
        # forked workers inherit the ZYGOTE's env — which deliberately
        # strips RAY_TPU_TORCH_* — so without this, knobs set on the driver
        # (inline-return thresholds, A/B toggles, test system_configs)
        # would silently default in every worker. worker_main applies it
        # through the typed registry before building its CoreWorker.
        cfg_diff = config.diff_nondefault()
        if cfg_diff:
            try:
                ident["RAY_TPU_TORCH_SYSTEM_CONFIG"] = json.dumps(cfg_diff)
            except (TypeError, ValueError):
                pass   # non-JSON value snuck in: workers keep defaults
        # Workers resolve by-reference pickles (functions defined in driver
        # modules) by importing the same modules, so they need the driver's
        # import roots (reference: runtime_env working_dir ships driver code
        # to workers; same-host equivalent is sharing sys.path).
        roots = list(extra_pythonpath or [])
        roots += serialization.import_roots()

        def build_env():
            env = dict(os.environ)
            _drop_tpu_env(env)
            env.update(env_extra or {})
            prior = env.get("PYTHONPATH")
            allroots = roots + ([prior] if prior else [])
            env["PYTHONPATH"] = os.pathsep.join(allroots)
            env.update(ident)
            if cwd is not None or extra_pythonpath:
                # Runtime-env isolation: the worker must NOT later
                # prepend driver sys.path entries ahead of its pinned
                # working_dir / py_modules snapshot (worker_main honors
                # this flag).
                env["RAY_TPU_TORCH_ISOLATED_ENV"] = "1"
            # A GPU worker's CUDA context sees exactly its assigned GPUs;
            # a CPU-only worker sees none (as the reference hides its
            # GPU plugin from CPU workers). Set after env_extra: a
            # runtime_env must not desync the free list.
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                self._gpu_tokens[i] for i in gpu_ids or ())
            if gpu_ids:
                env["RAY_TPU_TORCH_GPU_IDS"] = ",".join(
                    str(i) for i in gpu_ids)
            return env

        # Worker stdout/stderr -> per-worker session log files (reference:
        # default_worker.py redirection + log_monitor.py:104 tailing); the
        # node's log monitor streams new lines to the GCS, which forwards
        # them to drivers that asked for log_to_driver.
        log_dir = self._log_dir
        wid12 = worker_id.hex()[:12]
        out_path = os.path.join(log_dir, f"worker-{wid12}.out")
        err_path = os.path.join(log_dir, f"worker-{wid12}.err")
        # Record the handle BEFORE the fork/exec: a zygote-forked child
        # can boot and call register_worker in single-digit ms — faster
        # than this thread re-takes the GIL after the fork conversation
        # — and registration must find the handle. The placeholder proc
        # answers poll() None ("still starting") until the real one
        # lands below.
        handle = WorkerHandle(worker_id=worker_id, proc=_SPAWNING,
                              dedicated=dedicated, gpu_ids=gpu_ids or [],
                              env_key=(tuple(sorted(env_extra.items()))
                                       if env_extra else None),
                              log_paths={"stdout": out_path,
                                         "stderr": err_path},
                              log_offsets={"stdout": 0, "stderr": 0})
        with self._lock:
            self._workers[worker_id] = handle
        proc = None
        try:
            if not gpu_ids and cwd is None and not extra_pythonpath \
                    and not env_extra:
                # Plain CPU worker: fork from the pre-imported zygote
                # (interpreter start + imports already paid). Worker vars
                # only — the zygote holds the base environment.
                proc = self._zygote_fork({
                    "env": ident,
                    "stdout": out_path, "stderr": err_path,
                    "cwd": None,
                    "sys_path": [p for p in roots if p],
                })
            if proc is None:
                with open(out_path, "ab") as f_out, \
                        open(err_path, "ab") as f_err:
                    proc = subprocess.Popen(
                        [sys.executable, "-m",
                         "ray_tpu_torch._private.worker_main"],
                        env=build_env(),
                        cwd=cwd or os.getcwd(),
                        stdout=f_out,
                        stderr=f_err,
                    )
        except BaseException:
            # Spawn failed. The handle was visible in _workers during
            # the fork window, so a lease checkout or an actor creation
            # may already have CLAIMED it (lease_reply parked, actor
            # registered, resource holds bound) — those must unwind
            # through the normal worker-death path or the caller hangs
            # forever on a worker that never existed. Unclaimed
            # placeholders just vanish.
            with self._lock:
                claimed = (handle.actor_id is not None
                           or handle.lease_reply is not None
                           or handle.leased_conn is not None)
                if not claimed:
                    self._workers.pop(worker_id, None)
            if claimed:
                handle.death_reason = "worker spawn failed"
                self._on_worker_death(handle)
            raise
        handle.proc = proc
        return handle

    def _on_server_disconnect(self, conn: protocol.Conn):
        # Worker completion segments: whatever this conn
        # registered and never detached is a crash leftover — the
        # worker's own close and the driver's force-unlink both remove
        # the file when they run, so this unlink is the backstop for a
        # worker killed between creating the file and either of those
        # (idempotent: ENOENT ignored).
        with self._lock:
            seg_paths = self._worker_segments.pop(conn, None)
        if seg_paths:
            for p in seg_paths:
                try:
                    os.unlink(p)
                except OSError:
                    pass
        wid = conn.meta.get("worker_id")
        if wid is None:
            # A caller conn: release its local grants and reclaim any
            # workers it was leasing (safety net for callers that died
            # before ever dialing the worker).
            with self._lock:
                leased = [w for w in self._workers.values()
                          if w.leased_conn is conn]
                dead_grants = [lid for lid, g in self._local_grants.items()
                               if g["conn"] is conn]
                rings = self._submit_rings.pop(conn, [])
                comp_rings = self._completion_rings.pop(conn, [])
            for ent in rings:
                ent["stop"] = True   # drain thread exits after a final pass
            for ent in comp_rings:
                # Producer close flags the ring so a still-draining
                # consumer exits; never unlinks (the driver owns the
                # file and removes it on disconnect).
                try:
                    ent["producer"].close()
                except Exception:
                    pass
            for lid in dead_grants:
                self._release_local_grant(lid)
            for w in leased:
                self._release_leased_worker(w)
            return
        with self._lock:
            w = self._workers.get(wid)
        if w is not None and w.state != "dead":
            self._on_worker_death(w)

    def _on_worker_death(self, w: WorkerHandle):
        with self._lock:
            if w.state == "dead":
                return
            prev_state = w.state
            w.state = "dead"
            self._workers.pop(w.worker_id, None)
            # Release local-ledger holds tied to this worker (a brokered
            # checkout's shape, a local grant's lease tag).
            dead_lease_tag = w.lease_tag
            res, w.lease_resources = w.lease_resources, None
            if res:
                self._local_avail.release(res)
            if w in self._idle:
                self._idle.remove(w)
            for key, pool in list(self._gpu_idle.items()):
                if w in pool:
                    pool.remove(w)
                    if not pool:
                        self._gpu_idle.pop(key, None)
            for gpu in w.gpu_ids:
                self._free_gpus.add(gpu)
            tasks = dict(w.current_tasks)
            w.current_tasks.clear()
            parked_actor_specs = [p for (mt, p) in w.pending_pushes
                                  if mt == "run_actor_task"]
            w.pending_pushes = []
            actor_id = w.actor_id
            lease_reply, w.lease_reply = w.lease_reply, None
        death_detail = w.death_reason or f"exit code {w.proc.poll()}"
        self.agent.record_event(
            "worker_death",
            worker_id=w.worker_id.hex(),
            actor_id=actor_id.hex() if actor_id else None,
            pid=w.proc.pid, prev_state=prev_state,
            killed_by_us=w.killed_by_us, detail=death_detail,
            tasks=[tid.hex() for tid in tasks])
        if not w.killed_by_us and not self._shutdown \
                and (tasks or actor_id is not None
                     or prev_state == LEASED):
            # Unexpected death with work bound to the worker — in-flight
            # tasks, an actor, or a checked-out lease (whose
            # direct-transport tasks the NM cannot see; idle-pool
            # retires exit clean and are not postmortem-worthy): leave
            # the flight-recorder artifact now, while the ring still
            # holds the victim's last task events/spans.
            self.agent.recorder.dump(
                f"worker {w.worker_id.hex()[:12]} died unexpectedly "
                f"({death_detail})")
        self._release_local_grant(dead_lease_tag)
        if lease_reply is not None:
            # Died before registering: tell the waiting lease caller so it
            # can fall back to the scheduled path.
            lconn, lmsg_id = lease_reply
            try:
                lconn.reply_error(lmsg_id, "leased worker died at startup")
            except protocol.ConnectionClosed:
                pass
        for spec in parked_actor_specs:
            # Never delivered; the reroute path (below, via current_tasks)
            # or failure materialization takes custody of the args.
            self._refcount_delta(pinned_deps(spec), -1)
        # Fail in-flight tasks. Plain tasks: report crashed WITHOUT
        # materializing error objects — the GCS owns the retry budget, and
        # an early error object would fulfill the caller's get() with the
        # crash while the retry is still running (the GCS materializes
        # errors via store_error_objects only at FINAL failure). Actor
        # tasks: honor max_task_retries by rerouting the spec back through
        # the GCS (parked for the restarting actor, re-executed in order);
        # only an exhausted budget stores the actor error.
        max_task_retries = 0
        if w.actor_spec is not None:
            max_task_retries = getattr(w.actor_spec, "max_task_retries", 0)
        for tid, spec in tasks.items():
            if isinstance(spec, ActorTaskSpec):
                left = getattr(spec, "retries_left", None)
                if left is None:
                    left = max_task_retries
                if left != 0:
                    spec.retries_left = left - 1 if left > 0 else left
                    try:
                        self.gcs.notify("reroute_actor_task", spec)
                        continue
                    except Exception:
                        pass  # can't reroute: fall through to the error
                err: BaseException = exceptions.RayActorError(
                    actor_id=spec.actor_id.hex(), msg="actor died")
                objs = self._store_errors([r.binary() for r in
                                           spec.return_ids()], err)
                self._report_task_done(tid, "crashed", objs,
                                       error=str(err))
            elif isinstance(spec, TaskSpec):
                detail = w.death_reason or f"exit code {w.proc.poll()}"
                err = exceptions.WorkerCrashedError(
                    f"worker running {getattr(spec, 'name', '')} died "
                    f"({detail})")
                self._report_task_done(tid, "crashed", [],
                                       error=str(err))
        if actor_id is not None:
            push = False
            with self._lock:
                self._actors.pop(actor_id, None)
                held = self._res_held_actors.pop(actor_id, None)
                if held:
                    self._local_avail.release(held)
                if actor_id in self._local_actor_ids:
                    # Locally-placed actor (decentralized creation): the
                    # shape leaves the local_held aggregate with it.
                    self._local_actor_ids.discard(actor_id)
                    if held:
                        self._local_held.subtract(held)
                        self._local_held_seq += 1
                        push = True
            if push:
                self._push_resource_report()
            try:
                self.gcs.notify("actor_state", {
                    "actor_id": actor_id,
                    "state": "DEAD",
                    "expected": w.no_restart_kill,
                    "error": "actor worker died"
                    if not w.killed_by_us else "actor killed",
                })
            except Exception:
                pass
        elif prev_state in (BUSY, IDLE, STARTING) and not self._shutdown \
                and not w.dedicated:
            # keep the pool full
            with self._lock:
                refill = len([x for x in self._workers.values()
                              if not x.dedicated]) < self._max_pool
            if refill:
                try:
                    self._spawn_worker()
                except BaseException:
                    # A transient fork failure (likely under the same
                    # pressure that killed the worker) must not unwind
                    # into the reaper and disable death detection.
                    logger.exception("pool refill spawn failed")
        self._dispatch_queued()

    def _store_raw(self, oid: bytes, data: bytes) -> bool:
        """Write one pre-framed blob into the store (create/copy/seal;
        an existing object counts as success — idempotent redelivery)."""
        try:
            buf = self.store.create(oid, len(data))
        except plasma.ObjectExistsError:
            return True
        except plasma.StoreFullError:
            if self._spill_bytes(len(data) * 2) <= 0:
                return False
            try:
                buf = self.store.create(oid, len(data))
            except plasma.ObjectExistsError:
                return True
            except Exception:
                return False
        try:
            buf[:] = data
        finally:
            del buf
        self.store.seal(oid)
        return True

    def _store_errors(self, object_ids: List[bytes], err: BaseException):
        """Materialize an exception as the value of each object id. The
        exception is serialized and FRAMED once; each additional return
        id costs only the store memcpy of those same bytes."""
        out = []
        data = serialization.serialize(err).to_bytes()
        for oid in object_ids:
            try:
                if not self._store_raw(oid, data):
                    continue
            except Exception:
                logger.exception("failed storing error object")
                continue
            out.append((oid, len(data)))
        if out:
            try:
                self.gcs.notify("add_object_locations", {
                    "node_id": self.node_id, "objects": out})
            except Exception:
                pass
        return out

    def _on_store_inline_objects(self, p):
        """GCS inline-table pressure: materialize evicted in-band
        returns into this node's store. The GCS keeps its table entry
        until the add_object_locations report below confirms the store
        copy (keep-until-confirmed — a reader can never find the object
        in neither place), then drops it."""
        out = []
        for oid, data in p.get("objects", []):
            try:
                if self._store_raw(oid, data):
                    out.append((oid, len(data)))
            except Exception:
                logger.exception("inline-object materialization failed")
        if out:
            try:
                self.gcs.notify("add_object_locations", {
                    "node_id": self.node_id, "objects": out})
            except Exception:
                pass

    def _report_task_done(self, task_id: bytes, status: str, objects,
                          error: Optional[str] = None,
                          inline: Optional[dict] = None):
        with self._lock:
            held = self._res_held_tasks.pop(task_id, None)
            if held:
                self._local_avail.release(held)
        msg = {
            "task_id": task_id,
            "status": status,
            "objects": objects or [],
            "node_id": self.node_id,
            "error": error,
        }
        if inline:
            msg["inline"] = inline
        try:
            self.gcs.notify("task_done", msg)
        except Exception:
            pass

    # ------------------------------------------------------- GCS messages

    def _handle_gcs(self, conn, mtype, payload, msg_id):
        try:
            if mtype == "lease_task":
                self._on_lease_task(payload)
            elif mtype == "create_actor":
                self._on_create_actor(payload)
            elif mtype == "kill_actor":
                self._on_kill_actor(payload)
            elif mtype == "cancel_task":
                self._on_cancel_task(payload)
            elif mtype == "store_error_objects":
                self._on_store_error_objects(payload)
            elif mtype == "store_inline_objects":
                self._on_store_inline_objects(payload)
            elif mtype == "delete_objects":
                for oid in payload["object_ids"]:
                    self.store.delete(oid)
            elif mtype == "submit_actor_task":
                self._on_submit_actor_task(payload)
            elif mtype == protocol.REVOKE_LOCAL_LEASE:
                self._on_revoke_local_lease(payload)
            elif mtype == "dump_stacks":
                # Legacy signal path: SIGUSR2 -> worker_main's
                # faulthandler prints every thread's stack to stderr ->
                # per-worker log file -> log stream (reference:
                # `ray stack`). The in-band data path is collect_stacks.
                with self._lock:
                    pids = [w.proc.pid for w in self._workers.values()
                            if w.proc.poll() is None]
                for pid in pids:
                    try:
                        os.kill(pid, signal.SIGUSR2)
                    except OSError:
                        pass
            elif mtype in ("collect_stacks", "agent_logs",
                           "flight_snapshot", "profile"):
                self._handle_agent(conn, mtype, payload, msg_id)
            elif mtype == "flight_dump":
                # Fan-out notify (gang supervisor declared slice death):
                # no reply expected.
                self._handle_agent(conn, mtype, payload, msg_id,
                                   reply=False)
            elif mtype == "shutdown":
                threading.Thread(target=self.shutdown, daemon=True).start()
        except Exception:
            logger.exception("node manager: error handling %s", mtype)

    def _handle_agent(self, conn, mtype, payload, msg_id,
                      reply: bool = True):
        """Dispatch an observability-agent message — always OFF this
        conn's serve thread: collect_stacks waits on worker replies that
        arrive via the NM's conns, agent_logs does per-worker file I/O,
        and flight_dump writes to disk; none of it may stall delivery
        of lease pushes / actor-state traffic on the same conn."""
        def run():
            try:
                result = self.agent.handle(mtype, payload)
            except Exception as e:
                logger.exception("agent: error handling %s", mtype)
                if reply:
                    try:
                        conn.reply_error(msg_id,
                                         f"{type(e).__name__}: {e}")
                    except protocol.ConnectionClosed:
                        pass
                return
            if reply:
                try:
                    conn.reply(msg_id, result)
                except protocol.ConnectionClosed:
                    pass

        threading.Thread(target=run, daemon=True,
                         name="rtpu-nm-agent").start()

    def _on_store_error_objects(self, p):
        kind = p.get("kind", "task")
        if kind == "actor":
            err: BaseException = exceptions.RayActorError(msg=p["error"])
        elif p["error"] == "cancelled":
            err = exceptions.TaskCancelledError()
        elif "died" in (p["error"] or ""):
            # System failure (worker/node death after retry exhaustion)
            # surfaces as WorkerCrashedError, matching the client-side
            # _error_from_reason mapping.
            err = exceptions.WorkerCrashedError(p["error"])
        else:
            err = exceptions.RayTaskError(p.get("name", ""), p["error"])
        self._store_errors(p["object_ids"], err)

    def _on_lease_task(self, spec: TaskSpec):
        from ray_tpu_torch._private import runtime_env as renv_mod

        tid = spec.task_id.binary()
        with self._lock:
            # Mirror the GCS's resource acquisition on the local ledger
            # (guarded: _dispatch_queued re-enters here for GPU specs).
            if tid not in self._res_held_tasks:
                self._res_held_tasks[tid] = dict(spec.resources)
                self._local_avail.subtract(spec.resources)
        if renv_mod.needs_isolation(spec.runtime_env):
            # working_dir / py_modules need a dedicated worker whose cwd
            # and sys.path are set at spawn (reference: per-runtime-env
            # worker pools, worker_pool.h runtime_env_hash keying).
            # Materialization fetches packages over the GCS conn, so it
            # must run OFF this handler thread (which IS that conn's
            # serve loop — a request from here would deadlock).
            threading.Thread(
                target=self._lease_task_with_runtime_env, args=(spec,),
                daemon=True, name="rtpu-nm-renv").start()
            return
        needs_gpu = spec.resources.get(GPU, 0) > 0
        if needs_gpu:
            k = int(spec.resources[GPU])
            env = dict((spec.runtime_env or {}).get("env_vars", {}))
            env_key = tuple(sorted(env.items())) if env else None
            with self._lock:
                w = self._pop_gpu_idle_locked(k, env_key)
            if w is not None:
                # Same-shape reuse: the GPUs are already bound and the
                # CUDA context is warm.
                self._push_task(w, spec)
                return
            gpus = self._acquire_gpus(k)
            if gpus is None:
                # Shouldn't happen (GCS accounts GPU), but be safe.
                with self._lock:
                    self._task_queue.append(spec)
                return
            try:
                w = self._spawn_worker(dedicated=True, env_extra=env,
                                       gpu_ids=gpus)
            except BaseException as e:
                # Spawn failed AFTER the ledger hold and gpu acquisition:
                # release both (the task never binds to a WorkerHandle, so
                # no death/done path will) and fail the task through the
                # normal report — repeated spawn failures must not
                # permanently shrink local capacity (r7 finding c; the
                # attached[] guard pattern from _on_lease_worker).
                with self._lock:
                    for c in gpus:
                        self._free_gpus.add(c)
                self._report_task_done(
                    tid, "crashed", [],
                    error=f"worker spawn failed: {e}")
                return
            with self._lock:
                w.pending_pushes.append(("run_task", spec))
                w.current_tasks[spec.task_id.binary()] = spec
            return
        with self._lock:
            w = self._pop_idle_locked()
            if w is None:
                # Queue FIRST: a pool-refill spawn failure must leave the
                # spec queued (retried on the next dispatch trigger) with
                # its ledger hold intact, not leak the hold by unwinding
                # out of this handler (r7 finding c).
                self._task_queue.append(spec)
                refill = self._pool_pressure_locked()
        if w is None:
            if refill:
                try:
                    self._spawn_worker()
                except BaseException:
                    logger.exception("pool refill spawn failed; task "
                                     "stays queued")
            return
        self._push_task(w, spec)

    def _pool_pressure_locked(self) -> bool:
        """Elastic pool growth signal (caller holds the lock): spawn
        another shared worker when queued tasks outnumber the spawns
        already in flight for the queue, and the pool is under its
        elastic ceiling (num_workers_soft_limit). The reaper retires
        idle workers above the base pool, so pressure-grown workers are
        transient, not a permanently bigger pool."""
        n = 0
        spares = 0
        for x in self._workers.values():
            if x.dedicated or x.state == "dead":
                continue
            n += 1
            if (x.state == STARTING and x.lease_reply is None
                    and x.leased_conn is None and x.actor_id is None):
                spares += 1
        # Only CPU-servable specs are pressure: a gpu-starved GPU spec
        # waits for gpus, and a pool worker spawned for it could never
        # run it (it would ramp the pool to its cap with idle spawns).
        queued_cpu = sum(1 for s in self._task_queue
                         if s.resources.get(GPU, 0) <= 0)
        return queued_cpu > spares and n < self._pool_cap

    def _maybe_grow_pool(self) -> None:
        with self._lock:
            grow = bool(self._task_queue) and self._pool_pressure_locked()
        if grow:
            try:
                self._spawn_worker()
            except BaseException:
                logger.exception("elastic pool spawn failed; queue "
                                 "retries on the next dispatch trigger")

    def _materialize_runtime_env(self, runtime_env):
        """Fetch + extract this env's packages from the GCS KV into the
        session's URI cache; returns (cwd, extra_pythonpath). Reference:
        runtime_env plugins' create() hook (plugin.py:24)."""
        from ray_tpu_torch._private import runtime_env as renv_mod

        base = os.path.join(self.session_dir, "runtime_resources")
        os.makedirs(base, exist_ok=True)

        def kv_get(key):
            return self.gcs.request("kv_get", {
                "ns": renv_mod.KV_NAMESPACE, "key": key}, timeout=60)

        workdir, paths, plugin_env = renv_mod.ensure_runtime_env(
            kv_get, runtime_env, base)
        # working_dir is importable too (driver scripts import siblings).
        if workdir is not None:
            paths = [workdir] + paths
        return workdir, paths, plugin_env

    def _lease_task_with_runtime_env(self, spec: TaskSpec):
        try:
            cwd, pypaths, plugin_env = self._materialize_runtime_env(
                spec.runtime_env)
        except Exception as e:
            err = exceptions.RayTaskError(
                getattr(spec, "name", ""),
                f"runtime_env setup failed: {e}")
            objs = self._store_errors(
                [r.binary() for r in spec.return_ids()], err)
            self._report_task_done(spec.task_id.binary(), "error",
                                   objs, error=str(e))
            return
        # GPU requests get their gpu assignment exactly like the plain
        # GPU lease path — a runtime_env must not strip CUDA_VISIBLE_DEVICES
        # or desync the gpu free-list from GCS accounting.
        gpus: List[int] = []
        k = int(spec.resources.get(GPU, 0))
        if k > 0:
            gpus = self._acquire_gpus(k)
            if gpus is None:
                with self._lock:
                    self._task_queue.append(spec)
                return
        env = dict(plugin_env)
        env.update((spec.runtime_env or {}).get("env_vars", {}))
        try:
            w = self._spawn_worker(dedicated=True, env_extra=env, cwd=cwd,
                                   extra_pythonpath=pypaths,
                                   gpu_ids=gpus or None)
        except BaseException as e:
            # Release the ledger hold + gpus (nothing will ever bind
            # them) and fail the task cleanly (r7 finding c).
            with self._lock:
                for c in gpus:
                    self._free_gpus.add(c)
            self._report_task_done(
                spec.task_id.binary(), "crashed", [],
                error=f"worker spawn failed: {e}")
            return
        with self._lock:
            w.isolated = True
            w.pending_pushes.append(("run_task", spec))
            w.current_tasks[spec.task_id.binary()] = spec

    def _pop_idle_locked(self) -> Optional[WorkerHandle]:
        while self._idle:
            w = self._idle.pop()
            if w.state == IDLE and w.conn is not None and not w.conn.closed:
                return w
        return None

    def _pop_gpu_idle_locked(self, k: int,
                             env_key: Optional[tuple] = None
                             ) -> Optional[WorkerHandle]:
        """Reuse a parked GPU-bound worker of the same shape (its CUDA
        context is already initialized against exactly these GPUs)."""
        pool = self._gpu_idle.get((k, env_key))
        while pool:
            w = pool.pop()
            if not pool:
                self._gpu_idle.pop((k, env_key), None)
            if w.state == IDLE and w.conn is not None and not w.conn.closed:
                return w
            # Stale (conn dropped while parked, process may hang):
            # reclaim the bound gpus NOW — once out of the pool nothing
            # else could ever free them — and kill the process; the
            # reaper's poll() path finishes the bookkeeping.
            for c in w.gpu_ids:
                self._free_gpus.add(c)
            w.gpu_ids = []
            w.killed_by_us = True
            try:
                w.proc.kill()
            except OSError:
                pass
        return None

    def _reclaim_pooled_gpus_locked(self, needed: int) -> List[WorkerHandle]:
        """When the free list can't cover ``needed`` gpus, evict parked
        GPU workers (any shape) until it can. GPUs move to the free list
        immediately; the returned victims must be killed by the caller
        OUTSIDE the lock."""
        victims: List[WorkerHandle] = []
        if len(self._free_gpus) >= needed:
            return victims
        for key in list(self._gpu_idle.keys()):
            pool = self._gpu_idle[key]
            while pool and len(self._free_gpus) < needed:
                w = pool.pop()
                w.killed_by_us = True
                for c in w.gpu_ids:
                    self._free_gpus.add(c)
                w.gpu_ids = []   # death handler must not double-add
                victims.append(w)
            if not pool:
                self._gpu_idle.pop(key, None)
            if len(self._free_gpus) >= needed:
                break
        return victims

    def _acquire_gpus(self, k: int) -> Optional[List[int]]:
        """Take ``k`` gpus off the free list, evicting parked GPU-bound
        workers if the free list alone can't cover it. Returns the gpu
        ids, or None if the node can't provide ``k`` gpus even after
        reclaiming the whole parked pool. Victim kills happen here,
        outside the lock. GPUs still bound to a worker that was killed,
        or has exited, return when the reaper handles its death: the GCS
        has already released them, so a request that arrives in between
        waits for that (bounded by the worker start timeout) rather than
        fail."""
        deadline = time.time() + float(config.worker_start_timeout_s)
        while True:
            with self._lock:
                victims = self._reclaim_pooled_gpus_locked(k)
                gpus = sorted(self._free_gpus)[:k]
                if len(gpus) < k:
                    gpus = None
                    releasing = any(
                        w.gpu_ids and w.state != "dead"
                        and (w.killed_by_us or w.proc.poll() is not None)
                        for w in self._workers.values())
                else:
                    releasing = False
                    for c in gpus:
                        self._free_gpus.discard(c)
            for v in victims:
                try:
                    v.proc.kill()
                except OSError:
                    pass
            if gpus is not None or not releasing or \
                    time.time() > deadline or self._shutdown:
                return gpus
            time.sleep(0.05)

    def _maybe_refill_pool_locked(self) -> bool:
        """Keep the prestarted CPU pool full (reference:
        worker_pool.h:344 PrestartWorkers): spawn a replacement when a
        pool worker was converted to an actor or died."""
        n = len([x for x in self._workers.values()
                 if not x.dedicated and x.state != "dead"])
        return n < self._max_pool and not self._shutdown

    def _push_task(self, w: WorkerHandle, spec: TaskSpec):
        with self._lock:
            w.state = BUSY
            w.busy_since = time.time()
            w.current_tasks[spec.task_id.binary()] = spec
            if w.conn is None:
                w.pending_pushes.append(("run_task", spec))
                return
            conn = w.conn
        try:
            conn.notify("run_task", spec)
        except protocol.ConnectionClosed:
            self._on_worker_death(w)

    def _dispatch_queued(self):
        if not self._task_queue:
            # GIL-atomic emptiness peek: this runs after EVERY worker
            # registration / task completion / lease release, and taking
            # the NM lock just to learn the queue is empty convoys those
            # paths under churn. Enqueue+check is atomic under the lock
            # on the enqueueing side, so no wakeup can be lost.
            return
        while True:
            dispatch = None
            with self._lock:
                for i, spec in enumerate(self._task_queue):
                    if spec.resources.get(GPU, 0) > 0:
                        # GPU specs re-enter the gpu-assignment path;
                        # dispatch only when gpus exist (free or
                        # reclaimable from the parked pool) so a starved
                        # GPU spec never lands on a GPU-less CPU worker.
                        k = int(spec.resources[GPU])
                        avail = len(self._free_gpus) + sum(
                            len(x.gpu_ids)
                            for pool in self._gpu_idle.values()
                            for x in pool)
                        if avail >= k:
                            self._task_queue.pop(i)
                            dispatch = ("gpu", spec, None)
                            break
                    else:
                        w = self._pop_idle_locked()
                        if w is None:
                            continue
                        self._task_queue.pop(i)
                        dispatch = ("cpu", spec, w)
                        break
            if dispatch is None:
                # Queue still non-empty with nothing to run it on:
                # elastic growth (bounded by _pool_cap) instead of
                # waiting for a completion to free a worker.
                self._maybe_grow_pool()
                return
            kind, spec, w = dispatch
            if kind == "gpu":
                self._on_lease_task(spec)
            else:
                self._push_task(w, spec)

    def _on_create_actor(self, spec: ActorCreationSpec,
                         offthread: bool = False):
        from ray_tpu_torch._private import runtime_env as renv_mod

        aid_b = spec.actor_id.binary()
        with self._lock:
            # Mirror the GCS's acquisition (guarded: the runtime_env
            # branch re-enters off-thread).
            if aid_b not in self._res_held_actors:
                self._res_held_actors[aid_b] = dict(spec.resources)
                self._local_avail.subtract(spec.resources)
        env = dict((spec.runtime_env or {}).get("env_vars", {}))
        cwd, pypaths = None, []
        if renv_mod.needs_isolation(spec.runtime_env):
            if not offthread:
                # Package fetch uses the GCS conn; this handler runs ON
                # that conn's serve thread — hop off it first.
                threading.Thread(
                    target=self._on_create_actor, args=(spec, True),
                    daemon=True, name="rtpu-nm-renv").start()
                return
            try:
                cwd, pypaths, plugin_env = self._materialize_runtime_env(
                    spec.runtime_env)
                # Plugin-provided env vars; explicit env_vars win.
                env = {**plugin_env, **env}
            except Exception as e:
                self._release_actor_hold(aid_b)
                self.gcs.notify("actor_state", {
                    "actor_id": spec.actor_id.binary(), "state": "DEAD",
                    "creation_failed": True,
                    "error": f"runtime_env setup failed: {e}"})
                return
        gpus: List[int] = []
        k = int(spec.resources.get(GPU, 0))
        # Fast path: hand the actor a prestarted pool worker (CPU) or a
        # parked GPU-bound worker (GPU) instead of paying a cold
        # python+torch spawn (reference: PopWorker serves actor-creation
        # tasks from the pool, worker_pool.h:340).
        if cwd is None and not pypaths and not env:
            refill = False
            claimed = False
            notify_failed = False
            with self._lock:
                w = self._pop_gpu_idle_locked(k, None) if k > 0 \
                    else self._pop_idle_locked()
                if w is not None:
                    w.dedicated = True
                    w.state = ACTOR
                    w.actor_id = spec.actor_id.binary()
                    w.actor_spec = spec
                    self._actors[spec.actor_id.binary()] = w
                    conn = w.conn
                    # The create notify MUST be enqueued in this same
                    # critical section: the moment the _actors entry is
                    # visible with a live conn, a concurrent
                    # _on_submit_actor_task sends run_actor_task inline
                    # — outside the lock the create can lose that race
                    # and the worker executes a method on a
                    # not-yet-created actor (seen as a NoneType
                    # AttributeError under CPU contention). notify is a
                    # non-blocking queue append, safe under the lock
                    # (same rule as _on_register_worker's parked-push
                    # flush).
                    try:
                        conn.notify("create_actor", spec)
                    except protocol.ConnectionClosed:
                        notify_failed = True
                    refill = k == 0 and self._maybe_refill_pool_locked()
                elif k == 0:
                    # No idle worker: claim an unclaimed in-flight spawn
                    # (boot fill / pool refill) before herding a fresh
                    # process — the creation parks in pending_pushes and
                    # delivers at registration, pipelining actor churn
                    # with worker boot (the lease checkout's spare-spawn
                    # claim, applied to actors). Only SPARE spawns: ones
                    # the classic _task_queue counts on must reach the
                    # idle pool.
                    spare = [cand for cand in self._workers.values()
                             if cand.state == STARTING
                             and not cand.dedicated
                             and cand.lease_reply is None
                             and cand.leased_conn is None
                             and cand.actor_id is None]
                    if len(spare) > len(self._task_queue):
                        w2 = spare[0]
                        w2.dedicated = True
                        w2.state = ACTOR
                        w2.actor_id = spec.actor_id.binary()
                        w2.actor_spec = spec
                        self._actors[spec.actor_id.binary()] = w2
                        w2.pending_pushes.append(("create_actor", spec))
                        claimed = True
                        refill = self._maybe_refill_pool_locked()
            if claimed:
                if refill:
                    try:
                        self._spawn_worker()
                    except BaseException:
                        logger.exception("pool refill spawn failed")
                return
            if w is not None:
                if notify_failed:
                    self._on_worker_death(w)
                    return
                if refill:
                    try:
                        self._spawn_worker()
                    except BaseException:
                        logger.exception("pool refill spawn failed")
                return
        if k > 0:
            gpus = self._acquire_gpus(k)
            if gpus is None:
                # report failure back; GCS will keep it pending
                self._release_actor_hold(aid_b)
                self.gcs.notify("actor_state", {
                    "actor_id": spec.actor_id.binary(), "state": "DEAD",
                    "creation_failed": True,
                    "error": "GPUs unavailable"})
                return
        try:
            w = self._spawn_worker(dedicated=True, env_extra=env,
                                   gpu_ids=gpus, cwd=cwd,
                                   extra_pythonpath=pypaths)
        except BaseException as e:
            # Spawn failed after the ledger hold (and possibly gpus) were
            # acquired: release them — only a WorkerHandle-bound hold has
            # a death path to release it (r7 finding c) — and report the
            # creation failure so the GCS can retry elsewhere.
            with self._lock:
                for c in gpus:
                    self._free_gpus.add(c)
            self._release_actor_hold(aid_b)
            try:
                self.gcs.notify("actor_state", {
                    "actor_id": spec.actor_id.binary(), "state": "DEAD",
                    "creation_failed": True,
                    "error": f"worker spawn failed: {e}"})
            except Exception:
                pass
            return
        notify_failed = False
        with self._lock:
            if cwd is not None or pypaths:
                w.isolated = True
            w.state = ACTOR
            w.actor_id = spec.actor_id.binary()
            w.actor_spec = spec
            self._actors[spec.actor_id.binary()] = w
            if w.conn is not None:
                # The zygote-forked worker booted and REGISTERED before
                # this bind (registration already flushed its
                # pending_pushes — a push parked now would never be
                # delivered, leaving the actor's worker create-less
                # while inline run_actor_tasks reach it). Enqueue the
                # create directly; doing it in this critical section
                # keeps it ahead of any run_actor_task in the conn's
                # send order (same rule as the idle-conversion branch).
                try:
                    w.conn.notify("create_actor", spec)
                except protocol.ConnectionClosed:
                    notify_failed = True
            else:
                w.pending_pushes.append(("create_actor", spec))
        if notify_failed:
            self._on_worker_death(w)

    def _on_kill_actor(self, p):
        with self._lock:
            w = self._actors.get(p["actor_id"])
            if w is None:
                return
            w.killed_by_us = True
            w.no_restart_kill = p.get("no_restart", True)
        try:
            w.proc.kill()
        except Exception:
            pass

    def _on_cancel_task(self, p):
        tid = p["task_id"]
        with self._lock:
            target = None
            for w in self._workers.values():
                if tid in w.current_tasks:
                    target = w
                    break
            # also drop from the local queue, failing the dropped task's
            # returns so getters see TaskCancelledError
            dropped = [s for s in self._task_queue
                       if s.task_id.binary() == tid]
            self._task_queue = [s for s in self._task_queue
                                if s.task_id.binary() != tid]
        for s in dropped:
            objs = self._store_errors(
                [r.binary() for r in s.return_ids()],
                exceptions.TaskCancelledError(tid.hex()))
            self._report_task_done(tid, "error", objs, error="cancelled")
        if target is None:
            return
        if p.get("force"):
            try:
                target.proc.kill()
            except Exception:
                pass
        elif target.conn is not None:
            try:
                target.conn.notify("cancel_task", {"task_id": tid})
            except protocol.ConnectionClosed:
                pass

    def _refcount_delta(self, deps, delta: int) -> None:
        """Pin/unpin object deps under this NODE's refcount identity
        (dropped wholesale by the GCS if this node dies)."""
        if not deps:
            return
        try:
            self.gcs.notify("update_refcounts", {
                "client_id": f"node:{self.node_id[:12]}",
                "deltas": {d.binary(): delta for d in deps}})
        except Exception:
            pass

    def _on_submit_actor_task(self, spec: ActorTaskSpec):
        aid = spec.actor_id.binary()
        with self._lock:
            w = self._actors.get(aid)
            if w is not None and w.state != "dead":
                w.current_tasks[spec.task_id.binary()] = spec
                if w.conn is None:
                    # Parked until the actor's worker registers: pin the
                    # args under the NODE identity for the parked window
                    # (the worker pins on receive; the caller's pin was
                    # released at ack).
                    self._refcount_delta(pinned_deps(spec), +1)
                    w.pending_pushes.append(("run_actor_task", spec))
                    return
                conn = w.conn
            else:
                conn = None
        if conn is not None:
            try:
                conn.notify("run_actor_task", spec)
                return
            except protocol.ConnectionClosed:
                self._on_worker_death(w)
                return
        # Not hosted here (moved or dead): ask GCS to reroute.
        try:
            self.gcs.notify("reroute_actor_task", spec)
        except Exception:
            pass

    # ----------------------------------------------------- server messages

    def _handle_server(self, conn, mtype, payload, msg_id):
        try:
            if mtype == "register_worker":
                self._on_register_worker(conn, payload, msg_id)
            elif mtype == "task_done":
                self._on_task_done(conn, payload)
            elif mtype == "task_done_batch":
                self._on_task_done_batch(conn, payload)
            elif mtype == "actor_ready":
                self.gcs.notify("actor_state", {
                    "actor_id": payload["actor_id"], "state": "ALIVE"})
            elif mtype == "actor_failed":
                self.gcs.notify("actor_state", {
                    "actor_id": payload["actor_id"], "state": "DEAD",
                    "creation_failed": True, "error": payload.get("error")})
                self._release_actor_hold(payload["actor_id"])
                with self._lock:
                    w = self._actors.pop(payload["actor_id"], None)
                    if w is not None:
                        w.actor_id = None  # plain dead worker now
            elif mtype == "actor_exit":
                with self._lock:
                    w = self._actors.get(payload["actor_id"])
                    if w is not None:
                        w.killed_by_us = True
                        w.no_restart_kill = True
            elif mtype == "lease_worker":
                self._on_lease_worker(conn, payload, msg_id)
            elif mtype == protocol.REQUEST_LOCAL_LEASE:
                self._on_request_local_lease(conn, payload, msg_id)
            elif mtype == protocol.REQUEST_CREATE_ACTOR:
                # Off the serve thread: creation spawns a worker (zygote
                # fork) — inline it and a burst of creations serializes
                # behind one fork conversation per actor, stalling every
                # other message on this conn.
                self._actor_exec.submit(
                    self._request_create_actor_safe, conn, payload, msg_id)
            elif mtype == protocol.RETURN_LOCAL_LEASE:
                self._on_return_local_lease(conn, payload)
            elif mtype == "register_submit_ring":
                self._on_register_submit_ring(conn, payload, msg_id)
            elif mtype == protocol.REGISTER_COMPLETION_RING:
                self._on_register_completion_ring(conn, payload, msg_id)
            elif mtype == protocol.SCHEDULER_STATS:
                conn.reply(msg_id, self._scheduler_stats())
            elif mtype == "abandon_lease":
                self._on_abandon_lease(conn, payload)
            elif mtype == "kill_leased_worker":
                # Force-cancel of a running lease task: the classic path
                # kills the worker process (see _on_cancel_task force) —
                # same semantics here, holder-verified.
                with self._lock:
                    w_k = self._workers.get(payload.get("worker_id"))
                    if w_k is not None and w_k.leased_conn is not conn:
                        w_k = None
                if w_k is not None:
                    try:
                        w_k.proc.kill()
                    except Exception:
                        pass
            elif mtype == "return_leased_worker":
                # Explicit, authoritative return from the lease holder.
                with self._lock:
                    w_rel = self._workers.get(payload.get("worker_id"))
                    if w_rel is not None and w_rel.leased_conn is not conn:
                        w_rel = None   # not yours (stale / re-leased)
                if w_rel is not None:
                    self._release_leased_worker(w_rel)
            elif mtype == "lease_released":
                # From the leased worker itself: its last direct conn
                # closed. Honor it only when the holder is actually gone —
                # deliberate returns arrive as return_leased_worker, and a
                # stale notify must not free a re-leased worker under its
                # new holder (the caller-conn check is the guard).
                wid_rel = conn.meta.get("worker_id")
                with self._lock:
                    w_rel = self._workers.get(wid_rel)
                    if w_rel is not None and w_rel.leased_conn is not None \
                            and not w_rel.leased_conn.closed:
                        w_rel = None
                if w_rel is not None:
                    self._release_leased_worker(w_rel)
            elif mtype == "submit_actor_task":
                # Ack after the spec is parked with the actor's worker (or
                # handed to GCS for reroute) — from then on the worker-death
                # / reroute paths own failure handling. The driver reparks
                # and re-resolves if this ack never arrives.
                self._on_submit_actor_task(payload)
                conn.reply(msg_id, True)
            elif mtype == "fetch_object":
                self._on_fetch_object(conn, payload, msg_id)
            elif mtype == "fetch_object_chunk":
                self._on_fetch_object_chunk(conn, payload, msg_id)
            elif mtype == "restore_object":
                self._on_restore_object(conn, payload, msg_id)
            elif mtype == "spill_now":
                self._on_spill_now(conn, payload, msg_id)
            elif mtype == "store_stats":
                conn.reply(msg_id, self.store.stats())
            elif mtype == "task_events":
                # Workers mirror their task-event/span batches here so
                # the flight recorder holds this node's recent activity
                # (the GCS copy feeds the timeline; this one feeds
                # postmortems).
                self.agent.record_task_events(payload or [])
            elif mtype == "task_events_b":
                # Blob-framed variant: the worker ships ONE
                # pre-pickled batch; we unpickle for the local flight
                # recorder and relay the blob to the GCS timeline
                # verbatim — one worker _send serves both sinks.
                try:
                    events = pickle.loads(payload)
                except Exception:
                    events = []
                if events:
                    self.agent.record_task_events(events)
                    try:
                        self.gcs.notify("task_events_b", payload)
                    except Exception:
                        pass
            elif mtype == "worker_segment_attached":
                # Crash-cleanup registry for worker completion segment
                # files (see _on_server_disconnect).
                with self._lock:
                    self._worker_segments.setdefault(conn, set()).add(
                        payload["path"])
            elif mtype == "worker_segment_detached":
                with self._lock:
                    segs = self._worker_segments.get(conn)
                    if segs is not None:
                        segs.discard(payload["path"])
                        if not segs:
                            self._worker_segments.pop(conn, None)
            elif mtype in ("collect_stacks", "agent_logs",
                           "flight_snapshot", "flight_dump", "profile"):
                # The agent endpoint is also directly addressable on the
                # node (same transport the GCS fan-in uses).
                self._handle_agent(conn, mtype, payload, msg_id)
            else:
                conn.reply_error(msg_id, f"nm: unknown message {mtype}")
        except Exception as e:
            logger.exception("node manager server: error handling %s", mtype)
            try:
                conn.reply_error(msg_id, f"{type(e).__name__}: {e}")
            except Exception:
                pass

    def _on_register_worker(self, conn, p, msg_id):
        wid = p["worker_id"]
        lease_reply = None
        # Spawn-registration race: a zygote-forked child can boot and
        # dial back before the spawner thread re-takes the GIL to record
        # the WorkerHandle (parallel fork-servers made this window
        # real). This serve thread belongs to the registering worker's
        # own conn, so a short bounded wait blocks nobody else.
        deadline = time.time() + 5.0
        while True:
            with self._lock:
                w = self._workers.get(wid)
            if w is not None or time.time() >= deadline \
                    or self._shutdown:
                break
            time.sleep(0.002)
        with self._lock:
            w = self._workers.get(wid)
            if w is None:
                conn.reply_error(msg_id, "unknown worker")
                return
            if w.killed_by_us or w.proc.poll() is not None:
                # Raced the reaper (e.g. the hung-startup kill, which
                # also runs under this lock): the process is dead or
                # dying — never transition it to IDLE/LEASED or hand it
                # to a lease caller; the death path owns cleanup
                # (including erroring any parked lease_reply).
                reject = True
            else:
                reject = False
                w.conn = conn
                w.direct_address = p.get("direct_address")
                w.direct_address_ux = p.get("direct_address_ux")
                conn.meta["worker_id"] = wid
                pushes, w.pending_pushes = w.pending_pushes, []
                if w.state == STARTING:
                    if w.lease_reply is not None:
                        # Spawned to satisfy a pending lease: hand it to
                        # the waiting caller now that its direct address
                        # is known.
                        lease_reply, w.lease_reply = w.lease_reply, None
                        w.state = LEASED
                    elif w.dedicated:
                        w.state = BUSY
                    else:
                        w.state = IDLE
                        self._park_idle_locked(w)
                # Deliver parked pushes UNDER the lock, before any other
                # path can observe w.conn non-None: _on_submit_actor_task
                # sends inline the moment it sees a conn, and an inline
                # run_actor_task must never overtake the parked
                # create_actor on the same conn (the conn's writer
                # thread preserves _send call order; notify is a
                # non-blocking queue append, safe under the lock).
                push_fail = None
                for i, (mtype, payload) in enumerate(pushes):
                    try:
                        conn.notify(mtype, payload)
                    except protocol.ConnectionClosed:
                        push_fail = i
                        break
                    if mtype == "run_actor_task":
                        # Delivered: the worker's receive-time pin owns
                        # the args now; release the parked-window node
                        # pin.
                        self._refcount_delta(pinned_deps(payload), -1)
        if reject:
            try:
                conn.reply_error(msg_id, "worker was reaped at startup")
            except protocol.ConnectionClosed:
                pass
            return
        if push_fail is not None:
            # pending_pushes was already swapped out above, so the death
            # path can't see these: release the parked-window node pins
            # of every remaining undelivered run_actor_task here, or
            # they leak until node death.
            for fm, fp in pushes[push_fail:]:
                if fm == "run_actor_task":
                    self._refcount_delta(pinned_deps(fp), -1)
            self._on_worker_death(w)
            return
        conn.reply(msg_id, {"node_id": self.node_id})
        if lease_reply is not None:
            lconn, lmsg_id = lease_reply
            try:
                lconn.reply(lmsg_id, {"worker_id": wid,
                                      "direct_address": w.direct_address,
                                      "direct_address_ux":
                                          w.direct_address_ux,
                                      **(w.lease_grant or {})})
            except protocol.ConnectionClosed:
                self._release_leased_worker(w)
        self._dispatch_queued()

    def _on_lease_worker(self, conn, p, msg_id):
        """Check a pooled worker out to a caller's direct task transport
        (reference: raylet lease grant, node_manager.h:508). The GCS has
        already acquired the lease's resources; mirror that acquisition
        on the local ledger (so local grants can't double-book the
        capacity), then provide the process. Replies with the worker's
        own task-server address; if a fresh worker must spawn, the reply
        is deferred to registration."""
        res = dict(p.get("resources") or {})
        with self._lock:
            self._local_avail.subtract(res)
        attached = [False]
        try:
            self._checkout_worker(conn, p.get("lease_id"), msg_id,
                                  lease_resources=res, attached=attached)
        except BaseException:
            # If checkout never attached res to a WorkerHandle (spawn
            # failure), no death/return path will release it — undo the
            # mirror-subtract or the ledger leaks capacity on every
            # failed spawn. ``attached`` is set under the NM lock at the
            # moment of binding (NOT inferred after the fact — a
            # concurrent disconnect cleanup may already have released
            # and nulled the binding, and a second release here would
            # inflate the ledger into permanent oversubscription).
            if not attached[0]:
                with self._lock:
                    self._local_avail.release(res)
            raise   # generic handler replies error; caller falls back

    def _checkout_worker(self, conn, tag, msg_id,
                         grant_extra: Optional[dict] = None,
                         lease_resources: Optional[Dict[str, float]] = None,
                         attached: Optional[list] = None):
        """Hand an idle worker (or a fresh spawn, reply deferred to its
        registration) to a lease holder. ``attached`` (a one-element
        [False] list) flips True under the lock the moment
        ``lease_resources`` is bound to a WorkerHandle — from then on
        the worker's own cleanup paths own the release."""
        with self._lock:
            w = None
            while self._idle:
                cand = self._idle.pop()
                if cand.state == IDLE and cand.conn is not None \
                        and not cand.conn.closed \
                        and cand.direct_address is not None:
                    w = cand
                    break
            if w is not None:
                w.state = LEASED
                w.leased_conn = conn
                w.lease_tag = tag
                w.lease_resources = lease_resources
                w.busy_since = time.time()
                if attached is not None:
                    attached[0] = True
            else:
                # No idle worker — claim an unclaimed in-flight spawn
                # (boot fill / pool refill) before herding another
                # process (reference: worker_pool PopWorker reuses
                # starting workers). The reply defers to registration
                # exactly like a fresh spawn's. Only SPARE spawns are
                # claimable: ones the classic _task_queue is counting on
                # must register into the idle pool or a queued task
                # strands with nothing left to respawn for it.
                spare = [cand for cand in self._workers.values()
                         if cand.state == STARTING and not cand.dedicated
                         and cand.lease_reply is None
                         and cand.leased_conn is None
                         and cand.actor_id is None]
                if len(spare) > len(self._task_queue):
                    cand = spare[0]
                    cand.lease_reply = (conn, msg_id)
                    cand.leased_conn = conn
                    cand.lease_tag = tag
                    cand.lease_grant = grant_extra
                    cand.lease_resources = lease_resources
                    cand.busy_since = time.time()
                    if attached is not None:
                        attached[0] = True
                    return
        if w is not None:
            conn.reply(msg_id, {"worker_id": w.worker_id,
                                "direct_address": w.direct_address,
                                "direct_address_ux": w.direct_address_ux,
                                **(grant_extra or {})})
            return
        w = self._spawn_worker()
        with self._lock:
            w.lease_reply = (conn, msg_id)
            w.leased_conn = conn
            w.lease_tag = tag
            w.lease_grant = grant_extra
            w.lease_resources = lease_resources
            w.busy_since = time.time()
            if attached is not None:
                attached[0] = True

    # ------------------------------------------------- local-first scheduler
    # (reference: raylet/scheduling/policy/hybrid_scheduling_policy.h:50 —
    # grant on the caller's own node while resources fit; spill back to
    # the central scheduler otherwise. The GCS learns of local grants
    # asynchronously: the ``local_held`` aggregate rides heartbeats, with
    # an eager push on every grant/release so central placement and
    # fairness never run more than one notify behind.)

    _demand_overlaps = staticmethod(demand_overlaps)

    def _release_actor_hold(self, aid: bytes) -> None:
        push = False
        with self._lock:
            held = self._res_held_actors.pop(aid, None)
            if held:
                self._local_avail.release(held)
            if aid in self._local_actor_ids:
                # Locally-placed actor: its shape also rides the
                # local_held aggregate — return it there too, or the GCS
                # subtracts phantom holds forever.
                self._local_actor_ids.discard(aid)
                if held:
                    self._local_held.subtract(held)
                    self._local_held_seq += 1
                    push = True
        if push:
            self._push_resource_report()

    def _on_request_local_lease(self, conn, p, msg_id):
        """Grant (or decline) a worker lease from the local free-resource
        ledger — worker checkout, resource accounting, and lease-id
        issuance all happen here without touching the GCS lock. A None
        reply is spillback: the caller falls back to the GCS-brokered
        path (insufficient local capacity, GPU shapes whose gpu binding
        happens at spawn, or a classic-queue fairness backoff)."""
        res = dict(p["resources"])
        now = time.time()
        with self._lock:
            granted = (
                not self._shutdown
                and not res.get(GPU)
                and not (now < self._local_backoff_until
                         and any(self._demand_overlaps(d, res)
                                 for d in self._local_backoff_demands))
                and self._local_avail.acquire(res)
            )
            if granted:
                lease_id = b"nml:" + os.urandom(12)
                self._local_held.add(res)
                self._local_held_seq += 1
                self._local_grants[lease_id] = {
                    "resources": res, "conn": conn,
                    "client_id": p.get("client_id", "")}
                self.local_grants_total += 1
            else:
                self.local_spillbacks_total += 1
        if not granted:
            conn.reply(msg_id, None)
            return
        self._push_resource_report()
        try:
            self._checkout_worker(conn, lease_id, msg_id,
                                  grant_extra={"lease_id": lease_id,
                                               "node_id": self.node_id})
        except BaseException:
            # Checkout failed (e.g. spawn OSError) AFTER the grant was
            # recorded: the caller never learns the lease_id, so it can
            # never return it — release here or the capacity is gone
            # from both schedulers for the life of the caller's conn.
            self._release_local_grant(lease_id)
            try:
                conn.reply(msg_id, None)   # decline -> caller spills back
            except Exception:
                pass

    def _request_create_actor_safe(self, conn, spec: ActorCreationSpec,
                                   msg_id):
        """Executor-side guard: an unexpected raise must still resolve
        the driver's grant future (reply_error -> classic spillback) and
        release a recorded grant, or the driver parks forever and the
        ledger leaks the shape."""
        try:
            self._on_request_create_actor(conn, spec, msg_id)
        except Exception as e:
            logger.exception("request_create_actor failed")
            aid = spec.actor_id.binary()
            self._release_actor_hold(aid)
            try:
                # If the placement report already went out, bury the
                # actor so the driver's re-create lands on a DEAD entry
                # (which the GCS create handler replaces).
                self.gcs.notify("actor_state", {
                    "actor_id": aid, "state": "DEAD",
                    "creation_failed": True,
                    "error": f"local creation failed: {e}"})
            except Exception:
                pass
            try:
                conn.reply_error(msg_id, f"{type(e).__name__}: {e}")
            except protocol.ConnectionClosed:
                pass

    def _on_request_create_actor(self, conn, spec: ActorCreationSpec,
                                 msg_id):
        """Decentralized actor creation (the actor analog of
        request_local_lease — reference: the hybrid policy's bottom-up
        placement, raylet/scheduling/policy/hybrid_scheduling_policy.h):
        place the actor from the LOCAL free-resource ledger without ever
        taking a GCS lock on the happy path. On grant: the shape joins
        the local_held aggregate (seq-versioned heartbeat reports carry
        it, exactly like lease grants), the GCS learns of the placement
        via an async ``actor_placed`` notify — sent on the NM's GCS conn
        BEFORE any later actor_state for this actor, so same-conn FIFO
        gives the GCS creation-before-lifecycle ordering — and the
        worker spawns through the normal create path (pool conversion /
        zygote fork). A None reply is spillback: the driver falls back
        to the classic GCS-scheduled creation.

        The grant reply is sent only AFTER _on_create_actor bound the
        actor to a worker handle, so a submit_actor_task racing the
        reply always finds the actor registered here."""
        from ray_tpu_torch._private import runtime_env as renv_mod

        res = dict(spec.resources or {})
        aid = spec.actor_id.binary()
        now = time.time()
        with self._lock:
            granted = (
                not self._shutdown
                and not res.get(GPU)
                # Isolated runtime_envs materialize off-thread; keep the
                # reply-after-registration invariant by spilling back.
                and not renv_mod.needs_isolation(spec.runtime_env)
                and not (now < self._local_backoff_until
                         and any(self._demand_overlaps(d, res)
                                 for d in self._local_backoff_demands))
                and self._local_avail.acquire(res)
            )
            if granted:
                # Custody passes to the actor registries: the death /
                # creation-failure paths release both holds.
                self._res_held_actors[aid] = res
                self._local_actor_ids.add(aid)
                self._local_held.add(res)
                self._local_held_seq += 1
                self.local_actor_grants_total += 1
                held = self._local_held.to_dict()
                held_seq = self._local_held_seq
            else:
                self.local_actor_spillbacks_total += 1
        if not granted:
            conn.reply(msg_id, None)
            return
        try:
            # The placement report doubles as the eager resource report:
            # the local_held aggregate rides in the same notify (one GCS
            # send per creation, not two; seq-guarded like heartbeats).
            self.gcs.notify(protocol.ACTOR_PLACED, {
                "spec": spec, "node_id": self.node_id,
                "local_held": held, "local_held_seq": held_seq})
        except Exception:
            pass   # GCS redialing: the rejoin re-report covers live actors
        self._on_create_actor(spec)
        conn.reply(msg_id, {"node_id": self.node_id,
                            "address": self.address})

    def _release_local_grant(self, lease_id) -> bool:
        if lease_id is None:
            return False
        with self._lock:
            g = self._local_grants.pop(lease_id, None)
            if g is None:
                return False
            self._local_avail.release(g["resources"])
            self._local_held.subtract(g["resources"])
            self._local_held_seq += 1
        self._push_resource_report()
        return True

    def _on_return_local_lease(self, conn, p):
        """Holder returns a locally-granted lease (deliberate return,
        revocation drain, or abandonment of a worker it never dialed)."""
        lid = p.get("lease_id")
        self._release_local_grant(lid)
        wid = p.get("worker_id")
        with self._lock:
            w = self._workers.get(wid) if wid else None
            if w is not None and w.leased_conn is not conn:
                w = None   # not yours (stale / re-leased)
            if w is None and lid is not None:
                # Worker still spawning for this lease: detach it so
                # registration routes it to the idle pool instead.
                w2 = next((x for x in self._workers.values()
                           if x.lease_tag == lid), None)
                if w2 is not None and w2.state == STARTING \
                        and w2.lease_reply is not None:
                    w2.lease_reply = None
                    w2.leased_conn = None
                    w2.lease_tag = None
                    w2.lease_grant = None
        if w is not None:
            self._release_leased_worker(w)

    # ------------------------------------------------- shm submit rings

    _RING_RELAY_CHUNK = 256

    def _on_register_submit_ring(self, conn, p, msg_id):
        """A same-node driver published a submit ring file: map it,
        own its doorbell, and start one drain thread that relays record
        blobs to the GCS as submit_task_batch frames (no unpickle here —
        the relay is a byte pump)."""
        from ray_tpu_torch._private import submit_ring

        if self._shutdown:
            conn.reply(msg_id, False)
            return
        try:
            reader = submit_ring.RingReader(p["path"])
        except Exception as e:
            logger.warning("submit ring %s rejected: %s", p.get("path"), e)
            conn.reply(msg_id, False)
            return
        ent = {"reader": reader, "stop": False,
               "client_id": p.get("client_id")}
        t = threading.Thread(target=self._submit_ring_loop, args=(ent,),
                             daemon=True, name="rtpu-nm-subring")
        ent["thread"] = t
        with self._lock:
            self._submit_rings.setdefault(conn, []).append(ent)
        t.start()
        conn.reply(msg_id, True)

    def _submit_ring_loop(self, ent: dict):
        """Drain thread: beat the liveness heartbeat, relay pending
        records, park on the doorbell when idle. The consumer head
        advances only AFTER the GCS relay call returns (at-least-once;
        the GCS batch handler dedups on task id)."""
        reader = ent["reader"]
        pending = None   # (blobs, new_head, seq): one batch pinned
        try:
            while not ent["stop"] and not self._shutdown:
                reader.beat()
                if pending is not None:
                    blobs, new_head, seq = pending
                else:
                    blobs, new_head = reader.drain(self._RING_RELAY_CHUNK)
                    seq = None
                if blobs:
                    if seq is None:
                        ent["seq"] = seq = ent.get("seq", 0) + 1
                        # Pin the batch: a retry must resend EXACTLY
                        # these records under this seq — a regrown
                        # drain under a reused seq would get its new
                        # records dropped by the GCS's seq dedup.
                        pending = (blobs, new_head, seq)
                    try:
                        # Request, not notify: a fire-and-forget frame
                        # only ENQUEUES on the NM->GCS conn, and
                        # committing on that would lose queued-but-
                        # unflushed records if this NM dies. The GCS
                        # handler ACKs after the batch is enqueued. The
                        # timeout is SHORT so this thread's liveness
                        # beat never starves past the driver's ring
                        # staleness budget (lease._RING_STALE_S); a
                        # timed-out-but-landed batch is retried with the
                        # SAME (src, seq), which the GCS drops exactly.
                        self.gcs.request(
                            "submit_task_batch",
                            {"blobs": blobs, "src": reader.path,
                             "seq": seq},
                            timeout=2.0)
                    except Exception:
                        # GCS conn mid-redial / timed out: keep the
                        # pinned batch (head not committed), re-beat,
                        # and retry the same (src, seq).
                        reader.beat()
                        time.sleep(0.2)
                        continue
                    pending = None
                    reader.commit(new_head)
                    continue
                if reader.producer_closed():
                    break
                reader.park_wait()
        finally:
            try:
                reader.close()
            except Exception:
                pass

    # Matches lease._RING_STALE_S rationale: comfortably above any
    # bounded stall of the driver's consumer thread, so a healthy-but-
    # busy driver can never look dead.
    _COMP_RING_STALE_S = 5.0

    def _on_register_completion_ring(self, conn, p: dict, msg_id):
        """A same-node driver created a completion ring file and asks
        us to produce into it. The driver owns the file and the
        doorbell; we just map it and append."""
        from ray_tpu_torch._private import completion_ring

        if self._shutdown:
            conn.reply(msg_id, False)
            return
        try:
            producer = completion_ring.RingProducer(p["path"])
            producer.connect_bell()
        except Exception as e:
            logger.warning("completion ring %s rejected: %s",
                           p.get("path"), e)
            conn.reply(msg_id, False)
            return
        ent = {"producer": producer, "client_id": p.get("client_id")}
        with self._lock:
            self._completion_rings.setdefault(conn, []).append(ent)
        conn.reply(msg_id, True)

    def _relay_completion_rings(self, blobs: List[bytes]):
        """Append worker completion-record blobs to every registered
        same-node driver ring, WITHOUT unpickling them. Records carry
        no destination, so this is a broadcast — safe because driver-
        side absorption is redelivery- and foreign-record-idempotent
        (an LRU-bounded inline insert, a no-op pending pop). Ring-full
        skips the rest of the batch for that ring: the unconditional
        GCS relay is the authoritative copy, the ring only a fast-path
        hint. A full ring whose consumer heartbeat is stale means the
        driver died without its conn closing — tear the ring down."""
        with self._lock:
            ents = [(conn, e) for conn, lst in self._completion_rings.items()
                    for e in lst]
        if not ents:
            return
        dead = []
        for conn, ent in ents:
            producer = ent["producer"]
            # One batched append per relay: single tail publish, at
            # most one doorbell for the whole batch (a parked driver
            # used to eat one bell write per record).
            appended = producer.append_batch(blobs)
            if appended < len(blobs):
                try:
                    _comp_ring_full_counter().inc(len(blobs) - appended)
                except Exception:
                    pass
                if producer.consumer_stale(self._COMP_RING_STALE_S):
                    dead.append((conn, ent))
        for conn, ent in dead:
            try:
                ent["producer"].close()
            except Exception:
                pass
            with self._lock:
                lst = self._completion_rings.get(conn)
                if lst is not None and ent in lst:
                    lst.remove(ent)
                    if not lst:
                        self._completion_rings.pop(conn, None)

    def _on_revoke_local_lease(self, p):
        """GCS fairness signal: classic-queue work competing with
        locally-held resources can't place anywhere. Decline overlapping
        local grants for a backoff window and ask one holder to drain
        its lease (it returns via return_local_lease; the freed capacity
        reaches the GCS on the eager resource report)."""
        demands = [dict(d) for d in p.get("demands") or []]
        target = None
        with self._lock:
            self._local_backoff_until = time.time() + float(
                config.local_lease_backoff_s)
            self._local_backoff_demands = demands
            for lid, g in self._local_grants.items():
                if any(self._demand_overlaps(d, g["resources"])
                       for d in demands):
                    target = (lid, g["conn"])
                    break
        if target is not None:
            lid, holder = target
            try:
                holder.notify(protocol.REVOKE_LEASE, {"lease_id": lid})
            except protocol.ConnectionClosed:
                pass

    def _push_resource_report(self):
        """Eagerly ship the local-grant aggregate to the GCS (the
        periodic heartbeat is the batched carrier; grant/release edges
        push immediately so spillback scheduling sees fresh capacity).
        The seq lets the GCS drop reports that arrive out of order."""
        with self._lock:
            held = self._local_held.to_dict()
            seq = self._local_held_seq
        try:
            self.gcs.notify("heartbeat", {
                "node_id": self.node_id, "local_held": held,
                "local_held_seq": seq})
        except Exception:
            pass

    def _scheduler_stats(self) -> dict:
        with self._lock:
            return {
                "local_grants_total": self.local_grants_total,
                "local_spillbacks_total": self.local_spillbacks_total,
                "local_grants_open": len(self._local_grants),
                "local_actor_grants_total": self.local_actor_grants_total,
                "local_actor_spillbacks_total":
                    self.local_actor_spillbacks_total,
                "local_actors_open": len(self._local_actor_ids),
                "local_held": self._local_held.to_dict(),
                "local_available": self._local_avail.to_dict(),
            }

    def _on_abandon_lease(self, conn, p):
        """The caller gave up on a lease (grant timeout / connect failure)
        and already returned it to the GCS: reclaim the worker so it is
        not stranded in LEASED with nobody ever dialing it."""
        tag = p.get("lease_id")
        if tag is None:
            return
        with self._lock:
            w = next((x for x in self._workers.values()
                      if x.lease_tag == tag), None)
            if w is None:
                return
            if w.state == STARTING and w.lease_reply is not None:
                # Not yet registered: registration will route it to the
                # idle pool instead of the (gone) lease caller.
                w.lease_reply = None
                w.leased_conn = None
                w.lease_tag = None
                w.lease_grant = None
                res, w.lease_resources = w.lease_resources, None
                if res:
                    self._local_avail.release(res)
                return
        self._release_leased_worker(w)

    def _release_leased_worker(self, w: WorkerHandle):
        with self._lock:
            if w.state != LEASED or w.worker_id not in self._workers:
                return
            tag = w.lease_tag
            res, w.lease_resources = w.lease_resources, None
            if res:
                self._local_avail.release(res)
            w.state = IDLE
            w.leased_conn = None
            w.lease_tag = None
            w.lease_grant = None
            self._park_idle_locked(w)
        self._release_local_grant(tag)
        self._dispatch_queued()

    def _park_idle_locked(self, w: WorkerHandle) -> None:
        """Return a CPU pool worker to the idle list (caller holds the
        lock). idle_since feeds the elastic-pool reaper: idle workers
        above the base pool retire after worker_idle_timeout_s."""
        w.idle_since = time.time()
        self._idle.append(w)

    def _release_worker_after_tasks_locked(self, w: WorkerHandle,
                                           conn) -> None:
        """Shared tail of task_done / task_done_batch: once the worker's
        current_tasks drained, park it (CPU pool / GPU shape pool) or
        retire a one-shot dedicated worker. Caller holds the lock."""
        release_worker = (w.state == BUSY and not w.current_tasks)
        if release_worker and not w.dedicated:
            w.state = IDLE
            self._park_idle_locked(w)
        if release_worker and w.dedicated and w.actor_id is None:
            if w.gpu_ids and not w.isolated and not self._shutdown:
                # Park the GPU-bound worker for same-shape reuse:
                # the next GPU task of this shape skips the
                # multi-second fresh-spawn + CUDA context init.
                w.state = IDLE
                w.gpu_idle_since = time.time()
                self._gpu_idle.setdefault(
                    (len(w.gpu_ids), w.env_key), []).append(w)
            else:
                # one-shot dedicated worker (runtime_env): retire it
                for gpu in w.gpu_ids:
                    self._free_gpus.add(gpu)
                w.gpu_ids = []
                try:
                    conn.notify("exit")
                except protocol.ConnectionClosed:
                    pass

    def _on_task_done(self, conn, p):
        wid = conn.meta.get("worker_id")
        with self._lock:
            w = self._workers.get(wid)
            if w is None:
                return
            w.current_tasks.pop(p["task_id"], None)
            self._release_worker_after_tasks_locked(w, conn)
        self._report_task_done(p["task_id"], p["status"], p.get("objects"),
                               error=p.get("error"),
                               inline=p.get("inline"))
        self._dispatch_queued()

    def _on_task_done_batch(self, conn, payload):
        """Batched completion frame from a worker: (task_id, blob)
        pairs. The task ids ride OUTSIDE the blobs, so the worker/ledger
        bookkeeping happens here while the records relay to the GCS
        WITHOUT unpickling (mirroring the submit-ring relay — the GCS
        handler is the first decode)."""
        wid = conn.meta.get("worker_id")
        with self._lock:
            w = self._workers.get(wid)
            if w is None:
                return
            for tid, _blob in payload:
                w.current_tasks.pop(tid, None)
            self._release_worker_after_tasks_locked(w, conn)
            for tid, _blob in payload:
                held = self._res_held_tasks.pop(tid, None)
                if held:
                    self._local_avail.release(held)
        blobs = [b for _tid, b in payload]
        # Same-node driver fast path FIRST (SCALE_r10 stage 2): a
        # memcpy into each registered completion ring, still without
        # unpickling. The GCS relay below stays unconditional — it is
        # the authoritative copy; the ring only shortcuts the driver's
        # next get()/wait().
        if self._completion_rings:
            try:
                self._relay_completion_rings(blobs)
            except Exception:
                pass
        try:
            self.gcs.notify("task_done_batch", {
                "node_id": self.node_id, "blobs": blobs})
        except Exception:
            pass
        self._dispatch_queued()

    def _on_fetch_object(self, conn, p, msg_id):
        """Serve a cross-node object pull (reference: object_manager Push,
        protobuf/object_manager.proto:63; chunking elided — one framed blob).
        Falls through to spill storage for objects this node spilled."""
        oid = p["object_id"]
        view = self.store.get_buffer(oid, timeout_ms=p.get(
            "timeout_ms", 5000) if not self._spilled_url(oid) else 0)
        if view is None:
            url = self._spilled_url(oid)
            if url is not None:
                try:
                    conn.reply(msg_id, self.external_storage.restore(url))
                except OSError:
                    conn.reply(msg_id, None)
                return
            conn.reply(msg_id, None)
            return
        try:
            data = bytes(view)
        finally:
            del view
            self.store.release(oid)
        conn.reply(msg_id, data)

    def _on_fetch_object_chunk(self, conn, p, msg_id):
        """Serve one chunk of a cross-node pull (reference: 5 MiB chunked
        object-manager Push, ray_config_def.h:332 + object_manager.proto).
        Stateless per chunk: the puller drives offsets with a bounded
        in-flight window, so neither side ever materializes the whole
        object on its heap. Every reply carries the total size (the first
        chunk doubles as the metadata round trip). Falls through to
        range-reads of spill storage for objects this node spilled."""
        oid = p["object_id"]
        offset, length = p["offset"], p["length"]
        view = self.store.get_buffer(oid, timeout_ms=p.get(
            "timeout_ms", 5000) if not self._spilled_url(oid) else 0)
        if view is None:
            url = self._spilled_url(oid)
            if url is not None:
                try:
                    conn.reply(msg_id, {
                        "size": self.external_storage.size(url),
                        "data": self.external_storage.restore_range(
                            url, offset, length),
                    })
                except OSError:
                    conn.reply(msg_id, None)
                return
            conn.reply(msg_id, None)
            return
        try:
            reply = {"size": len(view),
                     "data": bytes(view[offset:offset + length])}
        finally:
            del view
            self.store.release(oid)
        conn.reply(msg_id, reply)

    # ------------------------------------------------------------- spilling

    def _spilled_url(self, oid: bytes):
        with self._spill_lock:
            return self._spilled.get(oid)

    def _on_restore_object(self, conn, p, msg_id):
        """Restore a spilled object into the local shared store (the local
        analog of the reference's restore-spilled-object raylet RPC)."""
        oid = p["object_id"]
        if self.store.contains(oid):
            conn.reply(msg_id, True)
            return
        url = self._spilled_url(oid)
        if url is None:
            conn.reply(msg_id, False)
            return
        try:
            data = self.external_storage.restore(url)
        except OSError:
            conn.reply(msg_id, False)
            return
        try:
            buf = self.store.create(oid, len(data))
            buf[:] = data
            self.store.seal(oid)
        except plasma.ObjectExistsError:
            pass
        conn.reply(msg_id, True)

    def _spill_loop(self):
        """Spill LRU objects to disk under memory pressure (reference:
        LocalObjectManager::SpillObjectsOfSize; threshold semantics from
        ray_config_def.h object_spilling_threshold)."""
        high = float(config.object_spilling_threshold)
        if high <= 0:  # spilling disabled (store falls back to eviction)
            return
        low = max(0.0, high - 0.2)
        while not self._shutdown:
            time.sleep(0.5)
            try:
                st = self.store.stats()
                cap = st["capacity_bytes"] or 1
                if st["used_bytes"] / cap < high:
                    continue
                for oid in self.store.list_objects():
                    if self._shutdown or \
                            self.store.stats()["used_bytes"] / cap < low:
                        break
                    self._spill_one(oid)
            except Exception:
                logger.exception("spill cycle failed")

    def _spill_one(self, oid: bytes) -> int:
        """Spill one sealed object; returns bytes freed (0 if skipped)."""
        if self._spilled_url(oid) is not None:
            # Already on disk (a restored copy): dropping the in-memory
            # copy frees space without re-writing the spill file.
            view = self.store.get_buffer(oid, timeout_ms=0)
            if view is None:
                return 0
            size = len(view)
            del view
            self.store.release(oid)
            return size if self.store.delete(oid) else 0
        view = self.store.get_buffer(oid, timeout_ms=0)
        if view is None:
            return 0
        try:
            data = bytes(view)
        finally:
            del view
            self.store.release(oid)
        url = self.external_storage.spill(oid, data)
        with self._spill_lock:
            self._spilled[oid] = url
        # A pinned object (reader holds a view) can't be deleted — the
        # disk copy is still valid, but no memory was freed, so report 0
        # or backpressure retries would spin against an unchanged arena.
        freed = len(data) if self.store.delete(oid) else 0
        try:
            self.gcs.notify("object_spilled", {
                "node_id": self.node_id, "object_id": oid, "url": url})
        except protocol.ConnectionClosed:
            pass
        logger.info("spilled object %s (%d bytes, freed %d)",
                    oid.hex()[:16], len(data), freed)
        return freed

    def _spill_bytes(self, target: int) -> int:
        freed = 0
        try:
            for oid in self.store.list_objects():
                if freed >= target or self._shutdown:
                    break
                freed += self._spill_one(oid)
        except OSError:
            pass
        return freed

    def _on_spill_now(self, conn, p, msg_id):
        """Synchronous spill on create-pressure (reference: plasma
        CreateRequestQueue retry-after-spill). Frees at least ``needed``
        bytes if possible; returns bytes freed."""
        needed = int(p.get("needed", 0)) or (64 << 20)
        conn.reply(msg_id, self._spill_bytes(needed * 2))
