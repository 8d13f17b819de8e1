"""Caller-side direct task transport: worker-lease management.

Role-equivalent to the reference's direct task submitter (reference:
src/ray/core_worker/transport/direct_task_transport.h:75 — lease reuse,
:307 — pipelined pushes to leased workers; leases granted by the raylet,
node_manager.h:508). The hot path after the first lease of a scheduling
shape is caller -> worker -> caller: no GCS scheduler, no node manager.

Division of labor per task:
- submit:   spec streams over a persistent conn straight to the leased
            worker (pipelined up to ``lease_pipeline_depth``).
- complete: the worker replies directly; the caller wakes local getters
            immediately and batch-reports {locations, lineage spec} to
            the GCS every ``lease_report_flush_ms`` (so other clients'
            get/wait and reconstruction still work, amortized).
- pinning:  arg deps are increffed locally for the task's flight time —
            by the time a net-zero delta could reach the GCS, the worker
            has already read the args, so premature frees are impossible.
- failure:  any transport error (worker/node death) falls the spec back
            to the classic GCS-scheduled path, which owns the retry
            budget and lineage; nothing is silently dropped.

Scale-out: while a shape's queue is non-empty the manager keeps
requesting more leases (bounded by ``lease_max_workers_per_shape`` and
cluster capacity), so bursts fan out across workers exactly like the
scheduled path — each additional worker costs one lease round trip,
amortized over every subsequent task it runs.
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
import pickle
import threading
import time
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private.spec_template import invalidate_wire, spec_wire
from ray_tpu_torch._private.task_spec import pinned_deps

if TYPE_CHECKING:
    from ray_tpu_torch._private.worker import CoreWorker

GPU = "GPU"

# Bound on the dial of a leased worker. Its node manager hands a worker out
# only once it listens, so a refused dial means it died after the grant;
# ``protocol.connect``'s 30 s default held every spec queued for the shape
# that long before they fell back to the scheduled path.
DIRECT_DIAL_S = 5.0

# Lease-grant latency by source ("local" = granted by the caller's own node
# manager without touching the GCS; "gcs" = the central spillback path).
_grant_latency = None
_grant_latency_lock = threading.Lock()

# Driver submit pipeline metrics (batched framing + shm ring): created
# lazily like the grant-latency histogram so importing this module never
# spins a reporter.
_submit_metrics = None
_submit_metrics_lock = threading.Lock()


def _submit_metrics_get():
    global _submit_metrics
    if _submit_metrics is None:
        with _submit_metrics_lock:
            if _submit_metrics is None:
                from ray_tpu_torch.util import metrics

                _submit_metrics = (
                    metrics.Counter(
                        "driver_submit_batches_total",
                        "Multi-spec submit frames shipped by the driver "
                        "(tag path: gcs=classic submit_task_batch, "
                        "lease=lease_run_tasks_b)",
                        tag_keys=("path",)),
                    metrics.Histogram(
                        "driver_submit_batch_size",
                        "Specs per driver submit batch frame",
                        boundaries=[1, 2, 4, 8, 16, 32, 64, 128, 256, 512],
                        tag_keys=("path",)),
                    metrics.Counter(
                        "driver_submit_ring_full_total",
                        "Submissions that found the shm submit ring full "
                        "and fell back to the socket batch path"),
                )
                metrics.start_reporter()
    return _submit_metrics


# Driver completion-ingestion metrics (SCALE_r10 absorb split): lazy
# like the submit-pipeline family above.
_completion_metrics = None
_completion_metrics_lock = threading.Lock()


def _completion_metrics_get():
    global _completion_metrics
    if _completion_metrics is None:
        with _completion_metrics_lock:
            if _completion_metrics is None:
                from ray_tpu_torch.util import metrics

                _completion_metrics = (
                    metrics.Gauge(
                        "driver_completion_absorb_depth",
                        "Completion frames parked in the driver's ingest "
                        "queue awaiting absorption (sampled by the absorb "
                        "drain)"),
                    metrics.Histogram(
                        "driver_completion_batch_size",
                        "Completion records per driver-ingested lease "
                        "completion frame",
                        boundaries=[1, 2, 4, 8, 16, 32, 64, 128, 256, 512]),
                )
                metrics.start_reporter()
    return _completion_metrics


def _grant_latency_hist():
    global _grant_latency
    if _grant_latency is None:
        with _grant_latency_lock:
            if _grant_latency is None:
                from ray_tpu_torch.util import metrics

                _grant_latency = metrics.Histogram(
                    "scheduler_lease_grant_latency_seconds",
                    "Worker-lease grant latency (request to usable lease)",
                    boundaries=[0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                                0.05, 0.1, 0.25, 0.5, 1.0, 2.5],
                    tag_keys=("source",))
                # Ship the histogram to the GCS metrics table (and from
                # there the dashboard's Prometheus /metrics): the process
                # that grants leases starts the push loop once.
                metrics.start_reporter()
    return _grant_latency


class _Lease:
    __slots__ = ("lease_id", "worker_id", "conn", "node_id", "nm_address",
                 "inflight", "idle_since", "dead", "shape_key", "pending",
                 "draining", "local")

    def __init__(self, lease_id, worker_id, conn, node_id, nm_address,
                 shape_key, local=False):
        self.lease_id = lease_id
        self.worker_id = worker_id
        self.conn = conn
        self.node_id = node_id
        self.nm_address = nm_address
        self.shape_key = shape_key
        self.local = local      # granted by the local NM, not the GCS
        self.inflight = 0
        self.idle_since: Optional[float] = time.monotonic()
        self.dead = False
        self.draining = False   # revoked: finish in-flight batch, then drop
        self.pending: Dict[bytes, Any] = {}   # task_id -> spec, in flight


class _ShapeState:
    __slots__ = ("leases", "queue", "requesting", "denied_until")

    def __init__(self):
        self.leases: List[_Lease] = []
        self.queue: collections.deque = collections.deque()
        self.requesting = 0
        self.denied_until = 0.0   # backoff after a capacity denial


class LeaseManager:
    """Per-CoreWorker lease table + direct submission engine."""

    def __init__(self, worker: "CoreWorker"):
        from ray_tpu_torch._private.config import config

        self._w = worker
        self._lock = threading.Lock()
        self._shapes: Dict[tuple, _ShapeState] = {}
        # id(resources dict) -> (dict ref, sorted shape key); see submit.
        self._shape_keys: Dict[int, Tuple[Dict[str, float], tuple]] = {}
        # Burst coalescing: reserved-but-unsent specs per lease. A burst
        # of submits to a busy lease batches into one notify (flushed at
        # _SEND_BATCH, on completions, on get()/wait() entry via
        # flush_sends, and by the flush loop); the FIRST task on an idle
        # lease always ships immediately so a lone submit never waits.
        self._sendbuf: Dict[_Lease, List[Any]] = {}
        # oid bytes -> {"ev": Event, "info": (node_id, nm_addr, size)|None}
        self._inflight: Dict[bytes, Dict[str, Any]] = {}
        self._task_lease: Dict[bytes, Tuple[_Lease, Any]] = {}
        self._cancelled: set = set()   # force-cancelled tids: never resubmit
        # worker_id -> system kill reason (e.g. OOM), pushed by the NM just
        # before it kills a leased worker; consumed by the failure path.
        self._kill_reasons: Dict[bytes, str] = {}
        self._reports: List[dict] = []
        self._depth = max(1, int(config.lease_pipeline_depth))
        self._max_per_shape = max(1, int(config.lease_max_workers_per_shape))
        self._idle_timeout = float(config.lease_idle_timeout_s)
        self._flush_s = max(0.01, config.lease_report_flush_ms / 1000.0)
        self._worker_timeout = float(config.worker_start_timeout_s) + 10.0
        self._bulk_conn = None   # lazy second GCS conn for fallback waves
        self._closed = False
        # Batched submit framing (SCALE_r08 stage 2): classic-path
        # dep-free specs coalesce here as PRE-PICKLED blobs and ship as
        # one submit_task_batch frame per _CLASSIC_BATCH (or on
        # get()/wait() entry / the flush loop); the lease dispatch path
        # ships lease_run_tasks_b blob batches the same way.
        self._batch_frames = bool(config.submit_batch_frames_enabled)
        self._classic_buf: List[bytes] = []
        # Deferred blob-route submissions: the caller thread appends
        # (template, tid, args, t) tuples — the absolute minimum — and
        # the lease executor patches + ships them (submit_classic_patch;
        # queueing beats sending on the caller's critical path).
        self._defer_buf: List[tuple] = []
        self._classic_lock = threading.Lock()
        # Shm submit ring (stage 3): registered lazily with our node
        # manager on first classic submission; 0=never tried,
        # 1=registering, 2=active, 3=dead/unavailable.
        self._ring = None
        self._ring_state = 0
        # x86-64 only: the ring's payload-before-tail publication relies
        # on TSO store-store ordering, which pure-Python mmap writes
        # cannot fence on weaker memory models (arm64).
        import platform

        self._ring_enabled = (self._batch_frames
                              and bool(config.submit_ring_enabled)
                              and platform.machine() in ("x86_64", "AMD64"))
        # In-flight local lease requests awaiting the NM's deferred reply
        # (deadline-bounded by _check_local_waits on the flush loop).
        self._local_waits: List[dict] = []
        self._local_waits_lock = threading.Lock()
        # Local-first scheduling: lease requests go to OUR node manager
        # first (one local round trip, no GCS lock); the GCS-brokered
        # path below becomes the spillback. Pre-dial the NM so the hot
        # path never blocks on a connect.
        self._local_nm_addr: Optional[str] = None
        if bool(getattr(config, "local_scheduling_enabled", True)):
            try:
                addr = worker._own_nm_address()
                if addr:
                    worker.nm_conn(addr)
                    self._local_nm_addr = addr
            except Exception:
                pass   # no NM reachable: GCS-brokered grants only
        # Completion ingestion fast path (SCALE_r10 stage 1): the lease
        # conn thread parks raw lease_tasks_done_b frames here (lock-free
        # deque) and the absorb executor — or a get()/wait() caller
        # work-stealing via steal_absorb (stage 3) — does the unpickle /
        # inline insert / wakeup / decref accounting.
        self._ingest: collections.deque = collections.deque()
        self._absorb_enabled = bool(config.completion_absorb_enabled)
        self._steal = bool(config.completion_steal_enabled)
        # Worker->driver shm completion segments: same-node
        # leased workers append their completion blobs straight into a
        # per-worker segment next to our completion ring, skipping the
        # lease conn. Advertised per-lease in _install_lease once the
        # main ring is active; absorbed via ring_absorb.
        self._worker_ring = bool(config.worker_completion_ring_enabled)
        self._absorb_exec = (concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="rtpu-completion-absorb")
            if self._absorb_enabled else None)
        # Lease acquisition dials node managers / workers (blocking), so it
        # runs here — never on a conn's serve thread.
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="rtpu-lease")
        self._stop = threading.Event()
        self._flusher = threading.Thread(target=self._flush_loop,
                                         daemon=True, name="rtpu-lease-flush")
        self._flusher.start()

    # ------------------------------------------------------------- submit

    @staticmethod
    def eligible(resources: Dict[str, float], scheduling_strategy,
                 placement_group, runtime_env) -> bool:
        """Fast-path eligibility: plain tasks only. GPU tasks keep the
        scheduled path (GPU assignment happens at worker spawn), as do
        placement-group / affinity / runtime-env tasks."""
        return (placement_group is None
                and not runtime_env
                and (scheduling_strategy is None
                     or scheduling_strategy == "DEFAULT")
                and not resources.get(GPU))

    def submit(self, spec) -> bool:
        """Take ownership of the spec (True) or decline (False: caller
        must use the scheduled path)."""
        if self._closed:
            return False
        # Shape-key memo: RemoteFunction shares ONE normalized resources
        # dict across its submissions, so the sorted-tuple key can be
        # cached by identity (the strong ref pins the dict, making the
        # id stable; one entry per remote function).
        res = spec.resources
        ent = self._shape_keys.get(id(res))
        if ent is not None and ent[0] is res:
            key = ent[1]
        else:
            key = tuple(sorted(res.items()))
            if len(self._shape_keys) >= 4096:
                # Per-call .options() builds a fresh dict per submission;
                # don't let the identity memo grow with it.
                self._shape_keys.clear()
            self._shape_keys[id(res)] = (res, key)
        # Lock-free fast decline for a shape inside its denial window
        # (the sustained-flood hot path: every submission would otherwise
        # pay the manager lock just to learn "go classic"). All reads are
        # GIL-atomic snapshots; any staleness only sends this spec down
        # the ALWAYS-correct classic path or falls through to the locked
        # check below.
        st0 = self._shapes.get(key)
        if st0 is not None and not st0.leases and st0.requesting == 0 \
                and not st0.queue \
                and time.monotonic() < st0.denied_until:
            return False
        with self._lock:
            if self._closed:
                return False
            st = self._shapes.get(key)
            if st is None:
                st = self._shapes[key] = _ShapeState()
            live = any(not l.dead for l in st.leases)
            if not live and st.requesting == 0 \
                    and time.monotonic() < st.denied_until:
                # Recently denied at capacity and nothing here to drain a
                # queue: go classic now rather than strand the spec.
                return False
            lease = self._pick_lease_locked(st)
            batch = None
            if lease is not None:
                self._reserve_locked(lease, spec)
                if lease.inflight <= 1:
                    # Worker is idle: ship now, plus anything buffered.
                    batch = self._sendbuf.pop(lease, [])
                    batch.append(spec)
                else:
                    buf = self._sendbuf.setdefault(lease, [])
                    buf.append(spec)
                    if len(buf) >= self._SEND_BATCH:
                        batch = self._sendbuf.pop(lease)
            else:
                st.queue.append(spec)
                if (len(st.leases) + st.requesting < self._max_per_shape
                        and st.requesting < len(st.queue)
                        and time.monotonic() >= st.denied_until):
                    st.requesting += 1
                    self._request_lease(key)
        # Pin arg deps for the spec's entire stay in the manager (queued
        # OR in flight): the classic path pins at GCS submit; here a local
        # incref keeps the aggregate count positive until completion or
        # until the spec leaves for the classic path (which then pins).
        self._incref_deps(spec)
        if batch:
            self._send(lease, batch)
        return True

    _SEND_BATCH = 16
    _CLASSIC_BATCH = 256

    def flush_sends(self) -> None:
        """Ship every coalesced submit batch now. Called on get()/wait()
        entry (a caller about to block must not sit on its own work),
        from completions, and by the flush loop."""
        self._flush_classic()
        with self._lock:
            if not self._sendbuf:
                return
            pending = list(self._sendbuf.items())
            self._sendbuf.clear()
        for lease, specs in pending:
            if specs and not lease.dead:
                self._send(lease, specs)

    # ---------------------------------------------- classic-path batching

    def classic_route(self, resources: Dict[str, float]) -> bool:
        """Lock-free: True when a submission of this shape cannot ride a
        lease RIGHT NOW — no lease exists and the shape is either inside
        its denial backoff or already queues more than the grants it
        waits on can take (``lease_pipeline_depth`` each). Lets the
        caller skip spec-object construction entirely and ship
        template-patched bytes (submit_classic_patch). Sustained
        infeasible/over-capacity floods then stream down the blob route
        instead of convoying through queue-and-drain cycles.

        A burst the pending grants can take queues for them instead: a
        spec sent down the scheduled path while its caller's grants are
        pending waits in the GCS's queue behind those very grants, and
        the GCS's fairness pass then revokes the caller's own local
        leases until it places (the reference routes every such spec
        there). All reads are GIL-atomic snapshots; staleness only costs
        one spec the slower trip."""
        if not self._batch_frames or self._closed:
            return False
        ent = self._shape_keys.get(id(resources))
        if ent is None or ent[0] is not resources:
            return False   # first sighting: take the full submit path
        st = self._shapes.get(ent[1])
        if st is None or st.leases:
            return False
        return (time.monotonic() < st.denied_until
                or (st.requesting > 0
                    and len(st.queue) >= st.requesting * self._depth))

    def submit_classic(self, spec) -> bool:
        """Take ownership of a spec bound for the GCS-scheduled path:
        ship it through the shm submit ring when available, else
        coalesce its pre-pickled blob into a submit_task_batch frame.
        Returns False (caller must notify the GCS itself, single-spec
        frame on its own conn) for dep-carrying specs — their pin-
        before-decref ordering relies on same-conn FIFO with the
        refcount flush — and when batch framing is off."""
        if not self._batch_frames or self._closed or spec.arg_deps \
                or spec.nested_deps:
            return False
        return self.submit_classic_blob(spec_wire(spec))

    def submit_classic_blob(self, wire: bytes) -> bool:
        """Ship one pre-pickled, DEP-FREE spec blob down the classic
        batch path (ring when available, coalesced socket frame
        otherwise). The blob-only route: callers that already know the
        lease path declines (classic_route) never build a spec object."""
        if not self._batch_frames or self._closed:
            return False
        if self._ring_enabled:
            ring = self._ring
            if ring is None:
                self._maybe_register_ring(inline=False)
            elif ring.active and not ring.dead:
                if ring.append(wire):
                    return True
                try:
                    _submit_metrics_get()[2].inc()
                except Exception:
                    pass
        batch = None
        with self._classic_lock:
            self._classic_buf.append(wire)
            if len(self._classic_buf) >= self._CLASSIC_BATCH:
                batch = self._classic_buf
                self._classic_buf = []
        if batch:
            self._classic_send(batch)
        return True

    _DEFER_BATCH = 512

    def submit_classic_patch(self, tpl, tid_bytes: bytes, args: bytes,
                             submitted_at: float) -> bool:
        """The blob-only route's caller-side half: append the variable
        slots and return — template patching, ring writes, and frame
        sends all happen on the lease executor. One uncontended lock
        acquisition + a list append on the submit hot path."""
        if not self._batch_frames or self._closed:
            return False
        batch = None
        with self._classic_lock:
            buf = self._defer_buf
            buf.append((tpl, tid_bytes, args, submitted_at))
            if len(buf) >= self._DEFER_BATCH:
                batch, self._defer_buf = buf, []
        if batch:
            self._exec_submit(self._drain_deferred, batch)
        return True

    def _maybe_register_ring(self, inline: bool) -> None:
        """One-shot CAS into the registering state (0 -> 1); never after
        close() — a shutdown-time flush must not dial the NM or create a
        ring file it would immediately tear down."""
        if not self._ring_enabled or self._closed \
                or self._ring_state != 0:
            return
        register = False
        with self._classic_lock:
            if self._ring_state == 0:
                self._ring_state = 1
                register = True
        if not register:
            return
        if inline:
            self._register_ring()   # caller is already off the hot path
        else:
            self._exec_submit(self._register_ring)

    def _drain_deferred(self, batch: List[tuple]):
        """Patch + ship a deferred blob-route batch (lease executor /
        flush paths)."""
        if self._ring_enabled and self._ring is None:
            self._maybe_register_ring(inline=True)
        ring = self._ring
        use_ring = (ring is not None and ring.active and not ring.dead)
        out = []
        for tpl, tid_bytes, args, t in batch:
            blob = tpl.patch(tid_bytes, args, t)
            if use_ring:
                if ring.append(blob):
                    continue
                use_ring = False
                try:
                    _submit_metrics_get()[2].inc()
                except Exception:
                    pass
            out.append(blob)
        for i in range(0, len(out), self._CLASSIC_BATCH):
            self._classic_send(out[i:i + self._CLASSIC_BATCH])

    def _flush_classic(self):
        with self._classic_lock:
            deferred, self._defer_buf = self._defer_buf, []
            batch, self._classic_buf = self._classic_buf, []
        if deferred:
            self._drain_deferred(deferred)
        if batch:
            self._classic_send(batch)

    def _classic_send(self, blobs: List[bytes]):
        """One submit_task_batch frame on the bulk conn (the GCS serves
        each conn on its own thread, so the driver's synchronous RPCs on
        the main channel never queue behind a wave)."""
        try:
            self._bulk_conn_get().notify("submit_task_batch", blobs)
        except Exception:
            try:
                self._w.gcs.notify("submit_task_batch", blobs)
            except Exception:
                return   # driver is dying; its refs error out with it
        try:
            m = _submit_metrics_get()
            m[0].inc(tags={"path": "gcs"})
            m[1].observe(len(blobs), tags={"path": "gcs"})
        except Exception:
            pass

    # ------------------------------------------------------- submit ring

    def _register_ring(self):
        """Create + register the shm submit ring with our node manager
        (runs on the lease executor — never on the submit hot path)."""
        from ray_tpu_torch._private.config import config
        from ray_tpu_torch._private import submit_ring

        addr = self._local_nm_addr
        if addr is None or not self._ring_enabled or self._closed:
            self._ring_state = 3
            return
        writer = None
        try:
            path = os.path.join(
                os.path.dirname(self._w.store_path),
                f"subring_{os.getpid()}_{id(self) & 0xffffff:x}")
            writer = submit_ring.RingWriter(
                path, int(config.submit_ring_bytes))
            ok = self._w.nm_conn(addr).request(
                "register_submit_ring",
                {"client_id": self._w.client_id, "path": path},
                timeout=min(30.0, float(config.gcs_rpc_timeout_s)))
            if not ok:
                raise RuntimeError("node manager declined submit ring")
            writer.connect_bell()
            writer.active = True
            self._ring = writer
            self._ring_state = 2
        except Exception:
            self._ring_state = 3
            if writer is not None:
                try:
                    writer.close()
                except Exception:
                    pass

    # Comfortably above the NM relay's 2s per-attempt GCS timeout plus
    # its retry sleep: the drain thread re-beats between attempts, so a
    # healthy-but-GCS-stalled ring can never look dead.
    _RING_STALE_S = 5.0

    def _check_ring(self):
        """NM-death fallback (runs on the flush loop): a stale consumer
        heartbeat with records pending means the NM (or its drain
        thread) died — recover every unconsumed record and resubmit it
        over the socket batch path. At-least-once end to end: the GCS
        batch handler dedups on task id."""
        ring = self._ring
        if ring is None or not ring.active:
            return
        if ring.consumer_stale(self._RING_STALE_S):
            blobs = ring.recover_unconsumed()
            self._ring = None
            self._ring_state = 3
            try:
                ring.close()
            except Exception:
                pass
            for i in range(0, len(blobs), self._CLASSIC_BATCH):
                self._classic_send(blobs[i:i + self._CLASSIC_BATCH])

    def _incref_deps(self, spec):
        refs = self._w._refs
        if refs is not None and (spec.arg_deps or spec.nested_deps):
            # One refcount-lock acquisition per submission, not one per
            # dep (the r08 profile's incref tower).
            refs.incref_many([d.binary() for d in pinned_deps(spec)])

    def _pick_lease_locked(self, st: _ShapeState) -> Optional[_Lease]:
        best = None
        for lease in st.leases:
            if lease.dead or lease.inflight >= self._depth:
                continue
            if best is None or lease.inflight < best.inflight:
                best = lease
        return best

    def _reserve_locked(self, lease: _Lease, spec):
        lease.inflight += 1
        lease.idle_since = None
        lease.pending[spec.task_id.binary()] = spec
        for rid in spec.return_ids():
            self._inflight[rid.binary()] = {"ev": threading.Event(),
                                            "info": None}
        self._task_lease[spec.task_id.binary()] = (lease, spec)

    def _send(self, lease: _Lease, specs: List[Any]):
        """Ship a batch of (already reserved) specs to the leased worker.
        One notify per batch; results come back batched too. Arg deps were
        pinned at submit(). With batch framing on, the frame carries
        PRE-PICKLED spec blobs (template-patched when available) so the
        envelope pickle is a memcpy of bytes, not a re-serialization of
        every spec."""
        try:
            if self._batch_frames:
                lease.conn.notify("lease_run_tasks_b",
                                  [spec_wire(s) for s in specs])
                try:
                    m = _submit_metrics_get()
                    m[0].inc(tags={"path": "lease"})
                    m[1].observe(len(specs), tags={"path": "lease"})
                except Exception:
                    pass
            else:
                lease.conn.notify("lease_run_tasks", specs)
        except BaseException:
            self._fail_specs(lease, specs)

    # ------------------------------------------------------ lease acquire

    def _request_lease(self, key: tuple):
        """Local-first: ask OUR node manager for the lease (grant +
        worker checkout in one local round trip, GCS untouched). The NM
        declines (None) on insufficient local capacity / GPU shapes /
        fairness backoff — then the request spills back to the
        GCS-brokered path (reference: hybrid_scheduling_policy.h
        local-node-first with spillback)."""
        t0 = time.perf_counter()
        addr = self._local_nm_addr
        nm = self._w.nm_conn_cached(addr) if addr is not None else None
        if nm is not None:
            try:
                fut = nm.request_nowait(protocol.REQUEST_LOCAL_LEASE, {
                    "client_id": self._w.client_id,
                    "resources": dict(key),
                })
            except BaseException:
                self._request_gcs_lease(key, t0)
                return
            # Bound the deferred NM reply by the worker-start timeout
            # (r7 finding a): when the grant's worker hangs during
            # startup the NM's reply defers forever — after the same
            # bound the GCS-brokered path applies (``_worker_timeout``),
            # give up on the local grant and spill back to the GCS so
            # this shape's pipeline can't wedge. A grant that arrives
            # late is handed straight back to the NM. The deadline is
            # enforced by the manager's existing flush loop (one shared
            # thread), not a per-request Timer thread.
            #
            # The settled flag gets its OWN lock: on_reply can run
            # inline on THIS thread (future already done inside
            # add_done_callback) while the caller holds self._lock —
            # taking self._lock here would self-deadlock the manager.
            wait = {"settled": False, "lock": threading.Lock(),
                    "deadline": time.monotonic() + self._worker_timeout,
                    "key": key, "t0": t0}

            def on_reply(f, wait=wait, key=key, t0=t0):
                with wait["lock"]:
                    late = wait["settled"]
                    wait["settled"] = True
                if not late:
                    self._exec_submit(self._on_local_lease_reply,
                                      key, t0, f)
                    return
                try:
                    grant = f.result(0)
                except BaseException:
                    return
                if grant is not None:
                    # Hand the late grant straight back (off the serve
                    # thread — the NM dial may block).
                    def give_back(grant=grant):
                        try:
                            self._w.nm_conn(self._local_nm_addr).notify(
                                protocol.RETURN_LOCAL_LEASE,
                                {"lease_id": grant["lease_id"],
                                 "worker_id": grant.get("worker_id")})
                        except Exception:
                            pass

                    self._exec_submit(give_back)

            with self._local_waits_lock:
                self._local_waits.append(wait)
            fut.add_done_callback(on_reply)
            return
        self._request_gcs_lease(key, t0)

    def _check_local_waits(self):
        """Fire worker-start-timeout spillbacks for local lease requests
        whose deferred NM reply never arrived (runs on the flush loop;
        settled entries are dropped on scan)."""
        now = time.monotonic()
        fire = []
        with self._local_waits_lock:
            keep = []
            for wait in self._local_waits:
                if wait["settled"]:
                    continue
                (fire if now >= wait["deadline"] else keep).append(wait)
            self._local_waits = keep
        for wait in fire:
            with wait["lock"]:
                if wait["settled"]:
                    continue
                wait["settled"] = True
            self._exec_submit(self._request_gcs_lease,
                              wait["key"], wait["t0"])

    def _request_gcs_lease(self, key: tuple, t0: float):
        st = self._shapes.get(key)
        backlog = len(st.queue) if st is not None else 1
        try:
            fut = self._w.gcs.request_nowait("request_worker_lease", {
                "client_id": self._w.client_id,
                "resources": dict(key),
                "owner_node": self._w.node_id,
                "backlog": max(1, backlog),
            })
        except BaseException:
            # Defer: callers reach here synchronously from under
            # self._lock (submit path), and _lease_denied re-acquires it
            # (non-reentrant) and can fall a queued wave back over a
            # fresh blocking connect. On the executor it runs lock-free.
            self._exec_submit(self._lease_denied, key)
            return
        fut.add_done_callback(
            lambda f: self._exec_submit(self._on_lease_reply, key, t0, f))

    def _exec_submit(self, fn, *args):
        try:
            self._exec.submit(fn, *args)
        except RuntimeError:   # executor shut down: manager closing
            pass

    def _make_direct_handler(self, holder: Dict[str, Any]):
        def on_msg(conn, mtype, payload, msg_id):
            if mtype == "lease_tasks_done":
                lse = holder.get("lease")
                if lse is not None:
                    self._on_tasks_done(lse, payload["results"])
            elif mtype == protocol.LEASE_TASKS_DONE_B:
                lse = holder.get("lease")
                if lse is None:
                    return
                if self._absorb_exec is not None:
                    # The conn thread's whole job: park the raw blob
                    # list and poke the absorb executor. Unpickle,
                    # inline insert, waiter wakeup, refill computation
                    # and decrefs all happen off this thread.
                    self._ingest.append((lse, payload))
                    self._absorb_submit()
                else:
                    # Knob drift (worker ships blobs, driver absorb
                    # off): absorb inline — always correct, just the
                    # pre-split cost profile.
                    self._absorb_frame(lse, payload)
            elif mtype == protocol.ATTACH_COMPLETION_SEGMENT:
                # Worker created its completion segment next to our
                # ring; map it and ack so the worker arms its producer
                # (no ack -> the worker stays on the socket path).
                self._w._attach_worker_segment(payload["path"], conn)
        return on_msg

    # ------------------------------------------------- completion absorb

    def _absorb_submit(self):
        try:
            self._absorb_exec.submit(self._drain_ingest)
        except RuntimeError:   # executor shut down: manager closing
            pass

    def _drain_ingest(self):
        while True:
            try:
                lease, blobs = self._ingest.popleft()
            except IndexError:
                break
            self._absorb_frame(lease, blobs)
        try:
            _completion_metrics_get()[0].set(len(self._ingest))
        except Exception:
            pass

    def _absorb_frame(self, lease: _Lease, blobs: List[bytes]):
        try:
            results = [pickle.loads(b) for b in blobs]
            self._on_tasks_done(lease, results, defer_send=True)
        except BaseException as e:
            self._absorb_failed(lease, e)

    def ring_absorb(self, blobs: List[bytes]) -> None:
        """Absorb worker-segment completion blobs. Runs on
        the driver's ring consumer thread. Unlike the socket frames —
        which arrive on a per-lease conn — segment blobs carry no lease
        identity, so each record routes through the task_id index.
        Redelivery-idempotent: a record whose task already completed
        (socket fallback raced the segment, or a re-drain after a torn
        commit) finds no _task_lease entry and drops here; records for
        a live lease re-use the one absorb path (_on_tasks_done pops
        lease.pending, so a duplicate inside it no-ops too)."""
        by_lease: Dict[_Lease, List[dict]] = {}
        for blob in blobs:
            try:
                rec = pickle.loads(blob)
                tid = rec["task_id"]
            except BaseException:
                continue   # torn/corrupt blob: socket fallback delivers
            with self._lock:
                ent = self._task_lease.get(tid)
            if ent is None:
                continue   # already completed via another path
            by_lease.setdefault(ent[0], []).append(rec)
        for lease, recs in by_lease.items():
            try:
                self._on_tasks_done(lease, recs, defer_send=True)
            except BaseException as e:
                self._absorb_failed(lease, e)

    def advertise_worker_ring(self) -> None:
        """The completion ring just came up: advertise it to every
        already-installed same-node lease (leases installed later get
        the advertisement inline in _install_lease). Idempotent on the
        worker side — a repeat attach for a conn is ignored."""
        if not self._worker_ring:
            return
        with self._lock:
            leases = [l for st in self._shapes.values()
                      for l in st.leases if not l.dead]
        for lease in leases:
            self._advertise_ring(lease)

    def _advertise_ring(self, lease: _Lease) -> None:
        """Tell a same-node leased worker where our completion ring
        lives; the worker answers with attach_completion_segment and
        we ack. Cross-node leases never get one — the segment is a
        same-filesystem mmap."""
        ring = self._w._comp_ring
        if (ring is None or self._w._comp_ring_state != 2
                or not self._worker_ring
                or lease.node_id != self._w.node_id):
            return
        try:
            lease.conn.notify(protocol.ATTACH_COMPLETION_RING,
                              {"path": ring.path,
                               "node_id": self._w.node_id})
        except Exception:
            pass   # conn dying: its close path retires the lease

    def _absorb_failed(self, lease: _Lease, e: BaseException):
        """Absorption died on a frame (corrupt blob, absorb bug): a
        silent drop would hang every getter parked on this lease's
        returns. Fail them all with a TYPED error instead — the worker
        may have executed the tasks, but their results can no longer be
        attributed, and the lease's accounting is unrecoverable."""
        from ray_tpu_torch import exceptions as exc

        err = exc.CompletionAbsorbError(
            f"completion absorb failed: {type(e).__name__}: {e}")
        with self._lock:
            specs = list(lease.pending.values())
            lease.pending.clear()
            for spec in specs:
                lease.inflight -= 1
                self._task_lease.pop(spec.task_id.binary(), None)
                for rid in spec.return_ids():
                    ent = self._inflight.get(rid.binary())
                    if ent is not None:
                        ent["error"] = err
                        ent["ev"].set()
        for spec in specs:
            self._decref_deps(spec)
        self._exec_submit(self._drop_lease, lease)

    def steal_enabled(self) -> bool:
        return self._steal

    def steal_absorb(self) -> bool:
        """Stage 3 (parallel wave collection): a caller about to block
        in get()/wait() absorbs one parked completion frame on ITS OWN
        thread instead of idling behind the absorb executor. Returns
        False when the queue is empty (or stealing is off) — the caller
        then parks for real. Absorption is thread-safe: accounting runs
        under the manager lock, the inline cache lock is a leaf."""
        if not self._steal:
            return False
        try:
            lease, blobs = self._ingest.popleft()
        except IndexError:
            return False
        self._absorb_frame(lease, blobs)
        return True

    def _direct_address(self, grant: Dict[str, Any]) -> str:
        """Pick the cheapest transport to the leased worker: its AF_UNIX
        listener when it is on OUR node (always true for local grants;
        loopback TCP costs ~2x per message), TCP otherwise."""
        ux = grant.get("direct_address_ux")
        if ux and grant.get("node_id") == self._w.node_id:
            return ux
        return grant["direct_address"]

    def _on_local_lease_reply(self, key: tuple, t0: float, f):
        try:
            grant = f.result(0)
        except BaseException:
            grant = None
        if grant is None:
            # Spillback: the central scheduler owns this shape now (the
            # requesting slot carries over to the GCS request).
            self._request_gcs_lease(key, t0)
            return
        holder: Dict[str, Any] = {}
        try:
            conn = protocol.connect(self._direct_address(grant),
                                    handler=self._make_direct_handler(holder),
                                    name="lease-direct",
                                    timeout=DIRECT_DIAL_S)
        except BaseException:
            # Never dialed the worker: hand the grant straight back.
            try:
                self._w.nm_conn(self._local_nm_addr).notify(
                    protocol.RETURN_LOCAL_LEASE,
                    {"lease_id": grant["lease_id"],
                     "worker_id": grant.get("worker_id")})
            except Exception:
                pass
            self._lease_denied(key)
            return
        lease = _Lease(grant["lease_id"], grant["worker_id"], conn,
                       grant["node_id"], self._local_nm_addr, key,
                       local=True)
        try:
            _grant_latency_hist().observe(time.perf_counter() - t0,
                                          tags={"source": "local"})
        except Exception:
            pass
        self._install_lease(key, lease, holder)

    def _on_lease_reply(self, key: tuple, t0: float, f):
        try:
            grant = f.result(0)
        except BaseException:
            grant = None
        if grant is None:
            self._lease_denied(key)
            return
        holder: Dict[str, Any] = {}
        try:
            nm = self._w.nm_conn(grant["node_address"])
            rep = nm.request("lease_worker", {
                "resources": dict(key), "lease_id": grant["lease_id"]},
                timeout=self._worker_timeout)
            conn = protocol.connect(
                self._direct_address({**rep, "node_id": grant["node_id"]}),
                handler=self._make_direct_handler(holder),
                name="lease-direct", timeout=DIRECT_DIAL_S)
        except BaseException:
            # Tell the NM the lease is dead too, so a worker that is still
            # spawning for it is not stranded in LEASED forever.
            try:
                self._w.nm_conn(grant["node_address"]).notify(
                    "abandon_lease", {"lease_id": grant["lease_id"]})
            except Exception:
                pass
            try:
                self._w.gcs.notify("return_lease",
                                   {"lease_id": grant["lease_id"]})
            except Exception:
                pass
            self._lease_denied(key)
            return
        lease = _Lease(grant["lease_id"], rep["worker_id"], conn,
                       grant["node_id"], grant["node_address"], key)
        try:
            _grant_latency_hist().observe(time.perf_counter() - t0,
                                          tags={"source": "gcs"})
        except Exception:
            pass
        self._install_lease(key, lease, holder)

    def _install_lease(self, key: tuple, lease: _Lease,
                       holder: Dict[str, Any]):
        holder["lease"] = lease
        lease.conn.on_close = lambda c, l=lease: self._exec_submit(
            self._on_lease_conn_closed, l)
        to_send = []
        with self._lock:
            st = self._shapes.get(key)
            if st is None or self._closed:
                lease.dead = True
            else:
                st.requesting = max(0, st.requesting - 1)
                st.leases.append(lease)
                while st.queue and lease.inflight < self._depth:
                    spec = st.queue.popleft()
                    self._reserve_locked(lease, spec)
                    to_send.append(spec)
        if lease.dead:
            self._drop_lease(lease)
            return
        # Same-node worker + active completion ring: advertise the ring
        # so the worker opens its shm segment. If the ring
        # comes up later, _register_completion_ring re-advertises.
        self._advertise_ring(lease)
        if to_send:
            self._send(lease, to_send)

    def _lease_denied(self, key: tuple):
        """No capacity (or broker error): fall queued tasks back to the
        scheduled path — the GCS queues them against future capacity."""
        with self._lock:
            st = self._shapes.get(key)
            if st is None:
                return
            st.requesting = max(0, st.requesting - 1)
            # Cluster is at capacity: stop hammering the broker for this
            # shape for a moment (live leases keep draining the queue).
            st.denied_until = time.monotonic() + 0.5
            specs = []
            if st.requesting == 0 and not any(
                    not l.dead for l in st.leases):
                while st.queue:
                    specs.append(st.queue.popleft())
        self._fallback_many(specs)

    def _fallback(self, spec):
        try:
            self._w.gcs.notify("submit_task", spec)
        except Exception:
            pass   # driver is dying; its refs error out with it
        self._decref_deps(spec)

    _FALLBACK_CHUNK = 500

    def _bulk_conn_get(self):
        """Dedicated GCS connection for bulk fallback waves: the GCS
        serves each conn on its own thread, so the driver's synchronous
        RPCs (on the main channel) interleave between chunks instead of
        queueing behind a 100k-spec wave (single-conn FIFO would be
        head-of-line blocking measured in seconds)."""
        conn = self._bulk_conn
        if conn is None or conn.closed:
            conn = self._bulk_conn = protocol.connect(
                self._w.gcs_address, name="lease-bulk")
        return conn

    def _fallback_many(self, specs: List[Any]):
        """Wave fallback (capacity denial, lease drop): batched submits
        so a big queued burst costs the GCS one handler invocation per
        chunk, not per spec. With batch framing on, the chunk ships as
        pre-pickled blobs (reusing each spec's template-patched bytes
        instead of re-serializing the wave)."""
        for i in range(0, len(specs), self._FALLBACK_CHUNK):
            chunk = specs[i:i + self._FALLBACK_CHUNK]
            if self._batch_frames:
                self._classic_send([spec_wire(s) for s in chunk])
            else:
                try:
                    self._bulk_conn_get().notify("submit_tasks", list(chunk))
                except Exception:
                    # Bulk conn unavailable: the main (reconnecting)
                    # channel still delivers; a dying driver's refs
                    # error out with it anyway.
                    try:
                        self._w.gcs.notify("submit_tasks", list(chunk))
                    except Exception:
                        pass
            for s in chunk:
                self._decref_deps(s)

    # ------------------------------------------------------- completion

    def _on_tasks_done(self, lease: _Lease, results: List[dict],
                       defer_send: bool = False):
        """Batched completion notify from the leased worker: wake
        getters, refill the pipeline. Runs on the lease conn's serve
        thread on the classic path; with the absorb split it runs on
        the absorb executor (or a stealing caller thread) and hands the
        refill-send to the lease executor (defer_send) so a slow absorb
        can never stall pipeline top-up."""
        try:
            _completion_metrics_get()[1].observe(len(results))
        except Exception:
            pass
        done_specs = []
        drained: List[Any] = []
        with self._lock:
            for rep in results:
                spec = lease.pending.pop(rep["task_id"], None)
                if spec is None:
                    continue   # raced with failure cleanup
                lease.inflight -= 1
                self._task_lease.pop(rep["task_id"], None)
                done_specs.append(spec)
                inline = rep.get("inline")
                if inline:
                    # In-band returns: the value is IN this message —
                    # park it in the caller's inline cache BEFORE waking
                    # getters, so the woken get() resolves with zero
                    # store/GCS round trips. (The cache's lock is a
                    # leaf; safe under the manager lock.)
                    cache = self._w._inline
                    for oid, blob in inline.items():
                        cache.put(oid, blob)
                for oid, size in rep["objects"]:
                    ent = self._inflight.get(oid)
                    if ent is not None:
                        if inline and oid in inline:
                            # No store copy exists anywhere: getters
                            # must never dial the producing node for
                            # this oid (worker._wait_lease_local honors
                            # the flag; the GCS inline table serves a
                            # local-cache miss).
                            ent["inline"] = True
                        ent["info"] = (rep["node_id"], lease.nm_address,
                                       size)
                        ent["ev"].set()
                report = {"spec": spec,
                          "node_id": rep["node_id"],
                          "objects": rep["objects"]}
                if inline:
                    report["inline"] = inline
                self._reports.append(report)
            st = self._shapes.get(lease.shape_key)
            if st is not None and not lease.dead:
                drained.extend(self._sendbuf.pop(lease, ()))
                # Low-watermark refill: top the pipeline back up only
                # once it has drained to half depth, so refills ship as
                # half-depth batches. Refilling on every completion
                # locks in a size-1 ping-pong — the worker flushes the
                # moment its queue empties, the 1-spec refill lands
                # after that flush, and from then on every frame in
                # both directions carries exactly one task (measured:
                # ~3k tasks/s/worker; batched refill amortizes the
                # per-frame cost with no completion-latency cost).
                if st.queue and lease.inflight <= self._depth // 2:
                    while st.queue and lease.inflight < self._depth:
                        nxt = st.queue.popleft()
                        self._reserve_locked(lease, nxt)
                        drained.append(nxt)
            if lease.inflight == 0 and not drained:
                lease.idle_since = time.monotonic()
            drain_done = (lease.draining and lease.inflight == 0
                          and not lease.pending)
            if drain_done:
                lease.draining = False
        # Batched decrefs on the completion frame: one deque extend for
        # the whole batch, not one _decref_deps round per spec.
        refs = self._w._refs
        if refs is not None:
            deps = [d.binary() for spec in done_specs
                    for d in pinned_deps(spec)]
            if deps:
                refs.decref_many(deps)
        if drained:
            if defer_send:
                self._exec_submit(self._send, lease, drained)
            else:
                self._send(lease, drained)
        if drain_done:
            # Revocation drain finished: NOW surrender the worker.
            self._exec_submit(self._drop_lease, lease)

    def _fail_specs(self, lease: _Lease, specs: List[Any]):
        """Transport failure (worker/node death) for in-flight specs.

        Mirrors the classic worker-death path's retry semantics: each
        failure consumes one unit of the task's retry budget; with budget
        left the spec resubmits through the scheduled path, otherwise its
        returns materialize as WorkerCrashedError — a max_retries=0 task
        is NEVER silently re-executed."""
        from ray_tpu_torch import exceptions as exc

        failed = []
        with self._lock:
            lease.dead = True
            for spec in specs:
                if lease.pending.pop(spec.task_id.binary(), None) is None:
                    continue   # already handled elsewhere
                lease.inflight -= 1
                self._task_lease.pop(spec.task_id.binary(), None)
                for rid in spec.return_ids():
                    ent = self._inflight.pop(rid.binary(), None)
                    if ent is not None:
                        ent["ev"].set()   # info None -> GCS path
                failed.append(spec)
        for spec in failed:
            if spec.task_id.binary() in self._cancelled:
                self._cancelled.discard(spec.task_id.binary())
                self._materialize_cancelled(spec)
                self._decref_deps(spec)
                continue
            left = getattr(spec, "retries_left", None)
            if left is None or left == 0:
                left = spec.max_retries
            if left <= 0:
                with self._lock:
                    why = self._kill_reasons.get(
                        lease.worker_id, "leased worker lost")
                self._materialize_error(spec, exc.WorkerCrashedError(
                    f"worker running {getattr(spec, 'name', '')} died "
                    f"({why})"))
                self._decref_deps(spec)
            else:
                # Hand the GCS the REMAINING budget (its submit handler
                # re-arms retries_left from max_retries). The cached
                # wire blob predates the mutation — drop it.
                spec.max_retries = left - 1
                spec.retries_left = left - 1
                invalidate_wire(spec)
                self._fallback(spec)  # fallback releases the submit pin
        self._exec_submit(self._drop_lease, lease)

    def _materialize_cancelled(self, spec):
        from ray_tpu_torch import exceptions as exc

        self._materialize_error(spec, exc.TaskCancelledError(
            spec.task_id.binary().hex()))

    def _materialize_error(self, spec, error: BaseException):
        from ray_tpu_torch._private import serialization

        err = serialization.serialize(error)
        objects = []
        for rid in spec.return_ids():
            oid = rid.binary()
            try:
                self._w.store.put_serialized(oid, err)
            except Exception:
                pass
            objects.append((oid, err.total_size()))
        try:
            self._w.gcs.notify("add_object_locations", {
                "node_id": self._w.node_id, "objects": objects})
        except Exception:
            pass

    def _on_lease_conn_closed(self, lease: _Lease):
        # Worker (or its node) died: every in-flight spec on this lease
        # falls back to the scheduled path; then retire the lease.
        # First give the ring consumer a bounded moment to finish
        # draining this worker's completion segment — a graceful exit
        # flushes its last results into the segment right before the
        # conn drops, and results that beat the death should resolve
        # instead of re-running (the consumer loop passes at least
        # every PARK_TIMEOUT_S, so this settles in one tick).
        self._w._detach_worker_segments(lease.conn)
        deadline = time.monotonic() + 0.5
        while self._w._has_segments_for_conn(lease.conn) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        with self._lock:
            lease.dead = True
            specs = list(lease.pending.values())
        if specs:
            self._fail_specs(lease, specs)
        self._drop_lease(lease)

    def _decref_deps(self, spec):
        refs = self._w._refs
        if refs is not None and (spec.arg_deps or spec.nested_deps):
            refs.decref_many([d.binary() for d in pinned_deps(spec)])

    # -------------------------------------------------------- lease drop

    def _drop_lease(self, lease: _Lease):
        with self._lock:
            self._sendbuf.pop(lease, None)
            lease.dead = True
            st = self._shapes.get(lease.shape_key)
            if st is not None and lease in st.leases:
                st.leases.remove(lease)
            requeued = []
            if st is not None and st.queue and not st.leases \
                    and st.requesting == 0:
                while st.queue:
                    requeued.append(st.queue.popleft())
        try:
            lease.conn.close()
        except Exception:
            pass
        # Explicit, authoritative return (the worker's own conn-closed
        # notify is only honored when the holder died). Local grants are
        # returned to the node manager alone — the GCS never brokered
        # them; it learns via the NM's async resource report.
        if lease.local:
            try:
                self._w.nm_conn(lease.nm_address).notify(
                    protocol.RETURN_LOCAL_LEASE,
                    {"lease_id": lease.lease_id,
                     "worker_id": lease.worker_id})
            except Exception:
                pass
        else:
            try:
                self._w.nm_conn(lease.nm_address).notify(
                    "return_leased_worker", {"worker_id": lease.worker_id})
            except Exception:
                pass
            try:
                self._w.gcs.notify("return_lease",
                                   {"lease_id": lease.lease_id})
            except Exception:
                pass
        self._fallback_many(requeued)

    # ---------------------------------------------------------- get glue

    def peek(self, oid: bytes) -> Optional[Dict[str, Any]]:
        """Fast-path completion entry for an object produced by one of our
        in-flight lease tasks (None once flushed to the GCS or unknown)."""
        with self._lock:
            return self._inflight.get(oid)

    def inflight_map(self) -> Dict[bytes, Dict[str, Any]]:
        """The oid -> completion-entry map itself, for lock-free
        membership probes (GIL-atomic dict reads) on the get()/wait()
        hot scans — a ctypes store probe per ref was 66% of a get()'s
        MainThread when every ref was a pending lease task (r10 driver
        profile). Staleness only costs the caller the always-correct
        slow path; anything beyond `in` goes through peek()."""
        return self._inflight

    def note_worker_killed(self, worker_id, reason: str) -> None:
        with self._lock:
            self._kill_reasons[worker_id] = reason
            if len(self._kill_reasons) > 64:
                self._kill_reasons.pop(next(iter(self._kill_reasons)))

    def revoke(self, lease_id) -> None:
        """GCS-initiated revocation (classic-queue fairness): DRAIN the
        lease — stop dispatching new specs, let the worker's in-flight
        batch finish, then return the worker. Revocation is a policy
        decision, not a failure: it must not double-execute tasks already
        running on the (healthy) worker, consume retry budget, or
        materialize crash errors (the reference returns leases on
        spillback without killing workers, direct_task_transport.h:75)."""
        target = None
        fallback_specs: List[Any] = []
        with self._lock:
            for st in self._shapes.values():
                for lease in st.leases:
                    if lease.lease_id == lease_id:
                        target = lease
                        break
                if target is not None:
                    break
            if target is None or target.dead:
                return
            target.dead = True        # _pick_lease_locked skips it now
            target.draining = target.inflight > 0
            # Reserved-but-coalesced specs count toward inflight: ship
            # them now or the drain waits forever on work the worker
            # never received.
            buffered = self._sendbuf.pop(target, None)
            st = self._shapes.get(target.shape_key)
            # The GCS wants this capacity back for the classic queue:
            # queued (never-sent) specs go to the scheduled path instead
            # of waiting on a lease being surrendered.
            if st is not None and st.queue and st.requesting == 0 \
                    and not any(not l.dead for l in st.leases):
                while st.queue:
                    fallback_specs.append(st.queue.popleft())
        if buffered:
            self._send(target, buffered)
        self._fallback_many(fallback_specs)
        if not target.draining:
            self._exec_submit(self._drop_lease, target)

    def cancel(self, task_id: bytes, force: bool = False) -> bool:
        queued_spec = None
        with self._lock:
            ent = self._task_lease.get(task_id)
            if ent is None:
                # Not yet dispatched: maybe still in a shape queue.
                for st in self._shapes.values():
                    for spec in st.queue:
                        if spec.task_id.binary() == task_id:
                            st.queue.remove(spec)
                            queued_spec = spec
                            break
                    if queued_spec is not None:
                        break
        if queued_spec is not None:
            # Materialize cancelled-error returns locally so the owner's
            # get() resolves immediately (mirrors the worker's queue-cancel).
            self._materialize_cancelled(queued_spec)
            self._decref_deps(queued_spec)
            return True
        if ent is None:
            return False
        lease, _spec = ent
        if force:
            # Classic force-cancel kills the worker process; match it.
            # The kill closes the lease conn: other in-flight specs fall
            # back, while this one (marked cancelled) materializes a
            # TaskCancelledError instead of resubmitting.
            self._cancelled.add(task_id)
            try:
                self._w.nm_conn(lease.nm_address).notify(
                    "kill_leased_worker", {"worker_id": lease.worker_id})
                return True
            except Exception:
                self._cancelled.discard(task_id)
                return False
        try:
            lease.conn.notify("cancel_task", {"task_id": task_id})
            return True
        except Exception:
            return False

    # ------------------------------------------------------- background

    def _flush_loop(self):
        while not self._stop.wait(self._flush_s):
            try:
                self.flush_sends()
                self._flush_reports()
                self._reap_idle()
                self._retry_backlogged()
                self._check_local_waits()
                self._check_ring()
            except Exception:
                pass

    def _retry_backlogged(self):
        """Shapes with queued work keep asking for capacity: each retry
        (a) grabs leases the moment the cluster grows — the autoscaler
        path — and (b) refreshes the GCS's denied-lease demand signal so
        the autoscaler knows to grow."""
        now = time.monotonic()
        with self._lock:
            if self._closed:
                return
            for key, st in self._shapes.items():
                if (st.queue and now >= st.denied_until
                        and st.requesting < len(st.queue)
                        and len(st.leases) + st.requesting
                        < self._max_per_shape):
                    st.requesting += 1
                    self._request_lease(key)

    def _flush_reports(self):
        with self._lock:
            reports, self._reports = self._reports, []
        if not reports:
            return
        by_node: Dict[str, List[dict]] = {}
        for r in reports:
            by_node.setdefault(r["node_id"], []).append(r)
        failed: List[dict] = []
        sent: List[dict] = []
        for node_id, group in by_node.items():
            tasks = []
            for r in group:
                task = {"spec": r["spec"], "objects": r["objects"]}
                if r.get("inline"):
                    # The GCS's copy of in-band returns: after this
                    # flush the inline table (not this driver) is the
                    # cluster-visible holder, so local cache eviction
                    # stays safe.
                    task["inline"] = r["inline"]
                tasks.append(task)
            try:
                self._w.gcs.notify("lease_task_events",
                                   {"node_id": node_id, "tasks": tasks})
                sent.extend(group)
            except Exception:
                # With inline returns the report IS the only durable
                # copy of the values: re-queue for the next flush tick
                # (at-least-once; the GCS inline insert and location
                # adds are both redelivery-idempotent).
                failed.extend(group)
        with self._lock:
            if failed and not self._closed:
                self._reports = failed + self._reports
            # Locations for the sent groups are now (or will
            # momentarily be) in the GCS: the local fast-path
            # entries can go.
            for r in sent:
                for oid, _size in r["objects"]:
                    self._inflight.pop(oid, None)

    def _reap_idle(self):
        now = time.monotonic()
        victims = []
        with self._lock:
            for key, st in list(self._shapes.items()):
                for lease in list(st.leases):
                    if (not lease.dead and lease.inflight == 0
                            and not st.queue
                            and lease.idle_since is not None
                            and now - lease.idle_since > self._idle_timeout):
                        lease.dead = True
                        victims.append(lease)
                if not st.leases and not st.queue and st.requesting == 0:
                    self._shapes.pop(key, None)
        for lease in victims:
            self._drop_lease(lease)

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            leases = [l for st in self._shapes.values() for l in st.leases]
            queued = [s for st in self._shapes.values() for s in st.queue]
            self._shapes.clear()
            for ent in self._inflight.values():
                ent["ev"].set()
            self._inflight.clear()
        self._stop.set()
        self._flush_classic()
        ring = self._ring
        if ring is not None:
            self._ring = None
            # Unconsumed records would die with the ring file — push
            # them through the socket path before tearing it down.
            blobs = ring.recover_unconsumed()
            for i in range(0, len(blobs), self._CLASSIC_BATCH):
                self._classic_send(blobs[i:i + self._CLASSIC_BATCH])
            try:
                ring.close()
            except Exception:
                pass
        self._flush_reports()
        for lease in leases:
            try:
                lease.conn.close()
            except Exception:
                pass
            if lease.local:
                try:
                    self._w.nm_conn(lease.nm_address).notify(
                        protocol.RETURN_LOCAL_LEASE,
                        {"lease_id": lease.lease_id,
                         "worker_id": lease.worker_id})
                except Exception:
                    pass
                continue
            try:
                self._w.nm_conn(lease.nm_address).notify(
                    "return_leased_worker", {"worker_id": lease.worker_id})
            except Exception:
                pass
            try:
                self._w.gcs.notify("return_lease",
                                   {"lease_id": lease.lease_id})
            except Exception:
                pass
        self._fallback_many(queued)
        if self._bulk_conn is not None:
            try:
                # Let queued batch frames reach the socket before the
                # shutdown aborts the writer (close() is immediate).
                self._bulk_conn.flush(2.0)
                self._bulk_conn.close()
            except Exception:
                pass
        self._exec.shutdown(wait=False)
        if self._absorb_exec is not None:
            # Parked frames die with the driver: every inflight event
            # was already set above, so nothing can hang on them.
            self._ingest.clear()
            self._absorb_exec.shutdown(wait=False)
