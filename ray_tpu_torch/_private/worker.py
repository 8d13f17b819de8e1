"""Core worker: the in-process runtime of every driver and worker.

Role-equivalent to the reference's core worker
(reference: src/ray/core_worker/core_worker.h:284 — SubmitTask :735,
SubmitActorTask :800, Put :506, Get :613) plus the Python-side driver state
(reference: python/ray/_private/worker.py:406 Worker, init :1045).

Data-plane design: objects live in the node's shared-memory store; ``get``
blocks on the GCS object directory only for objects that are not yet local,
then maps them zero-copy (same node) or pulls them from the holder node
(reference: object directory ownership_based_object_directory.h:37 +
PullManager pull_manager.h:52, collapsed into a directory lookup + one
fetch RPC).
"""

from __future__ import annotations

import atexit
import collections
import concurrent.futures
import itertools
import queue
import hashlib
import os
import pickle
import sys
import tempfile
import threading
import time
import uuid
import weakref
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch._private import pickler

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import (
    device_objects,
    inline_objects,
    protocol,
    serialization,
)
from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch._private.task_spec import (
    ActorCreationSpec,
    ActorTaskSpec,
    TaskSpec,
    normalize_resources,
    pinned_deps,
)
from ray_tpu_torch.object_store import plasma
from ray_tpu_torch.util import metrics as metrics_util

import logging

logger = logging.getLogger("ray_tpu_torch.worker")

_INLINE_ARG_LIMIT = 512 * 1024  # larger arg blobs go through the object store


def _build_ring_metrics():
    """Driver-side worker-segment metrics (lazy: only a driver whose
    consumer loop drains attached segments ever builds them)."""
    from ray_tpu_torch.util import metrics

    depth = metrics.Gauge(
        "worker_completion_segment_depth",
        "Deepest per-producer backlog in bytes across this driver's "
        "attached worker completion segments, sampled at each consumer "
        "drain pass")
    return (depth,)


_ring_metrics = metrics_util.lazy_metrics(_build_ring_metrics)


class ObjectRef:
    """A future for a value in the object store (reference: ObjectID/ObjectRef
    in _raylet.pyx). Picklable; reconnects to the ambient worker on loads.

    Lifetime-tracked: construction increfs and ``__del__`` decrefs through
    the ambient worker's ref tracker (batched to the GCS), so an object
    whose last reference anywhere dies is freed from the store without an
    explicit ``free()`` — including refs restored from pickles in other
    processes (borrower registration). Reference:
    core_worker/reference_count.h:61.
    """

    __slots__ = ("_id", "_owner_hint", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_hint: str = ""):
        self._id = object_id
        self._owner_hint = owner_hint
        w = _global_worker
        if w is not None and w._refs is not None:
            w._refs.incref(object_id.binary())

    def __del__(self):
        try:
            w = _global_worker
            if w is not None and w._refs is not None:
                w._refs.decref(self._id.binary())
        except Exception:
            pass  # interpreter shutdown

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    @property
    def id(self) -> ObjectID:
        return self._id

    def task_id(self) -> TaskID:
        return self._id.task_id()

    def job_id(self) -> JobID:
        return self._id.job_id()

    def __reduce__(self):
        nested = getattr(_nested_refs, "ids", None)
        if nested is not None:
            nested.append(self._id)
        return (_restore_ref, (self._id.binary(), self._owner_hint))

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def future(self):
        """concurrent.futures.Future resolving to the object's value.

        Resolution runs on a shared bounded pool — a caller creating
        thousands of futures costs at most ``_FUTURE_POOL_WORKERS``
        threads, not one daemon thread per call; excess resolutions
        queue and drain as earlier gets complete (object readiness is
        driven by remote workers, so queued waiters can't deadlock the
        pool)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def run():
            if not fut.set_running_or_notify_cancel():
                return
            try:
                fut.set_result(require_worker().get([self])[0])
            except BaseException as e:
                fut.set_exception(e)

        _future_executor().submit(run)
        return fut


_FUTURE_POOL_WORKERS = 16


class _DaemonPool:
    """Bounded pool of DAEMON worker threads for future() resolution.

    Not a ThreadPoolExecutor: its threads are non-daemon and CPython
    joins them BEFORE atexit handlers run, so one resolver blocked in
    get() on a never-ready object would hang interpreter exit forever
    (the atexit disconnect that errors out blocked gets never fires).
    Daemon threads die with the process, like the old thread-per-call
    behavior."""

    def __init__(self, max_workers: int, name: str):
        self._max = max_workers
        self._name = name
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._threads = 0
        self._idle = 0
        self._backlog = 0      # submitted, not yet claimed by a thread
        self._lock = threading.Lock()

    def submit(self, fn) -> None:
        # Check-and-reserve is atomic under the pool lock: the backlog
        # counter covers THIS submission, so two concurrent submits that
        # both observe one idle thread can't both skip the spawn (the
        # second sees backlog 2 > idle 1 and spawns). Over-spawning is
        # bounded by _max and harmless; under-spawning strands a waiter
        # behind an unrelated long-running resolution.
        with self._lock:
            self._backlog += 1
            spawn = (self._idle < self._backlog
                     and self._threads < self._max)
            if spawn:
                self._threads += 1
                n = self._threads
        self._q.put(fn)
        if spawn:
            threading.Thread(
                target=self._run, daemon=True,
                name=f"{self._name}-{n}").start()

    def _run(self):
        while True:
            with self._lock:
                self._idle += 1
            try:
                fn = self._q.get()
            finally:
                with self._lock:
                    self._idle -= 1
                    self._backlog -= 1
            try:
                fn()
            except BaseException:
                pass   # run() owns error delivery via the Future


_future_pool: Optional[_DaemonPool] = None
_future_pool_lock = threading.Lock()


def _future_executor() -> _DaemonPool:
    """Process-wide resolver pool for ObjectRef.future(). Survives
    init/shutdown cycles; daemon threads never block interpreter exit."""
    global _future_pool
    if _future_pool is None:
        with _future_pool_lock:
            if _future_pool is None:
                _future_pool = _DaemonPool(_FUTURE_POOL_WORKERS,
                                           "rtpu-ref-future")
    return _future_pool


# How long a pull retries a refused connection to the node the object
# directory lists (``_fetch_from``).
_FETCH_CONNECT_S = 1.0


# Set by _serialize_task_args while it pickles a task's args: the
# ObjectRefs nested in them note their ids here (TaskSpec.nested_deps).
_nested_refs = threading.local()


def _restore_ref(id_bytes: bytes, owner_hint: str) -> ObjectRef:
    return ObjectRef(ObjectID(id_bytes), owner_hint)


class ObjectRefGenerator:
    """The value of a ``num_returns="dynamic"`` task's single return: an
    iterable over the ObjectRefs of the values the task yielded
    (reference: python/ray DynamicObjectRefGenerator, exercised by
    python/ray/tests/test_generators.py).

    Carries raw id bytes — ObjectRefs materialize (and register with the
    consumer's ref tracker) only when iterated, so the yielded objects
    are owned by whoever actually consumes them.
    """

    __slots__ = ("_ids",)

    def __init__(self, id_bytes_list: List[bytes]):
        self._ids = list(id_bytes_list)

    def __iter__(self):
        for b in self._ids:
            yield ObjectRef(ObjectID(b))

    def __len__(self) -> int:
        return len(self._ids)

    def __getitem__(self, i: int) -> ObjectRef:
        return ObjectRef(ObjectID(self._ids[i]))

    def __reduce__(self):
        return (ObjectRefGenerator, (self._ids,))

    def __repr__(self):
        return f"ObjectRefGenerator({len(self._ids)} refs)"


class _ObjArg:
    """Marker for a top-level ObjectRef argument (resolved pre-execution)."""

    __slots__ = ("id_bytes",)

    def __init__(self, id_bytes: bytes):
        self.id_bytes = id_bytes


_tracing_mod = None


def _tracing():
    # Lazy to dodge the import cycle at module load; cached after.
    global _tracing_mod
    if _tracing_mod is None:
        from ray_tpu_torch.util import tracing

        _tracing_mod = tracing
    return _tracing_mod


class _RefTracker:
    """Batches local ObjectRef incref/decref deltas to the GCS (the
    owner-table half of reference_count.h:61, aggregated centrally)."""

    def __init__(self, worker: "CoreWorker"):
        from ray_tpu_torch._private.config import config

        self._worker = worker
        # Lock-free delta logs (the r08 profile's incref tower was the
        # per-ref lock round trip): producers append bare oids to a
        # deque — a single GIL-atomic op — and the flusher consolidates.
        # Decrefs are drained FIRST each flush: for any incref(t1) <
        # decref(t2) pair, catching the decref implies the (earlier)
        # incref is caught in the same pass, so a flush can never ship a
        # ref's -1 ahead of its +1.
        self._inc_log: collections.deque = collections.deque()
        self._dec_log: collections.deque = collections.deque()
        self._lock = threading.Lock()   # serializes flush consumers only
        self._stop = threading.Event()
        self._interval = max(0.01, config.refcount_flush_ms / 1000.0)
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="rtpu-refcount")
        self._thread.start()

    def incref(self, oid: bytes):
        self._inc_log.append(oid)

    def decref(self, oid: bytes):
        self._dec_log.append(oid)

    def incref_many(self, oids):
        self._inc_log.extend(oids)

    def decref_many(self, oids):
        self._dec_log.extend(oids)

    def _loop(self):
        while not self._stop.wait(self._interval):
            self.flush()

    # Deltas per notify: bounds how long one GCS handler invocation
    # holds the global lock. Unchunked, a 100k-task submission burst
    # flushed as ONE message stalls scheduling for seconds (SCALE_r04:
    # p95 placement 6.3 s behind a 100k queue).
    _FLUSH_CHUNK = 2000

    def flush(self):
        with self._lock:
            deltas: Dict[bytes, int] = {}
            dec, inc = self._dec_log, self._inc_log
            # Decrefs first — see __init__ for the ordering argument.
            # Bounded by the logs' CURRENT lengths so concurrent
            # producers can't spin this consumer forever.
            for _ in range(len(dec)):
                try:
                    oid = dec.popleft()
                except IndexError:
                    break
                deltas[oid] = deltas.get(oid, 0) - 1
            for _ in range(len(inc)):
                try:
                    oid = inc.popleft()
                except IndexError:
                    break
                deltas[oid] = deltas.get(oid, 0) + 1
        # Net-zero deltas are still sent: they tell the GCS this object was
        # referenced at all (creating its count entry), so a ref born and
        # dropped within one flush window still becomes free-eligible.
        if not deltas:
            return
        items = list(deltas.items())
        for i in range(0, len(items), self._FLUSH_CHUNK):
            try:
                self._worker.gcs.notify("update_refcounts", {
                    "client_id": self._worker.client_id,
                    "deltas": dict(items[i:i + self._FLUSH_CHUNK])})
            except Exception:
                return  # disconnecting; the GCS drops our counts anyway

    def stop(self):
        self._stop.set()
        self.flush()


class _GcsChannel:
    """Auto-reconnecting GCS client connection.

    A dropped connection (GCS crash + restart, reference: GCS fault
    tolerance via gcs_rpc_client retry) is redialed on the next call; the
    client re-registers under its existing identity (drivers keep their
    job id via ``existing_job``) and the operation is retried once.
    """

    def __init__(self, address: str, handler, name: str):
        self._address = address
        self._handler = handler
        self._name = name
        self._conn = protocol.connect(address, handler=handler, name=name)
        self._lock = threading.Lock()
        self._register_payload: Optional[dict] = None
        self._closed = False

    def set_reconnect_registration(self, payload: dict):
        self._register_payload = payload

    def _reconnect(self, dead_conn) -> protocol.Conn:
        # raylint: disable-next=blocking-under-lock (the redial lock:
        # every thread queued on it needs the very conn this dial is
        # establishing, and both the connect and the re-register carry
        # explicit bounds (<=30s, tightened by gcs_rpc_timeout_s))
        with self._lock:
            if self._closed:
                raise protocol.ConnectionClosed()
            if self._conn is not dead_conn and not self._conn.closed:
                return self._conn  # another thread already reconnected
            # Dial bound: a GCS that stays dead surfaces as a typed
            # ConnectionError within the control-RPC budget, never a
            # longer park than the caller's own timeout discipline.
            dial = min(30.0, float(config.gcs_rpc_timeout_s))
            conn = protocol.connect(self._address, handler=self._handler,
                                    name=self._name, timeout=dial)
            if self._register_payload is not None:
                conn.request("register_client", self._register_payload,
                             timeout=dial)
            self._conn = conn
            return conn

    def _call(self, fn_name: str, *args, **kwargs):
        conn = self._conn
        try:
            return getattr(conn, fn_name)(*args, **kwargs)
        except TimeoutError:
            # The caller's own bound ran out on a live connection (Python's
            # TimeoutError is an OSError): redialing would only repeat the
            # wait until gcs_rpc_timeout_s. The reference's channel does
            # that, so its pg.wait(1) takes a minute.
            raise
        except (protocol.ConnectionClosed, OSError):
            if self._closed or self._register_payload is None:
                raise
            # Redial WINDOW, not a single attempt: a crashed GCS
            # relaunching on the same port is unreachable for the few
            # seconds its replacement takes to bind — one immediate
            # redial only covers the already-back case and turned
            # every restart into a spurious ConnectionClosed at the
            # caller (in-flight get()s included). Bounded by the
            # control-RPC budget so a GCS that STAYS dead still fails
            # typed within ~gcs_rpc_timeout_s.
            deadline = time.time() + float(config.gcs_rpc_timeout_s)
            delay = 0.1
            while True:
                redialed = False
                try:
                    conn2 = self._reconnect(conn)
                    redialed = True
                    return getattr(conn2, fn_name)(*args, **kwargs)
                except (protocol.ConnectionClosed, OSError) as e:
                    if self._closed or (redialed and
                                        isinstance(e, TimeoutError)):
                        raise
                    conn = self._conn
                    if time.time() >= deadline:
                        raise
                    time.sleep(min(delay,
                                   max(0.0, deadline - time.time())))
                    delay = min(delay * 2, 2.0)

    # Explicit opt-out from the default RPC bound, for requests the GCS
    # deliberately parks server-side (wait_for_objects with no user
    # deadline): the wait is the user's contract, not a wedged peer.
    UNBOUNDED = float("inf")

    def request(self, mtype, payload=None, timeout=None):
        """Control RPC with a bound by default: ``timeout=None`` means
        ``config.gcs_rpc_timeout_s`` (a wedged GCS surfaces as
        TimeoutError, not a parked control thread), ``UNBOUNDED`` opts
        out for server-parked waits."""
        if timeout is None:
            timeout = float(config.gcs_rpc_timeout_s)
        elif timeout == self.UNBOUNDED:
            timeout = None
        return self._call("request", mtype, payload, timeout=timeout)

    def request_nowait(self, *args, **kwargs):
        return self._call("request_nowait", *args, **kwargs)

    def notify(self, *args, **kwargs):
        return self._call("notify", *args, **kwargs)

    def flush(self, *args, **kwargs):
        return self._conn.flush(*args, **kwargs)

    @property
    def closed(self) -> bool:
        return self._conn.closed

    def reachable(self, timeout: float = 1.0) -> bool:
        """Whether the GCS is there: the connection is open, or a fresh
        one, dialed and asked one KV read, each bounded by ``timeout``,
        gets its reply (the next call redials a connection the GCS's
        restart closed). A listener on the address that does not answer
        is not the GCS."""
        if self._closed:
            return False
        if not self._conn.closed:
            return True
        try:
            conn = protocol.connect(self._address, name=self._name,
                                    timeout=timeout)
        except ConnectionError:
            return False
        try:
            conn.request("kv_get", {"key": b""}, timeout=timeout)
            return True
        except Exception:
            return False
        finally:
            conn.close()

    def close(self):
        self._closed = True
        self._conn.close()

    def close_if_unreachable(self) -> None:
        """Close the channel when its connection is down and the GCS
        does not answer ``reachable``: every later call then fails at
        once instead of redialing for ``gcs_rpc_timeout_s`` (60 s, each
        dial up to 30 s). The driver's shutdown calls it before its last
        flushes: the ref tracker's final delta alone waited 90 s on a
        dead GCS."""
        if self._conn.closed and not self.reachable():
            self.close()


class SubmitTemplate:
    """Per-RemoteFunction holder for a pre-serialized TaskSpec skeleton
    (see _private/spec_template.py), cached per CoreWorker generation —
    a re-init() changes job/client identity, invalidating the frozen
    constants."""

    __slots__ = ("tpl", "core", "uses")

    # Build only after a few eligible submissions: a template costs ~10
    # pickles to build+self-check, so a one-shot .options() clone must
    # not pay more than classic construction would have.
    WARMUP_CALLS = 3

    def __init__(self):
        # core set with tpl None == build failed for this core: the
        # submit path then stops trying (classic construction).
        self.tpl = None
        self.core = None
        self.uses = 0

    def __reduce__(self):
        # A RemoteFunction closure-captured into a task pickles its
        # holder along: ship a FRESH one. The frozen constants (caller
        # identity, job) are per-process anyway, and the built template
        # references this process's CoreWorker — neither may cross a
        # process boundary.
        return (SubmitTemplate, ())


class _TaskContext(threading.local):
    def __init__(self):
        self.task_id: Optional[TaskID] = None
        self.job_id: Optional[JobID] = None
        self.actor_id: Optional[ActorID] = None
        self.task_name: str = ""
        self.put_index: int = 0


class CoreWorker:
    """Shared runtime for drivers and workers."""

    def __init__(
        self,
        gcs_address: str,
        role: str,                       # "driver" | "worker"
        node_id: Optional[str] = None,
        store_path: Optional[str] = None,
        job_id: Optional[JobID] = None,
        client_id: Optional[str] = None,
        log_to_driver: bool = False,
    ):
        self.role = role
        self.client_id = client_id or uuid.uuid4().hex
        self._refs: Optional[_RefTracker] = None  # set after wiring completes
        self.gcs = _GcsChannel(gcs_address, self._on_gcs_msg,
                               name=f"{role}-gcs")
        self.gcs_address = gcs_address
        self._log_to_driver = log_to_driver and role == "driver"
        reply = self.gcs.request("register_client", {
            "client_id": self.client_id,
            "role": role,
            "job_id": job_id,
            "log_to_driver": self._log_to_driver,
        })
        self.job_id: JobID = reply["job_id"] if role == "driver" else job_id
        # Survive a GCS restart: later calls re-register with the same
        # identity (drivers keep their job id).
        self.gcs.set_reconnect_registration({
            "client_id": self.client_id, "role": role,
            "job_id": self.job_id,
            "existing_job": self.job_id if role == "driver" else None,
            "log_to_driver": self._log_to_driver,
        })
        self.node_id = node_id or reply["head_node_id"]
        store_path = store_path or reply["head_store_path"]
        if store_path is None:
            raise RuntimeError("no object store available (no nodes?)")
        self.store_path = store_path
        self.store = plasma.PlasmaClient(store_path)
        # Workers know their node manager from the spawn env; drivers
        # resolve it once via the nodes table (lazy).
        # raylint: disable-next=config-knob-drift (bootstrap identity:
        # set per-process by the spawning NM, not a tunable knob)
        self._nm_address_cache: Optional[str] = \
            os.environ.get("RAY_TPU_TORCH_NM_ADDRESS") or None
        # Create-backpressure: on a full store, ask our node manager to
        # spill before failing (reference: plasma CreateRequestQueue).
        self.store.on_full = self._request_spill

        self.ctx = _TaskContext()
        self._root_task_id = TaskID.for_task(self.job_id or JobID.from_int(0))
        if role == "driver":
            self.ctx.job_id = self.job_id
            self.ctx.task_id = self._root_task_id
        self.namespace = "default"

        self._exported_functions: set = set()
        self._function_cache: Dict[str, Any] = {}
        # Same-process device-object handoff (device_objects.py): weak
        # registry of torch tensors this process put/returned, keyed by
        # object id — a local get returns the original array by
        # reference, zero copies, never touching store or GCS.
        self._device_local: "weakref.WeakValueDictionary[bytes, Any]" = \
            weakref.WeakValueDictionary()
        # In-band small-object returns (inline_objects.py): blobs
        # delivered by lease completions / object_locations replies,
        # backing get()/deserialize_args with zero store round trips.
        # Byte-bounded LRU; a miss falls back to the GCS/store path.
        self._inline = inline_objects.InlineCache(
            int(config.worker_inline_cache_bytes))
        # Return oids of OUR in-flight submissions, a bounded
        # insertion-ordered window (entries popped as gets resolve
        # them, oldest halved out past _PENDING_RETURNS_MAX). The
        # get()/wait() hot scans probe it — lock-free, GIL-atomic —
        # to skip the per-ref store FFI probe for results that cannot
        # be local yet: under load each ctypes call pays a GIL
        # reacquisition behind this process's busy conn threads
        # (~180us measured vs 0.6us idle), and the scan paid it per
        # ref. Staleness is safe: a stale entry only routes one get
        # through the always-correct GCS wait path.
        self._pending_returns: Dict[bytes, None] = {}
        self._nm_conns: Dict[str, protocol.Conn] = {}
        self._nm_lock = threading.Lock()
        # actor_id bytes -> {"address": str|None, "pending": [...], "info": {}}
        self._actor_routes: Dict[bytes, Dict[str, Any]] = {}
        self._actor_lock = threading.Lock()
        self._actor_seqno: Dict[bytes, int] = {}
        # Route repair (repark / re-resolve) runs on this single dispatcher
        # thread, never on a connection's serve/writer thread: repair can
        # block (protocol.connect retries ~30s) and takes _actor_lock, and
        # future callbacks may fire inline on whatever thread completes the
        # future — including one already holding _actor_lock.
        self._route_exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="rtpu-actor-route")
        self._closed = False
        from ray_tpu_torch._private.config import config as _cfg

        # Pull admission control: bounds in-flight transfer chunks across
        # all concurrent pulls (reference: pull_manager.h:52).
        self._pull_sem = threading.Semaphore(
            max(1, int(_cfg.pull_max_inflight_chunks)))
        if _cfg.refcount_enabled:
            self._refs = _RefTracker(self)
        # Local-first task scheduling (reference: the raylet's hybrid
        # local-first policy + direct_task_transport.h:75): same-shape
        # tasks stream straight to leased workers, with leases granted by
        # the caller's OWN node manager when resources fit (GCS consulted
        # only on spillback). local_scheduling_enabled=0 disables the
        # whole decentralized path — every task then serializes through
        # the central GCS scheduler (the A/B baseline).
        self._lease_mgr = None
        self._lease_mgr_lock = threading.Lock()
        self._lease_wanted = bool(_cfg.lease_enabled
                                  and _cfg.local_scheduling_enabled)
        if self._lease_wanted and role == "driver":
            from ray_tpu_torch._private.lease import LeaseManager

            self._lease_mgr = LeaseManager(self)
        # Shm completion ring (SCALE_r10 stage 2): registered lazily
        # with our own NM on the first submission (drivers only; see
        # _maybe_register_completion_ring). 0=never tried,
        # 1=registering, 2=active, 3=dead/unavailable. x86-64 only for
        # the same store-store-ordering reason as the submit ring.
        import platform as _platform

        self._comp_ring = None
        self._comp_ring_state = 0
        self._comp_ring_thread: Optional[threading.Thread] = None
        self._comp_ring_pause = False   # test seam: consumer idles
        self._comp_ring_lock = threading.Lock()
        self._comp_ring_enabled = (
            role == "driver"
            and bool(_cfg.completion_ring_enabled)
            and _platform.machine() in ("x86_64", "AMD64"))
        # Worker completion segments: per-worker SPSC
        # segments beside the main ring, attached over the lease conn
        # after we advertise the ring, drained by the same consumer
        # thread. path -> {"seg": SegmentConsumer, "conn": lease conn,
        # "closing": bool}; only the consumer thread ever drains or
        # closes a segment (single-consumer) — other threads just flag
        # "closing" under _comp_ring_lock.
        self._comp_segments: Dict[str, Dict[str, Any]] = {}
        self._worker_ring_enabled = (
            self._comp_ring_enabled
            and bool(_cfg.worker_completion_ring_enabled))
        # Workers get theirs lazily, on their first task submission:
        # LeaseManager construction costs a nodes() RPC + an NM pre-dial
        # + a flusher thread, and most actor/task workers never submit —
        # under a 200-actor churn burst those boot RPCs alone saturate
        # the head process.

        # Always-on sampling profiler (profiler_always_on): one
        # idempotent daemon sampler per process, stopped in
        # disconnect() — init()/shutdown() cycles never stack samplers.
        from ray_tpu_torch._private import profiler as profiler_mod

        profiler_mod.maybe_start_always_on()

    def _ensure_lease_mgr(self):
        if self._lease_mgr is None and self._lease_wanted \
                and not self._closed:
            from ray_tpu_torch._private.lease import LeaseManager

            with self._lease_mgr_lock:
                if self._lease_mgr is None:
                    self._lease_mgr = LeaseManager(self)
        return self._lease_mgr

    def _route_submit(self, fn, *args):
        try:
            self._route_exec.submit(fn, *args)
        except RuntimeError:  # executor shut down: worker is disconnecting
            pass

    # ----------------------------------------------------------- plumbing

    def _on_gcs_msg(self, conn, mtype, payload, msg_id):
        if mtype == "profile":
            # Driver-side sampling profile (`ray_tpu_torch profile --driver`):
            # answered over THIS conn but off its serve thread — the
            # window lasts seconds, and this thread must keep delivering
            # GCS replies (including, possibly, the very profile request
            # this driver itself issued).
            threading.Thread(
                target=self._reply_profile, args=(conn, msg_id, payload),
                daemon=True, name="rtpu-driver-profile").start()
            return
        if mtype == "revoke_lease":
            lm = self._lease_mgr
            if lm is not None:
                lm.revoke(payload.get("lease_id"))
            return
        if mtype == "pubsub":
            fn = _pubsub_dispatch
            if fn is not None:
                try:
                    fn(payload)
                except Exception:
                    pass
            return
        if mtype == "driver_logs" and self._log_to_driver:
            # Re-print remote worker output locally (reference:
            # worker.print_logs / print_to_stdstream, _private/worker.py),
            # prefixed with the producing worker's identity.
            import sys as _sys

            node12 = (payload.get("node_id") or "")[:12]
            for e in payload.get("entries", []):
                stream = _sys.stderr if e.get("stream") == "stderr"                     else _sys.stdout
                prefix = f"({e.get('worker_id', '?')} pid={e.get('pid')}"                          f" node={node12})"
                for line in e.get("lines", []):
                    print(f"{prefix} {line}", file=stream)
            try:
                stream.flush()
            except Exception:
                pass

    def _reply_profile(self, conn, msg_id, payload):
        from ray_tpu_torch._private import profiler

        p = payload or {}
        try:
            out = profiler.profile_self(
                duration_s=float(p.get("duration_s", 5.0)),
                hz=p.get("hz"),
                mode=p.get("mode", "wall"),
                kind=self.role,
                node_id=self.node_id,
                client_id=self.client_id,
            )
            conn.reply(msg_id, out)
        except protocol.ConnectionClosed:
            pass
        except Exception as e:
            try:
                conn.reply_error(msg_id, f"{type(e).__name__}: {e}")
            except protocol.ConnectionClosed:
                pass

    def _own_nm_address(self) -> Optional[str]:
        if self._nm_address_cache is None:
            try:
                for n in self.nodes():
                    if n["NodeID"] == self.node_id:
                        self._nm_address_cache = n["NodeManagerAddress"]
                        break
            except Exception:
                return None
        return self._nm_address_cache

    def _request_spill(self, needed: int) -> bool:
        addr = self._own_nm_address()
        if addr is None:
            return False
        try:
            freed = self.nm_conn(addr).request(
                "spill_now", {"needed": needed}, timeout=120)
        except (protocol.ConnectionClosed, TimeoutError, OSError):
            return False
        return bool(freed)

    def _on_nm_msg(self, conn, mtype, payload, msg_id):
        if mtype == "leased_worker_killed":
            lm = self._lease_mgr
            if lm is not None:
                lm.note_worker_killed(payload.get("worker_id"),
                                      payload.get("reason", ""))
        elif mtype == "revoke_lease":
            # Node manager revoking one of its local grants (classic-
            # queue fairness): drain and return, same as a GCS revoke.
            lm = self._lease_mgr
            if lm is not None:
                lm.revoke(payload.get("lease_id"))

    def nm_conn_cached(self, address: str) -> Optional[protocol.Conn]:
        """The cached live conn to a node manager, or None — never dials
        (safe to call from latency-sensitive paths holding locks)."""
        with self._nm_lock:
            conn = self._nm_conns.get(address)
        return conn if conn is not None and not conn.closed else None

    def nm_conn(self, address: str,
                connect_timeout: float = 30.0) -> protocol.Conn:
        with self._nm_lock:
            conn = self._nm_conns.get(address)
            if conn is not None and not conn.closed:
                return conn
        conn = protocol.connect(address, handler=self._on_nm_msg,
                                name=f"{self.role}-nm",
                                timeout=connect_timeout)
        with self._nm_lock:
            existing = self._nm_conns.get(address)
            if existing is not None and not existing.closed:
                # lost the connect race; use the winner
                conn.close()
                return existing
            self._nm_conns[address] = conn
        return conn

    def disconnect(self):
        if self._closed:
            return
        self._closed = True
        # Observability teardown first, while the GCS channel is still
        # open: join the metrics reporter thread (repeated
        # init()/shutdown() cycles must not stack reporters) and flush
        # any buffered driverside trace spans.
        from ray_tpu_torch.util import metrics as metrics_mod
        from ray_tpu_torch.util import tracing as tracing_mod

        try:
            metrics_mod.stop_reporter()
        except Exception:
            pass
        try:
            from ray_tpu_torch._private import profiler as profiler_mod

            profiler_mod.stop_always_on()
        except Exception:
            pass
        try:
            tracing_mod.flush_spans()
        except Exception:
            pass
        # Completion-ring teardown BEFORE the conns close: stop the
        # consumer thread (its finally unlinks the ring file and the
        # doorbell — no mmap or socket may outlive the driver).
        ring = self._comp_ring
        if ring is not None:
            self._comp_ring = None
            ring.stopped = True
            t = self._comp_ring_thread
            if t is not None and t.is_alive():
                t.join(timeout=2.0)
            try:
                ring.close()   # idempotent; covers a never-started loop
            except Exception:
                pass
        if self._lease_mgr is not None:
            try:
                self._lease_mgr.close()
            except Exception:
                pass
            self._lease_mgr = None
        if self._refs is not None:
            self._refs.stop()
            self._refs = None
        self._route_exec.shutdown(wait=False)
        try:
            self.gcs.close()
        except Exception:
            pass
        with self._nm_lock:
            for conn in self._nm_conns.values():
                conn.close()
            self._nm_conns.clear()
        try:
            self.store.close()
        except Exception:
            pass

    # ------------------------------------------------------------ functions

    def export_function(self, blob: bytes) -> str:
        key = hashlib.sha1(blob).hexdigest()
        if key not in self._exported_functions:
            self.gcs.request("put_function", {"key": key, "blob": blob})
            self._exported_functions.add(key)
        return key

    def fetch_function(self, key: str):
        fn = self._function_cache.get(key)
        if fn is None:
            blob = self.gcs.request("get_function", {"key": key})
            if blob is None:
                raise RuntimeError(f"function {key} not found in GCS")
            fn = pickler.loads(blob)
            self._function_cache[key] = fn
        return fn

    # -------------------------------------------------------------- objects

    def next_put_id(self) -> ObjectID:
        # ctx is thread-local: user threads (and library threads, e.g. serve
        # routers) fall back to a per-process root task id.
        if self.ctx.task_id is None:
            self.ctx.task_id = self._root_task_id
            self.ctx.job_id = self.job_id
        self.ctx.put_index += 1
        return ObjectID.for_put(self.ctx.task_id, self.ctx.put_index)

    def put(self, value) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("Calling put on an ObjectRef is not allowed")
        oid = self.next_put_id()
        size = self.store.put_value(oid.binary(), value)
        device_objects.core_note_put(self, oid.binary(), value)
        self.gcs.notify("add_object_locations", {
            "node_id": self.node_id,
            "objects": [(oid.binary(), size)],
        })
        return ObjectRef(oid)

    def put_serialized(self, sobj: serialization.SerializedObject) -> ObjectRef:
        oid = self.next_put_id()
        size = self.store.put_serialized(oid.binary(), sobj)
        self.gcs.notify("add_object_locations", {
            "node_id": self.node_id,
            "objects": [(oid.binary(), size)],
        })
        return ObjectRef(oid)

    def _store_local(self, oid: bytes, data: bytes) -> None:
        try:
            buf = self.store.create(oid, len(data))
        except plasma.ObjectExistsError:
            return
        try:
            buf[:] = data
        finally:
            del buf
        self.store.seal(oid)

    def ensure_local(self, id_bytes_list: List[bytes],
                     timeout: Optional[float] = None) -> Dict[bytes, str]:
        """Block until all ids are present in the local store.

        Returns {id: failure_reason} for ids that failed instead. Raises
        GetTimeoutError on timeout.
        """
        lm = self._lease_mgr
        inflight = lm.inflight_map() if lm is not None else None
        pend = self._pending_returns
        missing = []
        for o in id_bytes_list:
            if o in self._inline:
                pend.pop(o, None)
                continue
            if (inflight is not None and o in inflight) or o in pend:
                # A return of one of OUR in-flight submissions: the
                # lease completion event / GCS wait path decides
                # readiness — not a ctypes store probe per ref, which
                # inline returns made pure waste (the result never
                # touches the store, and under load each FFI call pays
                # a GIL reacquisition behind the busy conn threads).
                missing.append(o)
                continue
            if not self.store.contains(o):
                missing.append(o)
        failures: Dict[bytes, str] = {}
        if not missing:
            return failures
        deadline = time.time() + timeout if timeout is not None else None
        missing = self._wait_lease_local(missing, deadline)
        if not missing:
            return failures
        pending = set(missing)
        while pending:
            t = None
            if deadline is not None:
                t = max(0.0, deadline - time.time())
            # Server-parked wait: with no user deadline the GCS holds
            # the reply until the objects land — unbounded is the
            # get()-with-no-timeout user contract, not a wedged peer.
            reply = self.gcs.request("wait_for_objects", {
                "object_ids": list(pending),
                "num_returns": len(pending),
                "timeout": t,
            }, timeout=self.gcs.UNBOUNDED if t is None else t + 30.0)
            if reply.get("timeout"):
                raise exceptions.GetTimeoutError(
                    f"{len(pending)} object(s) not ready within timeout")
            for oid, reason in (reply.get("failed") or {}).items():
                failures[oid] = reason or "task failed"
                pending.discard(oid)
            ready = [o for o in reply["ready"] if o in pending]
            if ready:
                inlined = self._pull_objects(ready)
                still_missing = False
                for o in ready:
                    # A pull can be undone before we read it (restored
                    # object re-spilled under memory pressure) — only
                    # count objects that actually landed; retry the rest.
                    # Inline objects "land" in the process-local cache
                    # (an oid whose blob came back inline counts even if
                    # a tiny cache already churned it out: the reader's
                    # _fetch_inline backstop owns that case).
                    if o in inlined or o in self._inline \
                            or self.store.contains(o):
                        pending.discard(o)
                        pend.pop(o, None)
                    else:
                        still_missing = True
                if still_missing:
                    if deadline is not None and time.time() >= deadline:
                        raise exceptions.GetTimeoutError(
                            f"{len(pending)} object(s) ready elsewhere but "
                            f"not pulled within timeout")
                    time.sleep(0.05)
        return failures

    def _wait_lease_local(self, missing: List[bytes],
                          deadline: Optional[float]) -> List[bytes]:
        """Resolve objects produced by our own in-flight lease tasks
        without touching the GCS: wait on the local completion event,
        then read the local store (same node) or fetch from the producing
        node directly. Returns the ids that still need the GCS path."""
        lm = self._lease_mgr
        if lm is None:
            return missing
        rest: List[bytes] = []
        for oid in missing:
            ent = lm.peek(oid)
            if ent is None:
                rest.append(oid)
                continue
            # Parallel wave collection (SCALE_r10 stage 3): instead of
            # idling on the completion event while frames queue behind
            # one absorb thread, absorb them HERE — one may be the very
            # frame carrying this oid. Frames can land at ANY moment
            # while we block, so the steal interleaves with bounded
            # event waits (backing off to 50 ms) rather than running
            # once up front and then parking unconditionally.
            if lm.steal_enabled():
                step = 0.002
                while not ent["ev"].is_set():
                    while not ent["ev"].is_set() and lm.steal_absorb():
                        pass
                    t = None if deadline is None \
                        else deadline - time.time()
                    if t is not None and t <= 0:
                        raise exceptions.GetTimeoutError(
                            "object not ready within timeout")
                    if ent["ev"].wait(step if t is None
                                      else min(step, t)):
                        break
                    step = min(step * 2, 0.05)
            else:
                t = None if deadline is None else max(0.0,
                                                      deadline - time.time())
                if not ent["ev"].wait(t):
                    raise exceptions.GetTimeoutError(
                        "object not ready within timeout")
            err = ent.get("error")
            if err is not None:
                # Absorption died on this lease's completion frame: a
                # typed failure at get(), never a silent hang (the
                # worker may have run the task, but its result can no
                # longer be attributed).
                raise err
            info = ent.get("info")
            if info is None:          # task fell back to the scheduled path
                rest.append(oid)
                continue
            if oid in self._inline or self.store.contains(oid):
                # Inline lease results were delivered straight into the
                # local cache by the completion handler — no store read,
                # no fetch.
                self._pending_returns.pop(oid, None)
                continue
            if ent.get("inline"):
                # Delivered in-band but churned out of a small cache:
                # NO store copy exists on any node — dialing the
                # producer would park in its store wait. The GCS inline
                # table serves it on the directory path.
                rest.append(oid)
                continue
            node_id, nm_address, _size = info
            if node_id != self.node_id and \
                    self._fetch_from(nm_address, oid):
                continue
            rest.append(oid)          # evicted/spilled etc: GCS path
        return rest

    def _fetch_from(self, address: str, oid: bytes) -> bool:
        """Pull one object from a known holder node into the local store.

        Chunked (reference: 5 MiB object-manager chunks, pull admission
        pull_manager.h:52): the first chunk request learns the total size,
        the object is created straight in the local shm arena, and the
        remaining chunks stream with a bounded in-flight window shared by
        all concurrent pulls in this process — peak heap is
        O(window * chunk), never O(object).
        """
        from ray_tpu_torch._private.config import config as _cfg

        chunk = int(_cfg.fetch_chunk_bytes)
        try:
            # The directory lists a node that sealed this object, so it
            # was listening: a refused connection means it is gone (the
            # GCS may not know yet). Fail fast, and let the caller's wait
            # loop ask the GCS again, rather than retry the connect for
            # connect()'s default 30 s, past a get's timeout.
            conn = self.nm_conn(address, connect_timeout=_FETCH_CONNECT_S)
            first = conn.request("fetch_object_chunk", {
                "object_id": oid, "offset": 0, "length": chunk},
                timeout=60)
        except (protocol.ConnectionClosed, protocol.RemoteCallError,
                TimeoutError, OSError):
            return False
        if first is None:
            return False
        total = first["size"]
        data0 = first["data"]
        if total <= len(data0):
            self._store_local(oid, data0)
            self.gcs.notify("add_object_locations", {
                "node_id": self.node_id, "objects": [(oid, total)]})
            return True
        try:
            buf = self.store.create(oid, total)
        except plasma.ObjectExistsError:
            return True   # someone else pulled it meanwhile
        except plasma.StoreFullError:
            if not self._request_spill(total) and not \
                    self.store.contains(oid):
                return False
            try:
                buf = self.store.create(oid, total)
            except (plasma.ObjectExistsError,):
                return True
            except plasma.StoreFullError:
                return False
        ok = False
        try:
            buf[:len(data0)] = data0
            del data0, first
            sem = self._pull_sem
            failed = threading.Event()
            cv = threading.Condition()
            outstanding = [0]

            def on_chunk(off, f):
                try:
                    rep = f.result(0)
                    if rep is None:
                        raise ValueError("chunk unavailable")
                    buf[off:off + len(rep["data"])] = rep["data"]
                except BaseException:
                    failed.set()
                finally:
                    sem.release()
                    with cv:
                        outstanding[0] -= 1
                        cv.notify()

            sent_all = True
            for off in range(chunk, total, chunk):
                sem.acquire()
                if failed.is_set():
                    sem.release()
                    sent_all = False
                    break
                try:
                    fut = conn.request_nowait("fetch_object_chunk", {
                        "object_id": oid, "offset": off,
                        "length": min(chunk, total - off)})
                except BaseException:
                    sem.release()
                    failed.set()
                    sent_all = False
                    break
                with cv:
                    outstanding[0] += 1
                fut.add_done_callback(lambda f, o=off: on_chunk(o, f))
            # Drain the in-flight window (futures always complete: the
            # conn errors them out on close).
            with cv:
                cv.wait_for(lambda: outstanding[0] == 0, timeout=300)
                drained = outstanding[0] == 0
            ok = sent_all and drained and not failed.is_set()
        finally:
            del buf
            if ok:
                self.store.seal(oid)
            else:
                try:
                    self.store.abort(oid)
                except Exception:
                    pass
        if not ok:
            return False
        self.gcs.notify("add_object_locations", {
            "node_id": self.node_id, "objects": [(oid, total)]})
        return True

    def _pull_objects(self, id_bytes_list: List[bytes]) -> Set[bytes]:
        """Fetch objects that are ready somewhere into the local store
        (or, for inline objects, into the local inline cache — the
        object_locations reply carries the blob itself). Returns the
        oids served inline."""
        inlined: Set[bytes] = set()
        to_pull = [o for o in id_bytes_list
                   if o not in self._inline and not self.store.contains(o)]
        if not to_pull:
            return inlined
        locs = self.gcs.request("object_locations", {"object_ids": to_pull})
        for oid in to_pull:
            if self.store.contains(oid):
                continue
            info = locs.get(oid) or {}
            blob = info.get("inline")
            if blob is not None:
                # The object's only copy is the GCS inline table: the
                # directory lookup IS the transfer (no node hop).
                self._inline.put(oid, blob)
                inlined.add(oid)
                continue
            for node_id, address in info.get("locations", []):
                if node_id == self.node_id:
                    # Listed as local but store.contains said no: spilled
                    # (ask our node manager to restore from disk), being
                    # created right now, or LRU-evicted. On restore failure
                    # fall through to remote replicas.
                    try:
                        ok = self.nm_conn(address).request(
                            "restore_object", {"object_id": oid},
                            timeout=30)
                    except (protocol.ConnectionClosed,
                            protocol.RemoteCallError, TimeoutError,
                            OSError):
                        # Handler-side failures (e.g. StoreFullError during
                        # restore) must fall through to remote replicas;
                        # the copy may still be on disk, so the caller's
                        # wait loop retries until its deadline.
                        continue
                    if ok and self.store.contains(oid):
                        break
                    if ok is False:
                        # The node manager answered: neither in the store
                        # nor readable from a spill file. The copy is gone
                        # (evicted or deleted) but the directory still
                        # lists it. Drop the stale entry, on the conn of
                        # the next wait, so that wait sees the object lost
                        # and rebuilds it from its lineage rather than
                        # naming this node again.
                        self.gcs.notify("remove_object_location", {
                            "object_id": oid, "node_id": self.node_id})
                    continue
                if self._fetch_from(address, oid):
                    break
        return inlined

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        if not isinstance(refs, (list, tuple)):
            raise TypeError(
                f"get() expects an ObjectRef or list, got {type(refs)}")
        for r in refs:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() list items must be ObjectRef, got "
                                f"{type(r)}")
        ids = [r.binary() for r in refs]
        lm = self._lease_mgr
        if lm is not None:
            # About to block: ship any coalesced submit batches first.
            lm.flush_sends()
        # Same-process device-object handoff: refs whose value this
        # process itself put resolve by reference — no store read, no
        # GCS wait, no DMA (the array never left HBM).
        local_hits: Dict[bytes, Any] = {}
        for oid in ids:
            hit = device_objects.core_lookup_local(self, oid)
            if hit is not None:
                local_hits[oid] = hit
        remaining = [o for o in ids if o not in local_hits]
        failures = self.ensure_local(remaining, timeout=timeout) \
            if remaining else {}
        out = []
        for oid in ids:
            if oid in local_hits:
                out.append(local_hits[oid])
                continue
            out.append(self._resolve_ready_value(oid, failures))
        return out[0] if single else out

    def _resolve_ready_value(self, oid: bytes, failures: Dict[bytes, str]):
        """Value of a ready object via the inline/store cascade (shared
        by get() and deserialize_args — the fallback ORDER is the
        contract): local inline cache -> store -> directory backstop
        (_fetch_inline) -> late store copy. ``failures`` is the
        ensure_local failure map for the batch; a task error re-raises
        as its original exception."""
        # In-band small returns: the framed blob is already in this
        # process (lease delivery or object_locations reply) — no
        # store round trip at all. Same error semantics as the
        # store path below.
        blob = self._inline.get(oid)
        if blob is None and not self.store.contains(oid):
            # Ready but in neither the local cache nor the store:
            # either an inline blob churned out of a small cache
            # (the GCS table still holds it — one directory round
            # trip, cheaper than parking on the store) or a store
            # object mid-seal (falls through to the store wait).
            if oid in failures:
                raise _error_from_reason(failures[oid])
            blob = self._fetch_inline(oid)
        if blob is not None:
            value = serialization.loads_oob(blob)
        else:
            if oid in failures and not self.store.contains(oid):
                raise _error_from_reason(failures[oid])
            value, ok = self.store.get_value(oid, timeout_ms=30_000)
            if not ok:
                blob = self._fetch_inline(oid)
                if blob is not None:
                    value = serialization.loads_oob(blob)
                else:
                    # The backstop pull may have landed a STORE
                    # copy (table entry spilled to a node) rather
                    # than a blob.
                    value, ok = self.store.get_value(
                        oid, timeout_ms=1_000)
                    if not ok:
                        raise exceptions.ObjectLostError(oid.hex())
        if isinstance(value, exceptions.RayTaskError):
            raise value.as_instanceof_cause()
        if isinstance(value, exceptions.RayTpuError):
            raise value
        return value

    def _fetch_inline(self, oid: bytes) -> Optional[bytes]:
        """Directory-lookup backstop for an inline object missing from
        the local cache AND the store. One object_locations round trip
        resolves BOTH ways the blob can have moved on: the reply still
        carries it (GCS inline table holds the copy — returned
        directly, so a disabled/churned local cache cannot drop it), or
        the table entry was pressure-materialized into some node's
        store — then the copy is pulled local and the caller's store
        path serves it (ignoring store locations here would stall 30 s
        on the local store and raise a spurious ObjectLostError for an
        object alive on another node)."""
        try:
            locs = self.gcs.request("object_locations",
                                    {"object_ids": [oid]})
        except Exception:
            return None
        info = locs.get(oid) or {}
        blob = info.get("inline")
        if blob is not None:
            return blob
        for node_id, address in info.get("locations", []):
            if node_id == self.node_id:
                continue   # local: the caller's store wait covers it
            if self._fetch_from(address, oid):
                break
        return None

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = True
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        if isinstance(refs, ObjectRef):
            raise TypeError("wait() expects a list of ObjectRefs")
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds the number of refs")
        if len(set(r.binary() for r in refs)) != len(refs):
            raise ValueError("wait() got duplicate ObjectRefs")
        ids = [r.binary() for r in refs]
        if self._lease_mgr is not None:
            # About to block: ship any coalesced submit batches first.
            self._lease_mgr.flush_sends()
        lm = self._lease_mgr
        inflight = lm.inflight_map() if lm is not None else None
        pend = self._pending_returns
        ready_set = set()

        def scan(candidates):
            # Probe in refs order and STOP once num_returns are
            # satisfied: the result below only takes the first
            # num_returns ready refs anyway, so probing past that
            # point re-pays the peek/store cost every poll iteration
            # for refs the caller already collected.
            for o in candidates:
                if len(ready_set) >= num_returns:
                    break
                if o in ready_set:
                    continue
                if o in self._inline:
                    ready_set.add(o)
                    continue
                if inflight is not None and o in inflight:
                    # Completed-but-not-yet-flushed lease tasks are
                    # ready too; pending ones wait on their completion
                    # event — either way no per-ref ctypes store
                    # probe. An absorb-failed entry counts as ready:
                    # the get() surfaces its typed error.
                    ent = lm.peek(o)
                    if ent is not None and (
                            ent.get("error") is not None
                            or (ent["ev"].is_set()
                                and ent.get("info") is not None)):
                        ready_set.add(o)
                    continue
                if o in pend:
                    # A still-pending return of our own submission: the
                    # GCS wait below is authoritative (and a stale
                    # window entry only costs that one batched round
                    # trip).
                    continue
                if self.store.contains(o):
                    ready_set.add(o)

        scan(ids)
        if len(ready_set) < num_returns and lm is not None:
            # Parallel wave collection (SCALE_r10 stage 3): about to
            # block on the GCS, absorb any parked completion frames on
            # THIS thread first — one of them may carry the refs this
            # wait is polling for — then re-probe.
            stole = False
            while lm.steal_absorb():
                stole = True
            if stole:
                scan(ids)
        if len(ready_set) < num_returns:
            # Server-parked wait (see _wait_missing): unbounded only
            # when the caller passed no timeout — wait()'s contract.
            reply = self.gcs.request("wait_for_objects", {
                "object_ids": [o for o in ids if o not in ready_set],
                "num_returns": num_returns - len(ready_set),
                "timeout": timeout if timeout is not None else None,
            }, timeout=self.gcs.UNBOUNDED if timeout is None
                else timeout + 30.0)
            ready_set.update(reply["ready"])
            ready_set.update(reply.get("failed") or {})
        # Resolved returns leave the pending window: the next wait() on
        # the same ref probes the local store directly instead of paying
        # the GCS round trip again (poll loops call wait() repeatedly).
        for o in ready_set:
            pend.pop(o, None)
        ready, not_ready = [], []
        for r in refs:
            if r.binary() in ready_set and len(ready) < num_returns:
                ready.append(r)
            else:
                not_ready.append(r)
        if fetch_local and ready:
            try:
                self._pull_objects([r.binary() for r in ready])
            except Exception:
                pass
        return ready, not_ready

    def free(self, refs: Sequence[ObjectRef]):
        ids = [r.binary() for r in refs]
        # Explicit free must also evict locally-cached inline copies —
        # a later get() must see the loss, not a stale cached value.
        # OTHER processes' inline caches are not invalidated (no
        # client-side delete fan-out): a borrower that already pulled
        # the blob may keep serving it until its LRU churns. free()
        # while another process still uses the ref is undefined for
        # store objects too (the reference's free() contract) — inline
        # returns just fail stale instead of failing lost.
        for oid in ids:
            self._inline.pop(oid)
        self.gcs.request("free_objects", {"object_ids": ids})

    # ---------------------------------------------------------------- tasks

    _EMPTY_ARGS_BLOB: Optional[bytes] = None

    def _serialize_args(self, args, kwargs) -> Tuple[Any, List[ObjectID]]:
        """``(blob, deps)``, the reference's interface (the mirrored
        tests read it)."""
        blob, deps, _ = self._serialize_task_args(args, kwargs)
        return blob, deps

    def _serialize_task_args(self, args, kwargs
                             ) -> Tuple[Any, List[ObjectID],
                                        Tuple[ObjectID, ...]]:
        """``(blob, deps, nested)``: the framed args, the top-level refs
        the task waits for, and the refs nested inside the args, which
        it does not wait for but keeps pinned while it is in flight
        (``TaskSpec.nested_deps``)."""
        if not args and not kwargs:
            # Zero-arg calls are common on the hot path; reuse one blob.
            blob = CoreWorker._EMPTY_ARGS_BLOB
            if blob is None:
                blob = serialization.serialize(((), {})).to_bytes()
                CoreWorker._EMPTY_ARGS_BLOB = blob
            return blob, [], ()
        deps: List[ObjectID] = []
        proc_args = []
        for a in args:
            if isinstance(a, ObjectRef):
                deps.append(a.id)
                proc_args.append(_ObjArg(a.binary()))
            else:
                proc_args.append(a)
        proc_kwargs = {}
        for k, v in kwargs.items():
            if isinstance(v, ObjectRef):
                deps.append(v.id)
                proc_kwargs[k] = _ObjArg(v.binary())
            else:
                proc_kwargs[k] = v
        _nested_refs.ids = nested = []
        try:
            sobj = serialization.serialize((proc_args, proc_kwargs))
        finally:
            _nested_refs.ids = None
        nested = tuple(nested)
        if sobj.total_size() > _INLINE_ARG_LIMIT:
            ref = self.put_serialized(sobj)
            deps.append(ref.id)
            return ("ref", ref.binary()), deps, nested
        return sobj.to_bytes(), deps, nested

    def deserialize_args(self, args_blob) -> Tuple[tuple, dict]:
        # Zero-arg calls ship one well-known shared blob (_serialize_args
        # reuses it); recognize it by value and skip the unpickle — on
        # the nop-task hot path this is the whole args cost.
        blob = CoreWorker._EMPTY_ARGS_BLOB
        if blob is None:
            blob = serialization.serialize(((), {})).to_bytes()
            CoreWorker._EMPTY_ARGS_BLOB = blob
        if args_blob == blob:
            return (), {}
        if isinstance(args_blob, tuple) and args_blob[0] == "ref":
            oid = args_blob[1]
            failures = self.ensure_local([oid])
            if failures:
                raise _error_from_reason(failures[oid])
            value, ok = self.store.get_value(oid, timeout_ms=30_000)
            if not ok:
                raise exceptions.ObjectLostError(oid.hex())
            proc_args, proc_kwargs = value
        else:
            proc_args, proc_kwargs = serialization.loads_oob(args_blob)
        # Resolve top-level ObjectRef placeholders to their values.
        need = [a.id_bytes for a in proc_args if isinstance(a, _ObjArg)]
        need += [v.id_bytes for v in proc_kwargs.values()
                 if isinstance(v, _ObjArg)]
        if need:
            resolved: Dict[bytes, Any] = {}
            # Device objects this worker itself produced resolve by
            # reference (actor chaining steps on one GPU stays in device memory).
            for oid in need:
                hit = device_objects.core_lookup_local(self, oid)
                if hit is not None:
                    resolved[oid] = hit
            need = [o for o in need if o not in resolved]
            failures = self.ensure_local(need) if need else {}
            for oid in need:
                # Inline args: an upstream task's in-band return used as
                # this task's argument deserializes straight from the
                # delivered blob (ensure_local pulled it into the cache).
                resolved[oid] = self._resolve_ready_value(oid, failures)
            proc_args = [resolved[a.id_bytes] if isinstance(a, _ObjArg) else a
                         for a in proc_args]
            proc_kwargs = {k: resolved[v.id_bytes] if isinstance(v, _ObjArg)
                           else v for k, v in proc_kwargs.items()}
        return tuple(proc_args), proc_kwargs

    def _build_template(self, holder: SubmitTemplate, function_key, name,
                        num_returns, resources, max_retries, strategy,
                        pg_id, bundle_index, donate_result):
        from ray_tpu_torch._private import spec_template

        tpl = spec_template.build(dict(
            job_id=self.job_id, function_key=function_key,
            num_returns=num_returns, resources=resources, name=name,
            max_retries=max_retries, retries_left=0,
            caller_id=self.client_id, owner_node=self.node_id,
            scheduling_strategy=strategy, placement_group_id=pg_id,
            placement_group_bundle_index=bundle_index, runtime_env=None,
            donate_result=donate_result, arg_deps=[], trace_ctx=None))
        if tpl is not None:
            tpl.set_verify(bool(config.submit_template_verify))
        holder.tpl = tpl
        holder.core = self
        return tpl

    def submit_task(self, function_key: str, args, kwargs, *,
                    name: str = "", num_returns: int = 1,
                    resources: Dict[str, float],
                    max_retries: int = 0,
                    scheduling_strategy=None,
                    placement_group=None,
                    placement_group_bundle_index: int = -1,
                    runtime_env=None,
                    donate_result: bool = False,
                    template: Optional[SubmitTemplate] = None
                    ) -> List[ObjectRef]:
        if runtime_env:
            from ray_tpu_torch._private import runtime_env as renv_mod

            runtime_env = renv_mod.package_runtime_env(self.kv(), runtime_env)
        if args or kwargs:
            args_blob, deps, nested = self._serialize_task_args(args, kwargs)
        else:
            # Zero-arg fast path, inlined from _serialize_args.
            args_blob = CoreWorker._EMPTY_ARGS_BLOB
            if args_blob is None:
                args_blob, deps, nested = self._serialize_task_args(
                    args, kwargs)
            else:
                deps, nested = [], ()
        task_id = TaskID.for_task(self.job_id)
        trace_ctx = _tracing().for_submit()
        pg_id = placement_group.id if placement_group is not None else None
        spec = None
        if template is not None and not runtime_env \
                and config.submit_spec_template_enabled:
            # Pre-serialized spec template (spec_template.py): patch the
            # variable slots into the RemoteFunction's frozen skeleton —
            # no TaskSpec.__init__, no per-call pickle.dumps. The wire
            # bytes come attached as spec._wire for the framing layer.
            if template.core is self:
                tpl = template.tpl   # None when the build failed here
            else:
                template.uses += 1
                tpl = None
                if template.uses >= SubmitTemplate.WARMUP_CALLS:
                    tpl = self._build_template(
                        template, function_key, name, num_returns,
                        resources, max_retries, scheduling_strategy,
                        pg_id, placement_group_bundle_index,
                        donate_result)
            # accepts() inlined: this runs once per submission.
            if tpl is not None and trace_ctx is None and not deps \
                    and not nested and type(args_blob) is bytes \
                    and len(args_blob) < tpl.max_args:
                # Blob-only classic route: when the lease path is known
                # to decline this shape right now (denial window) — or
                # the shape was never lease-eligible — ship template-
                # patched BYTES and never materialize a TaskSpec at all;
                # the GCS's batch handler builds the only spec object
                # that ever exists. Skipped in verify mode so make()'s
                # byte-equality check still covers every submission.
                lm = self._lease_mgr or self._ensure_lease_mgr()
                if lm is not None and not tpl._verify \
                        and (lm.classic_route(resources)
                             or not lm.eligible(resources,
                                                scheduling_strategy,
                                                placement_group,
                                                runtime_env)):
                    if lm.submit_classic_patch(tpl, task_id._bytes,
                                               args_blob, time.time()):
                        return self._wrap_return_refs(task_id,
                                                      num_returns, None)
                spec = (tpl.make(task_id, args_blob, time.time())
                        if tpl._verify else
                        tpl.make_lazy(task_id, args_blob, time.time()))
        if spec is None:
            spec = TaskSpec(
                task_id=task_id,
                job_id=self.job_id,
                function_key=function_key,
                args=args_blob,
                arg_deps=deps,
                num_returns=num_returns,
                resources=resources,
                name=name,
                max_retries=max_retries,
                caller_id=self.client_id,
                owner_node=self.node_id,
                scheduling_strategy=scheduling_strategy,
                placement_group_id=pg_id,
                placement_group_bundle_index=placement_group_bundle_index,
                runtime_env=runtime_env,
                donate_result=donate_result,
                trace_ctx=trace_ctx,
                nested_deps=nested,
            )
        # Direct transport first: plain tasks stream to a leased worker
        # (submit() declines when closed/over capacity -> scheduled path).
        lm = self._lease_mgr or self._ensure_lease_mgr()
        if not (lm is not None
                and lm.eligible(resources, scheduling_strategy,
                                placement_group, runtime_env)
                and lm.submit(spec)):
            # Classic (GCS-scheduled) path: dep-free specs coalesce into
            # submit_task_batch frames (or the shm submit ring) through
            # the lease manager's classic buffer; dep-carrying specs
            # keep the single-spec frame on THIS conn — same-conn FIFO
            # with the refcount flush preserves pin-before-decref.
            if lm is None or not lm.submit_classic(spec):
                self.gcs.notify("submit_task", spec)
        return self._wrap_return_refs(task_id, num_returns, spec)

    _PENDING_RETURNS_MAX = 65536

    def _note_pending_returns(self, oid_bytes_list) -> None:
        """Record just-minted return oids in the pending window (see
        _pending_returns in __init__). Amortized O(1): past the cap the
        oldest half is dropped in one pass — stale entries are safe."""
        if self._comp_ring_state == 0 and self._comp_ring_enabled:
            # First submission: register the shm completion ring with
            # our NM (one int compare per call after that).
            self._maybe_register_completion_ring()
        pend = self._pending_returns
        for b in oid_bytes_list:
            pend[b] = None
        if len(pend) > self._PENDING_RETURNS_MAX:
            try:
                stale = list(itertools.islice(
                    iter(pend), self._PENDING_RETURNS_MAX // 2))
            except RuntimeError:
                # Another thread mutated the dict mid-scan (inserts and
                # pops are lock-free): skip this trim, the next submit
                # past the cap retries.
                return
            for b in stale:
                pend.pop(b, None)

    # ------------------------------------------ completion ring (driver)

    def _maybe_register_completion_ring(self) -> None:
        """One-shot CAS into the registering state (0 -> 1); the actual
        registration (file create + NM round trip) runs on its own
        short-lived thread, never on the submit hot path."""
        with self._comp_ring_lock:
            if self._comp_ring_state != 0 or self._closed:
                return
            self._comp_ring_state = 1
        threading.Thread(target=self._register_completion_ring,
                         daemon=True, name="rtpu-compring-reg").start()

    def _register_completion_ring(self) -> None:
        """Create the ring file (the driver owns it — role inversion vs
        the submit ring) and ask our NM to produce into it."""
        from ray_tpu_torch._private import completion_ring

        ring = None
        try:
            addr = self._own_nm_address()
            if not addr:
                raise RuntimeError("no local node manager")
            path = os.path.join(
                os.path.dirname(self.store_path),
                f"comring_{os.getpid()}_{id(self) & 0xffffff:x}")
            ring = completion_ring.RingConsumer(
                path, int(config.completion_ring_bytes))
            ok = self.nm_conn(addr).request(
                protocol.REGISTER_COMPLETION_RING,
                {"client_id": self.client_id, "path": path},
                timeout=min(30.0, float(config.gcs_rpc_timeout_s)))
            if not ok:
                raise RuntimeError("node manager declined completion ring")
            self._comp_ring = ring
            self._comp_ring_state = 2
            t = threading.Thread(target=self._completion_ring_loop,
                                 daemon=True, name="rtpu-completion-ring")
            self._comp_ring_thread = t
            t.start()
            if self._worker_ring_enabled:
                # Leases installed before the ring went live never saw
                # an advertisement — cover them now (the install path
                # covers every lease granted from here on).
                lm = self._lease_mgr
                if lm is not None:
                    lm.advertise_worker_ring()
        except Exception:
            self._comp_ring_state = 3
            if ring is not None:
                try:
                    ring.close()
                except Exception:
                    pass

    def _completion_ring_loop(self) -> None:
        """Consumer thread: beat the heartbeat the NM watches for
        driver liveness, absorb relayed completion records, park on the
        doorbell when idle. The head commits only AFTER a batch is
        absorbed — at-least-once, and safe because every absorb step is
        redelivery-idempotent. Records a dead NM left behind are plain
        shared memory: this loop keeps draining them (unconsumed-record
        recovery is just finishing the drain)."""
        ring = self._comp_ring
        if ring is None:
            return
        try:
            while not self._closed and not ring.stopped:
                ring.beat()
                with self._comp_ring_lock:
                    ents = list(self._comp_segments.values())
                for ent in ents:
                    # Per-segment heartbeat: the worker producer's
                    # staleness check watches ITS segment, not the
                    # main ring.
                    ent["seg"].beat()
                if self._comp_ring_pause:   # test seam: stop consuming
                    time.sleep(0.02)
                    continue
                progressed = False
                blobs, new_head = ring.drain(256)
                if blobs:
                    for blob in blobs:
                        try:
                            self._absorb_completion_record(blob)
                        except Exception:
                            pass   # corrupt record: the GCS copy owns it
                    ring.commit(new_head)
                    progressed = True
                if ents:
                    progressed |= self._drain_worker_segments(ents)
                if progressed:
                    continue
                if ring.producer_closed() and not ents:
                    break
                # Shared park: flag every segment parked so its worker
                # knows to ring OUR bell, re-check them (lost-wakeup
                # guard), then park on the main ring's doorbell. The
                # residual flag/publish race costs at worst one bounded
                # PARK_TIMEOUT_S, same as the main ring's. The drain
                # pass above may have detached+closed some of this
                # snapshot's segments (worker exit): skip those — their
                # mmap is gone.
                live = [e for e in ents if not e["seg"].stopped]
                for ent in live:
                    ent["seg"].set_parked(True)
                try:
                    if not any(e["seg"].pending() for e in live):
                        ring.park_wait()
                finally:
                    for ent in live:
                        ent["seg"].set_parked(False)
        finally:
            with self._comp_ring_lock:
                ents = list(self._comp_segments.values())
                self._comp_segments.clear()
            for ent in ents:
                try:
                    ent["seg"].close(unlink=True)
                except Exception:
                    pass
            try:
                ring.close()
            except Exception:
                pass
            # Orphan sweep: a worker SIGKILLed between creating its
            # segment file and the driver mapping it leaves a file no
            # registry entry points at. Every segment is namespaced
            # under OUR ring path, so the glob is exact.
            import glob as _glob

            for p in _glob.glob(ring.path + ".w*"):
                try:
                    os.unlink(p)
                except OSError:
                    pass

    def _drain_worker_segments(self, ents) -> bool:
        """One drain pass over the attached worker segments (consumer
        thread only). Returns True if any segment yielded records.
        A closed-and-drained segment (graceful worker exit) or one
        flagged closing (lease conn died) detaches here — the single
        consumer doing every close keeps the SPSC contract."""
        progressed = False
        depth = 0
        for ent in ents:
            seg = ent["seg"]
            try:
                depth = max(depth, seg.backlog_bytes())
                blobs, new_head = seg.drain(256)
            except Exception:
                blobs, new_head = [], None
                ent["closing"] = True
            if blobs:
                lm = self._lease_mgr
                if lm is not None:
                    lm.ring_absorb(blobs)
                seg.commit(new_head)
                progressed = True
            elif ent["closing"] or seg.producer_closed():
                # Drained dry and the producer is gone (or its lease
                # conn is): detach. Force-unlink — the worker may have
                # died without its close() running.
                with self._comp_ring_lock:
                    self._comp_segments.pop(seg.path, None)
                try:
                    seg.close(unlink=True)
                except Exception:
                    pass
        try:
            _ring_metrics()[0].set(depth)
        except Exception:
            pass
        return progressed

    def _attach_worker_segment(self, path: str, conn) -> None:
        """A same-node leased worker answered our ring advertisement
        with its freshly-created segment: map it, register it with the
        consumer loop, and ack so the worker arms its producer. Runs on
        the lease conn's serve thread (mapping is microseconds). No ack
        on any failure — the worker then simply keeps the socket path."""
        from ray_tpu_torch._private import completion_ring

        ring = self._comp_ring
        if (ring is None or not self._worker_ring_enabled
                or self._closed or ring.stopped):
            return
        if not path.startswith(ring.path + ".w"):
            return   # not a segment of OUR ring: refuse to map it
        try:
            seg = completion_ring.SegmentConsumer(path)
        except Exception:
            return
        with self._comp_ring_lock:
            if self._closed or ring.stopped \
                    or path in self._comp_segments:
                dup = True
            else:
                dup = False
                self._comp_segments[path] = {
                    "seg": seg, "conn": conn, "closing": False}
        if dup:
            seg.close()
            return
        try:
            conn.notify(protocol.ATTACH_COMPLETION_SEGMENT_ACK,
                        {"path": path})
        except protocol.ConnectionClosed:
            with self._comp_ring_lock:
                self._comp_segments.pop(path, None)
            seg.close(unlink=True)

    def _detach_worker_segments(self, conn) -> None:
        """Lease conn died (worker exit, SIGKILL, or lease drop): flag
        its segments closing. The consumer loop finishes draining any
        published records on its next pass — at-least-once for results
        that beat the death — then closes and force-unlinks."""
        with self._comp_ring_lock:
            for ent in self._comp_segments.values():
                if ent["conn"] is conn:
                    ent["closing"] = True

    def _has_segments_for_conn(self, conn) -> bool:
        """True while the consumer loop still holds segments attached
        over this conn (the lease failure path waits a bounded moment
        for their final drain before failing in-flight specs)."""
        with self._comp_ring_lock:
            return any(ent["conn"] is conn
                       for ent in self._comp_segments.values())

    def _absorb_completion_record(self, blob: bytes) -> None:
        """Apply one NM-relayed completion record locally: inline blobs
        land in the process cache, this driver's pending-returns window
        entries retire (the produced objects are in OUR node's store —
        the NM only relays same-node workers). Records are broadcast to
        every same-node driver, so FOREIGN records must be — and are —
        harmless: an LRU-bounded cache insert plus no-op pops."""
        rec = pickle.loads(blob)
        inline = rec.get("inline")
        if inline:
            cache = self._inline
            for oid, b in inline.items():
                cache.put(oid, b)
        pend = self._pending_returns
        for oid, _size in rec.get("objects") or ():
            pend.pop(oid, None)

    def _wrap_return_refs(self, task_id: TaskID, num_returns,
                          spec) -> List[ObjectRef]:
        """Owner-side ObjectRefs for a just-submitted task, without the
        constructor-check layers; ``spec`` is None on the blob-only
        route (no spec object exists on this side at all)."""
        refs_t = self._refs
        if num_returns == 1 or num_returns == "dynamic":
            # Single visible return (the overwhelmingly common case).
            rid = ObjectID.__new__(ObjectID)
            rid._bytes = task_id._bytes + b"\x00\x00\x00\x00"
            rid._hash = None
            if spec is not None:
                spec.__dict__["_rids"] = [rid]
            if refs_t is not None:
                refs_t.incref(rid._bytes)
            self._note_pending_returns((rid._bytes,))
            ref = ObjectRef.__new__(ObjectRef)
            ref._id = rid
            ref._owner_hint = ""
            return [ref]
        rids = [ObjectID.for_return(task_id, i) for i in range(num_returns)]
        if spec is not None:
            spec.__dict__["_rids"] = rids
        if refs_t is not None:
            # One refcount-lock acquisition for the whole batch of
            # return ids (vs one per ObjectRef constructor).
            refs_t.incref_many([r._bytes for r in rids])
        self._note_pending_returns([r._bytes for r in rids])
        out = []
        for rid in rids:
            ref = ObjectRef.__new__(ObjectRef)
            ref._id = rid
            ref._owner_hint = ""
            out.append(ref)
        return out

    def cancel(self, ref: ObjectRef, force: bool = False,
               recursive: bool = True):
        if self._lease_mgr is not None and \
                self._lease_mgr.cancel(ref.task_id().binary(), force):
            return
        self.gcs.request("cancel_task", {
            "task_id": ref.task_id().binary(), "force": force})

    # --------------------------------------------------------------- actors

    def create_actor(self, class_key: str, args, kwargs, *,
                     class_name: str,
                     resources: Dict[str, float],
                     name: Optional[str] = None,
                     namespace: Optional[str] = None,

                     lifetime: Optional[str] = None,
                     max_restarts: int = 0,
                     max_task_retries: int = 0,
                     max_concurrency: int = 1,
                     is_async: bool = False,
                     scheduling_strategy=None,
                     placement_group=None,
                     placement_group_bundle_index: int = -1,
                     runtime_env=None) -> ActorID:
        if runtime_env:
            from ray_tpu_torch._private import runtime_env as renv_mod

            runtime_env = renv_mod.package_runtime_env(self.kv(), runtime_env)
        args_blob, deps, nested = self._serialize_task_args(args, kwargs)
        actor_id = ActorID.of(self.job_id)
        spec = ActorCreationSpec(
            actor_id=actor_id,
            job_id=self.job_id,
            class_key=class_key,
            args=args_blob,
            arg_deps=deps,
            resources=resources,
            name=name,
            namespace=namespace or self.namespace,
            lifetime=lifetime,
            max_restarts=max_restarts,
            max_task_retries=max_task_retries,
            max_concurrency=max_concurrency,
            is_async=is_async,
            caller_id=self.client_id,
            scheduling_strategy=scheduling_strategy,
            placement_group_id=(placement_group.id
                                if placement_group is not None else None),
            placement_group_bundle_index=placement_group_bundle_index,
            runtime_env=runtime_env,
            class_name=class_name,
            sys_path=list(serialization.import_roots()),
            trace_ctx=_tracing().for_submit(),
            nested_deps=nested,
        )
        with self._actor_lock:
            self._actor_routes[actor_id.binary()] = {
                "address": None, "pending": [], "resolving": False,
                "info": {"max_task_retries": max_task_retries},
            }
        # Decentralized creation first: the local node manager places
        # eligible actors from its own ledger — no GCS lock, no central
        # round trip on the happy path; declines spill back to the
        # classic GCS-scheduled creation below.
        if not self._try_local_create_actor(spec):
            self.gcs.request("create_actor", spec)
        return actor_id

    @staticmethod
    def _local_actor_eligible(spec: ActorCreationSpec) -> bool:
        """NM-local creation handles only plain actors, mirroring the
        task-lease fast path: placement groups, affinity/spread, GPU
        shapes (GPU binding at spawn is node-chosen), runtime_envs, and
        NAMED actors (the GCS owns name uniqueness) take the scheduled
        path."""
        return (spec.placement_group_id is None
                and not spec.name
                and (spec.scheduling_strategy is None
                     or spec.scheduling_strategy == "DEFAULT")
                and not spec.runtime_env
                and not (spec.resources or {}).get("GPU"))

    def _try_local_create_actor(self, spec: ActorCreationSpec) -> bool:
        """Ask OUR node manager to place the actor (decentralized actor
        creation, the actor analog of request_local_lease). Returns True
        when the request was handed off — the grant/spillback resolves
        asynchronously on the route executor; actor method calls park on
        the route meanwhile. False = caller must use the classic path."""
        from ray_tpu_torch._private.config import config as _cfg

        if not (bool(_cfg.local_actor_creation_enabled)
                and bool(_cfg.local_scheduling_enabled)):
            return False
        if not self._local_actor_eligible(spec):
            return False
        addr = self._own_nm_address()
        if not addr:
            return False
        try:
            nm = self.nm_conn(addr)
        except (ConnectionError, OSError):
            return False
        aid = spec.actor_id.binary()
        route = self._route_for(aid)   # takes _actor_lock internally
        with self._actor_lock:
            # Park method calls until the grant (or spillback) lands.
            route["resolving"] = True
            # Kept for NM-death recovery: if the node dies before its
            # actor_placed report reaches the GCS, resolve_actor errors
            # "actor not found" and the route re-creates via the GCS.
            route["create_spec"] = spec
        try:
            fut = nm.request_nowait(protocol.REQUEST_CREATE_ACTOR, spec)
        except BaseException:
            with self._actor_lock:
                route["resolving"] = False
            return False
        fut.add_done_callback(
            lambda f: self._route_submit(
                self._on_local_create_reply, spec, addr, f))
        return True

    def _on_local_create_reply(self, spec, addr: str, f):
        aid = spec.actor_id.binary()
        try:
            grant = f.result(0)
        except BaseException:
            grant = None
        if grant is not None:
            # Granted: the actor lives behind OUR node manager, which
            # registered it before replying — publish the route and
            # flush parked calls (no resolve_actor round trip at all).
            self._on_actor_resolved(aid, {"state": "ALIVE",
                                          "node_address": addr})
            return
        # Spillback: classic GCS-scheduled creation (we are on the route
        # executor thread, so the blocking request is safe here).
        try:
            self.gcs.request("create_actor", spec)
        except Exception as e:
            logger.warning("actor creation spillback failed: %s", e)
        route = self._route_for(aid)
        with self._actor_lock:
            route["resolving"] = False
            need_resolve = bool(route["pending"])
            if need_resolve:
                route["resolving"] = True
        if need_resolve:
            self._resolve_actor_route(aid)

    def _route_for(self, actor_id_bytes: bytes) -> Dict[str, Any]:
        with self._actor_lock:
            route = self._actor_routes.get(actor_id_bytes)
            if route is None:
                route = {"address": None, "pending": [], "resolving": False,
                         "info": {}}
                self._actor_routes[actor_id_bytes] = route
            return route

    def submit_actor_task(self, actor_id: ActorID, method_name: str,
                          args, kwargs, *, num_returns: int = 1,
                          concurrency_group: str = "") -> List[ObjectRef]:
        args_blob, deps, nested = self._serialize_task_args(args, kwargs)
        # Pin arg deps while the spec is in OUR hands (parked on a route,
        # in flight to the NM): the ack hand-off transfers custody to the
        # receiving side's pins (worker on receive; NM while parked; GCS
        # for reroutes), so a caller that drops its ObjectRefs right after
        # .remote() can never get its args freed mid-flight.
        if self._refs is not None:
            for d in deps + list(nested):
                self._refs.incref(d.binary())
        aid = actor_id.binary()
        task_id = TaskID.for_actor_task(actor_id)
        with self._actor_lock:
            seq = self._actor_seqno.get(aid, 0)
            self._actor_seqno[aid] = seq + 1
        spec = ActorTaskSpec(
            task_id=task_id,
            actor_id=actor_id,
            job_id=self.job_id,
            method_name=method_name,
            args=args_blob,
            arg_deps=deps,
            num_returns=num_returns,
            caller_id=self.client_id,
            seqno=seq,
            concurrency_group=concurrency_group,
            trace_ctx=_tracing().for_submit(),
            nested_deps=nested,
        )
        self._dispatch_actor_task(spec)
        rids = spec.return_ids()
        self._note_pending_returns([r._bytes for r in rids])
        return [ObjectRef(oid) for oid in rids]

    def _dispatch_actor_task(self, spec: ActorTaskSpec):
        aid = spec.actor_id.binary()
        route = self._route_for(aid)
        with self._actor_lock:
            addr = route["address"]
            if addr is None:
                route["pending"].append(spec)
                if not route["resolving"]:
                    route["resolving"] = True
                    need_resolve = True
                else:
                    need_resolve = False
            else:
                need_resolve = False
        if addr is not None:
            if self._send_actor_task_acked(addr, spec):
                return
            # Connection already closed: park + re-resolve.
            with self._actor_lock:
                route["address"] = None
                route["pending"].append(spec)
                if not route["resolving"]:
                    route["resolving"] = True
                    need_resolve = True
        if need_resolve:
            self._resolve_actor_route(aid)

    def _send_actor_task_acked(self, addr: str, spec) -> bool:
        """Submit an actor task to a node manager with an async delivery ack.

        Sends ride a writer thread (protocol.py), so a dead peer no longer
        raises synchronously from notify(); instead the NM acks each spec
        once it has parked it with the actor's worker (at which point the
        worker-death path owns failure handling). If the ack errors —
        connection died with the spec possibly unsent — the spec is parked
        and the route re-resolved, so the task is never silently dropped.
        Returns False only if the connection was already closed at submit.
        """
        try:
            conn = self.nm_conn(addr)
            fut = conn.request_nowait("submit_actor_task", spec)
        except (protocol.ConnectionClosed, ConnectionError, OSError):
            return False
        fut.add_done_callback(self._make_submit_ack(spec))
        return True

    def _make_submit_ack(self, spec):
        def on_ack(f):
            try:
                f.result(0)
            except BaseException:
                # Hand off to the route dispatcher: this callback may run
                # inline under _actor_lock (future already done) or on the
                # conn's serve thread, and _repark_actor_task takes the lock.
                self._route_submit(self._repark_actor_task, spec)
            else:
                # Delivered: the receiver's pins own the args now.
                self._decref_actor_task_deps(spec)
        return on_ack

    def _decref_actor_task_deps(self, spec):
        if self._refs is not None:
            for d in pinned_deps(spec):
                self._refs.decref(d.binary())

    def _repark_actor_task(self, spec):
        aid = spec.actor_id.binary()
        route = self._route_for(aid)
        with self._actor_lock:
            route["address"] = None
            route["pending"].append(spec)
            if route["resolving"]:
                return
            route["resolving"] = True
        self._resolve_actor_route(aid)

    def _resolve_actor_route(self, aid: bytes):
        fut = self.gcs.request_nowait("resolve_actor", {"actor_id": aid})

        def on_done(f):
            try:
                info = f.result(0)
            except protocol.RemoteCallError as e:
                if "actor not found" in str(e):
                    # Locally-created actor whose node died before its
                    # actor_placed report reached the GCS: re-create it
                    # through the central path (once), then re-resolve.
                    self._route_submit(self._recover_unplaced_actor, aid)
                    return
                info = {"state": "DEAD", "node_address": None}
            except BaseException:
                info = {"state": "DEAD", "node_address": None}
            # _on_actor_resolved may dial the target node manager (blocking
            # up to the connect timeout) — keep that off the GCS serve
            # thread so unrelated GCS replies keep flowing.
            self._route_submit(self._on_actor_resolved, aid, info)

        fut.add_done_callback(on_done)

    def _recover_unplaced_actor(self, aid: bytes):
        """NM-death recovery for decentralized creation: the GCS never
        learned of the actor (node died with the placement report in
        flight), so re-submit the retained creation spec centrally —
        the actor re-places on a surviving node. One attempt: the spec
        is consumed."""
        with self._actor_lock:
            route = self._actor_routes.get(aid) or {}
            spec = route.pop("create_spec", None)
        if spec is not None:
            try:
                self.gcs.request("create_actor", spec)
            except Exception as e:
                logger.warning("lost-actor re-creation failed: %s", e)
                spec = None
        if spec is None:
            self._on_actor_resolved(aid, {"state": "DEAD",
                                          "node_address": None,
                                          "death_cause": "actor not found"})
            return
        self._resolve_actor_route(aid)

    def _on_actor_resolved(self, aid: bytes, info: dict):
        route = self._route_for(aid)
        addr = (info or {}).get("node_address") \
            if (info or {}).get("state") == "ALIVE" else None
        conn = None
        if addr is not None:
            # Pre-establish the connection outside the lock.
            try:
                conn = self.nm_conn(addr)
            except (protocol.ConnectionClosed, ConnectionError, OSError):
                conn = None
        # Flush the parked calls and publish the address while holding the
        # lock, so later calls (which go direct once the address is visible)
        # cannot overtake the parked ones (per-caller FIFO, reference:
        # direct_actor_task_submitter.h sequencing).
        unsent = []
        with self._actor_lock:
            route["resolving"] = False
            route["info"].update(info or {})
            pending, route["pending"] = route["pending"], []
            if conn is not None:
                try:
                    for i, spec in enumerate(pending):
                        fut = conn.request_nowait("submit_actor_task", spec)
                        fut.add_done_callback(self._make_submit_ack(spec))
                except protocol.ConnectionClosed:
                    unsent = pending[i:]
                else:
                    route["address"] = addr
            else:
                unsent = pending
        # Dead or unreachable: let the GCS materialize / reroute (its
        # handler pins the args; release our submit-time pin).
        for spec in unsent:
            try:
                self.gcs.notify("reroute_actor_task", spec)
            except Exception:
                pass
            self._decref_actor_task_deps(spec)

    def resolve_actor_blocking(self, actor_id: ActorID,
                               timeout: Optional[float] = None) -> dict:
        # Server-parked wait: the GCS holds the reply while the actor is
        # PENDING/RESTARTING. timeout=None is this method's documented
        # "block until resolved" — map it to the explicit UNBOUNDED
        # sentinel, not the channel's default bound.
        return self.gcs.request("resolve_actor",
                                {"actor_id": actor_id.binary()},
                                timeout=self.gcs.UNBOUNDED
                                if timeout is None else timeout)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        with self._actor_lock:
            route = self._actor_routes.get(actor_id.binary())
            if route is not None:
                route["address"] = None
        self.gcs.request("kill_actor", {
            "actor_id": actor_id.binary(), "no_restart": no_restart})

    def get_actor_info_by_name(self, name: str,
                               namespace: Optional[str] = None):
        return self.gcs.request("get_actor_by_name", {
            "name": name, "namespace": namespace or self.namespace})

    # -------------------------------------------------------------- cluster

    def available_resources(self) -> dict:
        return self.gcs.request("available_resources")

    def cluster_resources(self) -> dict:
        return self.gcs.request("cluster_resources")

    def nodes(self) -> List[dict]:
        return self.gcs.request("nodes")

    def timeline(self) -> List[dict]:
        return self.gcs.request("get_timeline")

    def kv(self):
        return KvClient(self.gcs)


class KvClient:
    """Internal KV (reference: gcs_kv_manager.h:101 / ray.experimental
    internal_kv)."""

    def __init__(self, gcs_conn):
        self._gcs = gcs_conn

    def _rpc_timeout(self) -> float:
        # Explicit per-call bound: KvClient also works over a raw
        # protocol.Conn (no channel-side default), so every KV RPC
        # states its own.
        return float(config.gcs_rpc_timeout_s)

    def put(self, key: bytes, value: bytes, overwrite: bool = True,
            namespace: str = "") -> bool:
        return self._gcs.request("kv_put", {
            "ns": namespace, "key": key, "value": value,
            "overwrite": overwrite}, timeout=self._rpc_timeout())

    def get(self, key: bytes, namespace: str = "") -> Optional[bytes]:
        return self._gcs.request("kv_get", {"ns": namespace, "key": key},
                                 timeout=self._rpc_timeout())

    def delete(self, key: bytes, namespace: str = "") -> bool:
        return self._gcs.request("kv_del", {"ns": namespace, "key": key},
                                 timeout=self._rpc_timeout())

    def exists(self, key: bytes, namespace: str = "") -> bool:
        return self._gcs.request("kv_exists",
                                 {"ns": namespace, "key": key},
                                 timeout=self._rpc_timeout())

    def keys(self, prefix: bytes = b"", namespace: str = "") -> List[bytes]:
        return self._gcs.request("kv_keys", {"ns": namespace,
                                             "prefix": prefix},
                                 timeout=self._rpc_timeout())


def _error_from_reason(reason: Optional[str]) -> BaseException:
    reason = reason or "task failed"
    if "cancel" in reason:
        return exceptions.TaskCancelledError()
    if "actor" in reason:
        return exceptions.RayActorError(msg=reason)
    if "node died" in reason or "worker died" in reason:
        return exceptions.WorkerCrashedError(reason)
    return exceptions.RayTaskError("", reason)


# ---------------------------------------------------------------- driver glue

_global_worker: Optional[CoreWorker] = None
# _LocalCluster when we started the control plane
_global_cluster: Optional["_LocalCluster"] = None
_init_lock = threading.RLock()


class _LocalCluster:
    """Locally-started head: GCS + head-node manager (reference: the head
    node's gcs_server + raylet processes, started by
    _private/node.py:1145).

    The GCS runs either in-process (default — unit tests don't pay a
    process spawn per init()) or, with ``gcs_out_of_process`` set, as a
    dedicated subprocess with its own interpreter/GIL: the head node
    manager and this driver then reach it purely over the protocol
    socket, exactly like worker nodes — GCS handler concurrency stops
    competing with the head NM and the driver for one GIL."""

    def __init__(self, num_cpus, num_gpus, resources, object_store_memory,
                 system_config=None, port: int = 0):
        from ray_tpu_torch._private.config import config as global_config

        # Apply overrides but remember the values they replaced: the
        # registry is process-global, so without restore-on-shutdown one
        # cluster's _system_config (e.g. a test's tiny memory budget)
        # silently governs every later cluster in the process.
        self._config_restore: dict = {}
        if system_config:
            if isinstance(system_config, str):
                import json as _json
                system_config = _json.loads(system_config) \
                    if system_config else {}
            self._config_restore = {
                k: global_config.get(k) for k in system_config
                if k in global_config.dump()}
            global_config.apply_system_config(system_config)
        # The port's own session root (the JAX package's is
        # /tmp/ray_tpu), so the two runtimes never share a directory.
        self.session_dir = os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch",
            f"session_{int(time.time()*1000)}_{os.getpid()}")
        os.makedirs(self.session_dir, exist_ok=True)
        self.gcs = None        # in-process GcsServer, or None
        self.gcs_proc = None   # gcs_launcher.GcsProcess, or None
        if bool(global_config.gcs_out_of_process):
            from ray_tpu_torch._private.gcs_launcher import GcsProcess

            # Config (including the system_config just applied) rides
            # the launcher's --system-config diff to the child.
            self.gcs_proc = GcsProcess(session_dir=self.session_dir,
                                       port=port)
            self.address = self.gcs_proc.address
        else:
            from ray_tpu_torch._private.gcs import GcsServer

            self.gcs = GcsServer(port=port)
            self.address = self.gcs.address
        from ray_tpu_torch._private.node_manager import NodeManager

        if num_cpus is None:
            num_cpus = os.cpu_count() or 4
        self.nm = NodeManager(
            gcs_address=self.address,
            session_dir=self.session_dir,
            num_cpus=num_cpus,
            num_gpus=detect_num_gpus() if num_gpus is None else num_gpus,
            resources=resources,
            object_store_memory=object_store_memory or (1 << 30),
            is_head=True,
            node_name="head",
        )

    def shutdown(self):
        try:
            self.nm.shutdown()
        except Exception:
            pass
        try:
            if self.gcs_proc is not None:
                self.gcs_proc.terminate()
            if self.gcs is not None:
                self.gcs.close()
        except Exception:
            pass
        if self._config_restore:
            from ray_tpu_torch._private.config import config as global_config
            for k, v in self._config_restore.items():
                try:
                    global_config.set(k, v)
                except Exception:
                    pass
            self._config_restore = {}
        import shutil

        shutil.rmtree(self.session_dir, ignore_errors=True)


def detect_num_gpus() -> int:
    """The GPUs this host offers, without creating a CUDA context in
    the caller: the entries of ``CUDA_VISIBLE_DEVICES`` when it is set,
    else the ``GPU`` lines of ``nvidia-smi -L``; 0 without either."""
    from ray_tpu_torch._private.node_manager import visible_gpu_tokens

    tokens = visible_gpu_tokens()
    if tokens is not None:
        return len(tokens)
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    return sum(1 for line in out.splitlines() if line.startswith("GPU "))


class ClientContext:
    def __init__(self, address: str, worker: CoreWorker):
        self.address_info = {"address": address,
                             "node_id": worker.node_id}
        self.dashboard_url = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        shutdown()


def init(address=None, num_cpus=None, num_gpus=None, resources=None,
         object_store_memory=None, namespace=None,
         ignore_reinit_error=False, runtime_env=None, system_config=None,
         log_to_driver=True) -> ClientContext:
    global _global_worker, _global_cluster
    with _init_lock:
        if _global_worker is not None:
            if ignore_reinit_error:
                return ClientContext(_global_worker.gcs_address,
                                     _global_worker)
            raise RuntimeError(
                "ray_tpu_torch.init() called twice; pass ignore_reinit_error=True "
                "or call ray_tpu_torch.shutdown() first")
        if address in (None, "local"):
            # raylint: disable-next=blocking-under-lock (init() IS the
            # blocking bootstrap — standing up GCS, node manager, and
            # their sockets. _init_lock exists precisely to make
            # concurrent init()/shutdown() callers wait for it.)
            _global_cluster = _LocalCluster(
                num_cpus, num_gpus, resources, object_store_memory,
                system_config)
            gcs_address = _global_cluster.address
        else:
            if address == "auto":
                # refresh: 'auto' historically honored RAY_TPU_TORCH_ADDRESS
                # set after import (programmatic exports before init).
                address = config.refresh_from_env("address")
                if not address:
                    raise ConnectionError(
                        "address='auto' but RAY_TPU_TORCH_ADDRESS is not set")
            gcs_address = address
        worker = CoreWorker(gcs_address, role="driver",
                            log_to_driver=log_to_driver)
        if namespace:
            worker.namespace = namespace
        _global_worker = worker
        atexit.register(_atexit_shutdown)
        from ray_tpu_torch._private import usage
        usage.on_driver_connect()
        return ClientContext(gcs_address, worker)


def _atexit_shutdown():
    try:
        shutdown()
    except Exception:
        pass


def shutdown():
    global _global_worker, _global_cluster
    with _init_lock:
        if _global_worker is not None:
            from ray_tpu_torch._private import usage
            # raylint: disable-next=blocking-under-lock (the lifecycle
            # guard below; the probe's dial and read are bounded by 1 s)
            _global_worker.gcs.close_if_unreachable()
            # raylint: disable-next=blocking-under-lock (the same guard;
            # the report's probe is bounded by 1 s, and a closed channel
            # skips it at once)
            usage.on_driver_disconnect()
            # raylint: disable-next=blocking-under-lock (_init_lock is
            # the init/shutdown lifecycle guard: a concurrent init()
            # MUST block until teardown — flushes, RPC drains, thread
            # joins included — completes; releasing mid-teardown would
            # let a new cluster interleave with the dying one)
            _global_worker.disconnect()
            _global_worker = None
        if _global_cluster is not None:
            # raylint: disable-next=blocking-under-lock (same lifecycle
            # guard: teardown joins daemon threads under the lock by
            # design)
            _global_cluster.shutdown()
            _global_cluster = None


def global_worker() -> Optional[CoreWorker]:
    return _global_worker


def set_global_worker(w: CoreWorker):
    global _global_worker
    _global_worker = w


_pubsub_dispatch = None


def register_pubsub_dispatch(fn) -> None:
    """Install the process-wide pubsub push handler (set by
    ray_tpu_torch.experimental.pubsub on first subscribe)."""
    global _pubsub_dispatch
    _pubsub_dispatch = fn


def require_worker() -> CoreWorker:
    if _global_worker is None:
        raise RuntimeError(
            "ray_tpu_torch.init() has not been called on this process")
    return _global_worker
