"""Worker process entrypoint and task execution loop.

Role-equivalent to the reference's default_worker.py:226 +
``execute_task`` (reference: python/ray/_raylet.pyx:702) +
the execution-side scheduling queues (reference:
src/ray/core_worker/transport/actor_scheduling_queue.h,
concurrency_group_manager.h): a worker registers with its node manager,
receives task pushes over that connection, and executes them on the main
thread (normal tasks, sync actors), an asyncio loop (async actors), or a
thread pool (threaded actors).
"""

from __future__ import annotations

import asyncio
import collections
import ctypes
import inspect
import os
import pickle
import signal
import sys
import threading
import time
import traceback
from typing import Any, Dict, Optional

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import (
    device_objects,
    inline_objects,
    protocol,
    serialization,
)
from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.ids import ActorID, JobID, TaskID
from ray_tpu_torch._private.task_spec import (ActorCreationSpec, ActorTaskSpec,
                                              TaskSpec, pinned_deps)
from ray_tpu_torch._private.worker import CoreWorker, set_global_worker
from ray_tpu_torch.object_store import plasma
from ray_tpu_torch.util import metrics as metrics_util


def _build_worker_metrics():
    """Worker-side fast-path metrics (created on first flush, not per
    task; the reporter ships them to the GCS metrics table)."""
    from ray_tpu_torch.util import metrics

    inline_total = metrics.Counter(
        "worker_inline_returns_total",
        "Task returns shipped in-band inside the completion "
        "message (zero object-store touches)")
    ring_appends = metrics.Counter(
        "worker_completion_ring_appends_total",
        "Lease completions appended to a same-node driver's shm "
        "completion segment (no socket send on the return path)")
    ring_full = metrics.Counter(
        "worker_completion_ring_full_total",
        "Lease completions that fell back to the socket because the "
        "shm completion segment was full (or mid-teardown)")
    return (inline_total, ring_appends, ring_full)


_worker_metrics = metrics_util.lazy_metrics(_build_worker_metrics)


class WorkerExecutor:
    def __init__(self, core: CoreWorker, nm_address: str, worker_id: bytes):
        self.core = core
        self.worker_id = worker_id
        self._queue: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._running = True
        self._current_task_id: Optional[bytes] = None
        self._cancel_requested: Optional[bytes] = None

        # actor state
        self.actor_instance: Any = None
        self.actor_spec: Optional[ActorCreationSpec] = None
        # Seqnos already accepted for execution: the driver's delivery-ack
        # repark (worker.py _repark_actor_task) resubmits specs whose ack —
        # not necessarily the task itself — was lost, so the same seqno can
        # arrive twice and must not run twice (reference: seq-numbered
        # per-actor queues, direct_actor_task_submitter.h:67). Bounded
        # memory: per caller, a contiguous high-water mark plus the
        # out-of-order remainder set (compacted as the gap fills).
        self._seqno_state: dict = {}  # caller_id -> [hw:int, extras:set]
        self._seqno_lock = threading.Lock()
        self._aio_loop: Optional[asyncio.AbstractEventLoop] = None
        self._aio_sem: Optional[asyncio.Semaphore] = None
        self._thread_pool = None

        signal.signal(signal.SIGUSR1, self._on_cancel_signal)

        # Worker-turnaround fast path knobs, snapshotted once (the
        # spawning NM ships its non-default config in the worker env,
        # applied in main() before this executor exists).
        self._inline_max = (int(config.worker_inline_return_max)
                            if bool(config.worker_inline_returns_enabled)
                            else 0)
        self._batch_done = bool(config.task_done_batch_enabled)
        # SCALE_r10 stage 1: ship lease completions as frames of
        # per-record pickle blobs (lease_tasks_done_b, the completion
        # twin of lease_run_tasks_b) so the driver's conn thread only
        # parks raw bytes and the absorb executor unpickles off-thread.
        self._absorb_b = bool(config.completion_absorb_enabled)
        # Worker->driver shm completion segments: when a
        # same-node lease holder advertises its completion ring, we
        # create a per-conn SPSC segment next to it and append lease
        # completions there instead of notifying over the conn. The
        # socket stays as the fallback for cross-node holders, a full
        # segment, a failed attach, or the knob being off anywhere.
        # x86-64 only: payload-before-tail publication relies on TSO
        # store-store ordering (see shm_ring).
        import platform

        self._worker_ring_on = (
            bool(config.worker_completion_ring_enabled)
            and platform.machine() in ("x86_64", "AMD64"))
        self._seg_bytes = int(config.worker_completion_ring_bytes)
        self._comp_producers: Dict[Any, Any] = {}   # lease conn -> producer
        self._prod_lock = threading.Lock()
        self._seg_seq = 0
        # Unified completion buffer: (conn_or_None, record) — None routes
        # to the NM as a task_done_batch frame (classic path), a conn is
        # a lease holder's direct connection (lease_tasks_done). One
        # flush policy for both: ship when the queue empties (a lone
        # task never waits) or at _COMPLETION_BATCH buffered; while the
        # queue is non-empty a slack-timer thread bounds how long a
        # finished result can sit behind the next task's execution —
        # flushing inline before every next task instead (the previous
        # policy) pinned completion frames at size 1 for fast tasks.
        self._completions: list = []
        self._completions_lock = threading.Lock()
        self._flush_slack = max(
            0.0005, float(config.task_done_flush_slack_s))
        self._flush_arm = threading.Event()
        self._flush_stop = threading.Event()
        threading.Thread(target=self._completion_flush_loop, daemon=True,
                         name="rtpu-completion-flush").start()
        self._event_buf: list = []
        self._event_lock = threading.Lock()
        self._event_stop = threading.Event()
        threading.Thread(target=self._event_flush_loop, daemon=True,
                         name="rtpu-task-events").start()

        # Direct task server: callers holding a lease on this worker stream
        # tasks here, bypassing GCS + node manager on the hot path
        # (reference: the core worker's gRPC task service,
        # direct_task_transport.h:75 / core_worker.h PushTask).
        self.direct = protocol.Server(self._on_direct_msg,
                                      name="worker-direct")
        self.direct.on_disconnect = self._on_direct_disconnect
        # Same-node holders get a unix-socket listener for the same
        # handler: locally-granted leases are by construction on the
        # caller's own node, and AF_UNIX halves the per-message round
        # trip vs loopback TCP (measured ~200us -> ~100us) — this is the
        # per-task steady-state path, so the saving lands on every task.
        self.direct_ux = None
        # raylint: disable-next=config-knob-drift (bootstrap identity:
        # per-worker spawn env from the NM, may differ from the value
        # the config module snapshotted at zygote import)
        session_dir = os.environ.get("RAY_TPU_TORCH_SESSION_DIR")
        if session_dir:
            try:
                self.direct_ux = protocol.Server(
                    self._on_direct_msg, name="worker-direct-ux",
                    unix_path=os.path.join(
                        session_dir, f"w{worker_id.hex()[:12]}.sock"))
                self.direct_ux.on_disconnect = self._on_direct_disconnect
            except OSError:
                self.direct_ux = None   # unbindable path: TCP-only
        # Set from the registration reply below; the node manager may ask
        # for a profile or a stack dump as soon as it has registered us,
        # before this thread has read that reply.
        self.node_id: Optional[str] = None
        self.nm = protocol.connect(nm_address, handler=self._on_msg,
                                   name="worker-nm")
        self.nm.on_close = lambda conn: self._on_nm_closed()
        # Bounded by the same budget the NM's reaper applies to us: a
        # worker that cannot register within it will be killed anyway,
        # so exit cleanly instead of parking on a wedged NM.
        reply = self.nm.request("register_worker", timeout=float(
            config.worker_start_timeout_s), payload={
            "worker_id": worker_id, "pid": os.getpid(),
            "direct_address": self.direct.address,
            "direct_address_ux": (self.direct_ux.address
                                  if self.direct_ux is not None else None)})
        self.node_id = reply["node_id"]
        # Intra-task spans (serve hops, collectives, device transfers)
        # route through this executor's task-event buffer: one flusher
        # ships them to the GCS timeline AND the node agent's flight
        # recorder alongside the task events they nest under.
        from ray_tpu_torch.util import tracing

        tracing.set_sink(self._record_span_event)
        # Cached module ref: _set_ctx runs per task and the import
        # machinery's sys.modules probe was visible in worker-side
        # profiles at nop-task rates.
        self._tracing = tracing

    # ------------------------------------------------------------- plumbing

    def _on_nm_closed(self):
        # Node manager went away: nothing to live for.
        os._exit(0)

    def _pin_actor_task_args(self, spec):
        refs = self.core._refs
        if refs is not None:
            for d in pinned_deps(spec):
                refs.incref(d.binary())

    def _unpin_actor_task_args(self, spec):
        refs = self.core._refs
        if refs is not None:
            for d in pinned_deps(spec):
                refs.decref(d.binary())

    def _on_msg(self, conn, mtype, payload, msg_id):
        if mtype == "dump_stacks":
            # In-band stack capture (the data path behind `ray_tpu_torch
            # stack`): answered HERE, on the conn's listener thread —
            # a main thread wedged inside a collective still reports
            # exactly where it is. The SIGUSR2/faulthandler seam stays
            # as the out-of-band fallback.
            self._reply_stacks(conn, msg_id)
            return
        if mtype == "profile":
            # In-band sampling profile (the data path behind `ray_tpu_torch
            # profile`): received on the listener thread — so a wedged
            # main thread still profiles — but the bounded window runs
            # on a short-lived thread (the sampler is a daemon thread
            # either way; the listener must keep delivering cancels and
            # exits while the window is open).
            threading.Thread(
                target=self._reply_profile, args=(conn, msg_id, payload),
                daemon=True, name="rtpu-profile-req").start()
            return
        if mtype == "run_actor_task":
            # Pin args the moment the spec lands here: the task may sit in
            # this actor's queue for a long time, and the caller's refs may
            # be long gone by then (custody chain: caller -> here -> done).
            self._pin_actor_task_args(payload)
        if mtype == "cancel_task":
            self._handle_cancel(payload["task_id"])
            return
        if mtype == "exit":
            with self._cv:
                self._running = False
                self._cv.notify()
            return
        if mtype == "run_actor_task" and self._aio_loop is not None:
            # async actor: schedule concurrently, don't serialize on the queue
            asyncio.run_coroutine_threadsafe(
                self._run_actor_task_async(payload), self._aio_loop)
            return
        if mtype == "run_actor_task" and self._thread_pool is not None:
            self._thread_pool.submit(self._execute_actor_task, payload)
            return
        with self._cv:
            self._queue.append((mtype, payload))
            self._cv.notify()

    def _on_direct_msg(self, conn, mtype, payload, msg_id):
        if mtype == "lease_run_tasks":
            # A batch of specs from the lease holder; results flow back in
            # batched "lease_tasks_done" notifies (amortizing per-message
            # cost both ways — reference: direct transport pipelining).
            with self._cv:
                for spec in payload:
                    self._queue.append(("lease_task", (spec, conn)))
                self._cv.notify()
        elif mtype == "lease_run_tasks_b":
            # Batched framing variant: the frame carries pre-pickled
            # spec blobs (template-patched on the driver) — decode here,
            # then identical semantics to lease_run_tasks.
            specs = []
            for b in payload:
                try:
                    specs.append(pickle.loads(b))
                except Exception:
                    # Per-blob guard (mirrors the GCS handler): one
                    # undecodable blob must not tear down the conn and
                    # fail every other task on the lease.
                    traceback.print_exc()
            with self._cv:
                for spec in specs:
                    self._queue.append(("lease_task", (spec, conn)))
                self._cv.notify()
        elif mtype == "cancel_task":
            self._handle_cancel(payload["task_id"])
        elif mtype == protocol.ATTACH_COMPLETION_RING:
            self._attach_completion_ring(conn, payload)
        elif mtype == protocol.ATTACH_COMPLETION_SEGMENT_ACK:
            self._arm_completion_segment(conn, payload)
        elif mtype == "ping":
            conn.reply(msg_id, True)

    def _reply_stacks(self, conn, msg_id):
        from ray_tpu_torch.dashboard.agent import current_stacks

        try:
            cur = self._current_task_id
            actor_id = None
            if self.actor_spec is not None:
                actor_id = self.actor_spec.actor_id.binary().hex()
            conn.reply(msg_id, {
                "worker_id": self.worker_id.hex(),
                "pid": os.getpid(),
                "actor_id": actor_id,
                "current_task_id": cur.hex() if cur else None,
                "threads": current_stacks(),
            })
        except protocol.ConnectionClosed:
            pass

    def _reply_profile(self, conn, msg_id, payload):
        from ray_tpu_torch._private import profiler

        p = payload or {}
        try:
            cur = self._current_task_id
            actor_id = None
            if self.actor_spec is not None:
                actor_id = self.actor_spec.actor_id.binary().hex()
            out = profiler.profile_self(
                duration_s=float(p.get("duration_s", 5.0)),
                hz=p.get("hz"),
                mode=p.get("mode", "wall"),
                kind="worker",
                node_id=self.node_id,
                worker_id=self.worker_id.hex(),
                actor_id=actor_id,
                current_task_id=cur.hex() if cur else None,
            )
            conn.reply(msg_id, out)
        except protocol.ConnectionClosed:
            pass
        except Exception as e:
            try:
                conn.reply_error(msg_id, f"{type(e).__name__}: {e}")
            except protocol.ConnectionClosed:
                pass

    def _attach_completion_ring(self, conn, payload):
        """A same-node lease holder advertised its completion ring:
        create our per-conn segment next to it, dial the SHARED bell,
        and answer with the segment path. The producer stays inactive
        (every append declines to the socket) until the driver maps the
        segment and acks — so a record can never strand in a file no
        consumer will ever read."""
        from ray_tpu_torch._private import completion_ring

        if not self._worker_ring_on:
            return
        if payload.get("node_id") != self.node_id:
            return   # cross-node advert (config confusion): mmap is local
        with self._prod_lock:
            if conn in self._comp_producers:
                return   # repeat advert (ring restart churn): keep ours
            self._seg_seq += 1
            seq = self._seg_seq
        base = payload["path"]
        path = f"{base}.w{os.getpid():x}_{seq}"
        try:
            prod = completion_ring.SegmentProducer(
                path, self._seg_bytes, bell_path=base + ".bell")
            prod.connect_bell()
        except Exception:
            # Can't create/dial (driver tearing down, FS oddity): the
            # socket path simply keeps carrying this conn's results.
            try:
                os.unlink(path)
            except OSError:
                pass
            return
        with self._prod_lock:
            if conn.closed or conn in self._comp_producers:
                stale = True
            else:
                stale = False
                self._comp_producers[conn] = prod
        if stale:
            prod.close()   # unlinks our own segment file
            return
        try:
            conn.notify(protocol.ATTACH_COMPLETION_SEGMENT, {"path": path})
        except protocol.ConnectionClosed:
            self._drop_producer(conn)
            return
        # Register with the NM: if we are SIGKILLed the NM unlinks the
        # segment file (the driver's force-unlink on detach covers the
        # mapped case; this covers died-before-the-driver-mapped).
        try:
            self.nm.notify("worker_segment_attached", {"path": path})
        except protocol.ConnectionClosed:
            os._exit(0)

    def _arm_completion_segment(self, conn, payload):
        """Driver mapped our segment and acked: arm the producer. From
        here every lease completion for this conn tries the segment
        first."""
        with self._prod_lock:
            prod = self._comp_producers.get(conn)
        if prod is not None and prod.path == payload.get("path"):
            prod.active = True

    def _drop_producer(self, conn):
        """Tear down this conn's segment producer (conn closed, driver
        heartbeat stale, or worker exit): flag the segment closed so
        the driver's consumer detaches after its final drain, unlink
        our file (idempotent vs the driver's force-unlink), and tell
        the NM to forget the crash-cleanup entry."""
        with self._prod_lock:
            prod = self._comp_producers.pop(conn, None)
        if prod is None:
            return
        path = prod.path
        try:
            prod.close()
        except Exception:
            pass
        try:
            self.nm.notify("worker_segment_detached", {"path": path})
        except protocol.ConnectionClosed:
            pass

    _SEG_STALE_S = 5.0

    def _check_producers(self):
        """Liveness backstop, polled from the event-flush loop: a
        driver that stopped beating its consumer heartbeat while we
        hold published records is wedged or dead — tear the segment
        down and let the socket path (and the lease conn's own death)
        take over."""
        if not self._comp_producers:
            return
        with self._prod_lock:
            items = list(self._comp_producers.items())
        for conn, prod in items:
            try:
                stale = prod.consumer_stale(self._SEG_STALE_S)
            except Exception:
                stale = True
            if stale or conn.closed:
                self._drop_producer(conn)

    def _on_direct_disconnect(self, conn):
        # The lease holder hung up: its segment producer goes first
        # (close flags the segment so the driver-side consumer detaches
        # after a final drain).
        self._drop_producer(conn)
        # Only tell the NM when NO direct conn
        # remains (on either listener): a stale old-holder conn closing
        # while the new holder is connected must not release the new
        # holder's lease.
        conns = list(self.direct._conns)
        if self.direct_ux is not None:
            conns += self.direct_ux._conns
        if any(not c.closed for c in conns):
            return
        try:
            self.nm.notify("lease_released", None)
        except protocol.ConnectionClosed:
            os._exit(0)

    def _handle_cancel(self, task_id: bytes):
        with self._cv:
            for item in list(self._queue):
                mtype, payload = item
                if mtype == "run_task" and \
                        payload.task_id.binary() == task_id:
                    self._queue.remove(item)
                    objects, inline = self._store_error_returns(
                        payload, exceptions.TaskCancelledError(
                            task_id.hex()))
                    self._task_done(payload, "error", objects,
                                    "cancelled", inline)
                    self._flush_completions()
                    return
                if mtype == "lease_task" and \
                        payload[0].task_id.binary() == task_id:
                    self._queue.remove(item)
                    spec, lconn = payload
                    objects, inline = self._store_error_returns(
                        spec, exceptions.TaskCancelledError(task_id.hex()))
                    rec = {
                        "task_id": task_id,
                        "status": "error", "objects": objects,
                        "error": "cancelled", "node_id": self.node_id}
                    if inline:
                        rec["inline"] = inline
                    self._queue_lease_result(lconn, rec)
                    self._flush_completions()
                    return
            if self._current_task_id == task_id:
                self._cancel_requested = task_id
                os.kill(os.getpid(), signal.SIGUSR1)

    def _on_cancel_signal(self, signum, frame):
        if (self._cancel_requested is not None
                and self._cancel_requested == self._current_task_id):
            self._cancel_requested = None
            raise exceptions.TaskCancelledError(
                self._current_task_id.hex()
                if self._current_task_id else "")

    # ------------------------------------------------------------ main loop

    def run(self):
        while True:
            with self._cv:
                while self._running and not self._queue:
                    # raylint: disable-next=unbounded-wait (the worker
                    # main loop parked for its next task; "exit" and
                    # conn-close both notify the cv to unpark it)
                    self._cv.wait()
                if not self._running:
                    break
                mtype, payload = self._queue.popleft()
            try:
                if mtype == "run_task":
                    self._execute_task(payload)
                elif mtype == "lease_task":
                    self._execute_lease_task(*payload)
                elif mtype == "create_actor":
                    self._create_actor(payload)
                elif mtype == "run_actor_task":
                    # Tasks that raced in before the constructor finished get
                    # re-routed to the concurrency executor chosen at creation.
                    if self._aio_loop is not None:
                        asyncio.run_coroutine_threadsafe(
                            self._run_actor_task_async(payload),
                            self._aio_loop)
                    elif self._thread_pool is not None:
                        self._thread_pool.submit(
                            self._execute_actor_task, payload)
                    else:
                        self._execute_actor_task(payload)
            except SystemExit:
                raise
            except BaseException:
                traceback.print_exc()

    # ------------------------------------------------------------ execution

    def _store_returns(self, spec, result) -> tuple:
        """Seal the task's returns; returns (objects, inline) where
        ``objects`` is the [(oid, size), ...] completion manifest and
        ``inline`` maps the subset of oids whose value travels IN-BAND
        (framed blob in the completion message, zero store touches) —
        OOB-free results at or under ``worker_inline_return_max``.
        Device tensors always carry out-of-band buffers, so they always
        take the store path (and keep their staging/donation
        semantics)."""
        if getattr(spec, "num_returns", None) == "dynamic":
            return self._store_dynamic_returns(spec, result)
        ids = spec.return_ids()
        if not ids:
            return [], {}
        if len(ids) == 1:
            values = [result]
        else:
            if not isinstance(result, (tuple, list)) or \
                    len(result) != len(ids):
                raise ValueError(
                    f"task declared num_returns={len(ids)} but returned "
                    f"{type(result).__name__}")
            values = list(result)
        out = []
        inline: Dict[bytes, bytes] = {}
        donate = bool(getattr(spec, "donate_result", False))
        inline_max = 0 if donate else self._inline_max
        donate_after = []
        for oid, value in zip(ids, values):
            sobj = serialization.serialize(value)
            if inline_objects.eligible(sobj, inline_max):
                blob = sobj.to_bytes()
                inline[oid.binary()] = blob
                out.append((oid.binary(), len(blob)))
                continue
            try:
                self.core.store.put_serialized(oid.binary(), sobj)
            except plasma.ObjectExistsError:
                pass
            # Staging of this slot is complete: register the device
            # tensor for same-process by-reference gets (actor/worker
            # chaining), or queue it for donation. Donation is deferred
            # until ALL slots are staged — a multi-return task may
            # return the same tensor in two slots, and releasing it at
            # slot 0 would make slot 1 serialize a dead storage.
            if donate:
                donate_after.append((oid.binary(), value))
            else:
                device_objects.note_return(self.core, oid.binary(), value,
                                           donate=False)
            out.append((oid.binary(), sobj.total_size()))
        for oid_b, value in donate_after:
            device_objects.note_return(self.core, oid_b, value, donate=True)
        return out, inline

    def _store_dynamic_returns(self, spec, result) -> tuple:
        """Generator task (num_returns="dynamic"): store each yielded
        value at return index 1..N as it is produced, then store the
        ObjectRefGenerator at index 0 — consumers only ever observe a
        COMPLETE generator, so a mid-yield crash + retry is safe (partial
        yields are re-stored idempotently; reference: task manager
        dynamic returns, python/ray/tests/test_generators.py)."""
        from ray_tpu_torch._private.ids import ObjectID
        from ray_tpu_torch._private.worker import ObjectRefGenerator

        if not inspect.isgenerator(result) and not hasattr(
                result, "__iter__"):
            raise TypeError(
                f"num_returns='dynamic' requires the task to return a "
                f"generator/iterable, got {type(result).__name__}")
        out = []
        yielded_ids: list = []
        donate = bool(getattr(spec, "donate_result", False))
        donate_after: list = []
        for i, value in enumerate(result):
            oid = ObjectID.for_return(spec.task_id, i + 1).binary()
            sobj = serialization.serialize(value)
            try:
                self.core.store.put_serialized(oid, sobj)
            except plasma.ObjectExistsError:
                pass   # retry of a task killed mid-yield
            if donate:
                # Releasing per-yield would pull the storage out from
                # under a generator that reuses its yielded tensor
                # (x = step(x); yield x) — donation waits until the
                # generator is done.
                donate_after.append((oid, value))
            else:
                device_objects.note_return(self.core, oid, value,
                                           donate=False)
            yielded_ids.append(oid)
            out.append((oid, sobj.total_size()))
        for oid, value in donate_after:
            device_objects.note_return(self.core, oid, value, donate=True)
        gen_oid = spec.return_ids()[0].binary()
        gen_obj = serialization.serialize(ObjectRefGenerator(yielded_ids))
        try:
            self.core.store.put_serialized(gen_oid, gen_obj)
        except plasma.ObjectExistsError:
            pass
        out.append((gen_oid, gen_obj.total_size()))
        # Dynamic yields are reconstructable-by-rerun and indexable via
        # the generator object: they keep the store path (no inline).
        return out, {}

    def _store_error_returns(self, spec, err: BaseException) -> tuple:
        """Materialize ``err`` as the value of every return id. The
        exception is serialized and framed ONCE: a sub-threshold error
        ships in-band with every return id ALIASING the same blob (the
        completion pickle memoizes the shared bytes object, so an
        N-return failure costs one copy on the wire and in the GCS
        table); an oversized error writes that one frame into the store
        per id — the per-id cost is a memcpy, never a re-serialization."""
        sobj = serialization.serialize(err)
        ids = spec.return_ids()
        out = []
        inline: Dict[bytes, bytes] = {}
        blob = sobj.to_bytes()
        if inline_objects.eligible(sobj, self._inline_max):
            for oid in ids:
                inline[oid.binary()] = blob
                out.append((oid.binary(), len(blob)))
            return out, inline
        for oid in ids:
            self.core._store_local(oid.binary(), blob)
            out.append((oid.binary(), len(blob)))
        return out, inline

    _COMPLETION_BATCH = 64

    def _task_done(self, spec, status: str, objects: list,
                   error: Optional[str] = None,
                   inline: Optional[dict] = None):
        """Buffer a classic-path completion for the NM; coalesced into
        task_done_batch frames exactly like lease results coalesce into
        lease_tasks_done — ship when the queue empties (a lone task
        never waits on a flush window) or at _COMPLETION_BATCH."""
        rec = {
            "task_id": spec.task_id.binary(),
            "status": status,
            "objects": objects,
            "error": error,
        }
        if inline:
            rec["inline"] = inline
        with self._completions_lock:
            self._completions.append((None, rec))
            n = len(self._completions)
        with self._cv:
            backlog = len(self._queue)
        if backlog == 0 or n >= self._COMPLETION_BATCH:
            self._flush_completions()
        else:
            self._flush_arm.set()

    def _set_ctx(self, spec, actor_id: Optional[ActorID] = None,
                 tid_hex: Optional[str] = None):
        ctx = self.core.ctx
        ctx.task_id = spec.task_id
        ctx.job_id = spec.job_id
        ctx.actor_id = actor_id
        ctx.task_name = getattr(spec, "name",
                                getattr(spec, "method_name", ""))
        ctx.put_index = 0
        self.core.job_id = spec.job_id
        # Continue the caller's trace: tasks submitted from THIS task
        # become its children (reference: tracing_helper.py:318 context
        # re-attachment on the execution side).
        self._tracing.activate(getattr(spec, "trace_ctx", None),
                               tid_hex if tid_hex is not None
                               else spec.task_id.binary().hex())

    def _execute_task(self, spec: TaskSpec):
        tid = spec.task_id.binary()
        self._current_task_id = tid
        self._set_ctx(spec, tid_hex=tid.hex())
        start = time.time()
        try:
            fn = self.core.fetch_function(spec.function_key)
            args, kwargs = self.core.deserialize_args(spec.args)
            result = fn(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = asyncio.run(result)
            objects, inline = self._store_returns(spec, result)
            status, error = "ok", None
        except BaseException as e:
            err = exceptions.RayTaskError.from_exception(
                spec.name or spec.function_key[:8], e)
            objects, inline = self._store_error_returns(spec, err)
            status, error = "error", str(e)
        finally:
            self._current_task_id = None
            self._cancel_requested = None
        self._task_done(spec, status, objects, error, inline)
        self._report_event(spec.task_id, spec.name, start, status,
                           kind="task")

    def _execute_lease_task(self, spec: TaskSpec, conn):
        """Run a direct-transport task; the result is buffered and ships
        to the caller in a batched "lease_tasks_done" notify (no
        node-manager/GCS round trip on the hot path; the caller
        batch-reports completions to the GCS for locations + lineage)."""
        tid = spec.task_id.binary()
        self._current_task_id = tid
        self._set_ctx(spec, tid_hex=tid.hex())
        start = time.time()
        try:
            fn = self.core.fetch_function(spec.function_key)
            args, kwargs = self.core.deserialize_args(spec.args)
            result = fn(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = asyncio.run(result)
            objects, inline = self._store_returns(spec, result)
            status, error = "ok", None
        except BaseException as e:
            err = exceptions.RayTaskError.from_exception(
                spec.name or spec.function_key[:8], e)
            objects, inline = self._store_error_returns(spec, err)
            status, error = "error", str(e)
        finally:
            self._current_task_id = None
            self._cancel_requested = None
        rec = {
            "task_id": tid, "status": status,
            "objects": objects, "error": error, "node_id": self.node_id}
        if inline:
            rec["inline"] = inline
        self._queue_lease_result(conn, rec)
        with self._cv:
            backlog = len(self._queue)
        if backlog == 0 or len(self._completions) >= self._COMPLETION_BATCH:
            self._flush_completions()
        else:
            self._flush_arm.set()
        self._report_event(spec.task_id, spec.name, start, status,
                           kind="task")

    def _queue_lease_result(self, conn, result: dict):
        with self._completions_lock:
            self._completions.append((conn, result))

    def _flush_completions(self):
        """Ship every buffered completion: lease results batch per
        holder conn (lease_tasks_done), classic-path records coalesce
        into ONE task_done_batch frame of (task_id, pickled-record)
        pairs — the task ids ride OUTSIDE the blobs so the NM can do
        its worker bookkeeping and relay the blobs to the GCS without
        unpickling them (mirroring submit_task_batch)."""
        with self._completions_lock:
            pending, self._completions = self._completions, []
        if not pending:
            return
        nm_records: list = []
        by_conn: Dict[Any, list] = {}
        inline_n = 0
        for conn, result in pending:
            inline_n += len(result.get("inline") or ())
            if conn is None:
                nm_records.append(result)
            else:
                by_conn.setdefault(conn, []).append(result)
        if inline_n:
            try:
                _worker_metrics()[0].inc(inline_n)
            except Exception:
                pass
        for conn, results in by_conn.items():
            # Shm fast path: a same-node holder with an
            # armed segment gets its records as in-place appends — no
            # socket send at all. Records the segment declines (full,
            # not yet acked, tearing down) fall through to the socket
            # notify below; the driver-side absorb is idempotent, so
            # the split delivery is safe in any interleaving.
            prod = (self._comp_producers.get(conn)
                    if self._comp_producers else None)
            if prod is not None and prod.active and not prod.dead:
                # One batched append per flush: a single tail publish
                # and AT MOST ONE doorbell for the whole batch (vs one
                # bell write per record while the driver was parked).
                appended = prod.append_batch(
                    [pickle.dumps(r, protocol=5) for r in results])
                rest = results[appended:]
                try:
                    if appended:
                        _worker_metrics()[1].inc(appended)
                    if rest:
                        _worker_metrics()[2].inc(len(rest))
                except Exception:
                    pass
                if not rest:
                    continue
                results = rest
            try:
                if self._absorb_b:
                    conn.notify(protocol.LEASE_TASKS_DONE_B, [
                        pickle.dumps(r, protocol=5) for r in results])
                else:
                    conn.notify("lease_tasks_done", {"results": results})
            except protocol.ConnectionClosed:
                pass  # caller gone; its GCS-side cleanup owns the fallout
        if not nm_records:
            return
        try:
            if self._batch_done:
                self.nm.notify("task_done_batch", [
                    (r["task_id"], pickle.dumps(r, protocol=5))
                    for r in nm_records])
            else:
                for r in nm_records:
                    self.nm.notify("task_done", r)
        except protocol.ConnectionClosed:
            os._exit(0)

    def _completion_flush_loop(self):
        """Slack-bounded completion flusher: armed when a completion is
        buffered behind a non-empty task queue, it flushes ``slack``
        seconds later regardless of what the main loop is executing —
        the bound on how long a finished result can wait behind a slow
        successor task. Fast bursts coalesce into one frame inside the
        slack window instead of flushing one frame per task."""
        while not self._flush_stop.is_set():
            # raylint: disable-next=unbounded-wait (armed-event park;
            # stop() sets _flush_stop then _flush_arm to unpark it)
            self._flush_arm.wait()
            if self._flush_stop.is_set():
                return
            self._flush_arm.clear()
            self._flush_stop.wait(self._flush_slack)
            if self._completions:
                self._flush_completions()

    def _create_actor(self, spec: ActorCreationSpec):
        self.actor_spec = spec
        self._current_task_id = None
        try:
            # A prestarted pool worker may predate driver sys.path
            # additions (e.g. a module dir created just before the actor
            # class was defined): prepend what the driver had so
            # by-reference pickles resolve. Isolated workers skip this —
            # driver-local dirs must never shadow their pinned
            # working_dir / py_modules snapshot.
            # raylint: disable-next=config-knob-drift (bootstrap
            # identity: per-worker isolation flag set at spawn)
            if not os.environ.get("RAY_TPU_TORCH_ISOLATED_ENV"):
                for p in reversed(spec.sys_path or []):
                    if p not in sys.path:
                        sys.path.insert(0, p)
            from ray_tpu_torch.util import tracing

            tracing.activate(
                getattr(spec, "trace_ctx", None),
                TaskID.for_actor_creation(spec.actor_id).binary().hex())
            cls = self.core.fetch_function(spec.class_key)
            args, kwargs = self.core.deserialize_args(spec.args)
            self.core.ctx.job_id = spec.job_id
            self.core.ctx.actor_id = spec.actor_id
            self.core.ctx.task_id = TaskID.for_actor_creation(spec.actor_id)
            self.core.job_id = spec.job_id
            self.actor_instance = cls(*args, **kwargs)
        except BaseException as e:
            tb = traceback.format_exc()
            try:
                self.nm.notify("actor_failed", {
                    "actor_id": spec.actor_id.binary(),
                    "error": f"{type(e).__name__}: {e}\n{tb}"})
            except protocol.ConnectionClosed:
                pass
            self.nm.flush()
            os._exit(1)
        if spec.is_async:
            self._start_aio_loop(spec.max_concurrency)
        elif spec.max_concurrency > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._thread_pool = ThreadPoolExecutor(
                max_workers=spec.max_concurrency,
                thread_name_prefix="rtpu-actor")
        try:
            self.nm.notify("actor_ready",
                           {"actor_id": spec.actor_id.binary()})
        except protocol.ConnectionClosed:
            os._exit(0)

    def _start_aio_loop(self, max_concurrency: int):
        loop = asyncio.new_event_loop()
        self._aio_loop = loop

        def runner():
            asyncio.set_event_loop(loop)
            self._aio_sem = asyncio.Semaphore(max_concurrency)
            loop.run_forever()

        t = threading.Thread(target=runner, daemon=True,
                             name="rtpu-actor-aio")
        t.start()
        while self._aio_sem is None:
            time.sleep(0.001)

    def _resolve_method(self, name: str):
        if name == "__ray_ready__":
            return lambda: True
        if name == "__ray_terminate__":
            return self._terminate_actor
        if self.actor_instance is None:
            # A task reached this worker before any create_actor did:
            # a control-plane routing bug, not a user error — name the
            # worker so the misrouted hop is attributable.
            raise AttributeError(
                f"actor task '{name}' reached worker "
                f"{self.worker_id.hex()[:12]} (pid {os.getpid()}) before "
                f"its create_actor (spec "
                f"{'set' if self.actor_spec is not None else 'unset'})")
        method = getattr(self.actor_instance, name, None)
        if method is None:
            raise AttributeError(
                f"{type(self.actor_instance).__name__} has no method "
                f"'{name}'")
        return method

    def _terminate_actor(self):
        try:
            self.nm.notify("actor_exit", {
                "actor_id": self.actor_spec.actor_id.binary()})
        except protocol.ConnectionClosed:
            pass
        # flush task_done for the terminate call happens in caller; exit soon
        threading.Thread(target=self._delayed_exit, daemon=True).start()
        return None

    def _delayed_exit(self):
        time.sleep(0.1)
        self._flush_completions()
        # Close segment producers AFTER the last flush appended into
        # them: the closed flag tells the driver's consumer "drain what
        # is there, then detach" — results published right before this
        # exit still resolve without re-running.
        for conn in list(self._comp_producers):
            self._drop_producer(conn)
        self.nm.flush()
        os._exit(0)

    def _claim_seqno(self, spec) -> bool:
        """True if this spec's seqno is new (claim it); False for a
        duplicate delivery. Duplicates still get a task_done report — the
        NM holds a current_tasks entry per submission and would otherwise
        keep the worker BUSY forever — but their returns are whatever the
        first execution sealed (same object IDs), so no user code reruns.
        """
        seqno = getattr(spec, "seqno", None)
        if seqno is None:
            return True
        # Seqnos are per-caller counters (each CoreWorker numbers its own
        # submissions), so dedup state is keyed by caller.
        caller = getattr(spec, "caller_id", "")
        with self._seqno_lock:
            state = self._seqno_state.setdefault(caller, [-1, set()])
            hw, extras = state
            if seqno <= hw or seqno in extras:
                dup = True
            else:
                dup = False
                extras.add(seqno)
                while hw + 1 in extras:  # compact the contiguous prefix
                    hw += 1
                    extras.discard(hw)
                state[0] = hw
        if dup:
            objects = [(oid.binary(), 0) for oid in spec.return_ids()]
            self._task_done(spec, "ok", objects)
        return not dup

    def _execute_actor_task(self, spec: ActorTaskSpec):
        try:
            self._execute_actor_task_inner(spec)
        finally:
            self._unpin_actor_task_args(spec)

    def _execute_actor_task_inner(self, spec: ActorTaskSpec):
        if not self._claim_seqno(spec):
            return
        self._current_task_id = spec.task_id.binary()
        self._set_ctx(spec, actor_id=spec.actor_id)
        start = time.time()
        exit_after = False
        try:
            method = self._resolve_method(spec.method_name)
            args, kwargs = self.core.deserialize_args(spec.args)
            result = method(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = asyncio.run(result)
            objects, inline = self._store_returns(spec, result)
            status, error = "ok", None
        except SystemExit:
            # ray_tpu_torch.actor.exit_actor(): graceful, expected termination.
            try:
                self.nm.notify("actor_exit", {
                    "actor_id": self.actor_spec.actor_id.binary()})
            except protocol.ConnectionClosed:
                pass
            objects, inline = self._store_returns(spec, None)
            status, error = "ok", None
            exit_after = True
        except BaseException as e:
            err = exceptions.RayTaskError.from_exception(
                f"{spec.method_name}", e)
            objects, inline = self._store_error_returns(spec, err)
            status, error = "error", str(e)
        finally:
            self._current_task_id = None
            self._cancel_requested = None
        self._task_done(spec, status, objects, error, inline)
        self._report_event(spec.task_id, spec.method_name, start, status,
                           kind="actor_task")
        if exit_after:
            self._delayed_exit()

    async def _run_actor_task_async(self, spec: ActorTaskSpec):
        try:
            await self._run_actor_task_async_inner(spec)
        finally:
            self._unpin_actor_task_args(spec)

    async def _run_actor_task_async_inner(self, spec: ActorTaskSpec):
        if not self._claim_seqno(spec):
            return
        async with self._aio_sem:
            start = time.time()
            try:
                method = self._resolve_method(spec.method_name)
                args, kwargs = self.core.deserialize_args(spec.args)
                result = method(*args, **kwargs)
                if inspect.iscoroutine(result):
                    result = await result
                objects, inline = self._store_returns(spec, result)
                status, error = "ok", None
            except BaseException as e:
                err = exceptions.RayTaskError.from_exception(
                    spec.method_name, e)
                objects, inline = self._store_error_returns(spec, err)
                status, error = "error", str(e)
            self._task_done(spec, status, objects, error, inline)
            self._report_event(spec.task_id, spec.method_name, start, status,
                               kind="actor_task")

    def _report_event(self, task_id: TaskID, name: str, start: float,
                      status: str, kind: str):
        """Buffer the event; a flusher ships batches to the GCS (one
        notify per flush window, not per task — at 1k+ tasks/s per worker
        a per-task notify measurably loads the single GCS lock)."""
        from ray_tpu_torch.util import tracing

        trace = tracing.current() or {}
        with self._event_lock:
            self._event_buf.append({
                "task_id": task_id.hex(),
                "name": name,
                "kind": kind,
                "node_id": self.node_id,
                "worker_id": self.worker_id.hex(),
                "pid": os.getpid(),
                "start": start,
                "end": time.time(),
                "status": status,
                "trace_id": trace.get("trace_id"),
                "span_id": trace.get("span_id"),
                "parent_span_id": trace.get("parent_span_id"),
            })

    def _record_span_event(self, ev: dict):
        """tracing sink: span events join the task-event batch with this
        worker's identity attached."""
        ev.setdefault("node_id", self.node_id)
        ev.setdefault("worker_id", self.worker_id.hex())
        ev.setdefault("pid", os.getpid())
        with self._event_lock:
            self._event_buf.append(ev)

    # Event pacing: telemetry tolerates ~1s of latency, and the r12
    # worker profile showed the old per-0.2s-tick double notify (GCS +
    # NM) as a standing _send tower on the rtpu-task-events thread at
    # high task rates. Size cap keeps a flood's frames bounded.
    _EVENT_FLUSH_S = 1.0
    _EVENT_BATCH = 256

    def _event_flush_loop(self):
        last_ev = time.monotonic()
        while not self._event_stop.wait(0.2):
            # Safety-net completion flush: queue-empty/size triggers
            # cover the main loop, but actor thread-pool / asyncio
            # completions can land while the main queue is busy.
            # (Completions keep the tight 0.2s tick — they gate caller
            # ray.get()s; events are telemetry and flush ~1/s.)
            if self._completions:
                try:
                    self._flush_completions()
                except Exception:
                    pass
            self._check_producers()
            now = time.monotonic()
            with self._event_lock:
                n = len(self._event_buf)
            if n and (n >= self._EVENT_BATCH
                      or now - last_ev >= self._EVENT_FLUSH_S):
                last_ev = now
                self._flush_events()

    def _flush_events(self):
        """Ship buffered task/span events as ONE pre-pickled blob to
        the NM, which feeds its agent's flight recorder and relays the
        same blob to the GCS timeline — one _send on this thread per
        flush window instead of the old two (GCS + NM) with the batch
        re-pickled for each."""
        with self._event_lock:
            batch, self._event_buf = self._event_buf, []
        if not batch:
            return
        try:
            self.nm.notify("task_events_b",
                           pickle.dumps(batch, protocol=5))
        except Exception:
            pass


def main():
    import faulthandler

    faulthandler.register(signal.SIGUSR2, all_threads=True)
    # Bootstrap identity, not knobs: the spawning NM writes these into
    # the child env AFTER the config module may already have been
    # imported (zygote fork), so the typed registry would serve stale
    # values — the raw read is the correct one here.
    # raylint: disable-next=config-knob-drift (bootstrap identity)
    worker_id = bytes.fromhex(os.environ["RAY_TPU_TORCH_WORKER_ID"])
    # raylint: disable-next=config-knob-drift (bootstrap identity)
    nm_address = os.environ["RAY_TPU_TORCH_NM_ADDRESS"]
    # raylint: disable-next=config-knob-drift (bootstrap identity)
    gcs_address = os.environ["RAY_TPU_TORCH_GCS_ADDRESS"]
    # raylint: disable-next=config-knob-drift (bootstrap identity)
    store_path = os.environ["RAY_TPU_TORCH_STORE_PATH"]
    # raylint: disable-next=config-knob-drift (bootstrap identity)
    node_id = os.environ["RAY_TPU_TORCH_NODE_ID"]
    # Non-default config of the spawning node manager (JSON diff; the
    # analog of serve.start shipping _system_config to worker actors):
    # without it, knobs set programmatically on the driver — inline-
    # return thresholds, A/B toggles — would silently default here,
    # because zygote-forked workers inherit the ZYGOTE's env (which
    # deliberately strips RAY_TPU_TORCH_*), not the driver's.
    # raylint: disable-next=config-knob-drift (bootstrap identity:
    # applied through the typed registry, not a raw knob read)
    cfg_diff = os.environ.get("RAY_TPU_TORCH_SYSTEM_CONFIG")
    if cfg_diff:
        try:
            config.apply_system_config(cfg_diff)
        except Exception:
            print("worker: malformed RAY_TPU_TORCH_SYSTEM_CONFIG ignored",
                  file=sys.stderr, flush=True)

    try:
        core = CoreWorker(
            gcs_address,
            role="worker",
            node_id=node_id,
            store_path=store_path,
            job_id=JobID.from_int(0),
            client_id=f"worker-{worker_id.hex()[:12]}",
        )
    except (ConnectionError, OSError) as e:
        # Cluster already gone (shutdown race) — usually benign, but say
        # WHY on stderr (-> worker log) so a connect/attach crash loop is
        # diagnosable instead of silent.
        print(f"worker startup aborted: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        sys.exit(0)
    set_global_worker(core)
    executor = WorkerExecutor(core, nm_address, worker_id)
    try:
        executor.run()
    finally:
        executor._event_stop.set()
        executor._flush_stop.set()
        executor._flush_arm.set()   # unpark the slack flusher to exit
        # Completions first: buffered task_done_batch records must reach
        # the NM before the conns die with this process (at-least-once —
        # a record lost here is re-run via the NM's worker-death report
        # and deduped by the GCS's idempotent location/put handling).
        try:
            executor._flush_completions()
        except Exception:
            pass
        # Segment producers close after the final flush: the closed
        # flag lets the driver drain the last records, then detach.
        for conn in list(executor._comp_producers):
            executor._drop_producer(conn)
        executor._flush_events()
        core.disconnect()


if __name__ == "__main__":
    main()
