"""Trace-context propagation across task/actor hops (reference:
``python/ray/util/tracing/tracing_helper.py:284`` _tracing_task_invocation
/ :318 _inject_tracing_into_function — a ``_ray_trace_ctx`` kwarg carries
OpenTelemetry context across process boundaries).

Simplification: instead of wrapping user functions with an
injected kwarg, the context rides the task spec itself (``trace_ctx``)
and spans are emitted through the EXISTING task-event machinery — every
task event already records start/end/status, so adding
trace_id/span_id/parent_span_id turns the timeline into a distributed
trace with zero extra RPCs. Always on (two small fields per spec).

A span is identified by the task id; a trace groups every task
transitively submitted from one root submission.

Beyond task-boundary spans (which the task-event machinery emits for
free), ``span()``/``emit_span()`` let ANY layer add intra-task spans to
the same stream: serve handle hops, collective operations, device-object
put/get transfers. They ride the identical event schema, so
``ray_tpu_torch timeline`` renders one connected cross-layer trace
(submit -> lease -> run -> collective -> KV handoff) with zero new RPCs
— span events batch into the existing ``task_events`` notify.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

_current: contextvars.ContextVar[Optional[Dict[str, str]]] = \
    contextvars.ContextVar("rtpu_trace_ctx", default=None)


# Trace ids = per-process random prefix + counter: uniqueness without
# per-task entropy draws (minting was ~7µs/task of the submit hot path;
# next() on itertools.count is GIL-atomic). The prefix resets in forked
# children so two processes never share an id stream.
_trace_prefix: Optional[str] = None
_trace_counter = __import__("itertools").count()


def _reset_trace_prefix() -> None:
    global _trace_prefix
    _trace_prefix = None


__import__("os").register_at_fork(after_in_child=_reset_trace_prefix)


def _new_trace_id() -> str:
    global _trace_prefix
    prefix = _trace_prefix
    if prefix is None:
        from ray_tpu_torch._private.ids import _rand_bytes

        prefix = _trace_prefix = _rand_bytes(5).hex()
    return prefix + format(next(_trace_counter) & 0xFFFFFFFFFFFF,
                           "012x")


def current() -> Optional[Dict[str, str]]:
    """The active {trace_id, span_id} in this task/driver context."""
    return _current.get()


def _sample_root() -> bool:
    """Head-based sampling decision, made ONCE when a trace roots
    (``trace_sample_rate``): the decision rides the context to every
    descendant span — across task hops via the spec's trace_ctx — so a
    trace is never half-kept. Spans whose status is not "ok" (errored
    requests, ingress sheds) are emitted regardless; see emit_span."""
    from ray_tpu_torch._private.config import config

    rate = float(config.trace_sample_rate)
    if rate >= 1.0:
        return True   # default: no entropy draw on the hot path
    if rate <= 0.0:
        return False
    import random

    return random.random() < rate


def for_submit() -> Optional[Dict[str, Optional[str]]]:
    """Context to attach to an outgoing task spec: continues the active
    trace (the submitting task's span becomes the parent). A driver-side
    ROOT submission returns None — the executing worker mints the trace
    id at activation (``activate`` handles a falsy ctx), so the submit
    hot path pays no id mint or dict build for the overwhelmingly common
    no-active-trace case; connectivity is unaffected because nothing on
    the submit side records a root trace id."""
    ctx = _current.get()
    if ctx is None:
        return None
    out: Dict[str, Optional[str]] = {
        "trace_id": ctx["trace_id"], "parent_span_id": ctx["span_id"]}
    if ctx.get("sampled") is False:
        out["sampled"] = False   # only ship the non-default decision
    return out


def activate(trace_ctx: Optional[Dict[str, Any]],
             span_id: str) -> contextvars.Token:
    """Execution side: make the inbound context current for the duration
    of the task body (span_id = this task's id). Returns the token for
    ``deactivate``."""
    if not trace_ctx:
        trace_ctx = {"trace_id": _new_trace_id(),
                     "parent_span_id": None,
                     "sampled": _sample_root()}
    return _current.set({"trace_id": trace_ctx.get("trace_id"),
                         "span_id": span_id,
                         "parent_span_id": trace_ctx.get("parent_span_id"),
                         "sampled": trace_ctx.get("sampled", True)})


def deactivate(token: contextvars.Token) -> None:
    _current.reset(token)


# ------------------------------------------------------------------- spans
#
# Span events share the task-event schema (the GCS appends them to the
# same ring the timeline reads). Worker processes register a sink that
# routes spans through the executor's existing event buffer — one
# flusher, one notify batch, and the node agent's flight recorder sees
# them too. Driverside (no executor) spans buffer here and flush
# opportunistically over the GCS channel.

_sink: Optional[Callable[[dict], None]] = None
_buf_lock = threading.Lock()
_buf: deque = deque(maxlen=4096)   # bounded: un-flushable spans drop oldest
_last_flush = 0.0
_FLUSH_BATCH = 16
_FLUSH_INTERVAL_S = 0.25


def set_sink(sink: Optional[Callable[[dict], None]]) -> None:
    """Route span events through ``sink`` instead of the local buffer
    (worker_main points this at the executor's task-event buffer)."""
    global _sink
    _sink = sink


def new_span_id() -> str:
    return _new_trace_id()


_UNSET = object()


def emit_span(name: str, kind: str, start: float,
              end: Optional[float] = None, status: str = "ok",
              attrs: Optional[Dict[str, Any]] = None,
              span_id: Optional[str] = None,
              trace_id: Optional[str] = None,
              parent_span_id: Any = _UNSET,
              sampled: Optional[bool] = None) -> None:
    """Append one completed span to the task-event stream. By default
    the span is a child of the active context (task span or enclosing
    ``span()``); with no active context it roots a fresh trace. Explicit
    trace_id/parent_span_id override the context (``span()`` passes its
    own identity — by emit time its contextvar is already reset). Never
    raises — tracing must not break the operation it observes.

    Sampling: a span belonging to a sampled-OUT trace (head-based,
    ``trace_sample_rate``) is dropped here — UNLESS its status marks a
    failure: errored requests and ingress sheds are always kept. A
    consumer-initiated "cancelled" (SSE client closing its tab) is
    ROUTINE on high-rate streaming traffic — the very traffic the knob
    exists for — so it samples like "ok"."""
    try:
        ctx = _current.get()
        if sampled is None:
            sampled = ctx.get("sampled", True) if ctx else _sample_root()
        if not sampled and status in ("ok", "cancelled"):
            return
        sid = span_id or new_span_id()
        ev = {
            "task_id": sid,
            "name": name,
            "kind": kind,
            "start": start,
            "end": end if end is not None else time.time(),
            "status": status,
            "trace_id": trace_id or (
                ctx["trace_id"] if ctx else _new_trace_id()),
            "span_id": sid,
            "parent_span_id": parent_span_id
            if parent_span_id is not _UNSET
            else (ctx["span_id"] if ctx else None),
        }
        if attrs:
            ev["attrs"] = dict(attrs)
        sink = _sink
        if sink is not None:
            sink(ev)
            return
        with _buf_lock:
            _buf.append(ev)
        _maybe_flush()
    except Exception:
        pass


@contextlib.contextmanager
def span(name: str, kind: str = "span",
         attrs: Optional[Dict[str, Any]] = None):
    """Context manager: everything submitted/emitted inside becomes a
    child of this span (task submissions pick it up via ``for_submit``),
    and the span itself lands in the task-event stream on exit."""
    ctx = _current.get()
    sid = new_span_id()
    tid = ctx["trace_id"] if ctx else _new_trace_id()
    parent = ctx["span_id"] if ctx else None
    sampled = ctx.get("sampled", True) if ctx else _sample_root()
    token = _current.set({
        "trace_id": tid,
        "span_id": sid,
        "parent_span_id": parent,
        "sampled": sampled,
    })
    start = time.time()
    status = "ok"
    try:
        yield sid
    except BaseException:
        status = "error"
        raise
    finally:
        _current.reset(token)
        emit_span(name, kind, start, status=status, attrs=attrs,
                  span_id=sid, trace_id=tid, parent_span_id=parent,
                  sampled=sampled)


class PendingSpan:
    """A root-capable span whose OUTCOME is known later than its body —
    the serve request shape: the handle submits inside the span (so the
    replica task parents under it and inherits the sampling decision),
    but ok/error is only known when the response resolves. ``finish``
    emits exactly once with the terminal status; an errored request is
    therefore always kept even when its trace was sampled out."""

    __slots__ = ("name", "kind", "attrs", "sid", "trace_id", "parent",
                 "sampled", "start", "_emitted")

    def __init__(self, name: str, kind: str = "span",
                 attrs: Optional[Dict[str, Any]] = None):
        ctx = _current.get()
        self.name, self.kind, self.attrs = name, kind, attrs
        self.sid = new_span_id()
        if ctx is not None:
            self.trace_id = ctx["trace_id"]
            self.parent = ctx["span_id"]
            self.sampled = ctx.get("sampled", True)
        else:
            self.trace_id = _new_trace_id()
            self.parent = None
            self.sampled = _sample_root()
        self.start = time.time()
        self._emitted = False

    @contextlib.contextmanager
    def active(self):
        """Make this span the current context (submissions inside become
        its children and inherit the sampling decision)."""
        token = _current.set({
            "trace_id": self.trace_id,
            "span_id": self.sid,
            "parent_span_id": self.parent,
            "sampled": self.sampled,
        })
        try:
            yield self
        finally:
            _current.reset(token)

    def finish(self, status: str = "ok") -> None:
        """Emit the span with its terminal status (idempotent; never
        raises — span bookkeeping must not break the request path)."""
        if self._emitted:
            return
        self._emitted = True
        emit_span(self.name, self.kind, self.start, status=status,
                  attrs=self.attrs, span_id=self.sid,
                  trace_id=self.trace_id, parent_span_id=self.parent,
                  sampled=self.sampled)


# raylint: disable-next=async-blocking (loop-safe boundary: when called
# on an event-loop thread, the flush — GCS notify, channel lock, maybe a
# reconnect — is shipped to the default executor; the synchronous branch
# below only runs on plain threads, which the static pass cannot see)
def _maybe_flush() -> None:
    global _last_flush
    now = time.time()
    with _buf_lock:
        due = len(_buf) >= _FLUSH_BATCH or \
            (now - _last_flush) >= _FLUSH_INTERVAL_S
        if not due or not _buf:
            return
        _last_flush = now
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        flush_spans()
        return
    loop.run_in_executor(None, flush_spans)


def flush_spans() -> None:
    """Ship buffered driverside spans to the GCS (called opportunistically
    from emit_span and once on shutdown). Best-effort: no cluster, no
    flush — the bounded buffer just keeps the most recent spans."""
    from ray_tpu_torch._private import worker as worker_mod

    with _buf_lock:
        if not _buf:
            return
        batch = list(_buf)
        _buf.clear()
    w = worker_mod.global_worker()
    if w is None:
        # Put them back (bounded deque: overflow drops oldest).
        with _buf_lock:
            _buf.extendleft(reversed(batch))
        return
    try:
        w.gcs.notify("task_events", batch)
    except Exception:
        pass
