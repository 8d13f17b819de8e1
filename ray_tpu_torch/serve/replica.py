"""Replica actor (the port's copy of ``ray_tpu/serve/replica.py``;
reference: ``serve/_private/replica.py:267`` ``RayServeReplica``;
``handle_request`` :514).

Wraps the user's class or function. Tracks in-flight request count for
queue-depth autoscaling and handle-side least-loaded routing.

Async deployments get ONE persistent background event loop per replica
(reference: the replica's user-code event loop) — coroutines from every
request run on the same loop, so async state (locks, queues, client
sessions) shared across requests works; the old per-request
``asyncio.run`` created and destroyed a loop per call.

Streaming deployments return a generator (sync or async):
``handle_request_stream`` registers it and ``stream_next`` pulls one
item per call, driven lazily by the consumer through the handle's
``remote_gen`` path — natural backpressure, no unbounded buffering.

The deployment's callable arrives pickled by ``_private/pickler.py`` (by
reference when the replica can import it, by value otherwise). A replica
on a GPU reports its peak device memory in ``stats``.
"""

from __future__ import annotations

import asyncio
import inspect
import threading
import uuid
from typing import Any, Dict, Iterator, Optional, Tuple


class _AsyncGenIter:
    """Drive an async generator from sync code via the replica loop."""

    def __init__(self, agen, loop):
        self._agen = agen
        self._loop = loop

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        fut = asyncio.run_coroutine_threadsafe(
            self._agen.__anext__(), self._loop)
        try:
            # raylint: disable-next=unbounded-wait (waits on the
            # replica's OWN user generator; the consumer side bounds
            # each pull with the handle's stream item timeout and
            # cancels the stream — which closes the generator — on
            # timeout or disconnect)
            return fut.result()
        except StopAsyncIteration:
            raise StopIteration from None


class Replica:
    def __init__(self, callable_blob: bytes, init_args: Tuple,
                 init_kwargs: Dict, deployment_name: str, replica_id: str,
                 user_config: Any = None):
        from ray_tpu_torch._private import pickler

        target = pickler.loads(callable_blob)
        self.deployment_name = deployment_name
        self.replica_id = replica_id
        self._ongoing = 0
        self._total = 0
        self._draining = False
        self._lock = threading.Lock()
        # One persistent event loop for the replica's async user code.
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._loop.run_forever, daemon=True,
            name=f"replica-loop-{replica_id}")
        self._loop_thread.start()
        # Live streams: id -> {"iter", "lock"}.
        self._streams: Dict[str, Dict[str, Any]] = {}
        if inspect.isclass(target):
            self._instance = target(*init_args, **init_kwargs)
            self._callable = self._instance
        else:
            if init_args or init_kwargs:
                raise TypeError(
                    "function deployments take no init args")
            self._instance = None
            self._callable = target
        if user_config is not None:
            self.reconfigure(user_config)

    def reconfigure(self, user_config: Any):
        """Reference: replica.py reconfigure — dynamic user_config push."""
        fn = getattr(self._instance, "reconfigure", None)
        if fn is not None:
            fn(user_config)
        return True

    def _resolve(self, method_name: str):
        if method_name == "__call__":
            return self._callable
        return getattr(self._callable, method_name)

    def _run_user_code(self, method_name: str, args: Tuple, kwargs: Dict):
        result = self._resolve(method_name)(*args, **kwargs)
        if inspect.iscoroutine(result):
            # Submit to the replica's persistent loop — NOT a fresh
            # asyncio.run() loop per call, which broke any deployment
            # sharing async state across requests.
            # raylint: disable-next=unbounded-wait (waits on the
            # replica's OWN user coroutine; the caller bounds the RPC
            # with the handle/ingress request timeout)
            result = asyncio.run_coroutine_threadsafe(
                result, self._loop).result()
        return result

    def _check_admission(self):
        """A draining replica refuses NEW work typed — the handle
        re-picks a healthy replica transparently. Streams already open
        keep being served (that is what the drain waits for)."""
        if self._draining:
            from ray_tpu_torch.exceptions import ReplicaDrainingError

            raise ReplicaDrainingError(
                f"replica {self.replica_id} of {self.deployment_name} "
                "is draining", replica_id=self.replica_id)

    def handle_request(self, method_name: str, args: Tuple, kwargs: Dict):
        self._check_admission()
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            result = self._run_user_code(method_name, args, kwargs)
            if inspect.isgenerator(result) or \
                    inspect.isasyncgen(result):
                raise TypeError(
                    f"{self.deployment_name}.{method_name} returned a "
                    "generator; call it through the handle's "
                    "remote_gen() streaming path")
            return result
        finally:
            with self._lock:
                self._ongoing -= 1

    # ------------------------------------------------------------ streaming

    def handle_request_stream(self, method_name: str, args: Tuple,
                              kwargs: Dict) -> str:
        """Start a streaming response: the user method must return a
        generator / async generator / iterator. Returns the stream id
        the caller pulls with ``stream_next``. The stream counts as one
        ongoing request until exhausted (autoscaling signal)."""
        self._check_admission()
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            result = self._run_user_code(method_name, args, kwargs)
            if inspect.isasyncgen(result):
                it = _AsyncGenIter(result, self._loop)
            elif inspect.isgenerator(result) or hasattr(
                    result, "__next__"):
                it = result
            else:
                raise TypeError(
                    f"{self.deployment_name}.{method_name} returned "
                    f"{type(result).__name__}, not a generator/iterator")
        except BaseException:
            with self._lock:
                self._ongoing -= 1
            raise
        sid = uuid.uuid4().hex[:12]
        with self._lock:
            self._streams[sid] = {"iter": it, "lock": threading.Lock()}
        return sid

    def stream_next(self, stream_id: str,
                    max_items: int = 1) -> Dict[str, Any]:
        """Pull the next item(s) of a stream. ``{"item": x, "done":
        False}`` or ``{"done": True}`` at exhaustion (the stream is
        then forgotten). Errors from the generator tear the stream down
        and propagate to the caller.

        With ``max_items > 1`` the reply is ``{"items": [...], "done":
        bool}``: after the first (blocking) item, every item the
        iterator reports ALREADY READY — via an optional non-blocking
        ``next_ready()`` probe (returns None when nothing is pending;
        the engine streams implement it) — rides the same RPC, so a
        producer that outruns the consumer costs one round-trip per
        batch instead of one per item. ``done: True`` may arrive WITH
        trailing items; the caller delivers them before stopping."""
        with self._lock:
            st = self._streams.get(stream_id)
        if st is None:
            return {"done": True}
        items: list = []
        done = False
        try:
            with st["lock"]:
                items.append(next(st["iter"]))
                probe = getattr(st["iter"], "next_ready", None) \
                    if max_items > 1 else None
                while probe is not None and len(items) < max_items:
                    nxt = probe()
                    if nxt is None:
                        break
                    items.append(nxt)
        except StopIteration:
            done = True
        except BaseException:
            self._drop_stream(stream_id)
            raise
        if done:
            self._drop_stream(stream_id)
        if max_items <= 1:
            if done:
                return {"done": True}
            return {"item": items[0], "done": False}
        return {"items": items, "done": done}

    def stream_cancel(self, stream_id: str) -> bool:
        """Abandon a stream (consumer went away)."""
        with self._lock:
            st = self._streams.get(stream_id)
        if st is None:
            return False
        it = st["iter"]
        close = getattr(it, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass
        self._drop_stream(stream_id)
        return True

    def _drop_stream(self, stream_id: str) -> None:
        with self._lock:
            if self._streams.pop(stream_id, None) is not None:
                self._ongoing -= 1

    # ------------------------------------------------------------- draining

    def drain(self, timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """Rolling-restart drain: stop admitting new requests/streams
        (``ReplicaDrainingError`` — the handle re-picks), then wait up
        to ``timeout_s`` (default ``config.serve_drain_timeout_s``) for
        in-flight work to finish. Returns ``{"drained": bool,
        "ongoing": int}`` — stragglers past the budget hand off through
        the same migration path as a crash when the controller kills
        this replica."""
        import time

        if timeout_s is None:
            from ray_tpu_torch._private.config import config

            timeout_s = float(config.serve_drain_timeout_s)
        self._draining = True
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        while True:
            with self._lock:
                ongoing = self._ongoing
            if ongoing <= 0 or time.monotonic() >= deadline:
                return {"drained": ongoing <= 0, "ongoing": ongoing,
                        "replica_id": self.replica_id}
            time.sleep(0.05)

    # ----------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        # Deployments exposing ``serve_stats()`` (e.g. the LLM engine
        # pools) merge engine-side signals — queue depth, slot
        # occupancy, and ``autoscale_load``, the number the queue-depth
        # autoscaler and the handle's pushed-stats router weigh.
        extra: Dict[str, Any] = {}
        fn = getattr(self._instance, "serve_stats", None)
        if fn is not None:
            try:
                extra = dict(fn() or {})
            except Exception:
                extra = {}
        import os
        import sys

        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            # Only a process that already uses its GPU reads it: a CPU
            # replica (CUDA_VISIBLE_DEVICES="") never touches CUDA here.
            extra["device_memory_peak_bytes"] = int(
                torch.cuda.max_memory_allocated())
        with self._lock:
            extra.update({"ongoing": self._ongoing, "total": self._total,
                          "replica_id": self.replica_id,
                          "pid": os.getpid(),
                          "draining": self._draining})
        return extra

    def check_health(self) -> bool:
        fn = getattr(self._instance, "check_health", None)
        if fn is not None:
            fn()
        return True
