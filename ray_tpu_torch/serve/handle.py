"""Deployment handles (the port's copy of ``ray_tpu/serve/handle.py``;
reference: ``serve/handle.py`` DeploymentHandle + ``_private/router.py:261``
Router).

``handle.remote(...)`` picks the least-loaded replica (power of two
choices) and returns a ``DeploymentResponse`` whose ``.result()``
blocks; ``handle.remote_gen(...)`` / ``method.remote_gen(...)`` opens a
streaming response (an iterator over the replica generator's items).

Replica-set updates are PUSHED: a background listener long-polls the
controller's versioned channel (reference: LongPollClient,
_private/long_poll.py:68) so membership changes land within one notify;
the TTL refresh remains only as bootstrap + fallback while the listener
is (re)connecting.

Routing load is pushed too: the controller piggybacks each replica's
observed load (``autoscale_load`` — in-flight requests, plus engine
queue depth for deployments that expose it) on the same channel, and
the handle layers its own optimistic in-flight deltas on top. The
request hot path therefore makes ZERO stats RPCs (the legacy
two-``stats.remote()``-per-request probe survives behind the
``serve_handle_stats_rpc`` config knob as the A/B baseline).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

_REPLICA_CACHE_TTL_S = 1.0
_STREAM_START_TIMEOUT_S = 120.0


def _aid(replica) -> str:
    """Stable routing key for a replica actor handle."""
    try:
        return replica._actor_id.hex()
    except Exception:
        return str(id(replica))


def _note_migration_quiet(deployment: str) -> None:
    try:
        from ray_tpu_torch.serve.migration import note_migration

        note_migration(deployment)
    except Exception:
        pass


class DeploymentResponse:
    def __init__(self, ref, resubmit=None, on_done=None, span=None,
                 deployment: str = ""):
        self._ref = ref
        self._resubmit = resubmit
        self._on_done = on_done
        self._deployment = deployment
        # The handle-root PendingSpan: emitted once, when the OUTCOME is
        # known (here, at result()) — an errored request's trace is then
        # always kept even when head-based sampling dropped it.
        self._span = span

    def result(self, timeout: Optional[float] = None):
        """Block for the response. If the serving replica died
        (controller replacement, node loss), its engine failed with the
        request in flight, or the replica is draining for a rolling
        restart, the request is resubmitted to a live replica up to
        ``serve_request_max_migrations`` times (reference: the serve
        router requeues requests from dead replicas). A unary rerun is
        bit-identical — nothing was delivered yet and per-request
        sampling keys are deterministic. An exhausted budget sheds
        typed (``RequestMigrationExhaustedError`` — the ingress maps it
        to 503)."""
        import ray_tpu_torch
        from ray_tpu_torch import exceptions
        from ray_tpu_torch._private.config import config

        limit = max(0, int(config.serve_request_max_migrations))
        migrations = 0
        try:
            while True:
                try:
                    out = ray_tpu_torch.get(self._ref, timeout=timeout)
                    self._finish_span("ok")
                    return out
                except (exceptions.RayActorError,
                        exceptions.WorkerCrashedError,
                        exceptions.ReplicaDrainingError,
                        exceptions.EngineFailedError) as e:
                    if self._resubmit is None:
                        self._finish_span("error")
                        raise
                    if migrations >= limit:
                        self._finish_span("error")
                        raise exceptions.RequestMigrationExhaustedError(
                            f"request still failing after {migrations} "
                            f"migrations (serve_request_max_migrations="
                            f"{limit})", migrations=migrations) from e
                    migrations += 1
                    # Small backoff: the controller needs a beat to
                    # prune the dead replica from the pushed set.
                    time.sleep(0.2 * migrations)
                    self._ref = self._resubmit()
                    _note_migration_quiet(self._deployment)
                except exceptions.GetTimeoutError:
                    raise   # not terminal: the caller may result() again
                except BaseException:
                    self._finish_span("error")
                    raise
        finally:
            self._done()

    def _finish_span(self, status: str):
        sp, self._span = self._span, None
        if sp is not None:
            sp.finish(status)

    def __del__(self):
        # Fire-and-forget (a response never result()ed): emit the handle
        # root at GC with the outcome unobserved, so the replica's task
        # event never dangles off an unwritten parent span. finish() is
        # idempotent and never raises, safe at interpreter teardown.
        try:
            self._finish_span("ok")
        except Exception:
            pass

    def _done(self):
        cb, self._on_done = self._on_done, None
        if cb is not None:
            try:
                cb()
            except Exception:
                pass

    @property
    def ref(self):
        return self._ref


class DeploymentResponseGenerator:
    """Streaming response: iterates the items of a replica-side
    generator, pulled lazily — the replica generator only advances when
    the consumer asks. Each ``stream_next`` RPC requests a BATCH
    (``max_items``): the replica returns its first item plus every item
    already ready, and the local buffer drains before the next
    round-trip, so per-item RPC count collapses on fast streams (the
    SSE pump iterates this same object and inherits the batching)."""

    # Per-RPC batch ceiling: bounds reply size while still collapsing
    # the per-token round-trips of a fast producer.
    _MAX_ITEMS = 16

    def __init__(self, replica, stream_id: str,
                 timeout_s: Optional[float] = None, on_done=None,
                 span=None, handle=None, resume=None):
        self._replica = replica
        self._sid = stream_id
        self._timeout = timeout_s
        self._on_done = on_done
        self._span = span
        self._status: Optional[str] = None
        self._exhausted = False
        self._buf: List[Any] = []
        self._done_after_buf = False
        # Crash-transparent migration: the opening handle plus a
        # ``resume(delivered) -> (method, args, kwargs) | None`` rewriter
        # that rebuilds the request from the items already received
        # client-side (the authoritative no-duplicate/no-gap tally).
        self._handle = handle
        self._resume = resume
        self._delivered: List[Any] = []
        self._migrations = 0

    def __iter__(self):
        return self

    def __next__(self):
        import ray_tpu_torch
        from ray_tpu_torch import exceptions

        while True:
            if self._buf:
                return self._buf.pop(0)
            if self._exhausted:
                raise StopIteration
            if self._done_after_buf:
                self._finish("ok")
                raise StopIteration
            try:
                out = ray_tpu_torch.get(
                    self._replica.stream_next.remote(self._sid,
                                                     self._MAX_ITEMS),
                    timeout=self._timeout)
            except (exceptions.RayActorError,
                    exceptions.WorkerCrashedError,
                    exceptions.EngineFailedError) as e:
                # The replica died (or its engine failed with a resume
                # descriptor) mid-stream: migrate to a healthy replica
                # and continue at the next item.
                if self._try_migrate(e):
                    continue
                self._status = "error"
                self.cancel()
                raise
            except BaseException:
                # Tell the replica before marking ourselves exhausted: a
                # CLIENT-side failure (per-item timeout, interrupt) is
                # one the replica cannot see — without the cancel its
                # stream entry, ongoing count, and the engine request
                # behind it would live on for a consumer that is gone.
                # (If the error CAME from the replica it already dropped
                # the stream and the cancel is a cheap no-op.)
                self._status = "error"
                self.cancel()
                raise
            if "items" in out:
                self._buf = list(out["items"])
                self._delivered.extend(self._buf)
                if out.get("done"):
                    # Deliver the trailing items first; stop after.
                    self._done_after_buf = True
                if self._buf:
                    return self._buf.pop(0)
                self._finish("ok")
                raise StopIteration
            if out.get("done"):
                self._finish("ok")
                raise StopIteration
            self._delivered.append(out["item"])
            return out["item"]

    def _try_migrate(self, err: BaseException) -> bool:
        """Re-open the stream on a healthy replica, resuming after the
        items already delivered. Returns False when migration is not
        wired (no ``resume`` rewriter — generic streams keep today's
        fail-loud behavior) or the rewriter declines; raises typed when
        the ``serve_request_max_migrations`` budget is exhausted."""
        from ray_tpu_torch import exceptions
        from ray_tpu_torch._private.config import config

        if self._resume is None or self._handle is None:
            return False
        limit = max(0, int(config.serve_request_max_migrations))
        if self._migrations >= limit:
            self._status = "error"
            self.cancel()
            raise exceptions.RequestMigrationExhaustedError(
                f"stream still failing after {self._migrations} "
                f"migrations (serve_request_max_migrations={limit})",
                migrations=self._migrations) from err
        try:
            call = self._resume(list(self._delivered))
        except Exception:
            call = None
        if call is None:
            return False
        method, args, kwargs = call
        try:
            replica, sid, done = self._handle._open_stream(
                method, args, kwargs, span=self._span, fresh=True)
        except BaseException:
            # Could not place the resume anywhere before the stream-open
            # deadline; surface the ORIGINAL death to the caller.
            return False
        self._migrations += 1
        _note_migration_quiet(self._handle.deployment_name)
        old_done, self._on_done = self._on_done, done
        if old_done is not None:
            try:
                old_done()
            except Exception:
                pass
        self._replica = replica
        self._sid = sid
        return True

    def cancel(self):
        """Abandon the stream (replica-side generator is closed)."""
        if self._exhausted:
            return
        try:
            self._replica.stream_cancel.remote(self._sid)
        except Exception:
            pass
        self._finish(self._status or "cancelled")

    # ``close`` so nested streams propagate cancellation: a replica
    # whose own streaming method wraps ANOTHER deployment's remote_gen
    # (e.g. router -> engine pool) gets stream_cancel'd, which close()s
    # its iterator — cancelling the inner stream instead of leaving the
    # engine decoding for a consumer that is gone.
    close = cancel

    def _finish(self, status: str = "ok"):
        self._exhausted = True
        sp, self._span = self._span, None
        if sp is not None:
            sp.finish(status)
        cb, self._on_done = self._on_done, None
        if cb is not None:
            try:
                cb()
            except Exception:
                pass


class DeploymentHandle:
    # Consecutive listen/lookup failures before the listener thread gives
    # up (controller gone: serve.shutdown, deployment deleted). A handle
    # still in use relaunches the listener lazily from _pick().
    _LISTEN_MAX_FAILURES = 5

    def __init__(self, deployment_name: str, method_name: str = "__call__"):
        self.deployment_name = deployment_name
        self._method = method_name
        self._replicas: List[Any] = []
        self._fetched_at = 0.0
        self._lock = threading.Lock()
        self._rr = random.Random()
        self._listener_started = False
        self._stopped = False
        # Pushed per-replica load (controller long-poll) + this handle's
        # own optimistic in-flight deltas, keyed by actor id hex.
        self._pushed_load: Dict[str, float] = {}
        self._local_delta: Dict[str, int] = {}

    def __reduce__(self):
        # Handles travel into replicas (deployment graphs); the listener
        # thread restarts lazily on the other side.
        return (DeploymentHandle, (self.deployment_name, self._method))

    def stop(self):
        """Stop the push listener (the thread exits at its next wakeup)."""
        with self._lock:
            self._stopped = True

    def _ensure_listener(self):
        with self._lock:
            if self._listener_started:
                return
            self._listener_started = True
            self._stopped = False
        threading.Thread(target=self._listen_loop, daemon=True,
                         name=f"serve-longpoll-{self.deployment_name}"
                         ).start()

    def _install_update(self, value):
        """A pushed replica-set update: either the legacy bare list or
        ``{"replicas": [...], "ongoing": {aid: load}}``."""
        if isinstance(value, dict):
            replicas = list(value.get("replicas") or [])
            ongoing = dict(value.get("ongoing") or {})
        else:
            replicas, ongoing = list(value), {}
        with self._lock:
            self._replicas = replicas
            self._fetched_at = time.time()
            self._pushed_load = ongoing
            # The push reflects controller-observed load, which includes
            # (or has retired) everything this handle submitted before
            # the controller's probe — reset the optimistic deltas.
            self._local_delta.clear()

    def _listen_loop(self):
        import ray_tpu_torch
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        key = f"replicas:{self.deployment_name}"
        version = 0
        failures = 0
        while True:
            with self._lock:
                if self._stopped:
                    break
            try:
                ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
                updates = ray_tpu_torch.get(
                    ctrl.listen_for_change.remote({key: version}, 25.0),
                    timeout=35)
            except Exception:
                # Controller unreachable (shutdown, deleted deployment's
                # cluster going away, transient outage): bounded retries,
                # then exit instead of leaking a thread that polls
                # forever. Unpickled handle copies inside dead replicas
                # die with this too.
                failures += 1
                if failures >= self._LISTEN_MAX_FAILURES:
                    break
                time.sleep(1.0)
                continue
            failures = 0
            if key in updates:
                version, value = updates[key]
                self._install_update(value)
        with self._lock:
            self._listener_started = False

    def options(self, method_name: str) -> "DeploymentHandle":
        h = DeploymentHandle(self.deployment_name, method_name)
        return h

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    # ------------------------------------------------------------- routing

    def _refresh(self, force: bool = False):
        import ray_tpu_torch
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        now = time.time()
        with self._lock:
            # With a live push listener the poll is only a safety net.
            ttl = 10.0 if self._listener_started else _REPLICA_CACHE_TTL_S
            if not force and self._replicas and \
                    now - self._fetched_at < ttl:
                return
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        replicas = ray_tpu_torch.get(
            ctrl.get_replicas.remote(self.deployment_name), timeout=30)
        with self._lock:
            self._replicas = replicas
            self._fetched_at = now

    def _load_of(self, replica) -> float:
        aid = _aid(replica)
        return (self._pushed_load.get(aid, 0.0)
                + self._local_delta.get(aid, 0))

    def _note_submit(self, replica):
        """Optimistic in-flight increment, undone when the response
        resolves (or cleared wholesale by the next pushed snapshot)."""
        aid = _aid(replica)
        with self._lock:
            self._local_delta[aid] = self._local_delta.get(aid, 0) + 1

        def done():
            with self._lock:
                n = self._local_delta.get(aid, 0) - 1
                if n > 0:
                    self._local_delta[aid] = n
                else:
                    self._local_delta.pop(aid, None)

        return done

    def _pick(self):
        import ray_tpu_torch
        from ray_tpu_torch._private.config import config

        self._ensure_listener()
        self._refresh()
        with self._lock:
            replicas = list(self._replicas)
        if not replicas:
            # Deployment may still be reconciling — retry briefly.
            deadline = time.time() + 10
            while not replicas and time.time() < deadline:
                time.sleep(0.1)
                self._refresh(force=True)
                with self._lock:
                    replicas = list(self._replicas)
            if not replicas:
                raise RuntimeError(
                    f"no replicas for deployment "
                    f"{self.deployment_name!r}")
        if len(replicas) == 1:
            return replicas[0]
        # Power of two choices on per-replica load.
        a, b = self._rr.sample(replicas, 2)
        if config.serve_handle_stats_rpc:
            # Legacy A/B baseline: two blocking stats RPCs per request.
            try:
                sa, sb = ray_tpu_torch.get(
                    [a.stats.remote(), b.stats.remote()], timeout=2)
                return a if sa["ongoing"] <= sb["ongoing"] else b
            except Exception:
                return a
        # Pushed loads + local optimistic deltas: zero RPCs.
        with self._lock:
            return a if self._load_of(a) <= self._load_of(b) else b

    def _submit(self, method: str, args, kwargs, fresh: bool = False,
                span=None):
        from ray_tpu_torch.util import tracing

        if fresh:
            self._refresh(force=True)
        replica = self._pick()
        done = self._note_submit(replica)
        # The handle hop is a span — and the TRACE ROOT for serve
        # traffic, where the head-based sampling decision is made
        # (trace_sample_rate): the replica's handle_request task submits
        # inside it, so its task event parents under this hop and
        # inherits the decision. The span's emission waits for the
        # request OUTCOME (DeploymentResponse.result), so an errored
        # request is always kept. A resubmission after replica death
        # reuses the original span — one request, one root.
        if span is None:
            span = tracing.PendingSpan(
                f"serve.handle.{self.deployment_name}.{method}",
                kind="serve_handle",
                attrs={"deployment": self.deployment_name,
                       "method": method})
        with span.active():
            ref = replica.handle_request.remote(method, args, kwargs)
        return ref, done, span

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        ref, done, span = self._submit(self._method, args, kwargs)
        return DeploymentResponse(
            ref,
            resubmit=lambda: self._submit(self._method, args, kwargs,
                                          fresh=True, span=span)[0],
            on_done=done,
            span=span,
            deployment=self.deployment_name)

    def remote_gen(self, *args, _item_timeout_s: Optional[float] = None,
                   _resume=None, **kwargs) -> DeploymentResponseGenerator:
        """Streaming call. ``_item_timeout_s`` (underscored so it can
        never collide with user kwargs) bounds EACH item pull — the
        ingress tier sets it so a wedged replica generator terminates
        the stream instead of parking a proxy thread forever.
        ``_resume`` is an optional migration rewriter
        (``resume(delivered) -> (method, args, kwargs) | None``, see
        ray_tpu_torch.serve.migration): with it, a replica death mid-stream
        re-opens on a healthy replica and continues at the next item."""
        return self._submit_stream(self._method, args, kwargs,
                                   item_timeout_s=_item_timeout_s,
                                   resume=_resume)

    def _open_stream(self, method: str, args, kwargs, span=None,
                     fresh: bool = False):
        """Pick a replica and open a stream on it. A pick that lands on
        a dead or draining replica retries against a force-refreshed
        set (bounded by the stream-start timeout) — replica churn at
        open time, including every stream migration's re-open, rides
        this. Returns ``(replica, stream_id, done_callback)``."""
        import ray_tpu_torch
        from ray_tpu_torch import exceptions

        deadline = time.time() + _STREAM_START_TIMEOUT_S
        while True:
            if fresh:
                self._refresh(force=True)
            replica = self._pick()
            done = self._note_submit(replica)
            try:
                if span is not None:
                    with span.active():
                        start_ref = replica.handle_request_stream.remote(
                            method, args, kwargs)
                else:
                    start_ref = replica.handle_request_stream.remote(
                        method, args, kwargs)
                sid = ray_tpu_torch.get(start_ref,
                                  timeout=_STREAM_START_TIMEOUT_S)
                return replica, sid, done
            except (exceptions.RayActorError,
                    exceptions.WorkerCrashedError):
                # The request moved off a CRASHED replica — that is a
                # migration (counted), even though open-retries do not
                # consume the per-stream migration budget: nothing was
                # delivered yet, so the retry is trivially exact.
                done()
                _note_migration_quiet(self.deployment_name)
                fresh = True
                if time.time() >= deadline:
                    raise
                time.sleep(0.2)
            except exceptions.ReplicaDrainingError:
                # Admission shed on a retiring replica: a re-pick, not
                # a crash migration — kept out of the counter.
                done()
                fresh = True
                if time.time() >= deadline:
                    raise
                time.sleep(0.2)
            except BaseException:
                done()
                raise

    def _submit_stream(self, method: str, args, kwargs,
                       item_timeout_s: Optional[float] = None,
                       resume=None) -> DeploymentResponseGenerator:
        from ray_tpu_torch.util import tracing

        span = tracing.PendingSpan(
            f"serve.handle.{self.deployment_name}.{method}",
            kind="serve_handle",
            attrs={"deployment": self.deployment_name,
                   "method": method, "streaming": True})
        try:
            replica, sid, done = self._open_stream(method, args, kwargs,
                                                   span=span)
        except BaseException:
            span.finish("error")
            raise
        return DeploymentResponseGenerator(replica, sid,
                                           timeout_s=item_timeout_s,
                                           on_done=done,
                                           span=span,
                                           handle=self,
                                           resume=resume)


class _MethodCaller:
    def __init__(self, handle: DeploymentHandle, method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        ref, done, span = self._handle._submit(self._method, args, kwargs)
        return DeploymentResponse(
            ref,
            resubmit=lambda: self._handle._submit(
                self._method, args, kwargs, fresh=True, span=span)[0],
            on_done=done,
            span=span,
            deployment=self._handle.deployment_name)

    def remote_gen(self, *args, _item_timeout_s: Optional[float] = None,
                   _resume=None, **kwargs) -> DeploymentResponseGenerator:
        return self._handle._submit_stream(
            self._method, args, kwargs, item_timeout_s=_item_timeout_s,
            resume=_resume)
