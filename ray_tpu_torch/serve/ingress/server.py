"""Async HTTP/SSE ingress proxy actor on the standard library (the port's
counterpart of ``ray_tpu/serve/ingress/server.py``, which rides aiohttp;
reference: ``serve/_private/http_proxy.py:234`` HTTPProxy / :415
HTTPProxyActor).

The port needs no HTTP package: the server is ``asyncio.start_server``
speaking HTTP/1.1 (``_private/http.py``, shared with the dashboard head)
with keep-alive (``Content-Length`` or chunked request
bodies, ``Expect: 100-continue``; chunked SSE responses). The contract is
the reference's:

- ``POST /v1/completions`` (OpenAI-style) onto an LLM deployment's
  generate/stream path; every other request goes to the deployment whose
  ``route_prefix`` is the longest prefix of its path;
- non-streaming calls run on a DEDICATED bounded thread pool
  (``serve_ingress_executor_threads``) with a per-call deadline;
- ``"stream": true`` completions flow token chunks to the client over
  Server-Sent Events as the engine produces them (``data: {json}``
  frames, ``data: [DONE]`` terminator); a client disconnect cancels the
  replica stream, which cancels the engine request and frees its slot
  and KV blocks;
- every request passes admission control first (concurrency budget,
  per-tenant fairness, watermark shedding; ``ingress/admission.py``).
  Sheds answer ``429``/``503`` with a ``Retry-After`` header;
  handle-queue-full and deadline errors map to ``429``/``503``, never a
  blanket 500. 400 for a body that is not JSON, 404 for no route.

The same status codes, JSON bodies (``json.dumps`` of the reference's
dicts, ``application/json; charset=utf-8``) and SSE frames as the
reference's proxy, and the port's exceptions: a
``RequestMigrationExhaustedError`` from the port's router is a 503.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import json
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private.http import (
    MAX_HEAD, WRITTEN, Request, Response, SSEWriter, json_response,
    serve_connection,
)

_TENANT_DEFAULT = "default"
_EOF_POLL_S = 0.1                # SSE: how often a gone client is noticed


def _ingress_metrics():
    """Process-wide ingress metric instruments (one proxy per process
    in practice; tags keep multi-proxy tests distinct)."""
    from ray_tpu_torch.util import metrics as m

    if not hasattr(_ingress_metrics, "_cache"):
        _ingress_metrics._cache = {
            "inflight": m.Gauge(
                "serve_ingress_inflight",
                "Requests admitted past the ingress front door and not "
                "yet answered (streams count until their last frame).",
                tag_keys=("proxy",)),
            "shed": m.Counter(
                "serve_ingress_shed_total",
                "Requests shed by ingress admission control, by reason "
                "(queue_watermark, queue_timeout, tenant_rate, "
                "downstream_overload).",
                tag_keys=("proxy", "reason")),
            "requests": m.Counter(
                "serve_ingress_requests_total",
                "Requests accepted by the ingress, per tenant.",
                tag_keys=("proxy", "tenant")),
            "latency": m.Histogram(
                "serve_ingress_latency_seconds",
                "End-to-end ingress latency (admission to last byte), "
                "per tenant.",
                tag_keys=("proxy", "tenant")),
        }
    return _ingress_metrics._cache


# ---------------------------------------------------------------- proxy


class HTTPProxy:
    def __init__(self, port: int,
                 system_config: Optional[Dict[str, Any]] = None):
        from ray_tpu_torch._private.config import config

        if system_config:
            # The driver's non-default knobs (shipped via the
            # controller): a worker process does not inherit the
            # driver's config registry, and everything under
            # serve_ingress_* is read HERE.
            config.apply_system_config(system_config)
        self.port = port           # requested; 0 = ephemeral
        self._bound_port: Optional[int] = None
        self._ready = threading.Event()
        # Route table + handles are cached so the data path does not hit
        # the controller per request. Primary freshness source is the
        # PUSH listener below (reference: proxies learn routes via
        # LongPollClient pushes, http_proxy.py:137); the TTL poll is
        # bootstrap + fallback.
        self._routes = {}          # name -> route_prefix
        self._routes_at = 0.0
        self._handles = {}         # name -> DeploymentHandle
        self._route_lock = threading.Lock()
        # The DEDICATED data-plane pool: blocking handle calls and SSE
        # pump loops run here, never on the asyncio default executor. A
        # stream holds one pump thread for its whole life, so the pool
        # covers the admission budget, with the executor_threads knob on
        # top as headroom for the short-lived calls (route resolution,
        # stream opens, non-streaming requests). Threads are created on
        # demand; an idle proxy pays nothing.
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=(config.serve_ingress_max_inflight +
                         config.serve_ingress_executor_threads),
            thread_name_prefix="serve-ingress")
        self._admission = None     # built on the server loop
        self._admitted = 0         # requests past admission (loop only)
        # Tag by a per-instance id, not the REQUESTED port: every
        # per-node proxy is spawned with the same port (and may fall
        # back to an ephemeral one).
        import uuid as _uuid

        self._tags = {"proxy": f"port{port}-{_uuid.uuid4().hex[:6]}"}
        self._m = _ingress_metrics()
        self._start_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._serve_thread,
                                        daemon=True, name="serve-http")
        self._thread.start()
        threading.Thread(target=self._routes_listener, daemon=True,
                         name="serve-routes-longpoll").start()
        # Ingress gauges/counters reach the dashboard /metrics through
        # the process metrics reporter (idempotent per process).
        try:
            from ray_tpu_torch.util import metrics as _metrics

            _metrics.start_reporter(period_s=2.0)
        except Exception:
            pass

    _ROUTES_TTL_S = 1.0
    _LISTEN_MAX_FAILURES = 8

    # ------------------------------------------------------------- routes

    def _routes_listener(self):
        """Long-poll the controller's route-table channel: every proxy
        learns of deploys/deletes within one notify (reference:
        http_state.py pushes route tables to all node proxies)."""
        import ray_tpu_torch
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        version = 0
        failures = 0
        while True:
            try:
                ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
                updates = ray_tpu_torch.get(
                    ctrl.listen_for_change.remote({"routes": version},
                                                  25.0), timeout=35)
            except Exception:
                failures += 1
                if failures >= self._LISTEN_MAX_FAILURES:
                    return   # controller gone (serve.shutdown)
                time.sleep(1.0)
                continue
            failures = 0
            if "routes" in updates:
                version, routes = updates["routes"]
                self._install_routes(routes)

    def _install_routes(self, routes):
        with self._route_lock:
            self._routes = dict(routes)
            self._routes_at = time.time()
            dropped = [h for n, h in self._handles.items()
                       if n not in routes]
            self._handles = {n: h for n, h in self._handles.items()
                             if n in routes}
        for h in dropped:
            # Stop the dropped handle's push listener: the controller is
            # alive, so its bounded-failure exit would never fire.
            try:
                h.stop()
            except Exception:
                pass

    def _route_table(self):
        import ray_tpu_torch
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        now = time.time()
        with self._route_lock:
            if self._routes and now - self._routes_at < self._ROUTES_TTL_S:
                return dict(self._routes)
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        deployments = ray_tpu_torch.get(ctrl.list_deployments.remote(),
                                        timeout=30)
        routes = {name: info["config"].get("route_prefix")
                  for name, info in deployments.items()}
        self._install_routes(routes)
        return dict(routes)

    def _handle_for(self, name: str):
        from ray_tpu_torch.serve.handle import DeploymentHandle

        with self._route_lock:
            h = self._handles.get(name)
            if h is None:
                h = self._handles[name] = DeploymentHandle(name)
        return h

    def _resolve_route(self, path: str) -> Optional[str]:
        """Longest-prefix route match -> deployment name."""
        routes = self._route_table()
        target: Optional[str] = None
        best_len = -1
        for name, prefix in routes.items():
            if prefix and (path == prefix or
                           path.startswith(prefix.rstrip("/") + "/")) \
                    and len(prefix) > best_len:
                target, best_len = name, len(prefix)
        return target

    # ------------------------------------------------------------ lifecycle

    def ready(self) -> bool:
        if not self._ready.wait(timeout=20) or self._bound_port is None:
            raise RuntimeError(
                f"HTTP proxy failed to start: {self._start_error!r}")
        return True

    def bound_port(self) -> int:
        """The actually-bound port (differs from the requested one when
        it was taken — e.g. per-node proxies of a single-host test
        cluster all asking for the same port)."""
        self.ready()
        return self._bound_port

    def ingress_stats(self) -> Dict[str, Any]:
        from ray_tpu_torch.serve.migration import migration_stats

        adm = self._admission
        out = dict(adm.stats()) if adm is not None else {}
        out["admitted_total"] = self._admitted
        # Streams opened BY this proxy migrate in this process.
        out.update(migration_stats())
        return out

    # --------------------------------------------------------------- server

    def _serve_thread(self):
        try:
            asyncio.run(self._serve())
        except BaseException as e:  # noqa: BLE001 (reported by ready())
            self._start_error = e
            self._ready.set()

    async def _serve(self):
        from ray_tpu_torch._private.config import config
        from ray_tpu_torch.serve.ingress.admission import AdmissionController

        self._admission = AdmissionController(
            max_inflight=config.serve_ingress_max_inflight,
            queue_watermark=config.serve_ingress_queue_watermark,
            queue_timeout_s=config.serve_ingress_queue_timeout_s,
            tenant_rate=config.serve_ingress_tenant_rate,
            tenant_burst=config.serve_ingress_tenant_burst,
            metrics=self._m, tags=self._tags)
        self._tenant_header = config.serve_ingress_tenant_header.lower()
        self._request_timeout_s = config.serve_ingress_request_timeout_s
        self._stream_item_timeout_s = \
            config.serve_ingress_stream_item_timeout_s
        on_connection = functools.partial(serve_connection,
                                          handle=self._dispatch)
        try:
            server = await asyncio.start_server(
                on_connection, "127.0.0.1", self.port, limit=MAX_HEAD)
        except OSError:
            # Requested port in use: fall back to an ephemeral port
            # (callers discover it via bound_port()).
            server = await asyncio.start_server(
                on_connection, "127.0.0.1", 0, limit=MAX_HEAD)
        self._bound_port = server.sockets[0].getsockname()[1]
        self._ready.set()
        async with server:
            await server.serve_forever()

    async def _dispatch(self, req: Request, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter):
        if req.method == "POST" and req.path == "/v1/completions":
            return await self._completions(req, reader, writer)
        return await self._handle(req)

    # ------------------------------------------------------------ data path

    def _tenant_of(self, request: Request) -> str:
        return request.headers.get(self._tenant_header) or _TENANT_DEFAULT

    @staticmethod
    def _overload_response(err) -> Response:
        status = getattr(err, "http_status", 429)
        retry = getattr(err, "retry_after_s", 1.0)
        return json_response(
            {"error": {"type": "overloaded", "message": str(err),
                       "retry_after_s": round(retry, 3)}},
            status=status,
            headers={"Retry-After": str(max(1, int(round(retry))))})

    async def _admit(self, request: Request):
        """Run admission; returns (tenant, None) or (tenant, response)."""
        from ray_tpu_torch.exceptions import ServeOverloadedError
        from ray_tpu_torch.util import tracing

        tenant = self._tenant_of(request)
        try:
            await self._admission.acquire(tenant)
        except ServeOverloadedError as e:
            # Shed requests are ALWAYS traced (status != "ok" bypasses
            # head-based span sampling).
            tracing.emit_span(
                f"serve.ingress.shed{request.path}", kind="serve_ingress",
                start=time.time(), status="shed",
                attrs={"tenant": tenant,
                       "reason": getattr(e, "reason", "overloaded")})
            return tenant, self._overload_response(e)
        self._admitted += 1
        self._m["requests"].inc(1, dict(self._tags, tenant=tenant))
        return tenant, None

    async def _call_bounded(self, fn, *args):
        """Run a blocking data-plane call on the dedicated pool with
        the ingress deadline (never the asyncio default executor)."""
        loop = asyncio.get_running_loop()
        return await asyncio.wait_for(
            loop.run_in_executor(self._pool, fn, *args),
            timeout=self._request_timeout_s + 5.0)

    def _classify_error(self, e: BaseException) -> Tuple[int, dict]:
        """(status, payload) for a data-path failure — typed, not a
        blanket 500. ``ServeOverloadedError`` (and with it the router's
        ``RequestMigrationExhaustedError``, ``http_status`` 503) is
        rendered by ``_overload_response`` before this is reached."""
        from ray_tpu_torch.exceptions import (
            GetTimeoutError, RayActorError, ReplicaDrainingError,
            WorkerCrashedError,
        )

        if isinstance(e, ReplicaDrainingError):
            # Raced a rolling restart past the handle's retry budget:
            # retryable, never a 500.
            return 503, {"error": {"type": "draining", "message": str(e)}}
        if isinstance(e, (RayActorError, WorkerCrashedError)):
            # Replica death the migration path could not absorb: the
            # replacement is already spawning — tell the client to retry.
            return 503, {"error": {"type": "replica_unavailable",
                                   "message": str(e)}}
        if isinstance(e, (GetTimeoutError, asyncio.TimeoutError,
                          concurrent.futures.TimeoutError,
                          TimeoutError)):
            return 503, {"error": {"type": "timeout", "message": str(e)}}
        return 500, {"error": {"type": "internal", "message": str(e)}}

    def _error_response(self, e: BaseException) -> Response:
        from ray_tpu_torch.exceptions import ServeOverloadedError

        if isinstance(e, ServeOverloadedError):
            # Downstream backpressure (engine queue full, migration
            # budget spent): 429/503 + Retry-After so clients back off.
            self._m["shed"].inc(1, dict(self._tags,
                                        reason="downstream_overload"))
            return self._overload_response(e)
        status, payload = self._classify_error(e)
        return json_response(payload, status=status)

    async def _handle(self, request: Request) -> Response:
        path = request.path
        payload = {"path": path,
                   "query": dict(request.query),
                   "method": request.method}
        if request.body:
            try:
                payload["json"] = json.loads(request.body)
            except (json.JSONDecodeError, UnicodeDecodeError):
                payload["body"] = request.body

        tenant, shed = await self._admit(request)
        if shed is not None:
            return shed
        t0 = time.monotonic()
        try:
            def route_and_call():
                target = self._resolve_route(path)
                if target is None:
                    return None, 404
                resp = self._handle_for(target).remote(payload)
                return resp.result(
                    timeout=self._request_timeout_s), 200

            try:
                result, code = await self._call_bounded(route_and_call)
            except Exception as e:  # noqa: BLE001
                return self._error_response(e)
            if code == 404:
                return json_response(
                    {"error": f"no deployment routes {path}"}, status=404)
            try:
                return json_response(result)
            except TypeError:
                return Response(200, str(result).encode())
        finally:
            self._admission.release()
            self._m["latency"].observe(time.monotonic() - t0,
                                       dict(self._tags, tenant=tenant))

    # ------------------------------------------------------ /v1/completions

    def _completions_target(self, body: Dict[str, Any]) -> Optional[str]:
        """The deployment serving this completion: the OpenAI-style
        ``model`` field when it names a deployment, else the
        conventional ``llm`` app."""
        routes = self._route_table()
        model = body.get("model")
        if model and model in routes:
            return model
        if "llm" in routes:
            return "llm"
        return None

    async def _completions(self, request: Request,
                           reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        try:
            body = json.loads(request.body)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return json_response(
                {"error": {"type": "bad_request",
                           "message": "body must be JSON"}}, status=400)
        if not isinstance(body, dict) or "prompt" not in body:
            return json_response(
                {"error": {"type": "bad_request",
                           "message": "missing 'prompt' (token id "
                                      "list)"}}, status=400)
        req = {"prompt": body["prompt"],
               "n": body.get("max_tokens"),
               "seed": body.get("seed") or 0}
        stream = bool(body.get("stream"))

        tenant, shed = await self._admit(request)
        if shed is not None:
            return shed
        t0 = time.monotonic()
        try:
            # Route resolution may RPC the controller on a cold cache:
            # keep it off the event loop.
            try:
                target = await self._call_bounded(
                    self._completions_target, body)
            except Exception as e:  # noqa: BLE001
                return self._error_response(e)
            if target is None:
                return json_response(
                    {"error": {"type": "not_found",
                               "message": "no LLM deployment (set "
                                          "'model' or deploy 'llm')"}},
                    status=404)
            handle = self._handle_for(target)
            if not stream:
                def call():
                    return handle.remote(req).result(
                        timeout=self._request_timeout_s)

                try:
                    out = await self._call_bounded(call)
                except Exception as e:  # noqa: BLE001
                    return self._error_response(e)
                return json_response(self._completion_body(
                    target, out.get("tokens") or []))

            # Open the replica stream BEFORE committing a 200: the
            # engine's queue-full/validation errors surface at stream
            # START as a real 429/Retry-After, not an error frame inside
            # a success-status SSE body. The resume rewriter makes a
            # router-replica death mid-SSE invisible: the handle re-opens
            # generate_stream on a healthy replica with ``generated`` =
            # every token already delivered.
            from ray_tpu_torch.serve.migration import llm_stream_resume

            def start_stream():
                return handle.generate_stream.remote_gen(
                    req, _item_timeout_s=self._stream_item_timeout_s,
                    _resume=llm_stream_resume(req))

            loop = asyncio.get_running_loop()
            inner = loop.run_in_executor(self._pool, start_stream)

            def _reap_abandoned(f):
                # The handler went away while the stream was still
                # opening: cancel it the moment it exists so the engine
                # doesn't decode a full budget for nobody.
                if not f.cancelled() and f.exception() is None:
                    try:
                        # raylint: disable-next=unbounded-wait (done
                        # callback: f has already completed, result()
                        # cannot block)
                        f.result().cancel()
                    except Exception:
                        pass

            try:
                gen = await asyncio.wait_for(
                    asyncio.shield(inner),
                    timeout=self._request_timeout_s + 5.0)
            except asyncio.CancelledError:
                inner.add_done_callback(_reap_abandoned)
                raise
            except asyncio.TimeoutError as e:
                inner.add_done_callback(_reap_abandoned)
                return self._error_response(e)
            except Exception as e:  # noqa: BLE001
                return self._error_response(e)
            await self._stream_completions(request, reader, writer, gen,
                                           target)
            return WRITTEN
        finally:
            self._admission.release()
            self._m["latency"].observe(time.monotonic() - t0,
                                       dict(self._tags, tenant=tenant))

    @staticmethod
    def _completion_body(model: str, tokens, finished: bool = True):
        return {"object": "text_completion", "model": model,
                "choices": [{"index": 0, "tokens": list(tokens),
                             "finish_reason": "stop" if finished
                             else None}],
                "usage": {"completion_tokens": len(tokens)}}

    async def _stream_completions(self, request: Request,
                                  reader: asyncio.StreamReader,
                                  writer: asyncio.StreamWriter, gen,
                                  target: str) -> None:
        """SSE: one ``data: {"tokens": [...]}`` frame per engine chunk,
        ``data: [DONE]`` terminator. ``gen`` is the already-opened
        replica stream. The blocking pump runs on the dedicated pool and
        feeds the response through a queue. A client that goes away (its
        end of the socket reads EOF, or a write fails) stops the pump and
        CANCELS the replica stream: the engine request's slot and KV
        blocks free instead of decoding to budget for a dead socket."""
        loop = asyncio.get_running_loop()
        out_q: asyncio.Queue = asyncio.Queue()
        stop = threading.Event()

        def pump():
            try:
                for chunk in gen:
                    if stop.is_set():
                        gen.cancel()
                        return
                    loop.call_soon_threadsafe(
                        out_q.put_nowait, ("chunk", chunk))
                loop.call_soon_threadsafe(out_q.put_nowait, ("done", None))
            except BaseException as e:  # noqa: BLE001
                try:
                    loop.call_soon_threadsafe(
                        out_q.put_nowait, ("error", e))
                except RuntimeError:
                    pass   # loop closed during shutdown

        resp = SSEWriter(writer, request.version, request.keep_alive)
        pump_fut = self._pool.submit(pump)
        item_timeout = self._stream_item_timeout_s + 10.0
        try:
            await resp.prepare()
            deadline = time.monotonic() + item_timeout
            while True:
                try:
                    kind, item = await asyncio.wait_for(
                        out_q.get(), timeout=_EOF_POLL_S)
                except asyncio.TimeoutError:
                    if reader.at_eof():
                        raise ConnectionResetError("client went away")
                    if time.monotonic() >= deadline:
                        raise
                    continue
                deadline = time.monotonic() + item_timeout
                if kind == "chunk":
                    frame = json.dumps(
                        {"model": target,
                         "choices": [{"index": 0,
                                      "tokens": list(item)}]})
                    await resp.write(f"data: {frame}\n\n".encode())
                elif kind == "done":
                    await resp.write(b"data: [DONE]\n\n")
                    break
                else:   # error from the replica stream
                    self._cancel_stream(stop, gen)
                    err_frame = json.dumps(
                        {"error": {"type": "stream_error",
                                   "message": str(item)}})
                    await resp.write(f"data: {err_frame}\n\n".encode())
                    break
            await resp.write_eof()
        except asyncio.CancelledError:
            self._cancel_stream(stop, gen)
            raise
        except (ConnectionError, asyncio.TimeoutError):
            # The client went away (or the stream wedged): cancel the
            # replica side and end the connection.
            self._cancel_stream(stop, gen)
            raise ConnectionResetError("stream ended early") from None
        finally:
            stop.set()
            pump_fut.cancel()

    @staticmethod
    def _cancel_stream(stop: threading.Event, gen) -> None:
        stop.set()
        try:
            gen.cancel()
        except Exception:
            pass
