"""LLM router deployment and ``build_llm_app`` (port of
``ray_tpu/serve/llm/router.py``).

The router is a thin deployment that owns the pool handles: it sequences
prefill -> KV handoff -> decode in disaggregated mode, or forwards to the
combined pool. The heavy state (weights, KV cache) lives in the pools.

``build_llm_app`` assembles the deployment graph with ``.bind()`` on
``runtime.serve`` — the ``ray_tpu`` module's serve package, or
``LocalRuntime``'s in-process facet — and binds the runtime and the device
as arguments of every replica. Deploy the result with that runtime's
``serve.run``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

from ray_tpu_torch._private.config import config
from ray_tpu_torch.device import DeviceLike
from ray_tpu_torch.exceptions import (
    KVAdoptTimeoutError, RequestMigrationExhaustedError,
)
from ray_tpu_torch.runtime import LocalRuntime
from ray_tpu_torch.serve import migration
from ray_tpu_torch.serve.llm.engine import EngineConfig
from ray_tpu_torch.serve.llm.replicas import (
    DecodeReplica, LLMReplica, PrefillReplica, normalize_request,
)

# Upper bound on one request's end-to-end residence: queueing plus
# generation.
_ROUTER_TIMEOUT_S = 600.0


class _DisaggStream:
    """First-token-then-decode-pool iterator with an EXPLICIT close():
    cancelling the router's stream must cancel the decode pool's stream
    even when the consumer never pulled a chunk."""

    def __init__(self, first_token: int, inner):
        self._first: Optional[List[int]] = [int(first_token)]
        self._inner = inner

    def __iter__(self) -> Iterator[List[int]]:
        return self

    def __next__(self) -> List[int]:
        if self._first is not None:
            out, self._first = self._first, None
            return out
        return next(self._inner)

    def close(self) -> None:
        self._inner.cancel()


class LLMRouter:
    """Sequences one request across the pools. Mode is implied by which
    handles were bound: (prefill, decode) or a single combined pool."""

    def __init__(self, prefill=None, decode=None, llm=None,
                 runtime: Any = None):
        if llm is None and (prefill is None or decode is None):
            raise ValueError(
                "LLMRouter needs either llm= (combined) or both "
                "prefill= and decode= handles")
        self._prefill = prefill
        self._decode = decode
        self._llm = llm
        self._runtime = runtime

    def _re_prefill(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Re-run prefill on a (fresh pick of a) healthy prefill replica
        after the original handoff became unresolvable. Deterministic in
        (prompt, seed): the new handoff carries the SAME first token and
        identical KV, so retrying decode with it is bit-identical."""
        migration.note_migration(self._prefill.deployment_name)
        return self._prefill.prefill.remote(req).result(
            timeout=_ROUTER_TIMEOUT_S)

    def _open_decode(self, req, handoff, open_fn):
        """``open_fn(handoff)``, re-prefilling on ``KVAdoptTimeoutError``
        up to ``serve_request_max_migrations`` times."""
        limit = max(0, int(config.serve_request_max_migrations))
        attempts = 0
        while True:
            try:
                return handoff, open_fn(handoff)
            except KVAdoptTimeoutError as e:
                # The prefill replica owning the KV refs died before the
                # decode pool adopted them: re-run prefill elsewhere.
                if attempts >= limit:
                    raise RequestMigrationExhaustedError(
                        f"KV handoff unresolvable after {attempts} "
                        f"re-prefills (serve_request_max_migrations="
                        f"{limit})", migrations=attempts) from e
                attempts += 1
                handoff = self._re_prefill(req)

    def __call__(self, request: Any) -> Dict[str, Any]:
        req = normalize_request(request)
        if self._llm is not None:
            return self._llm.remote(req).result(timeout=_ROUTER_TIMEOUT_S)
        handoff = self._prefill.prefill.remote(req).result(
            timeout=_ROUTER_TIMEOUT_S)
        if (handoff.get("n") or 2) <= 1:
            return {"tokens": [handoff["first_token"]]}
        handoff, rest = self._open_decode(
            req, handoff, lambda h: self._decode.decode.remote(h).result(
                timeout=_ROUTER_TIMEOUT_S))
        return {"tokens": [handoff["first_token"]] + rest["tokens"]}

    def generate_stream(self, request: Any) -> Iterator[List[int]]:
        """Streaming: yields token chunks. In disaggregated mode the first
        chunk is the prefill pool's token (the TTFT token); the rest stream
        from the decode pool as produced. The prefill call AND the
        decode-stream open run at stream start, not at the first pull, so
        errors reach the caller before any chunk.

        Every inner stream is opened with a migration rewriter: a pool
        replica dying mid-stream re-opens on a healthy replica and
        continues at the next token. A request arriving WITH ``generated``
        is itself a resume: it skips prefill and continues on the decode
        (or combined) pool directly."""
        req = normalize_request(request)
        if self._llm is not None:
            return self._llm.generate_stream.remote_gen(
                req, _resume=migration.llm_stream_resume(req))
        if req["generated"]:
            resume_req = {"prompt": req["prompt"], "n": req["n"],
                          "seed": req["seed"],
                          "generated": req["generated"]}
            return self._decode.resume_stream.remote_gen(
                resume_req, _resume=migration.llm_stream_resume(
                    resume_req, method="resume_stream"))
        handoff = self._prefill.prefill.remote(req).result(
            timeout=_ROUTER_TIMEOUT_S)
        if (handoff.get("n") or 2) <= 1:
            return iter([[handoff["first_token"]]])
        handoff, inner = self._open_decode(
            req, handoff, lambda h: self._decode.decode_stream.remote_gen(
                h, _resume=migration.disagg_decode_resume(h)))
        return _DisaggStream(handoff["first_token"], inner)

    def serve_stats(self) -> Dict[str, Any]:
        """This process's migration tally: the port's own (re-prefills,
        and the in-process runtime's handle migrations) plus the runtime's
        serve handle's, where it keeps one (``ray_tpu.serve.migration``
        counts the migrations of the pool streams this router holds)."""
        out = migration.migration_stats()
        theirs = getattr(getattr(self._runtime, "serve", None),
                         "migration", None)
        if theirs is not None and theirs is not migration:
            other = theirs.migration_stats()
            out["request_migrations_total"] += \
                other["request_migrations_total"]
            by = out["request_migrations_by_deployment"]
            for dep, n in other["request_migrations_by_deployment"].items():
                by[dep] = by.get(dep, 0) + n
        return out

    def check_health(self) -> bool:
        return True


def build_llm_app(engine_config: Optional[Dict[str, Any]] = None, *,
                  runtime: Any = None,
                  device: DeviceLike = None,
                  mode: str = "disaggregated",
                  name: str = "llm",
                  num_router_replicas: int = 1,
                  num_replicas: int = 1,
                  num_prefill_replicas: int = 1,
                  num_decode_replicas: int = 1,
                  autoscaling_config=None,
                  prefill_autoscaling=None,
                  decode_autoscaling=None,
                  max_ongoing_requests: int = 2048,
                  ray_actor_options: Optional[Dict[str, Any]] = None):
    """Build the LLM serving application on ``runtime`` (a new
    ``LocalRuntime`` when None; deploy it with that runtime's
    ``serve.run``). The replicas run on ``device`` (default ``cuda``).

    mode="disaggregated": PrefillReplica and DecodeReplica pools behind
    the router (KV handoff through the runtime's store). mode="combined":
    one continuous-batching pool. Autoscaling configs apply per pool.
    """
    runtime = LocalRuntime() if runtime is None else runtime
    serve = getattr(runtime, "serve", None)
    if serve is None:
        raise RuntimeError(
            "build_llm_app needs runtime.serve; on the ray_tpu runtime, "
            "`import ray_tpu.serve` first (import ray_tpu does not load it)")
    ec_dict = EngineConfig.from_dict(engine_config).to_dict()
    opts = dict(ray_actor_options or {})

    def pool(cls, suffix, replicas, autoscaling):
        return serve.deployment(
            cls, name=f"{name}-{suffix}", num_replicas=replicas,
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=autoscaling,
            ray_actor_options=opts).bind(ec_dict, runtime, device)

    if mode == "combined":
        handles = {"llm": pool(LLMReplica, "engine", num_replicas,
                               autoscaling_config)}
    elif mode == "disaggregated":
        handles = {
            "prefill": pool(PrefillReplica, "prefill", num_prefill_replicas,
                            prefill_autoscaling),
            "decode": pool(DecodeReplica, "decode", num_decode_replicas,
                           decode_autoscaling)}
    else:
        raise ValueError(f"unknown mode {mode!r} "
                         "(want 'disaggregated' or 'combined')")
    return serve.deployment(
        LLMRouter, name=name, num_replicas=num_router_replicas,
        max_ongoing_requests=max_ongoing_requests).bind(
        runtime=runtime, **handles)
