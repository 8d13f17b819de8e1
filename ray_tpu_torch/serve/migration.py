"""Client-side request migration for the serve tier (a copy of
``ray_tpu/serve/migration.py``, which imports no JAX; its counter lives in
``ray_tpu_torch.util.metrics``, in-process).

When a replica dies or its engine fails with a resume descriptor
(``EngineFailedError``) while a handle call or open stream is in flight,
the handle resubmits the request to a healthy replica instead of
surfacing the blip:

- **unary** calls are retried from scratch — per-request deterministic
  sampling keys make the rerun bit-identical, and nothing was delivered
  yet, so scratch is exact;
- **streams** rebuild a resume request from the tokens ALREADY DELIVERED
  client-side (the authoritative tally — never a duplicate, never a
  gap) via a ``resume`` rewriter the stream opener registers here, and
  the engine continues at position ``len(prompt) + len(generated)``.

Both paths are bounded by ``config.serve_request_max_migrations``; an
exhausted budget sheds typed (``RequestMigrationExhaustedError``).
Every successful migration counts into ``serve_request_migrations_total``
(tagged by deployment) and into a process-local tally the router exposes
through its stats.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.util.metrics import Counter

ResumeCall = Tuple[str, tuple, dict]
ResumeFn = Callable[[List[Any]], Optional[ResumeCall]]

_lock = threading.Lock()
_counts: Dict[str, int] = {}
_metrics: Optional[Dict[str, Any]] = None


def _migration_metrics() -> Dict[str, Any]:
    global _metrics
    with _lock:
        if _metrics is None:
            _metrics = {
                "migrations": Counter(
                    "serve_request_migrations_total",
                    "In-flight requests migrated to another replica "
                    "after a replica death, engine failure, or drain.",
                    tag_keys=("deployment",)),
            }
        return _metrics


def note_migration(deployment: str) -> None:
    """Record one successful migration (call AFTER the resubmission to
    the healthy replica was accepted)."""
    _migration_metrics()["migrations"].inc(
        1, {"deployment": deployment or "unknown"})
    with _lock:
        _counts[deployment or "unknown"] = \
            _counts.get(deployment or "unknown", 0) + 1


def migration_stats() -> Dict[str, Any]:
    """Process-local migration tally, exposed via proxy/router stats so
    cross-process consumers (chaos bench) can sum it."""
    with _lock:
        return {
            "request_migrations_total": sum(_counts.values()),
            "request_migrations_by_deployment": dict(_counts),
        }


# ------------------------------------------------------- stream rewriters


def llm_stream_resume(request: Dict[str, Any],
                      method: str = "generate_stream") -> ResumeFn:
    """Resume rewriter for an LLM token-chunk stream (the router's and
    proxy's ``generate_stream`` path). ``delivered`` holds every chunk
    the client already received — cumulative across migrations — so the
    rebuilt request appends the flattened tokens to whatever the
    original request had already resumed from."""
    base = dict(request if isinstance(request, dict) else {})
    if "json" in base and isinstance(base["json"], dict):
        base = dict(base["json"])
    base_generated = [int(t) for t in (base.get("generated") or [])]

    def resume(delivered: List[Any]) -> Optional[ResumeCall]:
        flat: List[int] = []
        for chunk in delivered:
            if isinstance(chunk, (list, tuple)):
                flat.extend(int(t) for t in chunk)
        req = dict(base)
        req["generated"] = base_generated + flat
        return (method, (req,), {})

    return resume


def disagg_decode_resume(handoff: Dict[str, Any]) -> Optional[ResumeFn]:
    """Resume rewriter for a disaggregated decode stream. The dead
    decode replica's adopted KV is gone, but the handoff carries the
    prompt and the prefill-sampled first token: the replacement replica
    re-prefills ``prompt + [first_token] + delivered`` locally via
    ``resume_stream`` — no prefill-pool round trip, no KV handoff.
    Returns None when the handoff carried no prompt (not resumable)."""
    prompt = handoff.get("prompt")
    if not prompt:
        return None
    base = {
        "prompt": [int(t) for t in prompt],
        "n": handoff.get("n"),
        "seed": int(handoff.get("seed") or 0),
    }
    first = [int(handoff["first_token"])]

    def resume(delivered: List[Any]) -> Optional[ResumeCall]:
        flat: List[int] = []
        for chunk in delivered:
            if isinstance(chunk, (list, tuple)):
                flat.extend(int(t) for t in chunk)
        req = dict(base)
        req["generated"] = first + flat
        return ("resume_stream", (req,), {})

    return resume
