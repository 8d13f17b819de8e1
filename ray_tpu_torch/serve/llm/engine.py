"""Continuous (in-flight) batching engine for LLM serving (port of
``ray_tpu/serve/llm/engine.py``).

The engine owns one fixed-shape slotted batch (``models/generate.py``'s
slotted functions ``prefill_slot`` / ``adopt_slot`` / ``decode_step``, or
with ``paged_kv`` the paged pool and chunked prefill) and a background
scheduler thread that, between decode steps, admits queued requests into
free slots and retires finished sequences. A request's tokens never depend
on which other requests share the batch (per-request ``fold_in`` sampling
keys — the isolation contract).

Two admission kinds feed the same batch:

- ``submit``            — a raw prompt; the engine prefills it locally;
- ``submit_prefilled``  — a KV block prefilled elsewhere, spliced into a
                          slot by ``adopt_slot`` / ``adopt_slot_paged``.

Consumers poll ``drain`` (bounded waits — one request), ``collect``
(non-blocking, many requests per call), or iterate ``stream`` (a generator
of token chunks).

The port keeps every method and contract of the reference: paged KV with
block-0 scratch, chunked prefill, the prefix cache, preemption by
recompute, cancel, poison with resume descriptors, and the
``step_error`` / ``die`` fault injection of ``EngineConfig.fault_inject``,
with the global ``serve_fault_inject`` knob (the port's own copy,
``ray_tpu_torch/_private/config.py``) for engines built without one.
``EngineConfig`` also carries the prefill micro-batching fields
(``prefill_batch_size``, ``prefill_batch_window_ms``) that
``replicas.PrefillReplica`` reads. Device work runs on the engine's device
(default ``cuda``; pass ``device="cpu"`` for the CPU), in the scheduler
thread, without autograd. Left out with the runtime it belongs to: the
export of the metrics (``serve_llm_*``, kept in-process by
``ray_tpu_torch.util.metrics``) to the dashboard. ``_build_model`` is the
one ``replicas.py`` delegates to.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.config import config
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.exceptions import (
    EngineFailedError, KVCacheExhaustedError, ServeOverloadedError,
)
from ray_tpu_torch.models import generate as gen
from ray_tpu_torch.models.transformer import GPTConfig, init_params
from ray_tpu_torch.serve.llm.paged import BlockPool
from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

_IDLE_WAIT_S = 0.02       # scheduler nap when no slot is active
_DRAIN_TICK_S = 0.25      # drain() wakes at least this often to re-check
_STOP_JOIN_S = 5.0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs of one engine (one replica). ``model_overrides`` is applied
    on top of the ``GPTConfig`` preset — serving wants smaller/faster
    variants of the training presets (fewer layers on the CPU test
    platform, bf16 on the card)."""

    preset: str = "llama-tiny"
    model_overrides: Tuple[Tuple[str, Any], ...] = ()
    max_slots: int = 8
    max_len: int = 256
    prompt_buckets: Tuple[int, ...] = (16, 32, 64, 128)
    max_new_tokens: int = 64          # default + hard cap per request
    temperature: float = 0.0
    top_k: int = 0
    param_seed: int = 0
    max_queue: int = 4096             # admission backpressure
    # --- paged KV (block-granular cache; see models/generate.py) ------
    paged_kv: bool = False            # block pool instead of per-slot
    #                                   max_len reservations
    kv_block_size: int = 16           # tokens per KV block
    kv_num_blocks: int = 0            # 0 = parity with the reserved
    #                                   layout: slots*ceil(max_len/bs)+1
    prefill_chunk: int = 32           # chunked-prefill chunk length
    max_kv_bytes: int = 0             # 0 = unlimited; else engine init
    #                                   refuses a KV allocation above it
    prefix_cache_enabled: bool = False  # share full-prompt-prefix KV
    #                                   blocks across requests (paged
    #                                   only; see serve/llm/paged.py)
    # --- prefill micro-batching (PrefillReplica) ----------------------
    prefill_batch_size: int = 1       # 1 = one prompt per program call
    prefill_batch_window_ms: float = 2.0
    # --- deterministic fault injection (tests / chaos bench) ----------
    fault_inject: str = ""            # "" = config.serve_fault_inject;
    #                                   "step_error:after=N" |
    #                                   "die:after_tokens=N"

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "EngineConfig":
        if d is None:
            return EngineConfig()
        if isinstance(d, EngineConfig):
            return d
        d = dict(d)
        if isinstance(d.get("model_overrides"), dict):
            d["model_overrides"] = tuple(sorted(
                d["model_overrides"].items()))
        for k in ("prompt_buckets",):
            if isinstance(d.get(k), list):
                d[k] = tuple(d[k])
        return EngineConfig(**d)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["model_overrides"] = dict(self.model_overrides)
        d["prompt_buckets"] = list(self.prompt_buckets)
        return d

    def gpt_config(self) -> GPTConfig:
        """The port's ``GPTConfig``; a dtype override given by name
        ("float32", "bfloat16") becomes the torch dtype."""
        overrides = dict(self.model_overrides)
        if "dtype" in overrides and isinstance(overrides["dtype"], str):
            overrides["dtype"] = getattr(torch, overrides["dtype"])
        return GPTConfig.preset(self.preset, **overrides)

    def kv_bytes_per_token(self, cfg=None) -> int:
        """Bytes of K+V cache one token of one sequence occupies."""
        cfg = cfg or self.gpt_config()
        return int(2 * cfg.n_layers * cfg.n_heads * cfg.head_dim *
                   cfg.dtype.itemsize)

    def kv_pool_blocks(self) -> int:
        """Paged pool size in blocks (scratch block 0 included):
        explicit ``kv_num_blocks`` or reserved-layout parity."""
        per_slot = -(-self.max_len // self.kv_block_size)
        return self.kv_num_blocks or (self.max_slots * per_slot + 1)


# ------------------------------------------------------------------ metrics

_metrics_lock = threading.Lock()
_metrics: Optional[Dict[str, Any]] = None


def engine_metrics() -> Dict[str, Any]:
    """Process-wide engine metric instruments (created once; several
    engines in one process share them, distinguished by tags)."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            tags = ("deployment", "replica")
            _metrics = {
                "queue_depth": Gauge(
                    "serve_llm_queue_depth",
                    "Requests admitted but not yet holding a batch slot.",
                    tag_keys=tags),
                "batch_occupancy": Gauge(
                    "serve_llm_batch_occupancy",
                    "Fraction of decode slots holding a live request.",
                    tag_keys=tags),
                "ttft": Histogram(
                    "serve_llm_ttft_seconds",
                    "Submit-to-first-token latency inside the engine.",
                    tag_keys=tags),
                "tokens": Counter(
                    "serve_llm_tokens_total",
                    "Tokens produced by the in-flight batching engine.",
                    tag_keys=tags),
                "kv_occupancy": Gauge(
                    "serve_llm_kv_block_occupancy",
                    "Fraction of the paged KV block pool in use.",
                    tag_keys=tags),
                "preempts": Counter(
                    "serve_llm_kv_preempts_total",
                    "Sequences preempted (recompute-resumed) because "
                    "the KV block pool could not grow them.",
                    tag_keys=tags),
                "prefix_hit_tokens": Counter(
                    "serve_llm_prefix_cache_hit_tokens_total",
                    "Prompt tokens served from shared prefix-cache "
                    "blocks instead of being re-prefilled.",
                    tag_keys=tags),
                "prefix_lookup_tokens": Counter(
                    "serve_llm_prefix_cache_lookup_tokens_total",
                    "Prompt tokens presented to the prefix-cache chain "
                    "lookup (the hit-rate denominator).",
                    tag_keys=tags),
                "kv_shared_blocks": Gauge(
                    "serve_llm_kv_shared_blocks",
                    "KV blocks currently referenced by more than one "
                    "sequence (live prefix sharing).",
                    tag_keys=tags),
            }
        return _metrics


def _parse_fault_inject(spec: str) -> Optional[Dict[str, Any]]:
    """Parse a fault-injection spec: ``action:key=int[,key=int]``.
    Unknown actions raise at engine init — a typo must not silently
    disable chaos coverage. Each spec fires at most once."""
    spec = (spec or "").strip()
    if not spec:
        return None
    action, _, rest = spec.partition(":")
    action = action.strip()
    if action not in ("step_error", "die"):
        raise ValueError(
            f"unknown serve_fault_inject action {action!r} "
            "(expected 'step_error' or 'die')")
    out: Dict[str, Any] = {"action": action, "fired": False, "count": 0}
    for part in (p.strip() for p in rest.split(",")):
        if not part:
            continue
        k, _, v = part.partition("=")
        out[k.strip()] = int(v)
    return out


class _Request:
    __slots__ = ("id", "kind", "prompt", "budget", "seed", "kv",
                 "first_token", "true_len", "tokens", "cursor", "done",
                 "error", "t_submit", "t_first", "truncated",
                 "cancelled", "produced", "resume_tokens")

    def __init__(self, kind: str, *, prompt=None, budget: int = 0,
                 seed: int = 0, kv=None, first_token: Optional[int] = None,
                 true_len: int = 0):
        self.id = uuid.uuid4().hex[:12]
        self.kind = kind                  # "prompt" | "prefilled"
        self.prompt = prompt
        self.budget = budget              # total new tokens wanted
        self.seed = seed
        self.kv = kv                      # prefilled: {"k","v"} arrays
        self.first_token = first_token
        self.true_len = true_len          # prompt length (prefilled kind)
        self.tokens: List[int] = []       # produced, pending consumption
        self.cursor = 0
        self.done = False
        self.error: Optional[BaseException] = None
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.truncated = False
        self.cancelled = False            # consumer went away
        self.produced = 0                 # generated tokens (incl. the
        #                                   prefill-pool token for the
        #                                   prefilled kind)
        self.resume_tokens: Optional[List[int]] = None  # preempted: the
        #                                   full sequence to re-prefill

    def full_sequence(self) -> List[int]:
        """prompt + every generated token — what a preempted request
        re-prefills to resume exactly where it left off (sampling is
        deterministic in (seed, position), so recompute-resume emits
        the same continuation the uninterrupted run would have)."""
        seq = list(self.prompt or [])
        if self.kind == "prefilled" and self.first_token is not None:
            seq.append(self.first_token)
        return seq + list(self.tokens)


class InflightBatchEngine:
    """One slotted batch + its scheduler thread. Thread-safe: any thread
    may submit/drain/collect; the scheduler thread owns the device state
    and is the only one running device work.

    ``params`` are the model's (``init_params`` or converted); the engine
    keeps ``generate.serving_params`` of them on ``device`` (default
    ``cuda``), the block weights cast to ``cfg.dtype`` once."""

    def __init__(self, params, cfg, engine_cfg: EngineConfig,
                 *, deployment: str = "llm", replica_id: str = "local",
                 device: DeviceLike = None):
        self._device = resolve_device(device)
        self._cfg = cfg
        self._ec = engine_cfg
        if engine_cfg.max_len > cfg.max_seq:
            raise ValueError(
                f"max_len {engine_cfg.max_len} > model max_seq "
                f"{cfg.max_seq}")

        B = engine_cfg.max_slots
        per_tok = engine_cfg.kv_bytes_per_token(cfg)
        if engine_cfg.paged_kv:
            bs = engine_cfg.kv_block_size
            self._slot_blocks_max = -(-engine_cfg.max_len // bs)
            nb = engine_cfg.kv_pool_blocks()
            self._check_kv_budget(nb * bs * per_tok, "paged KV pool")
            self._pool = BlockPool(
                nb, bs, prefix_cache=engine_cfg.prefix_cache_enabled)
            self._cache = gen.init_paged_pool(
                cfg, nb, bs, B, self._slot_blocks_max, device=self._device)
            # Host mirrors of the device block tables / lengths; pushed
            # to the device cache when dirty (scheduler thread only).
            self._bt = np.zeros((B, self._slot_blocks_max), np.int32)
            self._lengths = np.zeros((B,), np.int32)
            self._blocks: List[List[int]] = [[] for _ in range(B)]
            self._bt_dirty = False
            # Chunked-prefill queue: dicts {"slot","req","tokens","done"}
            # processed one chunk per scheduler pass, interleaved with
            # decode steps (long prompts never stall the decode batch).
            self._prefill_q: List[Dict[str, Any]] = []
        else:
            self._pool = None
            self._check_kv_budget(B * engine_cfg.max_len * per_tok,
                                  "reserved (max_len-per-slot) KV cache")
            self._cache = gen.init_slotted_cache(
                cfg, B, engine_cfg.max_len, device=self._device)
        self._params = gen.serving_params(params, cfg, self._device)
        self._slot_req: List[Optional[_Request]] = [None] * B
        self._last_tokens = np.zeros((B,), np.int32)
        self._active = np.zeros((B,), bool)
        self._seeds = np.zeros((B,), np.int32)
        self._produced = np.zeros((B,), np.int64)  # tokens emitted per slot

        self._cv = threading.Condition()
        self._pending: collections.deque = collections.deque()
        self._requests: Dict[str, _Request] = {}
        self._stopped = False
        self._steps = 0
        # Deterministic fault injection: the per-engine knob wins (it is
        # how the spec reaches replica processes, which do not inherit
        # their caller's config); the global knob covers same-process
        # engines.
        self._fault = _parse_fault_inject(
            engine_cfg.fault_inject or str(config.serve_fault_inject or ""))
        # Prefix-cache accounting (scheduler thread writes; stats()
        # readers tolerate a torn int read).
        self._prefix_hit_tokens = 0
        self._prefix_lookup_tokens = 0
        self._prefill_tokens_computed = 0

        self._tags = {"deployment": deployment, "replica": replica_id}
        self._m = engine_metrics()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"llm-engine-{deployment}-{replica_id}")
        self._thread.start()

    def _check_kv_budget(self, need_bytes: int, what: str) -> None:
        """Refuse a KV allocation above ``max_kv_bytes`` at INIT — a
        typed failure before the engine OOMs the device. This is the
        boundary the open-loop bench's long-context case exercises: the
        reserved layout needs ``slots x max_len`` rows up front and
        trips it, the paged pool sized for actual live tokens fits."""
        budget = self._ec.max_kv_bytes
        if budget and need_bytes > budget:
            raise KVCacheExhaustedError(
                f"{what} needs {need_bytes} bytes "
                f"(> max_kv_bytes {budget}): "
                f"{self._ec.max_slots} slots x max_len "
                f"{self._ec.max_len}")

    # ----------------------------------------------------------- admission

    def _bucket_for(self, n: int) -> int:
        for b in sorted(self._ec.prompt_buckets):
            if n <= b:
                return b
        raise ValueError(
            f"prompt length {n} exceeds the largest prompt bucket "
            f"{max(self._ec.prompt_buckets)}")

    def _check_budget(self, prompt_len: int,
                      max_new_tokens: Optional[int]) -> int:
        budget = min(max_new_tokens or self._ec.max_new_tokens,
                     self._ec.max_new_tokens)
        if budget < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt_len + budget > self._ec.max_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({budget}) "
                f"exceeds engine max_len {self._ec.max_len}")
        return budget

    def _enqueue(self, req: _Request) -> str:
        with self._cv:
            if self._stopped:
                raise RuntimeError("engine is stopped")
            if len(self._pending) >= self._ec.max_queue:
                raise ServeOverloadedError(
                    f"engine queue full ({self._ec.max_queue})",
                    retry_after_s=1.0, reason="engine_queue_full")
            self._pending.append(req)
            self._requests[req.id] = req
            # Publish INSIDE the lock: gauge updates are then serialized
            # with stop()'s zeroing, so a racing submit can never
            # overwrite the final gauge after shutdown.
            self._m["queue_depth"].set(len(self._pending), self._tags)
            self._cv.notify_all()
        return req.id

    def _check_pool_fit(self, total_tokens: int) -> None:
        """Paged admission sanity: a sequence whose prompt + budget can
        NEVER fit the block pool fails typed at submit instead of
        parking in the queue forever."""
        if self._pool is not None and not self._pool.can_fit(
                total_tokens):
            raise KVCacheExhaustedError(
                f"sequence of {total_tokens} tokens needs "
                f"{self._pool.blocks_for(total_tokens)} KV blocks but "
                f"the pool only has {self._pool.capacity}")

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               seed: int = 0,
               generated: Optional[Sequence[int]] = None) -> str:
        """Queue a raw prompt; returns a request id for drain/collect.

        ``generated`` resumes a migrated request: the tokens another
        engine already produced (and the caller already delivered).
        The engine re-prefills ``prompt + generated`` and continues at
        position ``len(prompt) + len(generated)`` — per-request
        ``fold_in(seed, position)`` sampling keys make the continuation
        bit-identical to the uninterrupted run (the recompute-preemption
        invariant), and the resumed tokens are never re-delivered
        (``drain``/``collect``/``stream`` start past them)."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        generated = [int(t) for t in generated] if generated else []
        if self._pool is None:
            # The (re-)prefilled sequence must fit a bucket.
            self._bucket_for(len(prompt) + len(generated))
        budget = self._check_budget(len(prompt), max_new_tokens)
        if generated and len(generated) >= budget:
            raise ValueError(
                f"resume carries {len(generated)} generated tokens but "
                f"the budget is {budget}: nothing left to generate")
        self._check_pool_fit(len(prompt) + budget)
        req = _Request(
            "prompt", prompt=prompt, budget=budget, seed=int(seed))
        if generated:
            # Preset the produced tokens as already-consumed: they ride
            # full_sequence() (re-prefill, descriptors, preemption)
            # but are invisible to drain/collect/stream.
            req.tokens = generated
            req.cursor = len(generated)
            req.produced = len(generated)
            req.resume_tokens = prompt + generated
        return self._enqueue(req)

    def submit_prefilled(self, first_token: int, kv: Dict[str, Any],
                         true_len: int,
                         max_new_tokens: Optional[int] = None,
                         seed: int = 0,
                         prompt: Optional[Sequence[int]] = None) -> str:
        """Queue a sequence prefilled elsewhere (disaggregated decode
        pool). ``kv`` holds the bucket-sized K/V blocks ({"k","v"},
        tensors or host arrays);
        ``first_token`` was sampled by the prefill pool and is NOT
        re-emitted here — the engine produces tokens 2..budget.
        ``prompt`` (the raw token ids, optional) enables
        recompute-resume if the paged pool preempts this sequence."""
        budget = self._check_budget(int(true_len), max_new_tokens)
        self._check_pool_fit(int(true_len) + budget)
        return self._enqueue(_Request(
            "prefilled", kv=kv, first_token=int(first_token),
            prompt=[int(t) for t in prompt] if prompt else None,
            true_len=int(true_len), budget=budget, seed=int(seed)))

    def cancel(self, req_id: str) -> bool:
        """Abandon a request (its consumer went away — e.g. an SSE
        client disconnected): it is forgotten immediately; the
        scheduler thread retires its slot and frees its KV blocks at
        the next pass boundary. Returns whether the id was live."""
        with self._cv:
            req = self._requests.pop(req_id, None)
            if req is None:
                return False
            req.cancelled = True
            try:
                self._pending.remove(req)
                self._m["queue_depth"].set(len(self._pending),
                                           self._tags)
            except ValueError:
                pass               # already holds a slot (or prefilling)
            self._cv.notify_all()
        return True

    # ----------------------------------------------------------- consumers

    def drain(self, req_id: str, max_wait_s: float = 0.5
              ) -> Dict[str, Any]:
        """Pop the tokens produced since the last drain. Waits (bounded
        by ``max_wait_s``) until at least one token or completion is
        available; ``done`` rides the response that delivers the final
        token, after which the request is forgotten."""
        deadline = time.monotonic() + max(0.0, max_wait_s)
        with self._cv:
            while True:
                req = self._requests.get(req_id)
                if req is None:
                    raise KeyError(f"unknown request {req_id!r}")
                if req.error is not None:
                    del self._requests[req_id]
                    raise req.error
                if req.cursor < len(req.tokens) or req.done:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(min(remaining, _DRAIN_TICK_S))
            out = req.tokens[req.cursor:]
            req.cursor = len(req.tokens)
            done = req.done and req.cursor == len(req.tokens)
            if done:
                del self._requests[req_id]
        return {"tokens": out, "done": done}

    def collect(self, req_ids: Sequence[str]) -> Dict[str, Dict[str, Any]]:
        """Non-blocking batched drain: one call serves many sessions
        (the closed-loop load generator's path — RPC count scales with
        poll rate, not with session count). Unknown ids report
        ``{"error": "unknown"}`` (e.g. drained-to-done earlier)."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._cv:
            for rid in req_ids:
                req = self._requests.get(rid)
                if req is None:
                    out[rid] = {"tokens": [], "done": True,
                                "error": "unknown"}
                    continue
                if req.error is not None:
                    out[rid] = {"tokens": [], "done": True,
                                "error": repr(req.error)}
                    del self._requests[rid]
                    continue
                toks = req.tokens[req.cursor:]
                req.cursor = len(req.tokens)
                done = req.done and req.cursor == len(req.tokens)
                if done:
                    del self._requests[rid]
                out[rid] = {"tokens": toks, "done": done}
        return out

    def stream(self, req_id: str,
               max_wait_s: float = 1.0) -> Iterator[List[int]]:
        """Generator of token CHUNKS for one request: each item is
        whatever accumulated since the last pull (>= 1 token, except
        possibly the final empty completion). An abandoned stream
        (``close()`` / consumer error) CANCELS the request — the slot
        and its KV blocks free instead of decoding out the budget."""
        try:
            while True:
                out = self.drain(req_id, max_wait_s=max_wait_s)
                if out["tokens"]:
                    yield out["tokens"]
                if out["done"]:
                    return
        finally:
            # No-op when the request already drained to done/error.
            self.cancel(req_id)

    def generate(self, prompt: Sequence[int],
                 max_new_tokens: Optional[int] = None,
                 seed: int = 0,
                 generated: Optional[Sequence[int]] = None) -> List[int]:
        """Blocking convenience: submit + drain to completion."""
        rid = self.submit(prompt, max_new_tokens, seed,
                          generated=generated)
        return list(itertools.chain.from_iterable(self.stream(rid)))

    # --------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            queue = len(self._pending)
            busy = int(self._active.sum())
            prefilling = len(self._prefill_q) if self._pool is not None \
                else 0
            pool_stats = dict(self._pool.stats()) \
                if self._pool is not None else {}
        out = {
            "queue_depth": queue,
            "busy_slots": busy,
            "prefilling": prefilling,
            "max_slots": self._ec.max_slots,
            "batch_occupancy": busy / self._ec.max_slots,
            "autoscale_load": queue + busy + prefilling,
            "steps": self._steps,
            "paged_kv": self._pool is not None,
        }
        out.update(pool_stats)
        if self._pool is not None:
            out["prefix_cache_enabled"] = self._pool.prefix_cache
            out["prefix_cache_hit_tokens"] = self._prefix_hit_tokens
            out["prefix_cache_lookup_tokens"] = \
                self._prefix_lookup_tokens
            out["prefill_tokens_computed"] = \
                self._prefill_tokens_computed
        return out

    # ------------------------------------------------- resume descriptors

    @staticmethod
    def _descriptor(req: _Request) -> Dict[str, Any]:
        """Durable resume descriptor of one in-flight request: enough to
        resubmit it to any healthy engine and continue bit-identically
        at position ``len(prompt) + len(generated)``."""
        prompt = [int(t) for t in (req.prompt or [])]
        generated: List[int] = []
        if req.kind == "prefilled" and req.first_token is not None:
            generated.append(int(req.first_token))
        generated += [int(t) for t in req.tokens]
        return {
            "req_id": req.id,
            "prompt": prompt,
            "generated": generated,
            "seed": int(req.seed),
            "position": len(prompt) + len(generated),
            "max_tokens": int(req.budget),
            "delivered": int(req.cursor),
        }

    def _resume_error_locked(self, req: _Request, cause: BaseException,
                             reason: str) -> BaseException:
        """The typed, descriptor-carrying error an in-flight request
        gets on engine failure/stop — durable and migratable, not
        terminal. A prefilled handoff that carried no prompt cannot be
        recomputed; it keeps the raw cause."""
        if req.prompt is None:
            return cause
        return EngineFailedError(
            f"engine {reason} with request {req.id} in flight "
            f"({cause!r}); resume descriptor attached",
            descriptor=self._descriptor(req), reason=reason)

    def dump_inflight(self) -> List[Dict[str, Any]]:
        """Resume descriptors of every live, recomputable request —
        queued, prefilling, or decoding — plus those already holding an
        unconsumed descriptor-carrying error. The drain/observability
        view of what a dying replica would owe its callers."""
        out: List[Dict[str, Any]] = []
        with self._cv:
            for req in self._requests.values():
                if req.done or req.cancelled or req.prompt is None:
                    continue
                if req.error is not None and \
                        not isinstance(req.error, EngineFailedError):
                    continue
                out.append(self._descriptor(req))
        return out

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            for req in self._requests.values():
                if not req.done and req.error is None:
                    req.error = self._resume_error_locked(
                        req, RuntimeError("engine stopped"),
                        "engine_stopped")
            self._cv.notify_all()
        self._thread.join(timeout=_STOP_JOIN_S)
        # Zero the gauges AFTER the scheduler thread exits (an
        # in-flight pass republishes occupancy as it retires slots) and
        # under the same lock every publisher holds: a racing submit
        # either published before stop() took the lock (overwritten
        # here) or sees _stopped and raises — the final exported state
        # is deterministically zero.
        with self._cv:
            self._m["queue_depth"].set(0, self._tags)
            self._m["batch_occupancy"].set(0, self._tags)
            if self._pool is not None:
                self._m["kv_occupancy"].set(0, self._tags)
                self._m["kv_shared_blocks"].set(0, self._tags)

    # ------------------------------------------------------ fault injection

    def _fault_step_tick(self) -> None:
        """``step_error:after=N``: the Nth decode step with live work
        raises — exercising ``_poison`` and the descriptor-carrying
        migration path deterministically. Fires once."""
        f = self._fault
        if f is None or f["fired"] or f["action"] != "step_error":
            return
        f["count"] += 1
        if f["count"] >= f.get("after", 1):
            f["fired"] = True
            raise RuntimeError(
                f"fault injection: step_error at decode step "
                f"{f['count']}")

    def _fault_token_tick(self, emitted: int) -> None:
        """``die:after_tokens=N``: hard-exit the process once N tokens
        have been emitted — a deterministic SIGKILL stand-in exercising
        the ActorDiedError migration path."""
        f = self._fault
        if f is None or f["fired"] or f["action"] != "die":
            return
        f["count"] += emitted
        if f["count"] >= f.get("after_tokens", 1):
            f["fired"] = True
            os._exit(1)

    # ----------------------------------------------------------- scheduler

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _to_device(self, arr) -> torch.Tensor:
        """A copy of a host array (or tensor) on the engine's device;
        integer arrays become int64, the port's index dtype."""
        t = torch.as_tensor(arr)
        if not (t.is_floating_point() or t.dtype == torch.bool):
            t = t.to(torch.int64)
        return t.to(self._device, copy=True)

    def _loop(self) -> None:
        device = torch.cuda.device(self._device) \
            if self._device.type == "cuda" else contextlib.nullcontext()
        with device, torch.no_grad():
            self._run()

    def _run(self) -> None:
        paged = self._pool is not None
        while True:
            with self._cv:
                if self._stopped:
                    return
            try:
                self._reap_cancelled()
                if paged:
                    progress = self._admit_paged()
                    progress = self._prefill_tick() or progress
                else:
                    progress = self._admit()
                progress = self._step() or progress
            except Exception as e:  # device/runtime failure: fail loud,
                self._poison(e)     # per-request, not a silent wedge
                continue
            if not progress:
                with self._cv:
                    if not self._stopped:
                        self._cv.wait(_IDLE_WAIT_S)

    def _poison(self, err: BaseException) -> None:
        """A scheduler-side failure fails every in-flight request
        instead of wedging the loop — but not terminally: each
        recomputable request's error is an ``EngineFailedError``
        carrying its resume descriptor, so the serve handle migrates it
        to a healthy replica and the client never sees the blip."""
        with self._cv:
            for req in list(self._requests.values()):
                if not req.done and req.error is None:
                    req.error = self._resume_error_locked(
                        req, err, "step_failure")
            self._pending.clear()
            self._m["queue_depth"].set(0, self._tags)
            for i in range(len(self._slot_req)):
                self._slot_req[i] = None
                if self._pool is not None:
                    self._free_slot_blocks(i)
            if self._pool is not None:
                self._prefill_q.clear()
            self._active[:] = False
            self._publish_occupancy_locked()
            self._cv.notify_all()

    def _reap_cancelled(self) -> None:
        """Retire slots whose request was cancelled (consumer gone):
        the slot and its KV blocks return to the pool without waiting
        for the budget to run out."""
        with self._cv:
            for slot, req in enumerate(self._slot_req):
                if req is None or not req.cancelled:
                    continue
                self._slot_req[slot] = None
                self._active[slot] = False
                if self._pool is not None:
                    self._prefill_q = [e for e in self._prefill_q
                                       if e["slot"] != slot]
                    self._free_slot_blocks(slot)
            self._publish_occupancy_locked()

    def _admit(self) -> bool:
        """Move queued requests into free slots: prefill (or adopt) and
        splice their KV into the batch cache. Compute runs OUTSIDE the
        lock — only queue/slot bookkeeping is under it."""
        with self._cv:
            free = self._free_slots()
            take: List[Tuple[int, _Request]] = []
            while free and self._pending:
                req = self._pending.popleft()
                if req.cancelled:
                    continue
                take.append((free.pop(0), req))
            if take:
                self._m["queue_depth"].set(len(self._pending), self._tags)
        if not take:
            return False

        for slot, req in take:
            try:
                if req.kind == "prompt":
                    # A resume (migrated request) re-prefills
                    # prompt + generated; the sampled token is then the
                    # continuation at the same counter the uninterrupted
                    # decode would have used.
                    seq = req.resume_tokens \
                        if req.resume_tokens is not None else req.prompt
                    bucket = self._bucket_for(len(seq))
                    padded = np.zeros((1, bucket), np.int64)
                    padded[0, :len(seq)] = seq
                    first, kv = gen.prefill_slot(
                        self._params, self._to_device(padded), len(seq),
                        req.seed, cfg=self._cfg,
                        temperature=self._ec.temperature,
                        top_k=self._ec.top_k)
                    first_token = int(first[0])
                    true_len = len(seq)
                    emit_first = True
                else:
                    kv = {"k": self._to_device(req.kv["k"]),
                          "v": self._to_device(req.kv["v"])}
                    first_token = req.first_token
                    true_len = req.true_len
                    req.kv = None      # drop the handoff reference early
                    emit_first = False
                self._cache = gen.adopt_slot(self._cache, slot, kv, true_len)
            except Exception as e:
                with self._cv:
                    req.error = e
                    self._cv.notify_all()
                continue

            self._last_tokens[slot] = first_token
            self._seeds[slot] = req.seed
            self._active[slot] = True
            req.resume_tokens = None
            req.produced += 1          # the prefill-sampled token
            self._produced[slot] = req.produced
            self._slot_req[slot] = req
            now = time.monotonic()
            with self._cv:
                req.t_first = now
                if emit_first:
                    req.tokens.append(first_token)
                if req.produced >= req.budget:
                    self._retire_slot_locked(slot)
                self._cv.notify_all()
            self._m["ttft"].observe(now - req.t_submit, self._tags)
            if emit_first:
                self._m["tokens"].inc(1, self._tags)
                self._fault_token_tick(1)
        with self._cv:
            self._publish_occupancy_locked()
        return True

    def _retire_slot_locked(self, slot: int) -> None:
        req = self._slot_req[slot]
        if req is not None:
            req.done = True
        self._slot_req[slot] = None
        self._active[slot] = False
        if self._pool is not None:
            self._free_slot_blocks(slot)

    # ------------------------------------------------- paged-KV scheduling

    def _free_slot_blocks(self, slot: int) -> None:
        """Release a slot's blocks back to the pool (a DECREF — shared
        prefix blocks another sequence still reads, or the cache wants
        warm, stay resident) and point its table at the scratch block
        (a stale table must never alias a reassigned block). Called
        with ``_cv`` held or from the scheduler thread."""
        if self._blocks[slot]:
            self._pool.release(self._blocks[slot])
            self._blocks[slot] = []
        self._bt[slot] = 0
        self._lengths[slot] = 0
        self._bt_dirty = True

    def _publish_occupancy_locked(self) -> None:
        self._m["batch_occupancy"].set(
            float(self._active.sum()) / self._ec.max_slots, self._tags)
        if self._pool is not None:
            self._m["kv_occupancy"].set(self._pool.occupancy(),
                                        self._tags)
            self._m["kv_shared_blocks"].set(
                self._pool.shared_blocks(), self._tags)

    def _sync_device_tables(self) -> None:
        """Push the host block-table / length mirrors to the device
        cache when admission/retire/growth changed them (tiny int32
        arrays; decode itself advances device lengths in lockstep with
        the host mirror, so a clean pass needs no transfer)."""
        if self._bt_dirty:
            self._cache["block_tables"] = self._to_device(self._bt)
            self._cache["lengths"] = self._to_device(self._lengths)
            self._bt_dirty = False

    def _admit_paged(self) -> bool:
        """Admit queued requests into free slots of the paged batch.
        Fresh prompts (and recompute-resumes) enter the chunked-prefill
        queue; prefilled handoffs adopt their KV block into pages
        directly. Block allocation is all-or-nothing per sequence and
        FIFO — a request the pool cannot serve YET parks at the queue
        head rather than being overtaken (no starvation).

        With the prefix cache on, the sequence's full-block prefix is
        matched against the pool's hash chain first: matched blocks
        join the slot's table BY REFERENCE (refcount bump, attention-
        read-only) and only the suffix is prefilled — or, for a
        disaggregated handoff, only the suffix rows of the prefill
        block are scattered (the handoff adopts refcounts rather than
        copying shared rows)."""
        progress = False
        while True:
            with self._cv:
                busy_prefill = {e["slot"] for e in self._prefill_q}
                free = [s for s in self._free_slots()
                        if s not in busy_prefill]
                if not free or not self._pending:
                    break
                req = self._pending.popleft()
                if req.cancelled:
                    self._m["queue_depth"].set(len(self._pending),
                                               self._tags)
                    continue
                slot = free[0]
                # Reserve the slot under the lock; compute happens out.
                self._slot_req[slot] = req
                self._m["queue_depth"].set(len(self._pending),
                                           self._tags)

            if req.kind == "prefilled" and req.resume_tokens is None:
                seq = req.prompt or []
                seq_len = req.true_len
            else:
                seq = req.resume_tokens if req.resume_tokens is not None \
                    else req.prompt
                seq_len = len(seq)
            got = self._pool.get_or_alloc(
                seq, self._pool.blocks_for(seq_len))
            if got is None:
                # Pool busy: give the slot back and repark at the HEAD.
                with self._cv:
                    self._slot_req[slot] = None
                    if not req.cancelled:
                        self._pending.appendleft(req)
                        self._m["queue_depth"].set(len(self._pending),
                                                   self._tags)
                break
            blocks, matched = got
            if self._pool.prefix_cache:
                self._prefix_lookup_tokens += seq_len
                self._m["prefix_lookup_tokens"].inc(seq_len, self._tags)
                if matched:
                    self._prefix_hit_tokens += matched
                    self._m["prefix_hit_tokens"].inc(matched, self._tags)
            self._blocks[slot] = blocks
            self._bt[slot] = 0
            self._bt[slot][:len(blocks)] = blocks
            self._bt_dirty = True

            if req.kind == "prefilled" and req.resume_tokens is None:
                # Disaggregated handoff: splice the contiguous prefill
                # block into the slot's pages — only the rows past the
                # shared prefix; matched blocks already hold identical
                # KV and stay read-only. The first token was sampled
                # (and delivered) by the prefill pool.
                try:
                    kv = {"k": self._to_device(req.kv["k"]),
                          "v": self._to_device(req.kv["v"])}
                    req.kv = None
                    self._sync_device_tables()
                    pool_kv = {"k": self._cache["k"],
                               "v": self._cache["v"]}
                    pool_kv = gen.adopt_slot_paged(
                        pool_kv, self._to_device(self._bt[slot]), kv,
                        req.true_len, start=matched,
                        block_size=self._pool.block_size)
                    self._cache["k"] = pool_kv["k"]
                    self._cache["v"] = pool_kv["v"]
                except Exception as e:
                    with self._cv:
                        req.error = e
                        self._slot_req[slot] = None
                        self._free_slot_blocks(slot)
                        self._cv.notify_all()
                    continue
                if seq:
                    self._pool.register(seq, blocks)
                self._activate_slot_paged(slot, req, seq_len=req.true_len,
                                          token=req.first_token,
                                          emit=False)
            else:
                with self._cv:
                    self._prefill_q.append(
                        {"slot": slot, "req": req, "tokens": seq,
                         "done": matched})
            progress = True
        return progress

    def _prefill_tick(self) -> bool:
        """Run ONE chunk of the oldest prefilling prompt — FCFS for
        TTFT, one chunk per scheduler pass so a long prompt interleaves
        with decode steps instead of stalling the whole batch."""
        with self._cv:
            entry = self._prefill_q[0] if self._prefill_q else None
        if entry is None:
            return False
        req, slot = entry["req"], entry["slot"]
        if req.cancelled:   # reaped next pass
            return True
        C = max(1, self._ec.prefill_chunk)
        toks = entry["tokens"]
        start = entry["done"]
        chunk = toks[start:start + C]
        padded = np.zeros((1, C), np.int64)
        padded[0, :len(chunk)] = chunk
        self._sync_device_tables()
        pool_kv = {"k": self._cache["k"], "v": self._cache["v"]}
        first, pool_kv = gen.prefill_chunk_paged(
            self._params, pool_kv, self._to_device(self._bt[slot]),
            self._to_device(padded), start, len(chunk), req.seed,
            cfg=self._cfg,
            block_size=self._pool.block_size,
            temperature=self._ec.temperature, top_k=self._ec.top_k)
        self._cache["k"] = pool_kv["k"]
        self._cache["v"] = pool_kv["v"]
        entry["done"] = start + len(chunk)
        self._prefill_tokens_computed += len(chunk)
        if entry["done"] < len(toks):
            return True
        with self._cv:
            if self._prefill_q and self._prefill_q[0] is entry:
                self._prefill_q.pop(0)
        # Prefill complete: register the sequence's full blocks in the
        # prefix chain (matched-prefix keys are already there; the
        # freshly computed suffix blocks become findable) …
        self._pool.register(toks, self._blocks[slot])
        # … and the sampled token is the next token of the sequence
        # (for a resume, the continuation token — same counter the
        # uninterrupted decode would have used).
        self._activate_slot_paged(
            slot, req, seq_len=len(toks), token=int(first[0]),
            emit=not (req.kind == "prefilled" and req.produced == 0))
        return True

    def _activate_slot_paged(self, slot: int, req: _Request,
                             seq_len: int, token: int,
                             emit: bool) -> None:
        """Move a slot from prefilling/adopted to decode-active."""
        self._lengths[slot] = seq_len
        self._bt_dirty = True
        self._last_tokens[slot] = token
        self._seeds[slot] = req.seed
        self._active[slot] = True
        req.resume_tokens = None
        req.produced += 1
        self._produced[slot] = req.produced
        now = time.monotonic()
        first_activation = req.t_first is None
        with self._cv:
            if first_activation:
                req.t_first = now
            if emit:
                req.tokens.append(token)
            if req.produced >= req.budget or seq_len >= self._ec.max_len:
                if seq_len >= self._ec.max_len and \
                        req.produced < req.budget:
                    req.truncated = True
                self._retire_slot_locked(slot)
            self._publish_occupancy_locked()
            self._cv.notify_all()
        if first_activation:
            self._m["ttft"].observe(now - req.t_submit, self._tags)
        if emit:
            self._m["tokens"].inc(1, self._tags)
            self._fault_token_tick(1)

    def _grow_or_preempt(self) -> None:
        """Before a decode step every active slot needs a page for its
        next token. A slot the pool cannot grow is PREEMPTED by
        recompute: its blocks return to the pool and the request reparks
        at the queue head as a resume (prompt + generated-so-far), to be
        re-prefilled when blocks free up — generation continues exactly
        where it stopped (sampling is deterministic in position)."""
        bs = self._pool.block_size
        for slot, req in enumerate(self._slot_req):
            if req is None or not self._active[slot]:
                continue
            need = int(self._lengths[slot]) // bs + 1
            if len(self._blocks[slot]) >= need:
                continue
            got = self._pool.alloc(1)
            if got is not None:
                self._bt[slot][len(self._blocks[slot])] = got[0]
                self._blocks[slot].extend(got)
                self._bt_dirty = True
                continue
            self._preempt_slot(slot, req)

    def _preempt_slot(self, slot: int, req: _Request) -> None:
        self._m["preempts"].inc(1, self._tags)
        with self._cv:
            self._active[slot] = False
            self._slot_req[slot] = None
            self._free_slot_blocks(slot)
            if req.cancelled:
                pass
            elif req.prompt is None:
                # Pre-prompt-carrying handoffs cannot be recomputed.
                req.error = KVCacheExhaustedError(
                    "KV pool exhausted and the handoff carried no "
                    "prompt tokens for recompute-resume")
            else:
                req.resume_tokens = req.full_sequence()
                self._pending.appendleft(req)
                self._m["queue_depth"].set(len(self._pending),
                                           self._tags)
            self._publish_occupancy_locked()
            self._cv.notify_all()

    def _step(self) -> bool:
        """One batched decode step; emit the new token of every active
        slot and retire exhausted sequences."""
        if self._pool is not None:
            self._grow_or_preempt()
        if not self._active.any():
            return False
        self._fault_step_tick()
        if self._pool is not None:
            self._sync_device_tables()
            active_now = self._active.copy()
            nxt, self._cache = gen.decode_step_paged(
                self._params, self._cache,
                self._to_device(self._last_tokens),
                self._to_device(active_now),
                self._to_device(self._seeds), cfg=self._cfg,
                block_size=self._pool.block_size,
                temperature=self._ec.temperature, top_k=self._ec.top_k)
            # Device lengths advanced for active slots; keep the host
            # mirror in lockstep so growth/retire decisions are exact.
            self._lengths += active_now.astype(np.int32)
        else:
            nxt, self._cache = gen.decode_step(
                self._params, self._cache,
                self._to_device(self._last_tokens),
                self._to_device(self._active),
                self._to_device(self._seeds), cfg=self._cfg,
                temperature=self._ec.temperature, top_k=self._ec.top_k)
        nxt = nxt.cpu().numpy()           # the per-step host sync
        self._steps += 1

        emitted = 0
        retired = False
        with self._cv:
            for slot, req in enumerate(self._slot_req):
                if req is None or not self._active[slot]:
                    continue
                token = int(nxt[slot])
                self._last_tokens[slot] = token
                self._produced[slot] += 1
                req.produced += 1
                req.tokens.append(token)
                emitted += 1
                if self._pool is not None:
                    cache_full = int(self._lengths[slot]) >= \
                        self._ec.max_len
                else:
                    full = req.true_len if req.kind == "prefilled" \
                        else len(req.prompt)
                    cache_full = full + self._produced[slot] >= \
                        self._ec.max_len
                if cache_full and self._produced[slot] < req.budget:
                    req.truncated = True
                if self._produced[slot] >= req.budget or cache_full:
                    self._retire_slot_locked(slot)
                    retired = True
            self._cv.notify_all()
        if emitted:
            self._m["tokens"].inc(emitted, self._tags)
            self._fault_token_tick(emitted)
        if retired:
            with self._cv:
                self._publish_occupancy_locked()
        return True


def _build_model(ec: EngineConfig, *, device: DeviceLike = None):
    """(cfg, params) of ``ec``'s model: ``init_params`` drawn from
    ``ec.param_seed`` with a generator on ``device`` (default ``cuda``),
    the counterpart of the reference's ``replicas._build_model``."""
    device = resolve_device(device)
    cfg = ec.gpt_config()
    generator = torch.Generator(device=device).manual_seed(ec.param_seed)
    return cfg, init_params(cfg, generator=generator, device=device)
