"""Deployment classes of the LLM serving tier (port of
``ray_tpu/serve/llm/replicas.py``).

Three pool shapes over one engine substrate:

- ``LLMReplica``      — combined prefill and decode with continuous
                        batching (one pool);
- ``PrefillReplica``  — prompt-only pool: runs the prefill products,
                        samples the first token, publishes the KV block
                        through the runtime's store (``kv_transfer``);
- ``DecodeReplica``   — decode-only pool: adopts prefilled KV blocks into
                        its in-flight batch and streams the remaining
                        tokens.

Each constructor takes ``(engine_config, runtime=None, device=None)``: the
runtime whose store carries the KV handoff and whose context names the
replica (a new ``LocalRuntime`` by default, or the ``ray_tpu`` module), and
the device (``cuda`` by default; ``device="cpu"`` for the CPU). A replica
keeps only the serving weights (``generate.serving_params``, the block
weights cast once), never the f32 master it was drawn as.

Each exposes ``serve_stats``, which a serve replica wrapper merges into its
stats (queue depth, slot occupancy, ``autoscale_load``). The engine's
metrics stay in-process in ``ray_tpu_torch.util.metrics``: there is no
reporter pushing them to a dashboard.

The port's engine raises the port's ``EngineFailedError`` and, when its
queue is full, ``ServeOverloadedError``. A runtime's serve handle migrates
a request only on its own ``EngineFailedError``, and its HTTP ingress sheds
with 429 and Retry-After only on its own ``ServeOverloadedError``. So where
the runtime has those classes in ``exceptions`` (the ``ray_tpu`` module
does) the replicas raise them instead, with the same message and fields
(resume descriptor and reason; ``retry_after_s`` and reason).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.exceptions import EngineFailedError, ServeOverloadedError
from ray_tpu_torch.models import generate as gen
from ray_tpu_torch.runtime import LocalRuntime
from ray_tpu_torch.serve.llm import engine as _engine
from ray_tpu_torch.serve.llm.engine import EngineConfig, InflightBatchEngine
from ray_tpu_torch.serve.llm.kv_transfer import adopt_kv, publish_kv

_PREFILL_FOLLOW_TIMEOUT_S = 120.0


def _runtime_class(runtime: Any, cls: type) -> type:
    """``runtime.exceptions``' class of ``cls``'s name, or ``cls``."""
    return getattr(getattr(runtime, "exceptions", None), cls.__name__, cls)


@contextlib.contextmanager
def _seam(runtime: Any):
    """Re-raise the port's ``EngineFailedError`` and
    ``ServeOverloadedError`` as ``runtime``'s own classes, where the
    runtime has them (module docstring)."""
    try:
        yield
    except EngineFailedError as e:
        cls = _runtime_class(runtime, EngineFailedError)
        if cls is EngineFailedError:
            raise
        raise cls(e.args[0] if e.args else "", descriptor=e.descriptor,
                  reason=e.reason) from e
    except ServeOverloadedError as e:
        cls = _runtime_class(runtime, ServeOverloadedError)
        if cls is ServeOverloadedError or type(e) is not ServeOverloadedError:
            raise
        raise cls(e.args[0] if e.args else "",
                  retry_after_s=e.retry_after_s, reason=e.reason) from e


class _EngineStream:
    """Iterator over one engine request's chunks with an EXPLICIT
    ``close()`` that cancels the request. The bare engine generator only
    reaches its cancel-on-abandon ``finally`` once started; a stream the
    consumer drops before pulling a single chunk would leak its slot and KV
    blocks without this wrapper."""

    def __init__(self, engine: InflightBatchEngine, req_id: str,
                 runtime: Any):
        self._engine = engine
        self._req_id = req_id
        self._runtime = runtime
        self._done = False

    def __iter__(self) -> Iterator[List[int]]:
        return self

    def _drain(self, max_wait_s: float) -> Dict[str, Any]:
        with _seam(self._runtime):
            out = self._engine.drain(self._req_id, max_wait_s=max_wait_s)
        if out["done"]:
            self._done = True
        return out

    def __next__(self) -> List[int]:
        if self._done:
            raise StopIteration
        while True:
            out = self._drain(1.0)
            if out["tokens"]:
                return out["tokens"]
            if self._done:
                raise StopIteration

    def next_ready(self) -> Optional[List[int]]:
        """Non-blocking probe: the chunk that has ALREADY accumulated, or
        None when nothing is ready yet (a serve replica's batched pull
        drains these after its first, blocking, item). Raises
        StopIteration at exhaustion, like ``__next__``."""
        if self._done:
            raise StopIteration
        out = self._drain(0.0)
        if out["tokens"]:
            return out["tokens"]
        if self._done:
            raise StopIteration
        return None

    def close(self) -> None:
        # Thread-safe and idempotent: close() may arrive from another
        # thread while __next__ is blocked inside drain.
        self._done = True
        self._engine.cancel(self._req_id)

    def __del__(self):
        # A stream dropped without close() must still cancel its request
        # so the slot and its KV blocks free.
        try:
            if not self._done:
                self._engine.cancel(self._req_id)
        except Exception:
            pass


def normalize_request(request: Any) -> Dict[str, Any]:
    """Accept either the direct dict ``{"prompt": [ids], "n": int,
    "seed": int}`` or the HTTP proxy payload (``{"json": {...}}``).
    ``generated`` (optional) marks a migrated request resuming after tokens
    another replica already produced and delivered."""
    if isinstance(request, dict) and "json" in request \
            and isinstance(request["json"], dict):
        request = request["json"]
    if not isinstance(request, dict) or "prompt" not in request:
        raise ValueError(
            "LLM request must be a dict with a 'prompt' token list "
            f"(got {type(request).__name__})")
    return {
        "prompt": [int(t) for t in request["prompt"]],
        "n": int(request["n"]) if request.get("n") else None,
        "seed": int(request.get("seed") or 0),
        "generated": [int(t) for t in (request.get("generated") or [])],
    }


def _build_model(ec: EngineConfig, *, device: DeviceLike = None):
    """(cfg, f32 params) of ``ec``'s model on ``device``: the engine's
    ``_build_model``."""
    return _engine._build_model(ec, device=device)


def _replica_tag(runtime: Any) -> str:
    """This replica's actor id for metric tags ("local" outside an actor,
    e.g. unit tests constructing replicas directly)."""
    try:
        return runtime.get_runtime_context().get_actor_id() or "local"
    except Exception:
        return "local"


def _runtime(runtime: Any) -> Any:
    return LocalRuntime() if runtime is None else runtime


class LLMReplica:
    """Combined pool: one continuous-batching engine per replica."""

    def __init__(self, engine_config: Optional[Dict[str, Any]] = None,
                 runtime: Any = None, device: DeviceLike = None):
        self._runtime = _runtime(runtime)
        ec = EngineConfig.from_dict(engine_config)
        cfg, params = _build_model(ec, device=device)
        self._engine = InflightBatchEngine(
            params, cfg, ec, deployment="llm",
            replica_id=_replica_tag(self._runtime), device=device)

    def __call__(self, request: Any) -> Dict[str, Any]:
        req = normalize_request(request)
        with _seam(self._runtime):
            tokens = self._engine.generate(req["prompt"], req["n"],
                                           req["seed"],
                                           generated=req["generated"])
        return {"tokens": tokens}

    def generate_stream(self, request: Any) -> Iterator[List[int]]:
        """Iterator of token chunks (the handle's streaming path); closing
        it cancels the engine request. A request carrying ``generated`` (a
        migrated stream resuming here) continues at the next token."""
        return _EngineStream(self._engine, self.submit(request),
                             self._runtime)

    # Decoupled submit/poll API: one collect call serves every session
    # parked on this replica.
    def submit(self, request: Any) -> str:
        req = normalize_request(request)
        with _seam(self._runtime):
            return self._engine.submit(req["prompt"], req["n"], req["seed"],
                                       generated=req["generated"])

    def drain(self, req_id: str, max_wait_s: float = 0.5):
        with _seam(self._runtime):
            return self._engine.drain(req_id, max_wait_s)

    def collect(self, req_ids: List[str]):
        return self._engine.collect(req_ids)

    def cancel(self, req_id: str) -> bool:
        return self._engine.cancel(req_id)

    def serve_stats(self) -> Dict[str, Any]:
        return self._engine.stats()

    def check_health(self) -> bool:
        return True

    def __del__(self):
        eng = getattr(self, "_engine", None)
        if eng is not None:
            eng.stop()


class _PrefillBatcher:
    """Micro-batch concurrent prefill calls into ONE ``prefill_slots`` run:
    callers arriving within ``prefill_batch_window_ms`` of each other whose
    prompts share a bucket ride the same [N, bucket] products. The first
    caller becomes the LEADER, waits out the window (skipped when the batch
    fills), runs the batch and hands each follower its row. The batch is
    rounded up to a power of two (one-token dummy rows pad it), as the
    reference does to compile once per (bucket, power of two)."""

    def __init__(self, params, cfg, ec: EngineConfig, device: torch.device):
        self._params = params
        self._cfg = cfg
        self._ec = ec
        self._device = device
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._waiting: List[Dict[str, Any]] = []   # queued entries
        self._leader = False

    @staticmethod
    def _pow2(n: int) -> int:
        p = 1
        while p < n:
            p *= 2
        return p

    def run(self, prompt: List[int], bucket: int, seed: int) -> Any:
        """Blocking: returns (first_token int, kv {"k","v"} for THIS
        prompt, [L, 1, bucket, H, Dh]). Every caller loops as a POTENTIAL
        leader: whoever finds no leader serves ONE batch round and hands
        leadership back, so leadership rotates under sustained arrivals and
        a waiter never strands leaderless."""
        entry = {"prompt": prompt, "bucket": bucket, "seed": seed,
                 "done": threading.Event(), "out": None, "err": None}
        deadline = time.monotonic() + _PREFILL_FOLLOW_TIMEOUT_S
        with self._cv:
            self._waiting.append(entry)
            self._cv.notify_all()
        while not entry["done"].is_set():
            with self._cv:
                if entry["done"].is_set():
                    break
                if self._leader or entry not in self._waiting:
                    # A round is in flight (possibly computing OUR batch):
                    # park briefly and re-check.
                    self._cv.wait(0.05)
                    if time.monotonic() > deadline:
                        try:
                            self._waiting.remove(entry)
                        except ValueError:
                            pass
                        if not entry["done"].is_set():
                            raise TimeoutError(
                                "prefill batch never served us")
                    continue
                self._leader = True
            try:
                self._serve_one_round()
            finally:
                with self._cv:
                    self._leader = False
                    self._cv.notify_all()
        if entry["err"] is not None:
            raise entry["err"]
        return entry["out"]

    def _serve_one_round(self) -> None:
        """One batch round: wait out the batching window for the oldest
        waiter's bucket, take up to a batch of its peers, run them."""
        window = max(0.0, self._ec.prefill_batch_window_ms / 1e3)
        cap = max(1, self._ec.prefill_batch_size)
        with self._cv:
            if not self._waiting:
                return
            bucket = self._waiting[0]["bucket"]
            deadline = time.monotonic() + window
            while len([e for e in self._waiting
                       if e["bucket"] == bucket]) < cap:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            batch = [e for e in self._waiting
                     if e["bucket"] == bucket][:cap]
            for e in batch:
                self._waiting.remove(e)
        if not batch:
            return
        try:
            self._run_batch(batch)
        except Exception as e:  # noqa: BLE001 — fan the failure out
            for e2 in batch:
                e2["err"] = e
                e2["done"].set()

    def _run_batch(self, batch: List[Dict[str, Any]]) -> None:
        bucket = batch[0]["bucket"]
        n = self._pow2(len(batch))
        prompts = np.zeros((n, bucket), np.int64)
        lens = np.ones((n,), np.int64)     # dummy rows: 1-token prompts
        seeds = np.zeros((n,), np.int64)
        for i, e in enumerate(batch):
            prompts[i, :len(e["prompt"])] = e["prompt"]
            lens[i] = len(e["prompt"])
            seeds[i] = e["seed"]

        def dev(a):
            return torch.from_numpy(a).to(self._device)

        firsts, kv = gen.prefill_slots(
            self._params, dev(prompts), dev(lens), dev(seeds),
            cfg=self._cfg, temperature=self._ec.temperature,
            top_k=self._ec.top_k)
        firsts = firsts.tolist()
        for i, e in enumerate(batch):
            # A row of its own, as the reference's slice is a new array:
            # the batch's cache is freed once every row is handed off.
            e["out"] = (int(firsts[i]),
                        {"k": kv["k"][:, i:i + 1].contiguous(),
                         "v": kv["v"][:, i:i + 1].contiguous()})
            e["done"].set()


class PrefillReplica:
    """Prompt-only pool. Two scaling axes compose: request concurrency
    across replicas, and micro-batching concurrent calls within a replica
    into one [N, bucket] run (``prefill_batch_size`` > 1), which streams
    the weights once for N prompts."""

    def __init__(self, engine_config: Optional[Dict[str, Any]] = None,
                 runtime: Any = None, device: DeviceLike = None):
        self._runtime = _runtime(runtime)
        self._ec = EngineConfig.from_dict(engine_config)
        self._device = resolve_device(device)
        cfg, master = _build_model(self._ec, device=self._device)
        self._cfg = cfg
        self._params = gen.serving_params(master, cfg, self._device)
        del master
        self._lock = threading.Lock()
        self._batcher = _PrefillBatcher(self._params, self._cfg, self._ec,
                                        self._device)
        self._batched_total = 0

    def _bucket_for(self, n: int) -> int:
        for b in sorted(self._ec.prompt_buckets):
            if n <= b:
                return b
        raise ValueError(
            f"prompt length {n} exceeds the largest prompt bucket "
            f"{max(self._ec.prompt_buckets)}")

    def prefill(self, request: Any) -> Dict[str, Any]:
        """Run the prompt, sample the first token, publish the KV block
        through the runtime's store. Returns the handoff descriptor the
        router forwards to the decode pool (with the raw prompt, so a paged
        decode engine can recompute-resume after preemption)."""
        req = normalize_request(request)
        prompt = req["prompt"]
        if not prompt:
            raise ValueError("empty prompt")
        bucket = self._bucket_for(len(prompt))
        if self._ec.prefill_batch_size > 1:
            first_token, kv = self._batcher.run(prompt, bucket, req["seed"])
            with self._lock:
                self._batched_total += 1
        else:
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :len(prompt)] = prompt
            # One prefill at a time per replica.
            with self._lock:
                first, kv = gen.prefill_slot(
                    self._params, torch.from_numpy(padded).to(self._device),
                    len(prompt), req["seed"], cfg=self._cfg,
                    temperature=self._ec.temperature, top_k=self._ec.top_k)
            first_token = int(first[0])
        return publish_kv(kv, len(prompt), first_token, runtime=self._runtime,
                          n=req["n"], seed=req["seed"], prompt=list(prompt))

    def serve_stats(self) -> Dict[str, Any]:
        return {"prefill_batched_total": self._batched_total}

    def check_health(self) -> bool:
        return True


class DecodeReplica:
    """Decode-only pool: adopts prefilled KV blocks into the in-flight
    batch. The first token was already sampled (and delivered) by the
    prefill pool; this engine streams tokens 2..n."""

    def __init__(self, engine_config: Optional[Dict[str, Any]] = None,
                 runtime: Any = None, device: DeviceLike = None):
        self._runtime = _runtime(runtime)
        ec = EngineConfig.from_dict(engine_config)
        cfg, params = _build_model(ec, device=device)
        self._engine = InflightBatchEngine(
            params, cfg, ec, deployment="llm-decode",
            replica_id=_replica_tag(self._runtime), device=device)

    def submit_prefilled(self, handoff: Dict[str, Any]) -> str:
        kv = adopt_kv(handoff, runtime=self._runtime)
        with _seam(self._runtime):
            return self._engine.submit_prefilled(
                handoff["first_token"], kv, handoff["length"],
                handoff.get("n"), handoff.get("seed") or 0,
                prompt=handoff.get("prompt"))

    def decode(self, handoff: Dict[str, Any]) -> Dict[str, Any]:
        """Blocking: the remaining tokens (2..n) for one handoff."""
        rid = self.submit_prefilled(handoff)
        tokens: List[int] = []
        with _seam(self._runtime):
            for chunk in self._engine.stream(rid):
                tokens.extend(chunk)
        return {"tokens": tokens}

    def decode_stream(self, handoff: Dict[str, Any]) -> Iterator[List[int]]:
        return _EngineStream(self._engine, self.submit_prefilled(handoff),
                             self._runtime)

    def resume_stream(self, request: Any) -> Iterator[List[int]]:
        """Adopt a MIGRATED stream whose previous decode replica died: no KV
        handoff exists anymore, but the request carries the prompt plus
        every token already delivered (prefill's first token included), so
        this engine re-prefills locally and continues at the next position
        without a prefill-pool round trip."""
        req = normalize_request(request)
        if not req["generated"]:
            raise ValueError(
                "resume_stream needs 'generated' (the tokens already "
                "delivered, first token included)")
        with _seam(self._runtime):
            rid = self._engine.submit(req["prompt"], req["n"], req["seed"],
                                      generated=req["generated"])
        return _EngineStream(self._engine, rid, self._runtime)

    def drain(self, req_id: str, max_wait_s: float = 0.5):
        with _seam(self._runtime):
            return self._engine.drain(req_id, max_wait_s)

    def collect(self, req_ids: List[str]):
        return self._engine.collect(req_ids)

    def cancel(self, req_id: str) -> bool:
        return self._engine.cancel(req_id)

    def serve_stats(self) -> Dict[str, Any]:
        return self._engine.stats()

    def check_health(self) -> bool:
        return True

    def __del__(self):
        eng = getattr(self, "_engine", None)
        if eng is not None:
            eng.stop()
