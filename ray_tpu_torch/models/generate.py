"""Autoregressive generation with a KV cache (port of
``ray_tpu/models/generate.py``).

Every function of the reference, in its order and under its name:

- the reserved cache (``init_cache``, ``_forward_cached``, ``prefill``,
  ``generate``): ``{k, v: [L, B, T, H, Dh], length}``;
- the slotted batch behind in-flight batching (``prefill_slot``,
  ``adopt_slot``, ``decode_step``): per-slot lengths, so slots at
  different positions share one decode step;
- the paged pool (``init_paged_pool``, ``prefill_chunk_paged``,
  ``adopt_slot_paged``, ``decode_step_paged``): one shared pool of
  fixed-size blocks, per-slot block tables. **Block 0 is scratch**: the
  allocator never hands it out, retired slots' tables point at it, and
  inactive slots and pad positions write to it. Several of them hit row 0
  in one call, and CUDA applies duplicate writes in no fixed order. A
  decode step's idle slots and a prefill chunk's pad rows attend to row 0
  after writing it, so there every duplicate carries the values of one
  row (``_one_writer``): the last, which is what the reference's in-order
  scatter leaves. Position ``p`` of a slot lives at pool row
  ``table[p // bs] * bs + p % bs``.

Kept from the reference: f32 attention logits and softmax with the finite
``-1e30`` mask, the probabilities cast back to the cache's dtype for the
product with V; f32 LM-head logits from the f32 embedding; the block math of
``transformer._ffn`` and ``_layer_norm`` (a MoE FFN's capacity counts every
row of a call, inactive slots and pad rows included, so they can push a
live token past its expert's capacity); sampling keys ``fold_in(fold_in(
key(0), seed), position)`` with threefry bits equal to ``jax.random``'s
(``ray_tpu_torch.random``).

What changes: ``lax.scan`` over layers is a Python loop over layer views of
the stacked params and caches. Where the reference donates a buffer, the
port writes the cache tensors in place and returns the same dict; the
reserved cache of ``_forward_cached`` is written in place too. ``length``
of the reserved cache is a Python int (host metadata); slotted and paged
lengths and block tables are int64 tensors on the cache's device. Tokens
come back int64. ``vmap`` over slots is broadcasting over a batch of keys.

Pass the params through ``serving_params`` once: the reference casts the
block weights to ``cfg.dtype`` inside each compiled step, where XLA fuses
the cast into the products; done eagerly on every step it would stream the
f32 master weights each time. Every function runs without autograd.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ray_tpu_torch import random as rnd
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.transformer import (
    _LN_PARAMS, GPTConfig, Params, _ffn, _layer_norm, _layer_params,
    _lm_head, _rope,
)

_NEG_INF = -1e30
IntLike = Any  # a Python int or a 0-d integer tensor


def serving_params(params: Params, cfg: GPTConfig,
                   device: DeviceLike = None) -> Params:
    """``params`` detached and on ``device`` (default ``cuda``), the block
    weights and biases cast to ``cfg.dtype`` once. Layer norm's params, the
    embeddings and the final norm keep their dtype: the reference reads
    them in it (the LM head multiplies the f32 embedding). Tensors already
    in place are shared, not copied."""
    device = resolve_device(device)
    out: Params = {}
    for name, val in params.items():
        if name == "blocks":
            out[name] = {
                n: w.detach().to(device, w.dtype if n in _LN_PARAMS
                                 else cfg.dtype)
                for n, w in val.items()}
        else:
            out[name] = val.detach().to(device)
    return out


def _embed(params: Params, tokens: torch.Tensor, positions: torch.Tensor,
           cfg: GPTConfig) -> torch.Tensor:
    """Token embeddings in ``cfg.dtype``, plus learned positions when the
    model has them (``positions`` broadcast against ``tokens``). Positions
    past the table are clamped: only pad or inactive rows reach them."""
    x = params["tok_embed"][tokens].to(cfg.dtype)
    if not cfg.rotary:
        pe = params["pos_embed"]
        x = x + pe[positions.clamp(max=pe.shape[0] - 1)].to(cfg.dtype)
    return x


def _qkv(x: torch.Tensor, bp: Params, cfg: GPTConfig):
    """Layer norm and the fused QKV projection: q, k, v [B, S, H, Dh]."""
    b, s, d = x.shape
    h = _layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], cfg.eps)
    wqkv = bp["wqkv"]
    qkv = (h @ wqkv.reshape(d, -1)).view(b, s, *wqkv.shape[1:]) + bp["bqkv"]
    return qkv.unbind(2)


def _out_ffn(x: torch.Tensor, attn: torch.Tensor, bp: Params,
             cfg: GPTConfig) -> torch.Tensor:
    """The rest of the block after attention: output projection, residual,
    layer norm, MLP, residual."""
    b, s, d = x.shape
    x = x + attn.reshape(b, s, -1) @ bp["wo"].reshape(-1, d) + bp["bo"]
    h = _layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], cfg.eps)
    return x + _ffn(h, bp, cfg)


def _logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """f32 logits [B, S, V] of x [B, S, D] against the embedding in f32
    (the reference's ``x.astype(f32) @ tok_embed.astype(f32)``)."""
    return _lm_head(x.float(), params["tok_embed"].float())


def _final(params: Params, x: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    return _layer_norm(x, params["lnf_scale"], params["lnf_bias"], cfg.eps)


def init_cache(cfg: GPTConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> Dict[str, Any]:
    L, H, Dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    device = resolve_device(device)
    return {
        "k": torch.zeros((L, batch, max_len, H, Dh), dtype=cfg.dtype,
                         device=device),
        "v": torch.zeros((L, batch, max_len, H, Dh), dtype=cfg.dtype,
                         device=device),
        "length": 0,
    }


def _attn_with_cache(q, k_cache, v_cache, cache_len: IntLike, scale):
    """q: [B, S, H, Dh] (S = new tokens); caches: [B, T, H, Dh] with the
    new keys already written at [cache_len, cache_len+S). Causal within
    the new block; all cached positions visible."""
    s, t = q.shape[1], k_cache.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_cache.float()) * scale
    q_pos = cache_len + torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    logits = logits.masked_fill(k_pos > q_pos, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v_cache.dtype), v_cache)


def _block_cached(x, bp, layer_cache, cache_len: int, cfg: GPTConfig,
                  positions):
    """One block over S new tokens, writing its K/V into the layer cache
    rows [cache_len, cache_len+S) in place. Returns (out, k, v caches)."""
    q, k, v = _qkv(x, bp, cfg)
    if cfg.rotary:
        q, k = _rope(q, positions), _rope(k, positions)
    k_cache, v_cache = layer_cache
    s = k.shape[1]
    k_cache[:, cache_len:cache_len + s] = k
    v_cache[:, cache_len:cache_len + s] = v
    attn = _attn_with_cache(q, k_cache, v_cache, cache_len,
                            cfg.head_dim ** -0.5)
    return _out_ffn(x, attn, bp, cfg), k_cache, v_cache


@torch.no_grad()
def _forward_cached(params: Params, tokens: torch.Tensor, cache,
                    cfg: GPTConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run S new tokens; returns (logits [B, S, V] f32, cache with them
    written and ``length`` advanced)."""
    s = tokens.shape[1]
    cache_len = cache["length"]
    positions = cache_len + torch.arange(s, device=tokens.device)
    x = _embed(params, tokens, positions, cfg)
    for i, bp in enumerate(_layer_params(params["blocks"], cfg.dtype)):
        x, _, _ = _block_cached(x, bp, (cache["k"][i], cache["v"][i]),
                                cache_len, cfg, positions)
    logits = _logits(params, _final(params, x, cfg))
    return logits, {"k": cache["k"], "v": cache["v"],
                    "length": cache_len + s}


def prefill(params: Params, prompt: torch.Tensor, cfg: GPTConfig,
            max_len: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process the whole prompt; returns (last-token logits [B, V],
    cache)."""
    cache = init_cache(cfg, prompt.shape[0], max_len, device=prompt.device)
    logits, cache = _forward_cached(params, prompt, cache, cfg)
    return logits[:, -1], cache


def _top_k_mask(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Logits below the k-th largest of their row set to -1e30 (ties with
    it kept), as ``where(logits >= sort(logits)[-top_k], ...)``."""
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, _NEG_INF)


def _sample(logits: torch.Tensor, rng: torch.Tensor, temperature: float,
            top_k: int) -> torch.Tensor:
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        logits = _top_k_mask(logits, top_k)
    return rnd.categorical(rng, logits)


# ---------------------------------------------------------------------------
# Slotted batch (continuous / in-flight batching substrate): a fixed batch
# of slots, each its own sequence with its own length. Pad garbage beyond a
# slot's length is never visible (attention masks keys past it) and is
# overwritten as the sequence advances.


def init_slotted_cache(cfg: GPTConfig, slots: int, max_len: int, *,
                       device: DeviceLike = None) -> Dict[str, Any]:
    """KV cache for ``slots`` independent sequences + per-slot lengths."""
    L, H, Dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    device = resolve_device(device)
    return {
        "k": torch.zeros((L, slots, max_len, H, Dh), dtype=cfg.dtype,
                         device=device),
        "v": torch.zeros((L, slots, max_len, H, Dh), dtype=cfg.dtype,
                         device=device),
        "lengths": torch.zeros((slots,), dtype=torch.int64, device=device),
    }


def _rope_batched(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embeddings with PER-SLOT positions: x [B, S, H, Dh],
    positions [B, S] (each slot sits at its own sequence offset)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=x.device) / half))
    angles = positions[..., None].float() * freqs       # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _write_slot_kv(cache_layer: torch.Tensor, new: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """Write one new K or V row per slot at that slot's own position, in
    place: cache_layer [B, T, H, Dh], new [B, 1, H, Dh], lengths [B]. A
    position past the end lands on the last row, as the reference's
    clamped ``dynamic_update_slice``."""
    b, t = cache_layer.shape[:2]
    rows = torch.arange(b, device=cache_layer.device)
    cache_layer[rows, lengths.clamp(max=t - 1)] = new[:, 0]
    return cache_layer


def _attn_slotted(q, k_cache, v_cache, lengths, scale):
    """Single-token attention with per-slot visibility: q [B, 1, H, Dh];
    slot b sees cache positions ``<= lengths[b]`` (its own new token
    included — it was just written at ``lengths[b]``)."""
    t = k_cache.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_cache.float()) * scale
    hidden = torch.arange(t, device=q.device)[None, :] > lengths[:, None]
    logits = logits.masked_fill(hidden[:, None, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v_cache.dtype), v_cache)


def _block_decode(x, bp, layer_cache, lengths, cfg: GPTConfig):
    """One block over one new token per slot. Returns (out, k, v caches),
    each slot's new row written in place."""
    q, k, v = _qkv(x, bp, cfg)
    if cfg.rotary:
        positions = lengths[:, None]                          # [B, 1]
        q, k = _rope_batched(q, positions), _rope_batched(k, positions)
    k_cache, v_cache = layer_cache
    _write_slot_kv(k_cache, k, lengths)
    _write_slot_kv(v_cache, v, lengths)
    attn = _attn_slotted(q, k_cache, v_cache, lengths, cfg.head_dim ** -0.5)
    return _out_ffn(x, attn, bp, cfg), k_cache, v_cache


@torch.no_grad()
def _forward_decode(params: Params, tokens: torch.Tensor, cache,
                    cfg: GPTConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode token per slot. tokens [B]; returns (last-token logits
    [B, V], cache with the new K/V written — lengths NOT yet advanced; the
    caller advances only the active slots)."""
    lengths = cache["lengths"]
    x = _embed(params, tokens[:, None], lengths[:, None], cfg)
    for i, bp in enumerate(_layer_params(params["blocks"], cfg.dtype)):
        x, _, _ = _block_decode(x, bp, (cache["k"][i], cache["v"][i]),
                                lengths, cfg)
    return _logits(params, _final(params, x, cfg))[:, 0], cache


def _request_key(seed: IntLike, counter: IntLike, *,
                 device: DeviceLike = None) -> torch.Tensor:
    """Per-request, per-position sampling key: deterministic in (seed,
    position) so a request's tokens do not depend on which other requests
    share the batch (the isolation contract of in-flight batching).
    Tensor ``seed``/``counter`` give a batch of keys [..., 2] on their
    device."""
    if isinstance(seed, torch.Tensor):
        device = seed.device
    return rnd.fold_in(rnd.fold_in(rnd.key(0, device=device), seed), counter)


def _sample_one(logits: torch.Tensor, seed: IntLike, counter: IntLike,
                temperature: float, top_k: int) -> torch.Tensor:
    """Sample one token from one slot's logits [V] — or, with ``seed`` and
    ``counter`` tensors [B], one per row of logits [B, V] (the reference's
    ``vmap``)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        logits = _top_k_mask(logits, top_k)
    return rnd.categorical(
        _request_key(seed, counter, device=logits.device), logits)


@torch.no_grad()
def prefill_slot(params: Params, prompt: torch.Tensor, true_len: IntLike,
                 seed: IntLike, *, cfg: GPTConfig, temperature: float = 0.0,
                 top_k: int = 0) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill ONE request padded to a bucket: prompt [1, bucket]
    (positions ``>= true_len`` are pad). Returns (first sampled token [1],
    bucket-sized KV block {"k","v": [L, 1, bucket, H, Dh]}). Pad garbage in
    the block beyond ``true_len`` is masked by the per-slot length after
    adoption and overwritten as decoding advances."""
    cache = init_cache(cfg, prompt.shape[0], prompt.shape[1],
                       device=prompt.device)
    logits, cache = _forward_cached(params, prompt, cache, cfg)
    last = logits[0, int(true_len) - 1]                         # [V]
    first = _sample_one(last, seed, true_len, temperature, top_k)
    return first[None], {"k": cache["k"], "v": cache["v"]}


@torch.no_grad()
def adopt_slot(cache: Dict[str, Any], slot: IntLike, kv: Dict[str, Any],
               true_len: IntLike) -> Dict[str, Any]:
    """Splice a prefill KV block into slot ``slot`` of the batch cache and
    set that slot's length, in place (the reference donates the cache)."""
    slot = int(slot)
    bucket = kv["k"].shape[2]
    cache["k"][:, slot, :bucket] = kv["k"][:, 0]
    cache["v"][:, slot, :bucket] = kv["v"][:, 0]
    cache["lengths"][slot] = int(true_len)
    return cache


@torch.no_grad()
def decode_step(params: Params, cache: Dict[str, Any], tokens: torch.Tensor,
                active: torch.Tensor, seeds: torch.Tensor, *,
                cfg: GPTConfig, temperature: float = 0.0,
                top_k: int = 0) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step for the whole slotted batch.

    tokens [B] — each slot's last sampled token; active [B] bool — slots
    holding a live request (inactive slots are computed and discarded;
    their lengths do not advance, so their writes land harmlessly on the
    same masked position every step); seeds [B] — per-request sampling
    seeds. Returns (next tokens [B], the cache, written in place, with
    active lengths +1)."""
    logits, cache = _forward_decode(params, tokens, cache, cfg)
    new_lengths = cache["lengths"] + active.to(torch.int64)
    nxt = _sample_one(logits, seeds, new_lengths, temperature, top_k)
    cache["lengths"] = new_lengths
    return nxt, cache


# ---------------------------------------------------------------------------
# Paged (block-granular) KV cache: a SHARED pool of fixed-size blocks plus
# a per-slot block table (vLLM's PagedAttention layout) in place of the
# per-slot max_len reservation. Conventions in the module docstring.


def init_paged_pool(cfg: GPTConfig, num_blocks: int, block_size: int,
                    slots: int, max_blocks_per_slot: int, *,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """Shared K/V block pool + per-slot block tables. Block 0 is the
    scratch block; per-slot capacity is ``max_blocks_per_slot *
    block_size`` logical positions."""
    L, H, Dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    device = resolve_device(device)
    rows = num_blocks * block_size
    return {
        "k": torch.zeros((L, rows, H, Dh), dtype=cfg.dtype, device=device),
        "v": torch.zeros((L, rows, H, Dh), dtype=cfg.dtype, device=device),
        "block_tables": torch.zeros((slots, max_blocks_per_slot),
                                    dtype=torch.int64, device=device),
        "lengths": torch.zeros((slots,), dtype=torch.int64, device=device),
    }


def _one_writer(real: torch.Tensor) -> torch.Tensor:
    """For rows whose writes land on pool rows by index: the row whose
    values each row writes. A real row writes its own; every other row
    (an idle slot, a pad position, all sent to scratch row 0) writes the
    values of the last row that is not real. Duplicate writes then carry
    the same bytes, so the order in which CUDA applies them cannot change
    what row 0 holds, and it holds what the reference's in-order scatter
    leaves there. Computed on the device, without a sync."""
    idx = torch.arange(real.shape[0], device=real.device)
    last = torch.where(real, -1, idx).max().clamp(min=0)
    return torch.where(real, idx, last)


def _scatter_rows(pool: torch.Tensor, rows: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """``pool[rows] = vals`` in place. Where ``rows`` repeats, the callers
    pass equal values (``_one_writer``)."""
    pool[rows] = vals


def _block_decode_paged(x, bp, layer_cache, lengths, pos, wp, src,
                        cfg: GPTConfig):
    """One block over one new token per slot against the paged pool.
    ``pos`` [S, T] maps each slot's logical positions to pool rows; ``wp``
    [S] is each slot's write row (scratch for inactive slots) and ``src``
    [S] the slot whose K/V row it writes (``_one_writer``)."""
    q, k, v = _qkv(x, bp, cfg)
    if cfg.rotary:
        positions = lengths[:, None]                          # [S, 1]
        q, k = _rope_batched(q, positions), _rope_batched(k, positions)
    k_pool, v_pool = layer_cache                              # [P, H, Dh]
    _scatter_rows(k_pool, wp, k[src, 0])
    _scatter_rows(v_pool, wp, v[src, 0])
    attn = _attn_slotted(q, k_pool[pos], v_pool[pos], lengths,
                         cfg.head_dim ** -0.5)
    return _out_ffn(x, attn, bp, cfg), k_pool, v_pool


@torch.no_grad()
def decode_step_paged(params: Params, cache: Dict[str, Any],
                      tokens: torch.Tensor, active: torch.Tensor,
                      seeds: torch.Tensor, *, cfg: GPTConfig,
                      block_size: int, temperature: float = 0.0,
                      top_k: int = 0) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step for the whole paged batch — the paged twin of
    ``decode_step``: same per-slot lengths/masks/sampling, but each slot's
    context is gathered through its block table and the new K/V row is
    scattered to its current page (inactive slots write to the scratch
    block). The pool is written in place."""
    bt = cache["block_tables"]                                # [S, M]
    lengths = cache["lengths"]                                # [S]
    S, M = bt.shape
    bs = block_size
    offs = torch.arange(bs, device=bt.device)
    pos = (bt[:, :, None] * bs + offs).reshape(S, M * bs)     # [S, T]
    # Write row of each slot's next token; inactive slots (zeroed table +
    # length) resolve to the scratch block.
    page = bt.gather(1, (lengths // bs).clamp(max=M - 1)[:, None])[:, 0]
    wp = torch.where(active, page * bs + lengths % bs, 0)
    src = _one_writer(active)

    x = _embed(params, tokens[:, None], lengths[:, None], cfg)
    for i, bp in enumerate(_layer_params(params["blocks"], cfg.dtype)):
        x, _, _ = _block_decode_paged(x, bp, (cache["k"][i], cache["v"][i]),
                                      lengths, pos, wp, src, cfg)
    logits = _logits(params, _final(params, x, cfg))[:, 0]
    new_lengths = lengths + active.to(torch.int64)
    nxt = _sample_one(logits, seeds, new_lengths, temperature, top_k)
    cache["lengths"] = new_lengths
    return nxt, cache


def _chunk_flat_positions(block_table: torch.Tensor, logical: torch.Tensor,
                          real: torch.Tensor,
                          block_size: int) -> torch.Tensor:
    """Pool rows for logical positions; entries where ``real`` is False
    (pad) are redirected to the scratch block so a pad write can never land
    on a page that holds live tokens (clipped out-of-range table reads
    would otherwise alias the slot's LAST page)."""
    page = (logical // block_size).clamp(0, block_table.shape[0] - 1)
    flat = block_table[page] * block_size + logical % block_size
    return torch.where(real, flat, 0)


@torch.no_grad()
def _prefill_chunk_logits(params: Params, pool: Dict[str, Any],
                          block_table: torch.Tensor, tokens: torch.Tensor,
                          start: IntLike, chunk_len: IntLike, *,
                          cfg: GPTConfig, block_size: int
                          ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The body of ``prefill_chunk_paged`` up to its sampling: the f32
    logits [V] after the chunk's last real token, and the pool with the
    chunk's K/V rows scattered into the slot's pages."""
    C = tokens.shape[1]
    M = block_table.shape[0]
    bs = block_size
    dev = tokens.device
    logical = int(start) + torch.arange(C, device=dev)         # [C]
    real = torch.arange(C, device=dev) < int(chunk_len)
    flat = _chunk_flat_positions(block_table, logical, real, bs)
    src = _one_writer(real)
    pos_map = (block_table[:, None] * bs +
               torch.arange(bs, device=dev)).reshape(M * bs)   # [T]
    scale = cfg.head_dim ** -0.5

    x = _embed(params, tokens, logical[None], cfg)
    for i, bp in enumerate(_layer_params(params["blocks"], cfg.dtype)):
        kc, vc = pool["k"][i], pool["v"][i]
        q, k, v = _qkv(x, bp, cfg)
        if cfg.rotary:
            q, k = _rope(q, logical), _rope(k, logical)
        _scatter_rows(kc, flat, k[0, src])
        _scatter_rows(vc, flat, v[0, src])
        attn = _attn_with_cache(q, kc[pos_map][None], vc[pos_map][None],
                                int(start), scale)
        x = _out_ffn(x, attn, bp, cfg)
    n = int(chunk_len)
    last = _final(params, x[:, n - 1:n], cfg)                  # [1, 1, D]
    return _logits(params, last)[0, 0], pool


def prefill_chunk_paged(params: Params, pool: Dict[str, Any],
                        block_table: torch.Tensor, tokens: torch.Tensor,
                        start: IntLike, chunk_len: IntLike, seed: IntLike, *,
                        cfg: GPTConfig, block_size: int,
                        temperature: float = 0.0, top_k: int = 0
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run ONE CHUNK of one prompt against a slot's pages: tokens [1, C]
    hold positions [start, start+chunk_len) of the prompt (the tail past
    ``chunk_len`` is pad), attention sees the slot's earlier pages plus the
    causal prefix of the chunk, and the chunk's K/V rows are scattered into
    the slot's pages in place. Returns (sampled next token [1] — meaningful
    on the FINAL chunk, where it is the sequence's first generated token,
    sampled at the same per-request counter the decode path uses — and the
    pool {"k","v"})."""
    logits, pool = _prefill_chunk_logits(
        params, pool, block_table, tokens, start, chunk_len, cfg=cfg,
        block_size=block_size)
    nxt = _sample_one(logits, seed, int(start) + int(chunk_len),
                      temperature, top_k)
    return nxt[None], pool


@torch.no_grad()
def adopt_slot_paged(pool: Dict[str, Any], block_table: torch.Tensor,
                     kv: Dict[str, Any], true_len: IntLike,
                     start: Optional[IntLike] = None, *,
                     block_size: int) -> Dict[str, Any]:
    """Scatter a contiguous bucket-sized prefill KV block (the
    disaggregated handoff format, ``{"k","v": [L, 1, bucket, H, Dh]}``)
    into a slot's pages, in place. Pad rows past ``true_len`` go to
    scratch, and so do rows BEFORE ``start`` (the token offset of the
    slot's shared prefix-cache prefix): a prefix-cache hit adopts only the
    suffix rows, leaving the shared prefix blocks attention-read-only.
    Those rows land on scratch row 0 in no fixed order on the card, which
    is harmless: every reader of row 0 (an idle decode slot, a chunk's pad
    row) is in a call that writes the row first, in each layer."""
    bucket = kv["k"].shape[2]
    logical = torch.arange(bucket, device=block_table.device)
    real = logical < int(true_len)
    if start is not None:
        real = real & (logical >= int(start))
    flat = _chunk_flat_positions(block_table, logical, real, block_size)
    pool["k"][:, flat] = kv["k"][:, 0].to(pool["k"].dtype)
    pool["v"][:, flat] = kv["v"][:, 0].to(pool["v"].dtype)
    return pool


@torch.no_grad()
def prefill_slots(params: Params, prompts: torch.Tensor,
                  true_lens: torch.Tensor, seeds: torch.Tensor, *,
                  cfg: GPTConfig, temperature: float = 0.0,
                  top_k: int = 0) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Batched ``prefill_slot``: N prompts padded to one bucket run as ONE
    set of big matmuls (prompts [N, bucket]). Returns (first sampled token
    per prompt [N], KV blocks {"k","v": [L, N, bucket, H, Dh]}) — row
    ``i`` sliced out is exactly the single-prompt handoff block."""
    n, s = prompts.shape
    cache = init_cache(cfg, n, s, device=prompts.device)
    logits, cache = _forward_cached(params, prompts, cache, cfg)
    rows = torch.arange(n, device=prompts.device)
    last = logits[rows, true_lens - 1]                          # [N, V]
    first = _sample_one(last, seeds, true_lens, temperature, top_k)
    return first, {"k": cache["k"], "v": cache["v"]}


@torch.no_grad()
def generate(params: Params, prompt: torch.Tensor, rng: torch.Tensor, *,
             cfg: GPTConfig, max_new_tokens: int,
             max_len: Optional[int] = None, temperature: float = 1.0,
             top_k: int = 0) -> torch.Tensor:
    """Sample ``max_new_tokens`` continuations for ``prompt`` [B, S] with
    key ``rng`` (``ray_tpu_torch.random.key``): prefill, then one cached
    step per token, token ``i`` drawn with ``split(rng, n)[i]``. Returns
    [B, max_new_tokens] token ids."""
    s = prompt.shape[1]
    max_len = max_len or min(cfg.max_seq, s + max_new_tokens)
    if not s + max_new_tokens <= max_len <= cfg.max_seq:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) must fit "
            f"max_len ({max_len}) <= max_seq ({cfg.max_seq})")
    logits, cache = prefill(params, prompt, cfg, max_len)
    rngs = rnd.split(rng.to(prompt.device), max_new_tokens)
    token = _sample(logits, rngs[0], temperature, top_k)
    out = [token]
    for step_rng in rngs[1:]:
        logits, cache = _forward_cached(params, token[:, None], cache, cfg)
        token = _sample(logits[:, -1], step_rng, temperature, top_k)
        out.append(token)
    return torch.stack(out, dim=1)
