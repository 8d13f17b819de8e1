"""Attention ops (port of ``ray_tpu/ops/attention.py``): reference MHA and
ring attention (context parallelism).

Ring attention is blockwise attention over a sequence-sharded mesh dim:
each rank holds a contiguous sequence shard of Q/K/V; the K/V shards
rotate around the ring (``collective.ppermute``) while each rank
accumulates its queries' attention with an online softmax in f32. After
``axis_size`` steps every query has attended to the whole sequence and no
rank ever held all of K/V. The reference computes it with einsums, not a
Pallas kernel, so plain torch products are its port.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

_NEG_INF = -1e30  # big-but-finite so exp() underflows cleanly, no NaN via inf-inf


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain einsum multi-head attention. Shapes [B, L, H, D]; the softmax
    runs in f32 and the probabilities are cast back to ``v``'s dtype."""
    lq, _, d = q.shape[-3:]
    lk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qi = torch.arange(lq, device=q.device)[:, None]
        kj = torch.arange(lk, device=q.device)[None, :]
        logits = logits.masked_fill(kj > qi, _NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _block_attn_accum(q, k, v, carry, q_offset, k_offset, scale, causal):
    """One blockwise-attention accumulation step (online softmax).

    carry = (numerator [B,Lq,H,D] f32, denominator [B,H,Lq] f32, running
    max [B,H,Lq] f32); offsets are *global* sequence positions of the first
    query / key row, used for causal masking across ring steps. The
    products take the operands' values exactly and sum in f32 (the
    reference's ``preferred_element_type=float32``)."""
    num, den, m = carry
    lq, lk = q.shape[1], k.shape[1]

    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qi = q_offset + torch.arange(lq, device=q.device)[:, None]
        kj = k_offset + torch.arange(lk, device=q.device)[None, :]
        s = s.masked_fill(kj > qi, _NEG_INF)

    m_new = torch.maximum(m, s.amax(-1))                 # [B,H,Lq]
    # Rescale previous accumulators to the new max.
    alpha = torch.exp(m - m_new)                         # [B,H,Lq]
    p = torch.exp(s - m_new[..., None])                  # [B,H,Lq,Lk]
    num = num * alpha.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v.float())
    den = den * alpha + p.sum(-1)
    return num, den, m_new


def _accum_init(q):
    b, l, h, d = q.shape
    return (torch.zeros((b, l, h, d), dtype=torch.float32, device=q.device),
            torch.zeros((b, h, l), dtype=torch.float32, device=q.device),
            torch.full((b, h, l), _NEG_INF, dtype=torch.float32,
                       device=q.device))


def _finish(num, den, dtype):
    return (num / den.transpose(1, 2)[..., None]).to(dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh_dim,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ring attention body: call it on every rank of ``mesh_dim`` (a 1-D
    ``DeviceMesh`` slice, the reference's ``axis_name``) with the sequence
    sharded over it, as inside ``collective.shard_map_compat``. Shapes are
    per-shard [B, L/N, H, D]."""
    from ray_tpu_torch.parallel.collective import ppermute

    l_shard = q.shape[1]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    axis_size = mesh_dim.size()
    my_idx = mesh_dim.get_local_rank()
    # Ring: shard s moves to rank (s+1); after step t this rank holds the
    # K/V shard first held by (my_idx - t) mod N. The reference also
    # rotates after the last step and drops the result; that rotation is
    # left out.
    perm = [(i, (i + 1) % axis_size) for i in range(axis_size)]
    acc = _accum_init(q)
    for t in range(axis_size):
        src = (my_idx - t) % axis_size
        acc = _block_attn_accum(q, k, v, acc, my_idx * l_shard,
                                src * l_shard, scale, causal)
        if t < axis_size - 1:
            k, v = ppermute(k, perm, mesh_dim), ppermute(v, perm, mesh_dim)
    num, den, _ = acc
    return _finish(num, den, q.dtype)


def ring_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    axis_name: str = "sp",
    causal: bool = False,
):
    """Top-level entry: shard [B, L, H, D] inputs (plain tensors with the
    same value on every rank, or DTensors) over ``axis_name`` on the
    sequence dim and run ring attention; a DTensor comes back. L must
    divide evenly by the axis size. Collective over the mesh."""
    from ray_tpu_torch.parallel.collective import shard_map_compat
    from ray_tpu_torch.parallel.sharding import PartitionSpec as P

    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    if q.shape[1] % n:
        raise ValueError(
            f"sequence length {q.shape[1]} not divisible by {axis_name}={n}")
    spec = P(None, axis_name, None, None)
    fn = shard_map_compat(
        functools.partial(ring_attention, mesh_dim=mesh[axis_name],
                          causal=causal),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)
