"""Flash attention on Hopper (port of ``ray_tpu/ops/flash_attention.py``).

Hand-written CUDA kernels in ``csrc/flash_attention.cu`` replace the three
Pallas TPU kernels. For bf16 all three run on the tensor cores (wgmma fed
by TMA); f32 runs f32 FMAs on the CUDA cores:

- ``FWD`` (``rtt_flash_fwd``) for ``_flash_kernel``: blockwise attention
  with an online softmax; writes O and the per-row logsumexp;
- ``BWD_DQ`` (``rtt_flash_bwd_dq``) for ``_bwd_dq_kernel``: recomputes each
  probability tile from Q, K and the logsumexp and accumulates dQ;
- ``BWD_DKV`` (``rtt_flash_bwd_dkv``) for ``_bwd_dkv_kernel``: accumulates
  dK and dV, one block per k tile, so no atomics.

Each has a plain PyTorch version here (``*_plain``) that repeats the
kernel's arithmetic tile by tile in f32, rounding where the kernel rounds:
for bf16 inputs the forward and dK/dV round each probability tile, and dQ
and dK/dV each dS tile, to bf16 before its product, as the tensor-core
kernels feed them to wgmma. A wrapper (``flash_forward``,
``flash_backward_dq``, ``flash_backward_dkv``) launches the kernel for a
CUDA tensor and takes the plain version only for a CPU tensor. The
``[B, L, H, D]`` <-> ``[BH, L, D]`` transposes stay torch copies
(``_to3``/``_from3``), as XLA did them in the reference; so does
delta = rowsum(dO * O). ``lse`` and ``delta`` are ``[BH, L]`` f32 (the
reference's ``[BH, 1, L]`` without the TPU's unit dimension).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops._kernels import Kernel, stream_handle
from ray_tpu_torch.ops.attention import mha_reference

_NEG_INF = -1e30

# The kernels' tiles, in rows, where they shape a plain version's loop.
F32_TILE = 64          # f32-FMA kernels (f32 K1-K3): q and k tiles
FWD_BF16_BLOCK_K = {64: 128, 128: 64}   # bf16 K1: k tile, by head dim
DKV_BF16_BLOCK_Q = 64  # bf16 K3: q rows of a step
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
FWD = Kernel("flash_attention", "rtt_flash_fwd",
             [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P])
BWD_DQ = Kernel("flash_attention", "rtt_flash_bwd_dq",
                [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                 ctypes.c_float, _I, _P])
BWD_DKV = Kernel("flash_attention", "rtt_flash_bwd_dkv",
                 [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                  ctypes.c_float, _I, _P])
KERNELS = (FWD, BWD_DQ, BWD_DKV)


def reset_launches() -> None:
    for kern in KERNELS:
        kern.launches = 0


# ---------------------------------------------------------------------------
# Plain versions: the kernels' arithmetic in f32, one tile step at a time.
# The thread blocks of a kernel are the vectorised tile dimension here; the
# loop inside a block is the Python loop.


def _operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An f32 tile as the tensor-core kernels hand it to a product: rounded
    to bf16 for bf16 inputs, unchanged for f32 ones."""
    return x.to(dtype).float() if dtype == torch.bfloat16 else x


def _tiles(x: torch.Tensor, tile: int) -> torch.Tensor:
    """[BH, L, ...] -> [BH, ceil(L/tile), tile, ...] in f32, zero-padded."""
    bh, n = x.shape[:2]
    pad = -n % tile
    x = x.float()
    if pad:
        x = torch.cat([x, x.new_zeros((bh, pad) + x.shape[2:])], dim=1)
    return x.reshape(bh, -1, tile, *x.shape[2:])


def _untile(x: torch.Tensor, n: int) -> torch.Tensor:
    """[BH, tiles, tile, ...] -> contiguous [BH, n, ...], as a kernel
    writes it."""
    return x.reshape(x.shape[0], -1, *x.shape[3:])[:, :n].contiguous()


def _positions(n_tiles: int, tile: int, device) -> torch.Tensor:
    """Global row indices of a tiled dimension, [n_tiles, tile]."""
    return torch.arange(n_tiles * tile, device=device).reshape(n_tiles, tile)


def flash_forward_plain(q3, k3, v3, *, scale: float, causal: bool,
                        tile: Optional[int] = None):
    """(O [BH, Lq, D] in q3's dtype, lse [BH, Lq] f32) as ``FWD`` computes
    them: for each k tile, every q tile on or below the diagonal updates its
    running max, denominator and f32 accumulator. ``tile`` defaults to the
    kernel's k tile: for bf16 the probabilities are rounded relative to the
    running max, so where they round depends on it. The denominator sums
    the unrounded probabilities, as the kernel does."""
    lq, lk = q3.shape[1], k3.shape[1]
    if tile is None:
        tile = (FWD_BF16_BLOCK_K.get(q3.shape[-1], F32_TILE)
                if q3.dtype == torch.bfloat16 else F32_TILE)
    q, k, v = _tiles(q3, tile), _tiles(k3, tile), _tiles(v3, tile)
    nq, nk = q.shape[1], k.shape[1]
    rows = _positions(nq, tile, q.device)[:, :, None]     # [nq, T, 1]
    m = q.new_full(q.shape[:3], _NEG_INF)
    l = q.new_zeros(q.shape[:3])
    acc = torch.zeros_like(q)
    for j in range(nk):
        lo = j if causal else 0          # q tiles whose loop reaches tile j
        cols = j * tile + torch.arange(tile, device=q.device)
        s = torch.einsum("bitd,bsd->bits", q[:, lo:], k[:, j]) * scale
        if causal:
            s = s.masked_fill(cols > rows[lo:], _NEG_INF)
        s = s.masked_fill(cols >= lk, float("-inf"))
        m_new = torch.maximum(m[:, lo:], s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m[:, lo:] - m_new)
        l[:, lo:] = l[:, lo:] * corr + p.sum(-1)
        acc[:, lo:] = (acc[:, lo:] * corr[..., None]
                       + torch.einsum("bits,bsd->bitd",
                                      _operand(p, q3.dtype), v[:, j]))
        m[:, lo:] = m_new
    denom = l.clamp_min(1e-30)
    o = _untile(acc / denom[..., None], lq).to(q3.dtype)
    lse = _untile(m + torch.log(denom), lq)
    return o, lse


def flash_backward_dq_plain(q3, k3, v3, do3, lse, delta, *, scale: float,
                            causal: bool, tile: int = F32_TILE):
    """dQ [BH, Lq, D] in q3's dtype as ``BWD_DQ`` computes it: for each k
    tile, every q tile on or below the diagonal recomputes P from the
    logsumexp and adds dS K. For bf16, dS is rounded to bf16 before that
    product. P is relative to the logsumexp, not to a running max, so
    ``tile`` only orders the sum."""
    lq, lk = q3.shape[1], k3.shape[1]
    q, k, v, do = (_tiles(x, tile) for x in (q3, k3, v3, do3))
    lse_t, delta_t = _tiles(lse, tile), _tiles(delta, tile)
    nq, nk = q.shape[1], k.shape[1]
    rows = _positions(nq, tile, q.device)[:, :, None]
    dq = torch.zeros_like(q)
    for j in range(nk):
        lo = j if causal else 0
        cols = j * tile + torch.arange(tile, device=q.device)
        s = torch.einsum("bitd,bsd->bits", q[:, lo:], k[:, j]) * scale
        if causal:
            s = s.masked_fill(cols > rows[lo:], _NEG_INF)
        p = torch.exp(s - lse_t[:, lo:, :, None])
        p = p.masked_fill(cols >= lk, 0.0)
        dp = torch.einsum("bitd,bsd->bits", do[:, lo:], v[:, j])
        ds = p * (dp - delta_t[:, lo:, :, None]) * scale
        dq[:, lo:] += torch.einsum("bits,bsd->bitd", _operand(ds, q3.dtype),
                                   k[:, j])
    return _untile(dq, lq).to(q3.dtype)


def flash_backward_dkv_plain(q3, k3, v3, do3, lse, delta, *, scale: float,
                             causal: bool, tile: Optional[int] = None):
    """(dK, dV) [BH, Lk, D] in k3's/v3's dtype as ``BWD_DKV`` computes
    them: for each q tile, every k tile on or left of the diagonal
    accumulates P^T dO and dS^T Q. For bf16, P and dS are rounded to bf16
    before those products (dS is computed from the unrounded P). ``tile``
    defaults to the kernel's q step."""
    lq, lk = q3.shape[1], k3.shape[1]
    if tile is None:
        tile = DKV_BF16_BLOCK_Q if q3.dtype == torch.bfloat16 else F32_TILE
    q, k, v, do = (_tiles(x, tile) for x in (q3, k3, v3, do3))
    lse_t, delta_t = _tiles(lse, tile), _tiles(delta, tile)
    nq, nk = q.shape[1], k.shape[1]
    cols = _positions(nk, tile, q.device)[:, None, :]    # [nk, 1, T]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for i in range(nq):
        hi = min(i + 1, nk) if causal else nk   # k tiles whose loop reaches i
        rows = i * tile + torch.arange(tile, device=q.device)[:, None]
        s = torch.einsum("btd,bjsd->bjts", q[:, i], k[:, :hi]) * scale
        if causal:
            s = s.masked_fill(cols[:hi] > rows, _NEG_INF)
        p = torch.exp(s - lse_t[:, i, None, :, None])
        p = p.masked_fill((rows >= lq) | (cols[:hi] >= lk), 0.0)
        dv[:, :hi] += torch.einsum("bjts,btd->bjsd", _operand(p, q3.dtype),
                                   do[:, i])
        dp = torch.einsum("btd,bjsd->bjts", do[:, i], v[:, :hi])
        ds = p * (dp - delta_t[:, i, None, :, None]) * scale
        dk[:, :hi] += torch.einsum("bjts,btd->bjsd", _operand(ds, q3.dtype),
                                   q[:, i])
    return _untile(dk, lk).to(k3.dtype), _untile(dv, lk).to(v3.dtype)


# ---------------------------------------------------------------------------
# Wrappers: the kernel for a CUDA tensor, the plain version for a CPU one.


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"flash attention: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"flash attention runs on cuda or cpu, not {dev}")


def _check_cuda(seqs, rows) -> int:
    """Validate the operands of a kernel launch; return the dtype code.
    ``seqs``: [BH, L, D] tensors of one dtype; ``rows``: f32 [BH, L]."""
    ref = seqs[0]
    if ref.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention kernels take f32 or bf16, not "
                        f"{ref.dtype}")
    bh, _, d = ref.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim in "
                         f"{HEAD_DIMS}, not {d}")
    if not 0 < bh < 65536:
        raise ValueError(f"batch*heads {bh} out of range")
    for t in seqs:
        if t.dtype != ref.dtype or t.dim() != 3 or t.shape[0] != bh \
                or t.shape[2] != d:
            raise ValueError(f"flash attention: expected [{bh}, L, {d}] "
                             f"{ref.dtype}, got {tuple(t.shape)} {t.dtype}")
    for t in rows:
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != bh:
            raise ValueError(f"flash attention: expected f32 [{bh}, L], got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in (*seqs, *rows):
        if not t.is_contiguous():
            raise ValueError("flash attention kernels take contiguous tensors")
    return _DTYPE_CODES[ref.dtype]


def flash_forward(q3, k3, v3, *, scale: float, causal: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O [BH, Lq, D], lse [BH, Lq] f32) for q3/k3/v3 [BH, L, D]."""
    if _on_cpu(q3, k3, v3):
        return flash_forward_plain(q3, k3, v3, scale=scale, causal=causal)
    code = _check_cuda((q3, k3, v3), ())
    bh, lq, d = q3.shape
    lk = k3.shape[1]
    if causal and lq != lk:
        raise ValueError("causal flash attention needs lq == lk")
    o3 = torch.empty_like(q3)
    lse = torch.empty((bh, lq), dtype=torch.float32, device=q3.device)
    with torch.cuda.device(q3.device):
        FWD(code, d, q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
            o3.data_ptr(), lse.data_ptr(), bh, lq, lk, scale, int(causal),
            stream_handle(q3.device))
    return o3, lse


def flash_backward_dq(q3, k3, v3, do3, lse, delta, *, scale: float,
                      causal: bool) -> torch.Tensor:
    """dQ [BH, Lq, D]; lse and delta are f32 [BH, Lq]."""
    if _on_cpu(q3, k3, v3, do3, lse, delta):
        return flash_backward_dq_plain(q3, k3, v3, do3, lse, delta,
                                       scale=scale, causal=causal)
    code = _check_cuda((q3, k3, v3, do3), (lse, delta))
    bh, lq, d = q3.shape
    dq3 = torch.empty_like(q3)
    with torch.cuda.device(q3.device):
        BWD_DQ(code, d, q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
               do3.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               dq3.data_ptr(), bh, lq, k3.shape[1], scale, int(causal),
               stream_handle(q3.device))
    return dq3


def flash_backward_dkv(q3, k3, v3, do3, lse, delta, *, scale: float,
                       causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [BH, Lk, D]; lse and delta are f32 [BH, Lq]."""
    if _on_cpu(q3, k3, v3, do3, lse, delta):
        return flash_backward_dkv_plain(q3, k3, v3, do3, lse, delta,
                                        scale=scale, causal=causal)
    code = _check_cuda((q3, k3, v3, do3), (lse, delta))
    bh, lq, d = q3.shape
    dk3, dv3 = torch.empty_like(k3), torch.empty_like(v3)
    with torch.cuda.device(q3.device):
        BWD_DKV(code, d, q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                do3.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dk3.data_ptr(), dv3.data_ptr(), bh, lq, k3.shape[1], scale,
                int(causal), stream_handle(q3.device))
    return dk3, dv3


# ---------------------------------------------------------------------------
# The differentiable op on [B, L, H, D].


def _to3(x: torch.Tensor) -> torch.Tensor:
    b, l, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, l, d).contiguous()


def _from3(x3: torch.Tensor, b: int, h: int) -> torch.Tensor:
    _, l, d = x3.shape
    return x3.reshape(b, h, l, d).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, o, lse) as the reference's custom VJP does;
    backward computes delta with a torch op, then launches dQ and dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        b, _, h, d = q.shape
        scale = d ** -0.5
        o3, lse = flash_forward(_to3(q), _to3(k), _to3(v), scale=scale,
                                causal=causal)
        ctx.save_for_backward(q, k, v, o3, lse)
        ctx.causal = causal
        return _from3(o3, b, h)

    @staticmethod
    def backward(ctx, g):
        q, k, v, o3, lse = ctx.saved_tensors
        b, _, h, d = q.shape
        scale = d ** -0.5
        do3 = _to3(g.to(q.dtype))
        # delta_i = sum_d dO_i * O_i: a cheap rowwise reduce, left to torch.
        delta = (do3.float() * o3.float()).sum(-1)
        q3, k3, v3 = _to3(q), _to3(k), _to3(v)
        dq3 = flash_backward_dq(q3, k3, v3, do3, lse, delta, scale=scale,
                                causal=ctx.causal)
        dk3, dv3 = flash_backward_dkv(q3, k3, v3, do3, lse, delta,
                                      scale=scale, causal=ctx.causal)
        return _from3(dq3, b, h), _from3(dk3, b, h), _from3(dv3, b, h), None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Flash attention on [B, L, H, D]; takes the reference when the shapes
    don't tile by the blocks (the reference's rule, kept as it is: the
    blocks choose the path; the kernels tile as they need, any length)."""
    lq, lk = q.shape[1], k.shape[1]
    block_q = min(block_q, lq)
    block_k = min(block_k, lk)
    if (lq % block_q or lk % block_k
            or (causal and (block_q != block_k or lq != lk))):
        return mha_reference(q, k, v, causal=causal)
    return _FlashAttention.apply(q, k, v, causal)
