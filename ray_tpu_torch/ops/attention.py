"""Reference multi-head attention (port of ``ray_tpu/ops/attention.py``).

Only ``mha_reference``: ring attention needs the collectives of a later
slice.
"""

from __future__ import annotations

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
