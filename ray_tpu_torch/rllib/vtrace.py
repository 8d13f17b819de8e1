"""V-trace off-policy correction (port of ``ray_tpu/rllib/vtrace.py``;
Espeholt et al. 2018, "IMPALA: Scalable Distributed Deep-RL").

The reference's reverse ``lax.scan`` over time is a reverse loop over T,
with each step's arithmetic in the reference's order. Its
``stop_gradient`` on the outputs is ``torch.no_grad`` over the whole
computation: the outputs are targets and carry no gradient. Arrays are
time-major ``[T]`` (one rollout fragment) or ``[T, B]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class VTraceReturns(NamedTuple):
    vs: torch.Tensor             # V-trace value targets for V(x_t)
    pg_advantages: torch.Tensor  # policy-gradient advantages


@torch.no_grad()
def vtrace(
    behavior_logp: torch.Tensor,
    target_logp: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    next_values: torch.Tensor,
    discounts: torch.Tensor,
    clip_rho_threshold: float = 1.0,
    clip_c_threshold: float = 1.0,
) -> VTraceReturns:
    """Compute V-trace targets for one time-major sequence.

    Args:
        behavior_logp: log pi_b(a_t|x_t) under the sampling policy.
        target_logp: log pi(a_t|x_t) under the learner policy.
        rewards: r_t.
        values: V(x_t) under the learner's value head.
        next_values: V(x_{t+1}); the final entry is the bootstrap value.
        discounts: gamma * (1 - done_t) — 0 at terminal steps.
        clip_rho_threshold: rho-bar; bounds the value-target correction.
        clip_c_threshold: c-bar; bounds the trace cutting in the backward
            recursion.
    """
    rhos = torch.exp(target_logp - behavior_logp)
    clipped_rhos = torch.clamp(rhos, max=clip_rho_threshold)
    cs = torch.clamp(rhos, max=clip_c_threshold)
    deltas = clipped_rhos * (rewards + discounts * next_values - values)
    decay = discounts * cs

    acc = torch.zeros_like(deltas[-1])
    vs_minus_v = []
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + decay[t] * acc
        vs_minus_v.append(acc)
    vs = values + torch.stack(vs_minus_v[::-1])

    # vs_{t+1}: shift forward; at the sequence end fall back to the
    # bootstrap value (next_values[-1]).
    vs_next = torch.cat([vs[1:], next_values[-1:]], dim=0)
    pg_advantages = clipped_rhos * (rewards + discounts * vs_next - values)
    return VTraceReturns(vs=vs, pg_advantages=pg_advantages)
