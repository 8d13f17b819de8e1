"""A2C's config and learner (port of ``ray_tpu/rllib/a2c.py`` :23-97):
synchronous advantage actor-critic, one gradient step on the joint batch.
The ``A2C`` algorithm waits for the runtime seam.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike
from ray_tpu_torch.rllib.algorithm import AlgorithmConfig, Learner
from ray_tpu_torch.rllib.policy import PolicySpec
from ray_tpu_torch.rllib.ppo import entropy_of, logp_of
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, ADVANTAGES, OBS, RETURNS, SampleBatch,
)


@dataclasses.dataclass
class A2CConfig(AlgorithmConfig):
    lam: float = 1.0          # plain n-step returns by default
    lr: float = 1e-3
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    microbatch_size: int = 0  # 0 = single step on the whole batch


class A2CLearner(Learner):
    """Vanilla policy-gradient + value update."""

    def __init__(self, spec: PolicySpec, config: A2CConfig, *,
                 device: DeviceLike = None):
        vf_c, ent_c = config.vf_coeff, config.entropy_coeff

        def loss_fn(policy, batch):
            logits, values = policy(batch[OBS])
            logp_all = torch.log_softmax(logits, -1)
            logp = logp_of(logp_all, batch[ACTIONS])
            # Advantages arrive normalized over the FULL train batch
            # (update_from_batch), so microbatched gradient accumulation is
            # exactly a full-batch step.
            pi_loss = -torch.mean(logp * batch[ADVANTAGES])
            vf_loss = torch.mean((values - batch[RETURNS]) ** 2)
            entropy = entropy_of(logp_all)
            total = pi_loss + vf_c * vf_loss - ent_c * entropy
            return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                           "entropy": entropy}

        super().__init__(spec, config, loss_fn, device=device)

    def update_from_batch(self, batch: SampleBatch,
                          microbatch_size: int = 0) -> Dict[str, float]:
        # Normalize advantages ONCE over the full train batch (numpy, as
        # the reference) so microbatch_size is a pure memory knob.
        adv = np.asarray(batch[ADVANTAGES], np.float32)
        batch = SampleBatch({**dict(batch),
                             ADVANTAGES: (adv - adv.mean())
                             / (adv.std() + 1e-8)})
        n = batch.count
        if not microbatch_size or microbatch_size >= n:
            return self.step(batch)
        # Reference semantics (a2c.py training_step): accumulate the
        # gradients of sequential microbatches, ragged tail included, each
        # weighted by its size, then ONE optimizer step on their mean.
        acc: Dict[str, torch.Tensor] = {}
        metric_sums: Dict[str, float] = {}
        total = 0
        for i in range(0, n, microbatch_size):
            sub = SampleBatch(
                {k: v[i:i + microbatch_size] for k, v in batch.items()})
            grads, aux = self.compute_grads(sub)
            w = sub.count
            for name, g in grads.items():
                acc[name] = w * g if name not in acc else acc[name] + w * g
            for k, val in aux.items():
                metric_sums[k] = metric_sums.get(k, 0.0) + w * val
            total += w
        self.apply_grads({name: g / total for name, g in acc.items()})
        return {k: s / total for k, s in metric_sums.items()}
