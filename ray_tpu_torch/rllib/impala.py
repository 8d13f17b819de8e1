"""IMPALA's config and learner (port of ``ray_tpu/rllib/impala.py``
:25-78): the V-trace actor-critic update over one time-major fragment. The
``IMPALA`` algorithm (asynchronous sampling through ``wait``) waits for the
runtime seam.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ray_tpu_torch.device import DeviceLike
from ray_tpu_torch.rllib.algorithm import AlgorithmConfig, Learner
from ray_tpu_torch.rllib.policy import PolicySpec
from ray_tpu_torch.rllib.ppo import entropy_of, logp_of
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, DONES, LOGPS, NEXT_VALUES, OBS, REWARDS, SampleBatch,
)
from ray_tpu_torch.rllib.vtrace import vtrace


@dataclasses.dataclass
class IMPALAConfig(AlgorithmConfig):
    lr: float = 6e-4
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    clip_rho_threshold: float = 1.0
    clip_c_threshold: float = 1.0
    # max fragments consumed per training_step (bounds iteration latency)
    max_fragments_per_step: int = 8


class IMPALALearner(Learner):
    """V-trace actor-critic update over one time-major fragment."""

    def __init__(self, spec: PolicySpec, config: IMPALAConfig, *,
                 device: DeviceLike = None):
        gamma = config.gamma
        vf_c, ent_c = config.vf_coeff, config.entropy_coeff
        rho_bar, c_bar = config.clip_rho_threshold, config.clip_c_threshold

        def loss_fn(policy, batch):
            logits, values = policy(batch[OBS])
            logp_all = torch.log_softmax(logits, -1)
            target_logp = logp_of(logp_all, batch[ACTIONS])
            discounts = gamma * (1.0 - batch[DONES].float())
            # Learner values at t; t+1 uses the learner's own estimates
            # shifted one step, with the sampler's bootstrap at the tail
            # (the one value not recomputable from the fragment's obs).
            next_values = torch.cat([values[1:], batch[NEXT_VALUES][-1:]])
            vt = vtrace(
                behavior_logp=batch[LOGPS], target_logp=target_logp,
                rewards=batch[REWARDS], values=values,
                next_values=next_values, discounts=discounts,
                clip_rho_threshold=rho_bar, clip_c_threshold=c_bar)
            pi_loss = -torch.mean(target_logp * vt.pg_advantages)
            vf_loss = 0.5 * torch.mean((vt.vs - values) ** 2)
            entropy = entropy_of(logp_all)
            total = pi_loss + vf_c * vf_loss - ent_c * entropy
            return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                           "entropy": entropy}

        super().__init__(spec, config, loss_fn, device=device)

    def update_from_fragment(self, batch: SampleBatch) -> Dict[str, float]:
        return self.step(batch)
