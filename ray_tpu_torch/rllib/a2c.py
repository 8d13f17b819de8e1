"""A2C (port of ``ray_tpu/rllib/a2c.py``): synchronous advantage
actor-critic. ``A2C.training_step`` gathers GAE fragments from every
rollout actor and takes one gradient step on the joint batch, so the batch
is exactly on-policy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, Learner
from ray_tpu_torch.rllib.policy import PolicySpec
from ray_tpu_torch.rllib.ppo import entropy_of, logp_of
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, ADVANTAGES, OBS, RETURNS, SampleBatch, concat_batches,
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


class A2C(Algorithm):
    """The Algorithm (reference: ``a2c.py:100-131``)."""

    def setup(self) -> None:
        config = self.config
        self.learner = A2CLearner(self.spec, config, device=self.device)
        self.workers = self._rollout_actors(
            RolloutWorker, config.env_creator, self.spec, gamma=config.gamma,
            lam=config.lam,
            rollout_fragment_length=config.rollout_fragment_length)

    def training_step(self) -> Dict[str, Any]:
        weights = self.learner.get_weights()
        batches = self.runtime.get(
            [w.sample.remote(weights) for w in self.workers])
        batch = concat_batches(batches)
        learn_metrics = self.learner.update_from_batch(
            batch, self.config.microbatch_size)
        return {
            "timesteps_this_iter": batch.count,
            "episode_return_mean": self._mean_returns_from(batches),
            **learn_metrics,
        }


A2CConfig._algo_cls = A2C
