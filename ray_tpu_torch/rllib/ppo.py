"""PPO (port of ``ray_tpu/rllib/ppo.py``).

``PPOLearner`` is the clipped-surrogate update, minibatch SGD over epochs
of a shuffled batch. ``PPO.training_step`` runs the sync loop: weights to
the rollout actors, fragments back, minibatch SGD, metrics. With
``num_learners > 1`` the SGD runs data-parallel across learner actors
through a ``LearnerGroup``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, Learner
from ray_tpu_torch.rllib.learner_group import LearnerGroup
from ray_tpu_torch.rllib.policy import PolicySpec
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, ADVANTAGES, LOGPS, OBS, RETURNS, SampleBatch, concat_batches,
)


@dataclasses.dataclass
class PPOConfig(AlgorithmConfig):
    lam: float = 0.95
    clip_param: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_sgd_epochs: int = 4
    sgd_minibatch_size: int = 128
    num_learners: int = 1  # >1: DP LearnerGroup (reference: learner_group.py)


def entropy_of(logp_all: torch.Tensor) -> torch.Tensor:
    """Mean entropy of the categorical rows of ``logp_all``."""
    return -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))


def logp_of(logp_all: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    return logp_all.gather(1, actions.long()[:, None])[:, 0]


class PPOLearner(Learner):
    """The PPO update (reference: ``ppo_base_learner.py`` loss)."""

    def __init__(self, spec: PolicySpec, config: PPOConfig, *,
                 device: DeviceLike = None):
        clip, vf_c, ent_c = (config.clip_param, config.vf_coeff,
                             config.entropy_coeff)

        def loss_fn(policy, batch):
            logits, values = policy(batch[OBS])
            logp_all = torch.log_softmax(logits, -1)
            logp = logp_of(logp_all, batch[ACTIONS])
            ratio = torch.exp(logp - batch[LOGPS])
            adv = batch[ADVANTAGES]
            # jnp.std: the population std
            adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
            surrogate = torch.minimum(
                ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
            pi_loss = -surrogate.mean()
            vf_loss = torch.mean((values - batch[RETURNS]) ** 2)
            entropy = entropy_of(logp_all)
            total = pi_loss + vf_c * vf_loss - ent_c * entropy
            return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                           "entropy": entropy}

        super().__init__(spec, config, loss_fn, device=device)

    def update_from_batch(self, batch: SampleBatch, *, num_epochs: int,
                          minibatch_size: int,
                          rng: np.random.Generator) -> Dict[str, float]:
        metrics: Dict[str, float] = {}
        mb = min(minibatch_size, batch.count)
        for _ in range(num_epochs):
            shuffled = batch.shuffle(rng)
            for sub in shuffled.minibatches(mb):
                metrics = self.step(sub)
        return metrics


class PPO(Algorithm):
    """The Algorithm (reference: ``ppo.py:83-132``)."""

    def setup(self) -> None:
        config = self.config
        if config.num_learners > 1:
            self.learner = LearnerGroup(
                functools.partial(PPOLearner, self.spec, config,
                                  device=self.device),
                config.num_learners, runtime=self.runtime)
        else:
            self.learner = PPOLearner(self.spec, config, device=self.device)
        self.workers = self._rollout_actors(
            RolloutWorker, config.env_creator, self.spec, gamma=config.gamma,
            lam=config.lam,
            rollout_fragment_length=config.rollout_fragment_length)

    def training_step(self) -> Dict[str, Any]:
        """Sync sample -> learn -> metrics (reference: ``algorithm.py:1309``)."""
        weights = self.learner.get_weights()
        batches = self.runtime.get(
            [w.sample.remote(weights) for w in self.workers])
        batch = concat_batches(batches)
        learn_metrics = self.learner.update_from_batch(
            batch, num_epochs=self.config.num_sgd_epochs,
            minibatch_size=self.config.sgd_minibatch_size,
            rng=self._np_rng)
        return {
            "timesteps_this_iter": batch.count,
            "episode_return_mean": self._mean_returns_from(batches),
            **learn_metrics,
        }

    def stop(self) -> None:
        if isinstance(self.learner, LearnerGroup):
            self.learner.stop()
        super().stop()


PPOConfig._algo_cls = PPO
