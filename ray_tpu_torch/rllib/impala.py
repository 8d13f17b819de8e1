"""IMPALA (port of ``ray_tpu/rllib/impala.py``): sampling decoupled from
learning, with V-trace's off-policy correction (Espeholt et al. 2018).

``IMPALALearner`` is the V-trace actor-critic update over one time-major
fragment. ``IMPALA.training_step`` keeps one sample task in flight per
rollout actor, consumes fragments through ``wait`` as they are ready, and
resubmits each actor with the fresh weights at once; the policy lag this
allows is what V-trace corrects.

How much an iteration consumes depends on the runtime. On the ``ray_tpu``
runtime it blocks for the first fragment, then takes only those already
finished, up to ``max_fragments_per_step``. On the in-process
``LocalRuntime`` every task samples when it is submitted, so every
fragment is ready and an iteration consumes ``max_fragments_per_step``
fragments, round robin over the actors, each sampled with the weights of
the update before it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ray_tpu_torch.device import DeviceLike
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, Learner
from ray_tpu_torch.rllib.policy import PolicySpec
from ray_tpu_torch.rllib.ppo import entropy_of, logp_of
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
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


class IMPALA(Algorithm):
    """Async actor-learner loop (reference: ``impala.py:81-146``): sample
    results are consumed as they complete, not barriered."""

    def setup(self) -> None:
        config = self.config
        self.learner = IMPALALearner(self.spec, config, device=self.device)
        self.workers = self._rollout_actors(
            RolloutWorker, config.env_creator, self.spec, gamma=config.gamma,
            lam=0.0,  # GAE unused by V-trace; keep fields cheap
            rollout_fragment_length=config.rollout_fragment_length)
        # ref -> worker for the continuously in-flight sample tasks
        self._inflight: Dict[Any, Any] = {}

    def _submit(self, worker) -> None:
        ref = worker.sample.remote(self.learner.get_weights())
        self._inflight[ref] = worker

    def training_step(self) -> Dict[str, Any]:
        rt = self.runtime
        if not self._inflight:
            for w in self.workers:
                self._submit(w)

        steps = 0
        learn_metrics: Dict[str, float] = {}
        consumed = 0
        fragments = []
        while consumed < self.config.max_fragments_per_step:
            # Block for the first fragment; afterwards only drain what is
            # already done so the iteration doesn't barrier on stragglers.
            timeout = None if consumed == 0 else 0
            ready, _ = rt.wait(list(self._inflight), num_returns=1,
                               timeout=timeout)
            if not ready:
                break
            ref = ready[0]
            worker = self._inflight.pop(ref)
            fragment = rt.get(ref)
            learn_metrics = self.learner.update_from_fragment(fragment)
            steps += fragment.count
            consumed += 1
            fragments.append(fragment)
            self._submit(worker)  # resample with fresh weights immediately

        return {
            "timesteps_this_iter": steps,
            "fragments_this_iter": consumed,
            # from the consumed fragments only: never a blocking call
            # behind the freshly resubmitted sample tasks
            "episode_return_mean": self._mean_returns_from(fragments),
            **learn_metrics,
        }

    def stop(self) -> None:
        self._inflight.clear()
        super().stop()


IMPALAConfig._algo_cls = IMPALA
