"""Trajectory batch container: the port's own copy of
``ray_tpu/rllib/sample_batch.py`` (numpy, unchanged). SampleBatch is a dict
of parallel arrays keyed by standard field names; ``compute_gae`` is
generalized advantage estimation over one rollout segment."""

from __future__ import annotations

from typing import List

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
LOGPS = "action_logp"
VALUES = "values"
ADVANTAGES = "advantages"
RETURNS = "value_targets"
NEXT_VALUES = "next_values"  # V(s_{t+1}) under behavior params; tail entry
                             # is the fragment's bootstrap value


class SampleBatch(dict):
    """dict[str, np.ndarray] with equal first dims."""

    @property
    def count(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    def shuffle(self, rng: np.random.Generator) -> "SampleBatch":
        order = rng.permutation(self.count)
        return SampleBatch({k: v[order] for k, v in self.items()})

    def minibatches(self, size: int):
        n = self.count
        for i in range(0, n - size + 1, size):
            yield SampleBatch({k: v[i:i + size] for k, v in self.items()})


def concat_batches(batches: List[SampleBatch]) -> SampleBatch:
    keys = batches[0].keys()
    return SampleBatch({k: np.concatenate([b[k] for b in batches])
                        for k in keys})


def compute_gae(rewards: np.ndarray, values: np.ndarray, dones: np.ndarray,
                last_value: float, gamma: float, lam: float):
    """Generalized advantage estimation over one rollout segment
    (reference: ``rllib/evaluation/postprocessing.py`` compute_advantages)."""
    n = len(rewards)
    adv = np.zeros(n, np.float32)
    gae = 0.0
    next_value = last_value
    for t in range(n - 1, -1, -1):
        nonterminal = 1.0 - float(dones[t])
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        gae = delta + gamma * lam * nonterminal * gae
        adv[t] = gae
        next_value = values[t]
    returns = adv + values
    return adv, returns
