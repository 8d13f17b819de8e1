"""Ape-X DQN's parts that run in-process (port of ``ray_tpu/rllib/apex.py``
:28-146 and :236-306): the config, one prioritized replay shard (numpy,
the port's own copy), the worker's TD-error priorities, and the
importance-weighted update.

The reference keeps the weighted update on the ``ApexDQN`` algorithm;
here it is ``ApexDQNLearner.weighted_update``, since the algorithm (shard
and worker actors, overlapped sampling) waits for the runtime seam. Until
then ``_ApexWorker`` stores into shards that are in-process objects.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import (
    Tensors, backward, floats, to_device,
)
from ray_tpu_torch.rllib.dqn import (
    DQNConfig, DQNLearner, _DQNRolloutWorker, huber, td_errors,
)
from ray_tpu_torch.rllib.policy import PolicySpec


@dataclasses.dataclass
class ApexDQNConfig(DQNConfig):
    num_replay_shards: int = 2
    prioritized_replay_alpha: float = 0.6
    prioritized_replay_beta: float = 0.4
    prioritized_replay_eps: float = 1e-6


class _ReplayShard:
    """One prioritized replay shard. Sampling probability is p_i^alpha /
    sum p^alpha; importance weights (N * P(i))^-beta are returned
    normalized by their max (reference: prioritized_replay_buffer.py)."""

    def __init__(self, capacity: int, obs_dim: int, alpha: float,
                 eps: float, seed: int):
        self.capacity = capacity
        self.alpha = alpha
        self.eps = eps
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity,), np.int32)
        self.rewards = np.zeros((capacity,), np.float32)
        self.dones = np.zeros((capacity,), np.float32)
        self.prios = np.zeros((capacity,), np.float64)
        self._next = 0
        self.size = 0
        self._rng = np.random.default_rng(seed)

    def add_batch(self, batch: Dict[str, Any],
                  priorities: Optional[np.ndarray] = None) -> int:
        n = len(batch["actions"])
        if priorities is None:
            # New experience gets max priority: every transition is
            # replayed at least ~once before priorities take over.
            mx = float(self.prios[:self.size].max()) if self.size else 1.0
            priorities = np.full(n, mx)
        for i in range(n):
            j = self._next
            self.obs[j] = batch["obs"][i]
            self.actions[j] = batch["actions"][i]
            self.rewards[j] = batch["rewards"][i]
            self.next_obs[j] = batch["next_obs"][i]
            self.dones[j] = batch["dones"][i]
            self.prios[j] = max(float(priorities[i]), self.eps)
            self._next = (self._next + 1) % self.capacity
            self.size = min(self.size + 1, self.capacity)
        return self.size

    def sample(self, n: int, beta: float):
        if self.size == 0:
            return None
        n = min(n, self.size)
        p = self.prios[:self.size] ** self.alpha
        p = p / p.sum()
        idx = self._rng.choice(self.size, size=n, p=p)
        w = (self.size * p[idx]) ** (-beta)
        w = (w / w.max()).astype(np.float32)
        return ({"obs": self.obs[idx], "actions": self.actions[idx],
                 "rewards": self.rewards[idx],
                 "next_obs": self.next_obs[idx],
                 "dones": self.dones[idx], "weights": w},
                idx.astype(np.int64))

    def update_priorities(self, idx: np.ndarray,
                          prios: np.ndarray) -> bool:
        self.prios[idx] = np.maximum(np.abs(prios), self.eps)
        return True

    def stats(self) -> Dict[str, float]:
        live = self.prios[:self.size]
        return {"size": self.size,
                "prio_mean": float(live.mean()) if self.size else 0.0,
                "prio_max": float(live.max()) if self.size else 0.0}


class _ApexWorker(_DQNRolloutWorker):
    """Rollout worker that stores its experience straight into a replay
    shard, with initial priorities from the online net's TD errors."""

    def __init__(self, env_creator, spec: PolicySpec, shards: List[Any],
                 *, gamma: float, rollout_fragment_length: int = 100,
                 seed: int = 0, device=None):
        super().__init__(env_creator, spec,
                         rollout_fragment_length=rollout_fragment_length,
                         seed=seed, device=device)
        self.gamma = gamma
        self._shards = shards
        self._shard_rr = seed

    @torch.no_grad()
    def td_error(self, batch: Dict[str, Any]) -> np.ndarray:
        """|TD| of each transition under the worker's current weights, the
        target taken from the same (online) net."""
        b = to_device({k: batch[k] for k in ("obs", "actions", "rewards",
                                             "next_obs", "dones")},
                      self.device)
        q_sel = self.policy(b["obs"])[0].gather(
            1, b["actions"].long()[:, None])[:, 0]
        q_next = self.policy(b["next_obs"])[0]
        target = b["rewards"] + self.gamma * (1.0 - b["dones"]) * \
            torch.max(q_next, dim=1).values
        return torch.abs(q_sel - target).cpu().numpy()

    def sample_and_store(self, weights: Tensors,
                         epsilon: float) -> Dict[str, Any]:
        batch = self.sample(weights, epsilon)
        returns = batch.pop("completed_returns")
        prios = self.td_error(batch)
        shard = self._shards[self._shard_rr % len(self._shards)]
        self._shard_rr += 1
        shard.add_batch(batch, prios)
        return {"steps": len(batch["actions"]),
                "completed_returns": returns}


class ApexDQNLearner(DQNLearner):
    """A DQN learner with Ape-X's importance-weighted update."""

    def weighted_update(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """One importance-weighted double-DQN TD update: the weights
        multiply the per-sample Huber loss (the PER correction). Returns the
        metrics plus each sample's |TD| under ``"_td_abs"``, the new
        priorities."""
        b = to_device(batch, self.device)
        q_sel, td = td_errors(self.policy, self.target, b, self.gamma,
                              self.double_q)
        loss = torch.mean(b["weights"] * huber(td))
        backward(loss, self.policy)
        self.optimizer.step()
        self._count_update()
        out = floats({"loss": loss, "q_mean": torch.mean(q_sel)})
        out["_td_abs"] = torch.abs(td).detach().cpu().numpy()
        return out
