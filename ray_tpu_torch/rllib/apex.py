"""Ape-X DQN: distributed prioritized replay (port of
``ray_tpu/rllib/apex.py``; reference: ``rllib/algorithms/apex_dqn``).

Replay shards are actors; rollout workers push their experience straight
into a shard (``shard.add_batch.remote``, no driver hop) with initial
priorities from their own TD errors; the learner samples the shards in
turn, takes importance-weighted double-DQN updates and sends the new
priorities back fire-and-forget. Sampling overlaps learning: one
``sample_and_store`` task per worker stays in flight across iterations
and is resubmitted with fresh weights as it completes.

The reference keeps the weighted update on the ``ApexDQN`` algorithm;
here it is ``ApexDQNLearner.weighted_update``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import (
    Algorithm, Tensors, backward, floats, to_device,
)
from ray_tpu_torch.rllib.dqn import (
    DQNConfig, DQNLearner, _DQNRolloutWorker, epsilon, huber, td_errors,
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
        # Fire-and-forget into the shard; the ref resolves shard-side.
        shard.add_batch.remote(batch, prios)
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


class ApexDQN(Algorithm):
    """Distributed prioritized-replay DQN (reference: ``apex.py:148-306``):
    overlapped sample/store/train with priority feedback."""

    def setup(self) -> None:
        config = self.config
        self.learner = ApexDQNLearner(self.spec, config, device=self.device)
        shard_cls = self.runtime.remote(_ReplayShard)
        self.replay_shards = [
            shard_cls.options(num_cpus=0).remote(
                config.buffer_size // config.num_replay_shards,
                config.obs_dim, config.prioritized_replay_alpha,
                config.prioritized_replay_eps, config.seed + 31 * i)
            for i in range(config.num_replay_shards)
        ]
        self.workers = self._rollout_actors(
            _ApexWorker, config.env_creator, self.spec, self.replay_shards,
            gamma=config.gamma,
            rollout_fragment_length=config.rollout_fragment_length)
        self._inflight: Dict[Any, Any] = {}   # sample task ref -> worker
        self._sample_rr = 0

    def training_step(self) -> Dict[str, Any]:
        rt, c = self.runtime, self.config
        eps = epsilon(c, self.timesteps_total)
        weights = self.learner.get_weights()
        # Keep one sample_and_store task in flight per worker; relaunch
        # with fresh weights as they complete (the Ape-X overlap: env
        # stepping never waits for the learner).
        for w in self.workers:
            if w not in self._inflight.values():
                self._inflight[w.sample_and_store.remote(weights, eps)] = w
        ready, _ = rt.wait(list(self._inflight), num_returns=1, timeout=60)
        steps = 0
        returns: List[float] = []
        for ref in ready:
            worker = self._inflight.pop(ref)
            out = rt.get(ref)
            steps += out["steps"]
            returns.extend(out["completed_returns"])
            self._inflight[worker.sample_and_store.remote(weights, eps)] = \
                worker

        # Train from the shards, feeding updated TD priorities back.
        learn_metrics: Dict[str, float] = {}
        sizes = rt.get([s.stats.remote() for s in self.replay_shards])
        total = sum(int(s["size"]) for s in sizes)
        updates = 0
        if total >= c.learning_starts:
            for _ in range(c.num_sgd_iters):
                shard = self.replay_shards[
                    self._sample_rr % len(self.replay_shards)]
                self._sample_rr += 1
                out = rt.get(shard.sample.remote(
                    c.train_batch_size, c.prioritized_replay_beta))
                if out is None:
                    continue
                batch, idx = out
                learn_metrics = self.learner.weighted_update(batch)
                shard.update_priorities.remote(
                    idx, learn_metrics.pop("_td_abs"))
                updates += 1
        return {
            "timesteps_this_iter": steps,
            "epsilon": eps,
            "replay_total": total,
            "replay_shards": len(self.replay_shards),
            "learner_updates_this_iter": updates,
            "episode_return_mean":
                float(np.mean(returns)) if returns else None,
            **learn_metrics,
        }

    def stop(self) -> None:
        for s in self.replay_shards:
            self.runtime.kill(s)
        self.replay_shards = []
        super().stop()


ApexDQNConfig._algo_cls = ApexDQN
