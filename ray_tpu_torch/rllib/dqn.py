"""DQN (port of ``ray_tpu/rllib/dqn.py``): replay-buffer off-policy
learning.

Epsilon-greedy ``_DQNRolloutWorker`` actors step the environments; the
replay buffer is a numpy ring on the host, as in the reference.
``DQNLearner`` is the double-DQN TD update with a target network that
copies the online params every ``target_update_freq`` updates.
``DQN.training_step`` samples, stores, trains from replay once the buffer
holds ``learning_starts`` transitions, and syncs the target.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch import random as rnd
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.algorithm import (
    Algorithm, AlgorithmConfig, Learner, Tensors, weights_of,
)
from ray_tpu_torch.rllib.policy import MLPPolicy, PolicySpec


@dataclasses.dataclass
class DQNConfig(AlgorithmConfig):
    rollout_fragment_length: int = 100
    lr: float = 1e-3
    buffer_size: int = 50_000
    learning_starts: int = 500
    train_batch_size: int = 64
    num_sgd_iters: int = 32          # minibatch updates per train()
    target_update_freq: int = 200    # in learner updates
    double_q: bool = True
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 5_000


class ReplayBuffer:
    """Uniform ring buffer (reference: replay_buffer.py:81)."""

    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity,), np.int32)
        self.rewards = np.zeros((capacity,), np.float32)
        self.dones = np.zeros((capacity,), np.float32)
        self._next = 0
        self.size = 0

    def add_batch(self, obs, actions, rewards, next_obs, dones):
        for i in range(len(actions)):
            j = self._next
            self.obs[j] = obs[i]
            self.actions[j] = actions[i]
            self.rewards[j] = rewards[i]
            self.next_obs[j] = next_obs[i]
            self.dones[j] = dones[i]
            self._next = (self._next + 1) % self.capacity
            self.size = min(self.size + 1, self.capacity)

    def sample(self, n: int, rng: np.random.Generator) -> Dict[str, Any]:
        idx = rng.integers(0, self.size, n)
        return {"obs": self.obs[idx], "actions": self.actions[idx],
                "rewards": self.rewards[idx],
                "next_obs": self.next_obs[idx], "dones": self.dones[idx]}


def td_errors(policy: MLPPolicy, target: MLPPolicy, batch, gamma: float,
              double_q: bool):
    """(q of the taken actions, TD error) of the double-DQN target: the
    online net picks the next action, the target net values it; the pi
    head doubles as the Q head."""
    q_sel = policy(batch["obs"])[0].gather(
        1, batch["actions"].long()[:, None])[:, 0]
    with torch.no_grad():
        q_next_target = target(batch["next_obs"])[0]
        if double_q:
            a_star = torch.argmax(policy(batch["next_obs"])[0], dim=1)
            next_v = q_next_target.gather(1, a_star[:, None])[:, 0]
        else:
            next_v = torch.max(q_next_target, dim=1).values
        target_v = batch["rewards"] + gamma * (1.0 - batch["dones"]) * next_v
    return q_sel, q_sel - target_v


def huber(td: torch.Tensor) -> torch.Tensor:
    """Keeps rare large TD errors from dominating."""
    return torch.where(torch.abs(td) < 1.0, 0.5 * td ** 2,
                       torch.abs(td) - 0.5)


class DQNLearner(Learner):
    """Double-DQN TD update with a target network."""

    loss_key = "loss"

    def __init__(self, spec: PolicySpec, config: DQNConfig, *,
                 device: DeviceLike = None):
        self.num_updates = 0
        self._target_freq = config.target_update_freq
        self.gamma, self.double_q = config.gamma, config.double_q

        def loss_fn(policy, batch):
            q_sel, td = td_errors(policy, self.target, batch, self.gamma,
                                  self.double_q)
            return torch.mean(huber(td)), {
                "td_error_mean": torch.mean(torch.abs(td)),
                "q_mean": torch.mean(q_sel)}

        super().__init__(spec, config, loss_fn, device=device)
        self.target = MLPPolicy(spec, rnd.key(config.seed, device="cpu"),
                                device=self.device).requires_grad_(False)
        self.sync_target()

    def sync_target(self) -> None:
        self.target.load_state_dict(self.policy.state_dict())

    def _count_update(self) -> None:
        self.num_updates += 1
        if self.num_updates % self._target_freq == 0:
            self.sync_target()

    def update_from_buffer(self, buffer: ReplayBuffer, *, iters: int,
                           batch_size: int,
                           rng: np.random.Generator) -> Dict[str, float]:
        metrics: Dict[str, float] = {}
        for _ in range(iters):
            batch = buffer.sample(min(batch_size, buffer.size), rng)
            metrics = self.step(batch)
            self._count_update()
        return metrics

    def get_state(self) -> Dict[str, Any]:
        return {**super().get_state(),
                "target_params": weights_of(self.target),
                "num_updates": self.num_updates}

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        self.target.load_state_dict(state["target_params"])
        self.num_updates = state["num_updates"]


class _DQNRolloutWorker:
    """Epsilon-greedy environment stepper; the greedy action comes from the
    policy on ``device``."""

    def __init__(self, env_creator, spec: PolicySpec, *,
                 rollout_fragment_length: int = 100, seed: int = 0,
                 device: DeviceLike = None):
        self.env = env_creator()
        self.spec = spec
        self.fragment = rollout_fragment_length
        self.device = resolve_device(device)
        self.policy = MLPPolicy(spec, rnd.key(seed, device="cpu"),
                                device=self.device)
        self._np_rng = np.random.default_rng(seed)
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0
        self._completed: List[float] = []

    @torch.no_grad()
    def sample(self, weights: Tensors, epsilon: float) -> Dict[str, Any]:
        self.policy.load_state_dict(weights)
        obs_b, act_b, rew_b, nxt_b, done_b = [], [], [], [], []
        for _ in range(self.fragment):
            obs = np.asarray(self._obs, np.float32)
            if self._np_rng.random() < epsilon:
                a = int(self._np_rng.integers(self.spec.num_actions))
            else:
                logits, _ = self.policy(torch.as_tensor(obs[None],
                                                        device=self.device))
                a = int(torch.argmax(logits, dim=1)[0])
            nxt, r, term, trunc, _ = self.env.step(a)
            done = bool(term)  # truncation bootstraps (not a true terminal)
            obs_b.append(obs)
            act_b.append(a)
            rew_b.append(float(r))
            nxt_b.append(np.asarray(nxt, np.float32))
            done_b.append(float(done))
            self._episode_return += float(r)
            if term or trunc:
                self._completed.append(self._episode_return)
                self._episode_return = 0.0
                self._obs, _ = self.env.reset()
            else:
                self._obs = nxt
        return {"obs": np.stack(obs_b), "actions": np.asarray(act_b),
                "rewards": np.asarray(rew_b, np.float32),
                "next_obs": np.stack(nxt_b),
                "dones": np.asarray(done_b, np.float32),
                "completed_returns": self.episode_returns()}

    def episode_returns(self) -> List[float]:
        out, self._completed = self._completed, []
        return out


def epsilon(config: DQNConfig, timesteps: int) -> float:
    """The exploration rate after ``timesteps`` env steps: linear from
    ``epsilon_start`` to ``epsilon_end`` over ``epsilon_decay_steps``."""
    frac = min(1.0, timesteps / max(1, config.epsilon_decay_steps))
    return config.epsilon_start + frac * (config.epsilon_end
                                          - config.epsilon_start)


class DQN(Algorithm):
    """The Algorithm (reference: ``dqn.py:206-253``): sample -> store ->
    replay-train -> target sync."""

    def setup(self) -> None:
        config = self.config
        self.learner = DQNLearner(self.spec, config, device=self.device)
        self.buffer = ReplayBuffer(config.buffer_size, config.obs_dim)
        self.workers = self._rollout_actors(
            _DQNRolloutWorker, config.env_creator, self.spec,
            rollout_fragment_length=config.rollout_fragment_length)

    def training_step(self) -> Dict[str, Any]:
        eps = epsilon(self.config, self.timesteps_total)
        weights = self.learner.get_weights()
        batches = self.runtime.get(
            [w.sample.remote(weights, eps) for w in self.workers])
        for b in batches:
            self.buffer.add_batch(b["obs"], b["actions"], b["rewards"],
                                  b["next_obs"], b["dones"])
        learn_metrics: Dict[str, float] = {}
        if self.buffer.size >= self.config.learning_starts:
            learn_metrics = self.learner.update_from_buffer(
                self.buffer, iters=self.config.num_sgd_iters,
                batch_size=self.config.train_batch_size, rng=self._np_rng)
        steps = sum(len(b["actions"]) for b in batches)
        return {
            "timesteps_this_iter": steps,
            "epsilon": eps,
            "buffer_size": self.buffer.size,
            "episode_return_mean": self._mean_returns_from(batches),
            **learn_metrics,
        }


DQNConfig._algo_cls = DQN
