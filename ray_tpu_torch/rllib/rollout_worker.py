"""Environment-sampling worker (port of ``ray_tpu/rllib/rollout_worker.py``).

Each worker owns one env instance; ``sample(weights)`` steps
``rollout_fragment_length`` transitions with the given policy weights and
returns a GAE-postprocessed SampleBatch. Env stepping stays numpy on the
host; the policy and its threefry key live on ``device`` (default
``cuda``), and each step reads its action, log-prob and value back in one
copy. Algorithms run workers as actors of their runtime.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ray_tpu_torch import random as rnd
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.algorithm import Tensors
from ray_tpu_torch.rllib.policy import MLPPolicy, PolicySpec
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, ADVANTAGES, DONES, LOGPS, NEXT_VALUES, OBS, RETURNS, REWARDS,
    SampleBatch, VALUES, compute_gae,
)


class RolloutWorker:
    def __init__(self, env_creator: Callable[[], Any], spec: PolicySpec,
                 *, gamma: float = 0.99, lam: float = 0.95,
                 rollout_fragment_length: int = 200, seed: int = 0,
                 connectors=None, device: DeviceLike = None):
        # Obs connectors run before every policy call; action connectors
        # before every env.step (rllib/connectors.py).
        self.connectors = connectors
        self.env = env_creator()
        self.device = resolve_device(device)
        self._rng = rnd.key(seed, device=self.device)
        self.policy = MLPPolicy(spec, self._rng, device=self.device)
        self.gamma = gamma
        self.lam = lam
        self.fragment = rollout_fragment_length
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0
        self._completed_returns: list = []

    def _transform(self, obs) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        if self.connectors is not None:
            obs = self.connectors.transform_obs(obs)
        return obs

    def _on_device(self, obs: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(obs, np.float32)[None],
                               device=self.device)

    def _value(self, obs) -> float:
        return float(self.policy(self._on_device(self._transform(obs)))[1][0])

    @torch.no_grad()
    def sample(self, weights: Tensors) -> SampleBatch:
        self.policy.load_state_dict(weights)
        obs_buf, act_buf, rew_buf, done_buf, logp_buf, val_buf = \
            [], [], [], [], [], []
        for _ in range(self.fragment):
            keys = rnd.split(self._rng)
            self._rng, key = keys[0], keys[1]
            obs = self._transform(self._obs)
            a, logp, v = self.policy.sample_action(self._on_device(obs), key)
            a, logp, v = torch.cat([a.to(logp.dtype), logp, v]).tolist()
            a = int(a)
            env_a = a if self.connectors is None else \
                self.connectors.transform_action(a)
            nxt, r, term, trunc, _ = self.env.step(env_a)
            done = bool(term or trunc)
            r = raw_r = float(r)
            if trunc and not term:
                # Time-limit truncation is NOT termination: bootstrap the
                # cut-off tail with V(s') so surviving to the limit isn't
                # penalized.
                r += self.gamma * self._value(nxt)
            obs_buf.append(obs)
            act_buf.append(a)
            rew_buf.append(r)
            done_buf.append(done)
            logp_buf.append(logp)
            val_buf.append(v)
            self._episode_return += raw_r
            if done:
                self._completed_returns.append(self._episode_return)
                self._episode_return = 0.0
                self._obs, _ = self.env.reset()
            else:
                self._obs = nxt
        # Bootstrap value for the (possibly unfinished) tail state.
        last_value = 0.0 if done_buf[-1] else self._value(self._obs)
        rewards = np.asarray(rew_buf, np.float32)
        values = np.asarray(val_buf, np.float32)
        dones = np.asarray(done_buf)
        adv, rets = compute_gae(rewards, values, dones, last_value,
                                self.gamma, self.lam)
        # V(s_{t+1}) for off-policy corrections (V-trace): interior entries
        # are the next step's behavior value, the tail entry the bootstrap.
        next_values = np.append(values[1:], np.float32(last_value))
        batch = SampleBatch({
            NEXT_VALUES: next_values.astype(np.float32),
            OBS: np.asarray(obs_buf, np.float32),
            ACTIONS: np.asarray(act_buf, np.int32),
            REWARDS: rewards,
            DONES: dones,
            LOGPS: np.asarray(logp_buf, np.float32),
            VALUES: values,
            ADVANTAGES: adv.astype(np.float32),
            RETURNS: rets.astype(np.float32),
        })
        # Completed-episode returns ride on the fragment, as the reference's.
        batch.completed_returns = self.episode_returns()
        return batch

    def episode_returns(self) -> list:
        """Completed-episode returns since last call (drained)."""
        out, self._completed_returns = self._completed_returns, []
        return out
