"""SAC for continuous control (port of ``ray_tpu/rllib/sac.py``):
twin Q critics, a tanh-squashed Gaussian actor, polyak-averaged targets and
automatic entropy-temperature tuning toward a target entropy of
``-action_dim`` (Haarnoja et al. 2018 v2).

``GaussianPolicy`` is an ``nn.Module`` holding the reference's ``actor``,
``q1`` and ``q2`` layer lists under their names. ``SACLearner`` keeps the
reference's two Adam states (actor and critics in one, ``log_alpha`` in the
other) and draws its reparameterized noise with the port's threefry
``normal``, the update's key split as the reference splits it. The replay
buffer stays host numpy; ``SAC.training_step`` fills it from the rollout
actors and trains once it holds ``learning_starts`` transitions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch import random as rnd
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.algorithm import (
    Algorithm, AlgorithmConfig, Tensors, adam_state, floats, load_adam_state,
    to_device, weights_of,
)
from ray_tpu_torch.rllib.policy import Dense

_LOG_STD_MIN, _LOG_STD_MAX = -20.0, 2.0


@dataclasses.dataclass(frozen=True)
class ContinuousPolicySpec:
    obs_dim: int
    action_dim: int
    # Scalars broadcast; tuples give per-dimension Box bounds.
    action_low: Any = -1.0
    action_high: Any = 1.0
    hidden: tuple = (128, 128)


@dataclasses.dataclass
class SACConfig(AlgorithmConfig):
    rollout_fragment_length: int = 200
    lr: float = 3e-4
    buffer_size: int = 100_000
    learning_starts: int = 500
    train_batch_size: int = 128
    num_sgd_iters: int = 32
    tau: float = 0.005              # polyak factor for target critics
    init_alpha: float = 0.1
    autotune_alpha: bool = True     # entropy temperature learning


class ContinuousReplayBuffer:
    """Uniform ring with float action vectors (reference:
    utils/replay_buffers/replay_buffer.py:81)."""

    def __init__(self, capacity: int, obs_dim: int, action_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity, action_dim), np.float32)
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


def _mlp(key: torch.Tensor, dims: Sequence[int], out: int) -> nn.ModuleList:
    """Layers ``dims[0] -> ... -> out``, layer ``i`` drawn with key ``i`` of
    ``split(key, len(dims))`` and scaled by sqrt(2 / din)."""
    sizes = list(dims) + [out]
    keys = rnd.split(key, len(dims))
    return nn.ModuleList(
        Dense(k, din, dout, math.sqrt(2.0 / din))
        for k, (din, dout) in zip(keys, zip(sizes[:-1], sizes[1:])))


def _run(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for layer in layers[:-1]:
        x = torch.tanh(layer(x))
    return layers[-1](x)


class GaussianPolicy(nn.Module):
    """Tanh-squashed diagonal Gaussian actor and twin Q critics."""

    def __init__(self, spec: ContinuousPolicySpec, key: torch.Tensor, *,
                 device: DeviceLike = None):
        super().__init__()
        self.spec = spec
        ka, k1, k2 = rnd.split(key.cpu(), 3)
        h = list(spec.hidden)
        q_in = spec.obs_dim + spec.action_dim
        self.actor = _mlp(ka, [spec.obs_dim] + h, 2 * spec.action_dim)
        self.q1 = _mlp(k1, [q_in] + h, 1)
        self.q2 = _mlp(k2, [q_in] + h, 1)
        low = np.asarray(spec.action_low, np.float32)
        high = np.asarray(spec.action_high, np.float32)
        scale = (high - low) / 2.0        # per-dimension for Box bounds
        # The affine rescaling's Jacobian in the log-density.
        self._log_scale = float(np.sum(np.log(scale)))
        self.register_buffer("_scale", torch.as_tensor(scale),
                             persistent=False)
        self.register_buffer("_mid", torch.as_tensor((high + low) / 2.0),
                             persistent=False)
        self.to(resolve_device(device))

    def actor_dist(self, obs: torch.Tensor):
        mu, log_std = torch.chunk(_run(self.actor, obs), 2, dim=-1)
        return mu, torch.clamp(log_std, _LOG_STD_MIN, _LOG_STD_MAX)

    def sample_action(self, obs: torch.Tensor, key: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reparameterized tanh-Gaussian sample -> (action, logp)."""
        mu, log_std = self.actor_dist(obs)
        std = torch.exp(log_std)
        eps = rnd.normal(key, mu.shape)
        pre = mu + std * eps
        a = torch.tanh(pre)
        # logp with tanh change-of-variables (SAC appendix C); softplus as
        # jax.nn.softplus, logaddexp(x, 0).
        logp = (-0.5 * ((eps ** 2) + 2 * log_std + math.log(2 * math.pi))
                ).sum(-1)
        softplus = torch.logaddexp(-2 * pre, torch.zeros_like(pre))
        logp = logp - (2 * (math.log(2.0) - pre - softplus)).sum(-1)
        logp = logp - self._log_scale
        return a * self._scale + self._mid, logp

    def q_values(self, obs: torch.Tensor, act: torch.Tensor):
        x = torch.cat([obs, act], dim=-1)
        return _run(self.q1, x)[:, 0], _run(self.q2, x)[:, 0]


class SACLearner:
    """The SAC update: critics, actor, alpha, polyak targets."""

    def __init__(self, spec: ContinuousPolicySpec, config: SACConfig, *,
                 device: DeviceLike = None):
        self.spec = spec
        self.config = config
        self.device = resolve_device(device)
        key = rnd.key(config.seed, device="cpu")
        self.policy = GaussianPolicy(spec, key, device=self.device)
        self.target = GaussianPolicy(spec, key, device=self.device)
        self.target.requires_grad_(False)
        # np.log in f64, rounded to f32, as the reference's jnp.asarray.
        self.log_alpha = nn.Parameter(torch.tensor(
            float(np.log(config.init_alpha)), device=self.device))
        self.opt = torch.optim.Adam(self.policy.parameters(), lr=config.lr)
        self.alpha_opt = torch.optim.Adam([self.log_alpha], lr=config.lr)
        self._rng = rnd.key(config.seed + 1, device=self.device)

    def _update(self, batch: Dict[str, torch.Tensor], key: torch.Tensor):
        cfg, p = self.config, self.policy
        k1, k2, _ = rnd.split(key, 3)
        alpha = torch.exp(self.log_alpha.detach())
        with torch.no_grad():
            next_a, next_logp = p.sample_action(batch["next_obs"], k1)
            q1t, q2t = self.target.q_values(batch["next_obs"], next_a)
            backup = batch["rewards"] + cfg.gamma * (1 - batch["dones"]) * (
                torch.minimum(q1t, q2t) - alpha * next_logp)
        q1, q2 = p.q_values(batch["obs"], batch["actions"])
        c_loss = ((q1 - backup) ** 2 + (q2 - backup) ** 2).mean()
        a, logp = p.sample_action(batch["obs"], k2)
        qa1, qa2 = p.q_values(batch["obs"], a)
        a_loss = (alpha * logp - torch.minimum(qa1, qa2)).mean()
        # Critic grads update the q nets, actor grads the actor; one
        # optimizer state serves both.
        critics = [*p.q1.parameters(), *p.q2.parameters()]
        actor = list(p.actor.parameters())
        grads = torch.autograd.grad(c_loss, critics, retain_graph=False) + \
            torch.autograd.grad(a_loss, actor)
        for param, g in zip(critics + actor, grads):
            param.grad = g
        self.opt.step()

        logp = logp.detach()
        if cfg.autotune_alpha:
            target_entropy = -float(self.spec.action_dim)
            al_loss = -(torch.exp(self.log_alpha)
                        * (logp + target_entropy)).mean()
            self.alpha_opt.zero_grad(set_to_none=True)
            al_loss.backward()
            self.alpha_opt.step()
        with torch.no_grad():
            tgt = list(self.target.parameters())
            torch._foreach_mul_(tgt, 1 - cfg.tau)
            torch._foreach_add_(tgt, torch._foreach_mul(
                list(p.parameters()), cfg.tau))
        return {"critic_loss": c_loss, "actor_loss": a_loss,
                "alpha": torch.exp(self.log_alpha.detach()),
                "entropy": -logp.mean()}

    def update_from_buffer(self, buf: ContinuousReplayBuffer, iters: int,
                           batch_size: int,
                           rng: np.random.Generator) -> Dict[str, float]:
        aux = {}
        for _ in range(iters):
            batch = to_device(buf.sample(batch_size, rng), self.device)
            self._rng, sub = rnd.split(self._rng)
            aux = self._update(batch, sub)
        return floats(aux) if aux else {}

    # -- weights / checkpointable state ------------------------------------

    def get_weights(self) -> Tensors:
        return weights_of(self.policy)

    def set_weights(self, params: Tensors) -> None:
        self.policy.load_state_dict(params)

    def _alpha(self):
        return [("log_alpha", self.log_alpha)]

    def get_state(self) -> Dict[str, Any]:
        return {"params": self.get_weights(),
                "target": weights_of(self.target),
                "opt_state": adam_state(self.opt,
                                        self.policy.named_parameters()),
                "log_alpha": self.log_alpha.detach().clone(),
                "alpha_opt_state": adam_state(self.alpha_opt, self._alpha())}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.set_weights(state["params"])
        self.target.load_state_dict(state["target"])
        load_adam_state(self.opt, self.policy.named_parameters(),
                        state["opt_state"])
        with torch.no_grad():
            self.log_alpha.copy_(torch.as_tensor(state["log_alpha"]))
        load_adam_state(self.alpha_opt, self._alpha(),
                        state["alpha_opt_state"])


class _SACRolloutWorker:
    """Env stepper sampling from the current stochastic policy on
    ``device``."""

    def __init__(self, env_creator: Callable, spec: ContinuousPolicySpec,
                 fragment_length: int, seed: int, *,
                 device: DeviceLike = None):
        self.env = env_creator()
        self.spec = spec
        self.fragment = fragment_length
        self.device = resolve_device(device)
        self._rng = rnd.key(seed, device=self.device)
        self.policy = GaussianPolicy(spec, self._rng, device=self.device)
        self._obs, _ = self.env.reset(seed=seed)
        self._ep_return = 0.0
        self._returns: List[float] = []

    @torch.no_grad()
    def sample(self, weights: Tensors) -> Dict[str, Any]:
        self.policy.load_state_dict(weights)
        obs_l, act_l, rew_l, next_l, done_l = [], [], [], [], []
        for _ in range(self.fragment):
            self._rng, sub = rnd.split(self._rng)
            obs = np.asarray(self._obs, np.float32)
            a, _ = self.policy.sample_action(
                torch.as_tensor(obs[None], device=self.device), sub)
            a = a[0].cpu().numpy()
            nxt, r, term, trunc, _ = self.env.step(a)
            obs_l.append(obs)
            act_l.append(a)
            rew_l.append(float(r))
            next_l.append(np.asarray(nxt, np.float32))
            done_l.append(float(term))
            self._ep_return += float(r)
            if term or trunc:
                self._returns.append(self._ep_return)
                self._ep_return = 0.0
                self._obs, _ = self.env.reset()
            else:
                self._obs = nxt
        returns, self._returns = self._returns, []
        return {"obs": np.stack(obs_l), "actions": np.stack(act_l),
                "rewards": np.asarray(rew_l, np.float32),
                "next_obs": np.stack(next_l),
                "dones": np.asarray(done_l, np.float32),
                "episode_returns": returns}


class SAC(Algorithm):
    """The Algorithm (reference: ``sac.py:333-383``)."""

    def setup(self) -> None:
        config = self.config
        # Spaces (incl. Box bounds) were probed once by infer_spaces;
        # config.hidden sizes the actor/critic MLPs.
        self.cspec = ContinuousPolicySpec(
            obs_dim=config.obs_dim, action_dim=config.num_actions,
            action_low=getattr(config, "action_low", -1.0),
            action_high=getattr(config, "action_high", 1.0),
            hidden=tuple(config.hidden))
        self.learner = SACLearner(self.cspec, config, device=self.device)
        self.buffer = ContinuousReplayBuffer(
            config.buffer_size, self.cspec.obs_dim, self.cspec.action_dim)
        self.workers = self._rollout_actors(
            _SACRolloutWorker, config.env_creator, self.cspec,
            config.rollout_fragment_length)
        self._returns: List[float] = []

    def training_step(self) -> Dict[str, Any]:
        params = self.learner.get_weights()
        batches = self.runtime.get(
            [w.sample.remote(params) for w in self.workers])
        steps = 0
        for b in batches:
            self.buffer.add_batch(b["obs"], b["actions"], b["rewards"],
                                  b["next_obs"], b["dones"])
            steps += len(b["rewards"])
            self._returns.extend(b["episode_returns"])
        metrics: Dict[str, float] = {}
        if self.buffer.size >= self.config.learning_starts:
            metrics = self.learner.update_from_buffer(
                self.buffer, self.config.num_sgd_iters,
                self.config.train_batch_size, self._np_rng)
        recent = self._returns[-20:]
        return {
            "timesteps_this_iter": steps,
            "buffer_size": self.buffer.size,
            "episode_return_mean":
                float(np.mean(recent)) if recent else None,
            **metrics,
        }


SACConfig._algo_cls = SAC
