"""Multi-agent PPO (port of ``ray_tpu/rllib/multi_agent.py``): policy maps
over one shared environment.

Environment protocol (dict-keyed by agent id):
    reset(seed=...) -> (obs_dict, info_dict)
    step(action_dict) -> (obs_dict, reward_dict, terminated_dict,
                          truncated_dict, info_dict)
``terminated_dict["__all__"]`` ends the episode for everyone.

The rollout actor routes every agent's experience to its policy through
``policy_mapping_fn`` and computes per-agent GAE at episode end; each policy
trains with its own ``PPOLearner`` (``policy_learners``) on its own batch.
The actor takes the mapping function itself, where the reference's takes
it cloudpickled: the ``ray_tpu`` runtime's serializer is cloudpickle and
carries it, and the port does not need cloudpickle on the card's machine.
The checkpoint holds every policy's learner state, in plain pickle.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch import random as rnd
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.algorithm import (
    Algorithm, AlgorithmConfig, Tensors, load_state, save_state,
)
from ray_tpu_torch.rllib.policy import MLPPolicy, PolicySpec
from ray_tpu_torch.rllib.ppo import PPOConfig, PPOLearner
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, ADVANTAGES, LOGPS, OBS, RETURNS, SampleBatch, compute_gae,
    concat_batches,
)


@dataclasses.dataclass
class MultiAgentPPOConfig(AlgorithmConfig):
    # name -> PolicySpec; agents map onto these via policy_mapping_fn.
    policies: Optional[Dict[str, PolicySpec]] = None
    policy_mapping_fn: Optional[Callable[[str], str]] = None
    lr: float = 3e-4
    clip_param: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_sgd_epochs: int = 4
    sgd_minibatch_size: int = 128
    lam: float = 0.95

    def multi_agent(self, *, policies: Dict[str, PolicySpec],
                    policy_mapping_fn: Callable[[str], str]
                    ) -> "MultiAgentPPOConfig":
        self.policies = policies
        self.policy_mapping_fn = policy_mapping_fn
        return self

    def infer_spaces(self) -> None:
        # Spaces come from the per-policy specs, not a probe env.
        self.obs_dim = self.obs_dim or 1
        self.num_actions = self.num_actions or 1


def policy_learners(config: MultiAgentPPOConfig, *,
                    device: DeviceLike = None) -> Dict[str, PPOLearner]:
    """One PPOLearner per named policy, as the reference's
    ``MultiAgentPPO.setup`` builds them."""
    if not config.policies or config.policy_mapping_fn is None:
        raise ValueError("multi_agent(policies=..., "
                         "policy_mapping_fn=...) required")
    ppo_cfg = PPOConfig(
        lr=config.lr, clip_param=config.clip_param,
        vf_coeff=config.vf_coeff, entropy_coeff=config.entropy_coeff,
        seed=config.seed)
    return {name: PPOLearner(spec, ppo_cfg, device=device)
            for name, spec in config.policies.items()}


class _MultiAgentRolloutWorker:
    """Steps one shared multi-agent env; emits per-POLICY batches."""

    def __init__(self, env_creator: Callable,
                 policies: Dict[str, PolicySpec],
                 policy_mapping_fn: Callable[[str], str],
                 gamma: float, lam: float,
                 fragment_length: int, seed: int, *,
                 device: DeviceLike = None):
        self.env = env_creator()
        self.policies = policies
        self.mapping = policy_mapping_fn
        self.gamma, self.lam = gamma, lam
        self.fragment = fragment_length
        self.device = resolve_device(device)
        self._rng = rnd.key(seed, device=self.device)
        self._nets = {name: MLPPolicy(spec, self._rng, device=self.device)
                      for name, spec in policies.items()}
        self._reset(seed)
        self._returns: List[float] = []

    def _reset(self, seed: Optional[int] = None):
        self._obs, _ = self.env.reset(seed=seed)
        # agent -> per-episode trajectory columns
        self._traj: Dict[str, Dict[str, list]] = {}
        self._ep_return = 0.0

    def _on_device(self, obs) -> torch.Tensor:
        return torch.as_tensor(np.asarray(obs, np.float32)[None],
                               device=self.device)

    @torch.no_grad()
    def sample(self, weights: Dict[str, Tensors]) -> Dict[str, Any]:
        for name, net in self._nets.items():
            net.load_state_dict(weights[name])
        out_rows: Dict[str, List[SampleBatch]] = {p: []
                                                  for p in self.policies}
        steps = 0
        while steps < self.fragment:
            actions: Dict[str, Any] = {}
            cache: Dict[str, tuple] = {}
            for agent, obs in self._obs.items():
                net = self._nets[self.mapping(agent)]
                self._rng, sub = rnd.split(self._rng)
                a, logp, v = net.sample_action(self._on_device(obs), sub)
                a, logp, v = torch.cat([a.to(logp.dtype), logp, v]).tolist()
                actions[agent] = int(a)
                cache[agent] = (logp, v, obs)
            nxt, rew, term, trunc, _ = self.env.step(actions)
            steps += len(actions)
            for agent, act in actions.items():
                logp, v, obs = cache[agent]
                t = self._traj.setdefault(agent, {
                    "obs": [], "act": [], "logp": [], "val": [],
                    "rew": [], "done": []})
                done = bool(term.get(agent) or term.get("__all__"))
                t["obs"].append(np.asarray(obs, np.float32))
                t["act"].append(act)
                t["logp"].append(logp)
                t["val"].append(v)
                t["rew"].append(float(rew.get(agent, 0.0)))
                t["done"].append(done)
                self._ep_return += float(rew.get(agent, 0.0))
            if term.get("__all__") or trunc.get("__all__"):
                # Advance to the FINAL observation first so a truncated
                # (not terminated) episode bootstraps from V(s_{t+1}).
                self._obs = nxt
                self._flush_episode(out_rows)
                self._returns.append(self._ep_return)
                self._reset()
            else:
                self._obs = nxt
        self._flush_episode(out_rows)   # bootstrap mid-episode
        batches = {p: dict(concat_batches(rows)) if rows else None
                   for p, rows in out_rows.items()}
        returns, self._returns = self._returns, []
        return {"batches": batches, "steps": steps,
                "episode_returns": returns}

    def _flush_episode(self, out_rows):
        for agent, t in self._traj.items():
            if not t["act"]:
                continue
            pol = self.mapping(agent)
            if t["done"][-1] or agent not in self._obs:
                last_value = 0.0
            else:
                _, v = self._nets[pol](self._on_device(self._obs[agent]))
                last_value = float(v[0])
            adv, ret = compute_gae(
                np.asarray(t["rew"], np.float32),
                np.asarray(t["val"], np.float32),
                np.asarray(t["done"]), last_value,
                self.gamma, self.lam)
            out_rows[pol].append(SampleBatch({
                OBS: np.stack(t["obs"]),
                ACTIONS: np.asarray(t["act"], np.int32),
                LOGPS: np.asarray(t["logp"], np.float32),
                ADVANTAGES: adv, RETURNS: ret,
            }))
        self._traj = {}


class MultiAgentPPO(Algorithm):
    """The Algorithm (reference: ``multi_agent.py:165-248``)."""

    def setup(self) -> None:
        config = self.config
        self.learners = policy_learners(config, device=self.device)
        self.learner = next(iter(self.learners.values()))  # weights anchor
        self.workers = self._rollout_actors(
            _MultiAgentRolloutWorker, config.env_creator, config.policies,
            config.policy_mapping_fn, config.gamma, config.lam,
            config.rollout_fragment_length)

    def training_step(self) -> Dict[str, Any]:
        weights = {n: lr.get_weights() for n, lr in self.learners.items()}
        outs = self.runtime.get([w.sample.remote(weights)
                                 for w in self.workers])
        steps = sum(o["steps"] for o in outs)
        returns = [r for o in outs for r in o["episode_returns"]]
        metrics: Dict[str, Any] = {"timesteps_this_iter": steps}
        for name, learner in self.learners.items():
            parts = [SampleBatch(o["batches"][name]) for o in outs
                     if o["batches"].get(name) is not None]
            if not parts:
                continue
            m = learner.update_from_batch(
                concat_batches(parts), num_epochs=self.config.num_sgd_epochs,
                minibatch_size=self.config.sgd_minibatch_size,
                rng=self._np_rng)
            for k, v in m.items():
                metrics[f"{name}/{k}"] = v
        metrics["episode_return_mean"] = (
            float(np.mean(returns)) if returns else None)
        return metrics

    # Multi-policy checkpoint state (the config holds the mapping function,
    # which plain pickle does not carry, so it stays out).
    def save_checkpoint(self, path: str) -> str:
        return save_state(path, {
            "learners": {n: lr.get_state()
                         for n, lr in self.learners.items()},
            "iteration": self.iteration,
            "timesteps_total": self.timesteps_total,
        })

    def restore_checkpoint(self, path: str) -> None:
        state = load_state(path)
        for n, s in state["learners"].items():
            self.learners[n].set_state(s)
        self.iteration = state["iteration"]
        self.timesteps_total = state["timesteps_total"]


MultiAgentPPOConfig._algo_cls = MultiAgentPPO
