"""DD-PPO: decentralized distributed PPO (port of ``ray_tpu/rllib/ddppo.py``).

Each gang member hosts env sampling and a PPO learner; after every
minibatch the gradient, flattened to one vector in the policy's parameter
order (``parameters_to_vector``), is averaged through the collective layer:
``store`` for CPU-rollout gangs, ``torch_dist`` when the average should be
one collective on the ranks' devices. There is no central learner and no
weight broadcast in steady state: ranks start identical (rank 0's weights
broadcast at join) and stay identical because every rank applies the same
averaged gradient.

The members are actors of the algorithm's runtime. The in-process runtime
holds one member (``train.worker_group.check_gang``): its calls run one
after another, and a join blocks until the whole world has joined.
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.nn.utils import parameters_to_vector, vector_to_parameters

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.parallel import collective
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.policy import PolicySpec
from ray_tpu_torch.rllib.ppo import PPOConfig, PPOLearner
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
from ray_tpu_torch.runtime import LocalRuntime
from ray_tpu_torch.train.worker_group import check_gang, rank_runtime_env


@dataclasses.dataclass
class DDPPOConfig(PPOConfig):
    """DD-PPO config: the reference's collective backend choice."""

    collective_backend: str = "store"   # "torch_dist" for device gangs


class _DDPPOWorker:
    """One decentralized rank: rollout sampling, a local learner, and the
    gradient allreduce."""

    def __init__(self, env_creator, spec: PolicySpec, config: DDPPOConfig,
                 world: int, rank: int, group_name: str, *,
                 device: DeviceLike = None, worker_device: DeviceLike = None,
                 runtime: Any = None):
        self.device = resolve_device(device)
        self.sampler = RolloutWorker(
            env_creator, spec, gamma=config.gamma, lam=config.lam,
            rollout_fragment_length=config.rollout_fragment_length,
            seed=config.seed + 1 + rank,
            device=self.device if worker_device is None else worker_device)
        self.learner = PPOLearner(spec, config, device=self.device)
        self.world = world
        self.rank = rank
        self._group_name = group_name
        self._backend = config.collective_backend
        self._runtime = runtime
        self._group: Optional[collective.BaseGroup] = None
        self._np_rng = np.random.default_rng(config.seed + 101 + rank)

    def _params(self):
        return list(self.learner.policy.parameters())

    def _collective(self, fn, vec: torch.Tensor, **kwargs) -> torch.Tensor:
        """``fn``, an op of the group, on ``vec``: the tensor itself on a
        ``torch_dist`` group, numpy on a ``store`` one."""
        if isinstance(self._group, collective.TorchDistGroup):
            return fn(vec, **kwargs).to(self.device)
        out = fn(vec.detach().cpu().numpy(), **kwargs)
        return torch.from_numpy(np.asarray(out)).to(self.device)

    def join(self) -> bool:
        """Form the collective group (all ranks call at once) and take rank
        0's weights."""
        self._group = collective.init_collective_group(
            self.world, self.rank, backend=self._backend,
            group_name=self._group_name, device=self.device,
            runtime=self._runtime)
        flat = parameters_to_vector(self._params()).detach()
        synced = self._collective(self._group.broadcast, flat, src_rank=0)
        with torch.no_grad():
            vector_to_parameters(synced, self._params())
        return True

    def leave(self) -> bool:
        """Destroy this rank's group (and its world, if it was the last)."""
        if self._group is not None:
            collective.destroy_collective_group(self._group_name)
            self._group = None
        return True

    def train_iteration(self, num_epochs: int, minibatch_size: int,
                        batch: Optional[Any] = None) -> Dict[str, Any]:
        """Sample locally, then SGD with allreduce-averaged gradients.
        Every rank samples the same fragment length, so minibatch counts
        match and the collectives stay aligned. ``batch`` can be injected
        for deterministic equivalence tests."""
        if batch is None:
            batch = self.sampler.sample(self.learner.get_weights())
        returns = list(getattr(batch, "completed_returns", None) or ())
        mb = min(minibatch_size, batch.count)
        metrics: Dict[str, float] = {}
        for _ in range(num_epochs):
            shuffled = batch.shuffle(self._np_rng)
            for sub in shuffled.minibatches(mb):
                metrics = self._allreduce_step(dict(sub))
        return {"metrics": metrics, "count": batch.count,
                "returns": returns}

    def _allreduce_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        grads, aux = self.learner.compute_grads(batch)
        flat = torch.cat([g.reshape(-1) for g in grads.values()])
        avg = self._collective(self._group.allreduce, flat,
                               op=collective.ReduceOp.AVG)
        sizes = [g.numel() for g in grads.values()]
        self.learner.apply_grads({
            name: part.view_as(g) for (name, g), part in
            zip(grads.items(), torch.split(avg, sizes))})
        return aux

    # -- weights / state (any rank speaks for the gang; writes fan out) --

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, w) -> bool:
        self.learner.set_weights(w)
        return True

    def get_state(self):
        return self.learner.get_state()

    def set_state(self, state) -> bool:
        self.learner.set_state(state)
        return True


class _GangLearnerHandle:
    """Learner facade over the decentralized gang: rank 0 speaks for reads
    (ranks are replicated); writes fan out to every rank to keep the
    invariant."""

    def __init__(self, workers: List[Any], runtime: Any):
        self._workers = workers
        self._rt = runtime

    def get_weights(self):
        return self._rt.get(self._workers[0].get_weights.remote())

    def set_weights(self, w) -> None:
        self._rt.get([a.set_weights.remote(w) for a in self._workers])

    def get_state(self):
        return self._rt.get(self._workers[0].get_state.remote())

    def set_state(self, state) -> None:
        self._rt.get([a.set_state.remote(state) for a in self._workers])


class DDPPO(Algorithm):
    """Decentralized PPO: no central learner, no weight shipping;
    ``training_step`` triggers the members' iterations and aggregates their
    metrics. The learners run on
    ``device`` in the members; on a process runtime a CUDA gang pins each
    member's GPU through its ``runtime_env``. The members reserve no
    placement group, as the reference's do not, so they count as one
    node's: member i takes the i-th GPU of the node's mask."""

    def setup(self) -> None:
        config = self.config
        n = config.num_rollout_workers
        check_gang(self.runtime, n)
        gname = f"ddppo_{uuid.uuid4().hex[:8]}"
        worker_cls = self.runtime.remote(_DDPPOWorker)
        cuda = self.device.type == "cuda"
        pin = cuda and not isinstance(self.runtime, LocalRuntime)
        self.workers = []
        for i in range(n):
            opts: Dict[str, Any] = {
                "num_cpus": 1,
                "num_gpus": 1 if cuda and config.collective_backend
                == "torch_dist" else 0}
            if pin:
                opts["runtime_env"] = rank_runtime_env(None, i, self.device)
            self.workers.append(worker_cls.options(**opts).remote(
                config.env_creator, self.spec, config, world=n, rank=i,
                group_name=gname, device="cuda" if pin else self.device,
                worker_device="cuda" if pin else self.worker_device,
                runtime=self.runtime))
        # Rendezvous runs concurrently across ranks (group formation blocks
        # until the whole world joins).
        self.runtime.get([w.join.remote() for w in self.workers])
        self.learner = _GangLearnerHandle(self.workers, self.runtime)

    def training_step(self) -> Dict[str, Any]:
        outs = self.runtime.get([
            w.train_iteration.remote(self.config.num_sgd_epochs,
                                     self.config.sgd_minibatch_size)
            for w in self.workers
        ])
        returns = [r for o in outs for r in o["returns"]]
        metrics = dict(outs[0]["metrics"])
        return {
            "timesteps_this_iter": sum(o["count"] for o in outs),
            "episode_return_mean":
                float(np.mean(returns)) if returns else None,
            **metrics,
        }

    def stop(self) -> None:
        try:
            self.runtime.get([w.leave.remote() for w in self.workers])
        # A dead member's world goes with its process; the kill below is
        # the real teardown.
        except Exception:
            pass
        super().stop()


DDPPOConfig._algo_cls = DDPPO
