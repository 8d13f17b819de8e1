"""The shared config, learner and algorithm (port of
``ray_tpu/rllib/algorithm.py``).

``AlgorithmConfig`` is the reference's chainable config; ``build`` takes
the runtime and the devices, which are not config fields (a checkpoint
pickles the config's fields). ``Learner`` is the reference's learner with
torch in place of jax and optax: params live in an ``MLPPolicy`` module on
``device`` (default ``cuda``), ``optax.adam(lr)`` is ``torch.optim.Adam(lr)``
(the same defaults: betas 0.9/0.999, eps 1e-8 outside the square root, bias
correction), and a step is eager autograd in place of one jitted program.
``Algorithm`` is the reference's train loop, checkpoints and Tune adapter;
each algorithm's ``setup`` creates its rollout actors through the runtime
(``ray_tpu_torch/runtime.py``'s ``LocalRuntime`` unless one is given).

State crosses devices and packages as plain tensors keyed by parameter
name: ``get_weights`` -> ``{name: tensor}``, ``get_state`` ->
``{"params": ..., "opt_state": {name: {"step", "exp_avg",
"exp_avg_sq"}}}``. ``rllib/convert.py`` builds the same from the
reference's pytrees.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import (
    Any, Callable, ClassVar, Dict, Iterable, List, Optional, Tuple,
)

import numpy as np
import torch
from torch import nn

from ray_tpu_torch import random as rnd
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.policy import MLPPolicy, PolicySpec
from ray_tpu_torch.runtime import LocalRuntime

Batch = Dict[str, torch.Tensor]
Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AlgorithmConfig:
    """Chainable config shared by all algorithms (reference:
    ``algorithm_config.py`` — env/rollouts/training sections)."""

    env_creator: Optional[Callable[[], Any]] = None
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 200
    gamma: float = 0.99
    lr: float = 3e-4
    hidden: tuple = (64, 64)
    seed: int = 0
    # obs/action space; inferred from a probe env if None
    obs_dim: Optional[int] = None
    num_actions: Optional[int] = None

    # set by each subclass to its Algorithm class (not a dataclass field)
    _algo_cls: ClassVar[Any] = None

    def environment(self, env_creator) -> "AlgorithmConfig":
        self.env_creator = env_creator
        return self

    def rollouts(self, *, num_rollout_workers: int = None,
                 rollout_fragment_length: int = None) -> "AlgorithmConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k) or k.startswith("_"):
                raise ValueError(
                    f"unknown {type(self).__name__} option {k!r}")
            setattr(self, k, v)
        return self

    def infer_spaces(self) -> None:
        """Fill obs_dim/num_actions from a probe env instance."""
        if self.obs_dim is not None and self.num_actions is not None:
            return
        if self.env_creator is None:
            raise ValueError(
                f"{type(self).__name__}.environment(env_creator) required")
        probe = self.env_creator()
        self.obs_dim = int(np.prod(probe.observation_space.shape))
        act = probe.action_space
        if hasattr(act, "n"):
            self.num_actions = int(act.n)
        else:
            # Continuous (Box) space: SAC builds its own spec from the
            # recorded per-dimension bounds.
            self.num_actions = int(np.prod(act.shape))
            self.action_low = tuple(np.asarray(act.low).ravel().tolist())
            self.action_high = tuple(
                np.asarray(act.high).ravel().tolist())
        close = getattr(probe, "close", None)
        if close:
            close()

    def build(self, *, runtime: Any = None, device: DeviceLike = None,
              worker_device: DeviceLike = None) -> "Algorithm":
        if self._algo_cls is None:
            raise ValueError(
                f"{type(self).__name__} is not bound to an Algorithm")
        return self._algo_cls(self, runtime=runtime, device=device,
                              worker_device=worker_device)


# ---------------------------------------------------------------- helpers


def to_device(batch: Dict[str, Any], device: torch.device) -> Batch:
    """A batch of numpy columns as tensors on ``device``. Floats become
    float32, as the reference's jit makes them with 64-bit mode off."""
    out = {}
    for k, v in dict(batch).items():
        arr = np.asarray(v)
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float32, copy=False)
        out[k] = torch.as_tensor(arr, device=device)
    return out


def floats(aux: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar metrics as Python floats, read from the device at once."""
    vals = torch.stack([v.detach().float() for v in aux.values()]).tolist()
    return dict(zip(aux, vals))


def weights_of(module: nn.Module) -> Tensors:
    """The module's params by name, copied (the reference's arrays are
    immutable, so a caller may keep them across updates)."""
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


Named = Iterable[Tuple[str, torch.Tensor]]


def adam_state(opt: torch.optim.Adam, named: Named) -> Dict[str, dict]:
    """``opt``'s moments and step count for each ``(name, param)`` of
    ``named`` (optax's ``ScaleByAdamState``: ``count``, ``mu``, ``nu``)."""
    out = {}
    for name, p in named:
        st = opt.state.get(p)
        if st:
            out[name] = {"step": float(st["step"]),
                         "exp_avg": st["exp_avg"].detach().clone(),
                         "exp_avg_sq": st["exp_avg_sq"].detach().clone()}
    return out


def load_adam_state(opt: torch.optim.Adam, named: Named,
                    state: Dict[str, dict]) -> None:
    """Set ``opt``'s moments and step count from ``adam_state``'s form; a
    param missing from ``state`` starts fresh, as optax's zero moments."""
    for name, p in named:
        opt.state.pop(p, None)
        st = state.get(name)
        if st is not None:
            # torch keeps a non-fused, non-capturable Adam's step on the
            # CPU as a float32 tensor.
            opt.state[p] = {
                "step": torch.tensor(float(st["step"]), dtype=torch.float32),
                "exp_avg": torch.as_tensor(st["exp_avg"]).to(
                    p.device, p.dtype, copy=True),
                "exp_avg_sq": torch.as_tensor(st["exp_avg_sq"]).to(
                    p.device, p.dtype, copy=True)}


def backward(loss: torch.Tensor, module: nn.Module) -> None:
    """``loss.backward()`` into freshly cleared grads; a param the loss does
    not reach (the value head of BC's or DQN's loss) gets a zero grad, so
    Adam still decays its moments and counts the step, as optax does."""
    for p in module.parameters():
        p.grad = None
    loss.backward()
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


# ---------------------------------------------------------------- learner

LossFn = Callable[[nn.Module, Batch], Any]


class Learner:
    """Shared learner machinery (reference: ``core/learner/learner.py:89``
    — params + optimizer + an update built from a loss function).

    Subclasses pass ``loss_fn(policy, batch) -> (loss, aux_dict)`` and get
    the SGD step, the gradient split a ``LearnerGroup`` uses, and the
    checkpointable state accessors.
    """

    # name of the loss in step()'s metrics (DQN's reference calls it "loss")
    loss_key = "total_loss"

    def __init__(self, spec: PolicySpec, config: AlgorithmConfig,
                 loss_fn: LossFn, *, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.policy = MLPPolicy(spec, rnd.key(config.seed, device="cpu"),
                                device=self.device)
        self.optimizer = torch.optim.Adam(self.policy.parameters(),
                                          lr=config.lr)
        self._loss_fn = loss_fn

    def _loss(self, batch: Dict[str, Any]):
        return self._loss_fn(self.policy, to_device(batch, self.device))

    def step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One SGD step on the batch; returns float metrics."""
        loss, aux = self._loss(batch)
        backward(loss, self.policy)
        self.optimizer.step()
        aux[self.loss_key] = loss
        return floats(aux)

    # -- LearnerGroup protocol (reference: Learner.compute_gradients /
    #    apply_gradients) --------------------------------------------------

    def compute_grads(self, batch: Dict[str, Any]):
        """-> ({name: gradient}, float metrics), params untouched."""
        loss, aux = self._loss(batch)
        names, params = zip(*self.policy.named_parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        aux[self.loss_key] = loss
        return dict(zip(names, grads)), floats(aux)

    def apply_grads(self, grads: Tensors) -> None:
        for name, p in self.policy.named_parameters():
            p.grad = grads[name].to(p.device)
        self.optimizer.step()

    # -- weights / checkpointable state ------------------------------------

    def get_weights(self) -> Tensors:
        return weights_of(self.policy)

    def set_weights(self, params: Tensors) -> None:
        self.policy.load_state_dict(params)

    def get_state(self) -> Dict[str, Any]:
        return {"params": self.get_weights(),
                "opt_state": adam_state(self.optimizer,
                                        self.policy.named_parameters())}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.set_weights(state["params"])
        load_adam_state(self.optimizer, self.policy.named_parameters(),
                        state["opt_state"])


# -------------------------------------------------------------- algorithm


def on_cpu(tree: Any) -> Any:
    """``tree`` (nested dicts) with every tensor copied to the CPU, so a
    checkpoint restores on any device."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: on_cpu(v) for k, v in tree.items()}
    return tree


def save_state(path: str, state: Dict[str, Any]) -> str:
    """Pickle ``state`` (tensors on the CPU) to ``path``/algorithm_state.pkl
    and return the file's path."""
    os.makedirs(path, exist_ok=True)
    file = os.path.join(path, "algorithm_state.pkl")
    with open(file, "wb") as f:
        pickle.dump(on_cpu(state), f)
    return file


def load_state(path: str) -> Dict[str, Any]:
    """What ``save_state`` wrote; ``path`` is the file or its directory."""
    file = path if path.endswith(".pkl") else os.path.join(
        path, "algorithm_state.pkl")
    with open(file, "rb") as f:
        return pickle.load(f)


class Algorithm:
    """Base algorithm: the train loop's bookkeeping, checkpoints and the
    Tune adapter (reference: ``algorithm.py:183-304``).

    Subclasses implement ``setup()`` (create ``self.learner`` and, through
    ``self.runtime``, ``self.workers``) and ``training_step() -> metrics``.
    ``runtime`` is any object with the runtime seam's calls (the
    ``ray_tpu`` module, say); None means a new ``LocalRuntime``. The learner
    runs on ``device`` (``cuda`` when None), the rollout actors on
    ``worker_device`` (``device`` when None).
    """

    def __init__(self, config: AlgorithmConfig, *, runtime: Any = None,
                 device: DeviceLike = None,
                 worker_device: DeviceLike = None):
        if config.env_creator is None:
            raise ValueError(
                f"{type(config).__name__}.environment(env_creator) required")
        self.device = resolve_device(device)
        self.worker_device = (self.device if worker_device is None
                              else resolve_device(worker_device))
        self.runtime = LocalRuntime() if runtime is None else runtime
        self.config = config
        config.infer_spaces()
        self.spec = PolicySpec(config.obs_dim, config.num_actions,
                               config.hidden)
        self._np_rng = np.random.default_rng(config.seed)
        self.iteration = 0
        self.timesteps_total = 0
        self.learner: Any = None
        self.workers: List[Any] = []
        self.setup()

    # ------------------------------------------------------------ overrides

    def setup(self) -> None:
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    # ------------------------------------------------------------ train loop

    def train(self) -> Dict[str, Any]:
        """One iteration (reference: ``algorithm.py:1309`` training_step
        wrapped with iteration/timestep bookkeeping)."""
        t0 = time.perf_counter()
        metrics = self.training_step()
        dt = time.perf_counter() - t0
        self.iteration += 1
        steps = metrics.get("timesteps_this_iter", 0)
        self.timesteps_total += steps
        metrics.setdefault("training_iteration", self.iteration)
        metrics.setdefault("timesteps_total", self.timesteps_total)
        if steps and "env_steps_per_sec" not in metrics:
            metrics["env_steps_per_sec"] = steps / dt
        return metrics

    @staticmethod
    def _mean_returns_from(batches) -> Optional[float]:
        """Mean completed-episode return piggybacked on sample batches
        (non-blocking: no extra call behind in-flight sample tasks)."""
        returns: List[float] = []
        for b in batches:
            returns.extend(getattr(b, "completed_returns", None)
                           or b.get("completed_returns", ()))
        return float(np.mean(returns)) if returns else None

    def _rollout_actors(self, cls: type, *args, **kwargs) -> List[Any]:
        """``config.num_rollout_workers`` actors of ``cls`` on
        ``worker_device``, worker i seeded ``config.seed + 1 + i``."""
        actor_cls = self.runtime.remote(cls)
        return [actor_cls.options(num_cpus=1).remote(
                    *args, seed=self.config.seed + 1 + i,
                    device=self.worker_device, **kwargs)
                for i in range(self.config.num_rollout_workers)]

    # ------------------------------------------------------------ weights

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights) -> None:
        self.learner.set_weights(weights)

    # ------------------------------------------------------------ checkpoint

    def save_checkpoint(self, path: str) -> str:
        """Write the learner's state and the iteration counters (reference:
        ``Algorithm.save_checkpoint``); returns the checkpoint file's path.
        Plain pickle, every tensor on the CPU."""
        return save_state(path, {
            "learner_state": self.learner.get_state(),
            "iteration": self.iteration,
            "timesteps_total": self.timesteps_total,
            "config": dataclasses.asdict(
                dataclasses.replace(self.config, env_creator=None)),
        })

    def restore_checkpoint(self, path: str) -> None:
        state = load_state(path)
        self.learner.set_state(state["learner_state"])
        self.iteration = state["iteration"]
        self.timesteps_total = state["timesteps_total"]

    # ------------------------------------------------------------ lifecycle

    def stop(self) -> None:
        for w in self.workers:
            self.runtime.kill(w)
        self.workers = []

    @classmethod
    def as_trainable(cls, base_config: AlgorithmConfig,
                     stop_iters: int = 10, *,
                     report: Callable[[Dict[str, Any]], Any],
                     runtime: Any = None,
                     device: DeviceLike = None) -> Callable:
        """Function trainable for a Tuner (reference: Algorithm IS a
        Trainable; here a closure that passes each iteration's metrics to
        ``report``, such as ``ray_tpu.train.session.report``)."""

        def trainable(tune_config: Dict[str, Any]):
            cfg = dataclasses.replace(base_config, **tune_config)
            algo = cls(cfg, runtime=runtime, device=device)
            try:
                for _ in range(stop_iters):
                    report(algo.train())
            finally:
                algo.stop()

        return trainable
