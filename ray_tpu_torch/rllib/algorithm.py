"""The shared config and learner (port of ``ray_tpu/rllib/algorithm.py``
:25-180).

``AlgorithmConfig`` is the reference's chainable config without ``build``:
``Algorithm`` (setup, ``training_step``, checkpoints) drives rollout actors
through the runtime and waits for the port's runtime seam. ``Learner`` is
the reference's learner with torch in place of jax and optax: params live in
an ``MLPPolicy`` module on ``device`` (default ``cuda``), ``optax.adam(lr)``
is ``torch.optim.Adam(lr)`` (the same defaults: betas 0.9/0.999, eps 1e-8
outside the square root, bias correction), and a step is eager autograd in
place of one jitted program.

State crosses devices and packages as plain tensors keyed by parameter
name: ``get_weights`` -> ``{name: tensor}``, ``get_state`` ->
``{"params": ..., "opt_state": {name: {"step", "exp_avg",
"exp_avg_sq"}}}``. ``rllib/convert.py`` builds the same from the
reference's pytrees.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch import random as rnd
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.policy import MLPPolicy, PolicySpec

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
