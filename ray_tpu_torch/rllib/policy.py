"""Actor-critic MLP policy (port of ``ray_tpu/rllib/policy.py``).

The reference keeps params as a pytree beside stateless functions; here
``MLPPolicy`` is an ``nn.Module`` that owns them, with the reference's
names and layouts (``trunk.<i>``, ``pi``, ``v``, each ``w`` [din, dout] and
``b`` [dout]), so a converted pytree loads by name (``rllib/convert.py``).
Initialisation draws with the port's threefry ``normal`` from the same key
as the reference and runs on the CPU, so every device starts from the same
params; they equal the reference's to the few ulp ``random.normal`` is
off by.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch import random as rnd
from ray_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    obs_dim: int
    num_actions: int
    hidden: Sequence[int] = (64, 64)


class Dense(nn.Module):
    """``x @ w + b`` in the reference's layout."""

    def __init__(self, key: torch.Tensor, din: int, dout: int, scale: float):
        super().__init__()
        # The reference multiplies the f32 draw by the f32 rounding of its
        # scale (a numpy float64 or a Python float, both taken as f32).
        self.w = nn.Parameter(rnd.normal(key, (din, dout))
                              * float(np.float32(scale)))
        self.b = nn.Parameter(torch.zeros(dout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class MLPPolicy(nn.Module):
    """Tanh MLP trunk, a categorical head and a value head."""

    def __init__(self, spec: PolicySpec, key: torch.Tensor, *,
                 device: DeviceLike = None):
        super().__init__()
        self.spec = spec
        dims = [spec.obs_dim, *spec.hidden]
        keys = rnd.split(key.cpu(), len(dims) + 1)
        self.trunk = nn.ModuleList(
            Dense(k, din, dout, math.sqrt(2.0 / din))
            for k, (din, dout) in zip(keys, zip(dims[:-1], dims[1:])))
        self.pi = Dense(keys[-2], dims[-1], spec.num_actions, 0.01)
        self.v = Dense(keys[-1], dims[-1], 1, 1.0)
        self.to(resolve_device(device))

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits [B, A], values [B])."""
        x = obs
        for layer in self.trunk:
            x = torch.tanh(layer(x))
        return self.pi(x), self.v(x)[:, 0]

    def sample_action(self, obs: torch.Tensor, key: torch.Tensor):
        """-> (action [B], logp [B], value [B]) for one observation batch;
        the action is ``jax.random.categorical(key, logits)``'s."""
        logits, values = self(obs)
        action = rnd.categorical(key, logits)
        logp = torch.log_softmax(logits, -1).gather(1, action[:, None])[:, 0]
        return action, logp, values
