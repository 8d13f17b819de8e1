"""Small dense nets (port of ``ray_tpu/models/mlp.py``; fashion-MNIST
scale, BASELINE.json config 2).

The reference's params and math: ``{"layers": [{"w": [din, dout], "b":
[dout]}, ...]}``, He-normal weights (std sqrt(2 / din)), zero biases, relu
between layers and none after the last. What changes: draws come from an
explicit ``torch.Generator`` in place of a JAX key, so the port's own init
gives other values; ``mlp_params_from_numpy`` carries the reference's
params over.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: Sequence[int] = (128, 128)
    out_dim: int = 10
    dtype: torch.dtype = torch.float32


def _dims(cfg: MLPConfig):
    dims = [cfg.in_dim, *cfg.hidden, cfg.out_dim]
    return list(zip(dims[:-1], dims[1:]))


def mlp_init(cfg: MLPConfig, *, generator: torch.Generator,
             device: DeviceLike = None) -> Dict[str, Any]:
    """He-normal weights drawn on ``generator``'s device, zero biases, on
    ``device`` (default ``cuda``) in ``cfg.dtype``."""
    device = resolve_device(device)
    layers = []
    for din, dout in _dims(cfg):
        w = torch.empty((din, dout), dtype=torch.float32,
                        device=generator.device)
        w.normal_(0.0, (2.0 / din) ** 0.5, generator=generator)
        layers.append({
            "w": w.to(device, cfg.dtype).requires_grad_(True),
            "b": torch.zeros(dout, dtype=cfg.dtype,
                             device=device).requires_grad_(True)})
    return {"layers": layers}


def mlp_forward(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    *hidden, last = params["layers"]
    for lyr in hidden:
        x = torch.relu(x @ lyr["w"] + lyr["b"])
    return x @ last["w"] + last["b"]


def mlp_params_from_numpy(tree: Mapping[str, Any], cfg: MLPConfig,
                          device: DeviceLike = None) -> Dict[str, Any]:
    """The port's params from the reference's as numpy arrays (for example
    ``jax.tree.map(np.asarray, params)``), in ``cfg.dtype`` on ``device``
    (default ``cuda``). Raises if the layer count or a shape differs from
    ``cfg``'s."""
    device = resolve_device(device)
    dims = _dims(cfg)
    layers = list(tree["layers"])
    if len(layers) != len(dims):
        raise ValueError(f"expected {len(dims)} layers, got {len(layers)}")
    out = []
    for i, (lyr, (din, dout)) in enumerate(zip(layers, dims)):
        conv = {}
        for name, shape in (("w", (din, dout)), ("b", (dout,))):
            arr = np.array(lyr[name], dtype=np.float32)
            if arr.shape != shape:
                raise ValueError(f"layers[{i}][{name!r}]: expected shape "
                                 f"{shape}, got {arr.shape}")
            conv[name] = torch.from_numpy(arr).to(
                device, cfg.dtype).requires_grad_(True)
        out.append(conv)
    return {"layers": out}
