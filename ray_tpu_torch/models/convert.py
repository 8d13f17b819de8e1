"""Carry reference params over to the port.

``params_from_numpy`` takes the JAX params pytree as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``) and returns the port's params.
It is a rename, not a reshape: both sides keep the same names and layouts
(``wqkv`` [L, D, 3, H, Dh], ``wo`` [L, H, Dh, D], stacked ``layers`` dim).
It takes numpy in, so it never needs JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.transformer import GPTConfig, Params, init_params


def params_from_numpy(tree: Mapping[str, Any], cfg: GPTConfig,
                      device: DeviceLike = None) -> Params:
    """Port params for ``cfg`` from a nested dict of numpy arrays, in
    ``cfg.param_dtype`` on ``device`` (default ``cuda``), ready to train.
    Raises if a name or shape differs from what ``init_params`` makes."""
    device = resolve_device(device)
    expected = init_params(cfg, generator=torch.Generator(), device="meta")

    def convert(node, spec, path):
        if isinstance(spec, dict):
            if not isinstance(node, Mapping) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, Mapping) else type(node)
                raise ValueError(f"params{path}: expected keys "
                                 f"{sorted(spec)}, got {got}")
            return {k: convert(node[k], spec[k], f"{path}[{k!r}]")
                    for k in spec}
        arr = np.asarray(node)
        if arr.shape != tuple(spec.shape):
            raise ValueError(f"params{path}: expected shape "
                             f"{tuple(spec.shape)}, got {arr.shape}")
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        return t.to(device, cfg.param_dtype).requires_grad_(True)

    return convert(tree, expected, "")
