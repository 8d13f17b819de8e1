"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device``, or ``cuda`` when it is None. Raises when CUDA is asked
    for (or defaulted to) and there is none: the port never falls back to
    the CPU on its own; a caller that wants the CPU says ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on CUDA and no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev
