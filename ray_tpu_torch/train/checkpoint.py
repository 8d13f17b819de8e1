"""Checkpoints (port of ``ray_tpu/train/checkpoint.py``).

A checkpoint is a directory. A dict payload is pickled to
``<dir>/_dict.pkl``, as the reference's is. A pytree payload, a nested dict
(or list) of tensors such as a model's params, is ``torch.save``d to
``<dir>/pytree.pt`` and loaded with ``weights_only=True`` onto the caller's
device; the reference's orbax layout has no counterpart here.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.device import DeviceLike, resolve_device

_DICT_FILE = "_dict.pkl"
_PYTREE_FILE = "pytree.pt"


class Checkpoint:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    # ------------------------------------------------------------- creation

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any],
                  path: Optional[str] = None) -> "Checkpoint":
        path = path or tempfile.mkdtemp(prefix="rtpu_ckpt_")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _DICT_FILE), "wb") as f:
            pickle.dump(data, f)
        return cls(path)

    @classmethod
    def from_pytree(cls, tree: Any, path: Optional[str] = None,
                    extra: Optional[Dict[str, Any]] = None) -> "Checkpoint":
        """Save a nested dict of tensors (params, optimizer moments);
        ``extra`` holds small picklable metadata (step, config)."""
        path = path or tempfile.mkdtemp(prefix="rtpu_ckpt_")
        os.makedirs(path, exist_ok=True)
        torch.save(tree, os.path.join(path, _PYTREE_FILE))
        if extra is not None:
            with open(os.path.join(path, _DICT_FILE), "wb") as f:
                pickle.dump(extra, f)
        return cls(path)

    # -------------------------------------------------------------- reading

    def to_dict(self) -> Dict[str, Any]:
        fp = os.path.join(self.path, _DICT_FILE)
        if not os.path.exists(fp):
            raise ValueError(f"checkpoint at {self.path} has no dict payload")
        with open(fp, "rb") as f:
            return pickle.load(f)

    def to_pytree(self, device: DeviceLike = None) -> Any:
        """The saved tensors on ``device`` (``cuda`` unless the caller
        passes another)."""
        return torch.load(os.path.join(self.path, _PYTREE_FILE),
                          map_location=resolve_device(device),
                          weights_only=True)

    def has_pytree(self) -> bool:
        return os.path.isfile(os.path.join(self.path, _PYTREE_FILE))

    # ------------------------------------------------------------ transport

    def to_directory(self, path: str) -> str:
        if os.path.abspath(path) != self.path:
            shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    def move_to(self, path: str) -> "Checkpoint":
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.abspath(path) != self.path:
            if os.path.exists(path):
                shutil.rmtree(path)
            shutil.move(self.path, path)
        return Checkpoint(path)

    def __repr__(self):
        return f"Checkpoint({self.path})"
