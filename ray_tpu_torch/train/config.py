"""Run, scaling and failure configuration (port of
``ray_tpu/train/config.py``)."""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclasses.dataclass
class ScalingConfig:
    """How many workers and what each holds.

    ``use_gpu`` gives each worker one GPU (``num_gpus``) as the reference's
    ``use_tpu`` gives one TPU chip; ``resources_per_worker`` may name
    ``"GPU"`` itself. The reference's ``topology`` (an ICI sub-slice) has
    no GPU counterpart. ``worker_runtime_env`` goes to every gang worker;
    a CUDA gang adds each rank's ``CUDA_VISIBLE_DEVICES`` to it.
    """

    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    worker_runtime_env: Optional[Dict[str, Any]] = None

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        if "CPU" not in res:
            res["CPU"] = 1.0
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1.0
        return res


@dataclasses.dataclass
class FailureConfig:
    """``max_failures=0`` fails fast; -1 restarts without limit."""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    verbose: int = 0

    def resolved_storage_path(self) -> str:
        return self.storage_path or os.path.join(
            tempfile.gettempdir(), "ray_tpu_results")


@dataclasses.dataclass
class Result:
    """Outcome of a training run."""

    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Checkpoint]
    path: Optional[str]
    error: Optional[BaseException] = None
    metrics_history: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    # How many times the gang was torn down and re-formed from the latest
    # checkpoint during this run, and why.
    num_restarts: int = 0
    restart_reasons: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.error is None
