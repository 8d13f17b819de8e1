"""Distributed training (port of ``ray_tpu/train``): the gang trainer, its
sessions, checkpoints and the torch data-parallel helpers.

The gang's ranks are actors of a runtime (the runtime seam): the
in-process ``LocalRuntime`` by default, which holds one rank, or any object
with its calls, such as the ``ray_tpu`` module. ``TorchDistTrainer`` takes
the place of ``JaxTrainer``: its ranks join one ``torch.distributed``
world. Checkpoints are plain pickle and ``torch.save`` files.
"""

from ray_tpu_torch.train.config import (  # noqa: F401
    ScalingConfig, RunConfig, FailureConfig, CheckpointConfig, Result,
)
from ray_tpu_torch.train.checkpoint import Checkpoint  # noqa: F401
from ray_tpu_torch.train import session  # noqa: F401
from ray_tpu_torch.train.session import (  # noqa: F401
    report, get_checkpoint, get_dataset_shard, get_world_rank,
    get_world_size, get_local_rank, get_device, get_context,
)
from ray_tpu_torch.train.data_parallel import (  # noqa: F401
    DataParallelTrainer, TorchDistTrainer,
)

__all__ = [
    "ScalingConfig", "RunConfig", "FailureConfig", "CheckpointConfig",
    "Result", "Checkpoint", "session", "report", "get_checkpoint",
    "get_dataset_shard", "get_world_rank", "get_world_size",
    "get_local_rank", "get_device", "get_context",
    "DataParallelTrainer", "TorchDistTrainer",
]
