"""Per-worker training session (port of ``ray_tpu/train/session.py``): the
user loop runs in a thread of its worker and talks to the trainer through
a report queue. ``get_device`` is the port's own: the device the rank's
tensors belong on.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.train.checkpoint import Checkpoint

_session_lock = threading.Lock()
_session: Optional["_TrainSession"] = None


class _TrainSession:
    def __init__(self, world_rank: int, world_size: int, local_rank: int,
                 checkpoint: Optional[Checkpoint], experiment_name: str = "",
                 collective_group_name: str = "",
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 device: Optional[torch.device] = None):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.experiment_name = experiment_name
        self.collective_group_name = collective_group_name
        self.device = device if device is not None else torch.device("cpu")
        self._start_checkpoint = checkpoint
        self.dataset_shards = dataset_shards or {}
        self.reports: "queue.Queue" = queue.Queue()
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None):
        self.reports.put({"metrics": dict(metrics),
                          "checkpoint": checkpoint})

    def drain(self):
        out = []
        while True:
            try:
                out.append(self.reports.get_nowait())
            except queue.Empty:
                return out


def _init_session(**kwargs) -> _TrainSession:
    global _session
    with _session_lock:
        _session = _TrainSession(**kwargs)
        return _session


def _shutdown_session():
    global _session
    with _session_lock:
        _session = None


def _get_session() -> _TrainSession:
    if _session is None:
        raise RuntimeError(
            "No training session active — this API must be called from "
            "inside a train_loop_per_worker.")
    return _session


# ------------------------------------------------------------- public API

def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (and optionally a checkpoint) to the trainer."""
    _get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint to resume from, if the run was restored."""
    return _get_session()._start_checkpoint


def get_dataset_shard(name: str = "train"):
    """This worker's shard of a dataset passed to the trainer as
    ``datasets={name: ds}``."""
    shards = _get_session().dataset_shards
    if name not in shards:
        raise KeyError(
            f"no dataset shard named {name!r}; trainer datasets: "
            f"{sorted(shards)}")
    return shards[name]


def get_world_rank() -> int:
    return _get_session().world_rank


def get_world_size() -> int:
    return _get_session().world_size


def get_local_rank() -> int:
    return _get_session().local_rank


def get_device() -> torch.device:
    """The device this rank computes on (its pinned GPU, or the CPU)."""
    return _get_session().device


def get_context() -> _TrainSession:
    return _get_session()


def allreduce(tensor, op=None):
    """Allreduce over the gang's collective group: the one-line gradient
    sync of a data-parallel loop."""
    from ray_tpu_torch.parallel import collective

    sess = _get_session()
    if sess.world_size == 1 or not sess.collective_group_name:
        return tensor
    kwargs = {"op": op} if op is not None else {}
    return collective.allreduce(tensor, sess.collective_group_name, **kwargs)
