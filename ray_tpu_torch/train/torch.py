"""Torch data-parallel helpers (port of ``ray_tpu/train/torch.py``):
``prepare_model`` replicates rank 0's weights, ``backward_allreduce``
averages gradients across the gang in DDP-style buckets.

Both take an ``nn.Module`` or an iterable of tensors, such as
``models.transformer.tree_leaves(params)`` of the port's GPT. On a
``torch_dist`` group a bucket is reduced on the group's device with no
numpy round trip: on the GPUs themselves under NCCL, staged through the
host under gloo. On a ``store`` group it goes through numpy, as the
reference's does.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Union

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.parallel import collective
from ray_tpu_torch.train import session as session_mod
from ray_tpu_torch.train.data_parallel import DataParallelTrainer

Params = Union[nn.Module, Iterable[torch.Tensor]]


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer whose workers run torch loops over the ``store``
    backend (``TorchDistTrainer`` joins a torch.distributed world)."""

    _default_backend = "store"


def _tensors(model: Params) -> List[torch.Tensor]:
    if isinstance(model, nn.Module):
        return list(model.parameters())
    return list(model)


def _gang_group(group: Optional[collective.BaseGroup]):
    """``group``, or the session's group when the gang has more than one
    rank; None when there is nothing to reduce across."""
    if group is None:
        sess = session_mod._get_session()
        if sess.world_size == 1 or not sess.collective_group_name:
            return None
        group = collective.get_group(sess.collective_group_name)
    return group if group.world_size > 1 else None


def prepare_model(model: Params, *,
                  broadcast_parameters: bool = True) -> Params:
    """Broadcast rank 0's weights so every rank starts identical."""
    group = _gang_group(None)
    if group is None or not broadcast_parameters:
        return model
    on_device = isinstance(group, collective.TorchDistGroup)
    with torch.no_grad():
        for p in _tensors(model):
            src = p.detach() if on_device else p.detach().cpu().numpy()
            out = group.broadcast(src, src_rank=0)
            p.copy_(out if on_device else torch.from_numpy(out))
    return model


# DDP's bucket cap: one collective per ~25 MB of gradients, not one per
# parameter.
_BUCKET_CAP_BYTES = 25 * 1024 * 1024


def backward_allreduce(model: Params, *,
                       bucket_cap_bytes: int = _BUCKET_CAP_BYTES,
                       group: Optional[collective.BaseGroup] = None) -> None:
    """Average gradients across the gang after ``loss.backward()``; call
    once per step. Gradients are coalesced into flat float32 buckets of at
    most ``bucket_cap_bytes``, one collective each. ``group`` defaults to
    the session's; a process started outside the trainer passes its own
    (a ``TorchDistGroup`` met at an ``address``)."""
    group = _gang_group(group)
    if group is None:
        return
    ws = group.world_size
    on_device = isinstance(group, collective.TorchDistGroup)
    params = [p for p in _tensors(model) if p.grad is not None]

    def flush(bucket):
        grads = [p.grad.detach().reshape(-1).float() for p in bucket]
        if on_device:
            flat = torch.cat([g.to(group.device) for g in grads])
            out = group.allreduce(flat) / ws
        else:
            flat = np.concatenate([g.cpu().numpy() for g in grads])
            out = torch.from_numpy(np.asarray(group.allreduce(flat)) / ws)
        off = 0
        with torch.no_grad():
            for p in bucket:
                n = p.grad.numel()
                p.grad.copy_(out[off:off + n].view_as(p.grad))
                off += n

    bucket: list = []
    bucket_bytes = 0
    for p in params:
        nbytes = p.grad.numel() * 4
        if bucket and bucket_bytes + nbytes > bucket_cap_bytes:
            flush(bucket)
            bucket, bucket_bytes = [], 0
        bucket.append(p)
        bucket_bytes += nbytes
    if bucket:
        flush(bucket)


def prepare_data_loader(dataset, *, batch_size: int, shuffle: bool = True,
                        seed: int = 0):
    """Shard a torch dataset across the gang (rank r takes every
    world_size-th example of one seeded permutation)."""
    from torch.utils.data import DataLoader, Subset

    sess = session_mod._get_session()
    idx = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    shard = idx[sess.world_rank::sess.world_size]
    return DataLoader(Subset(dataset, shard.tolist()),
                      batch_size=batch_size, shuffle=shuffle)
