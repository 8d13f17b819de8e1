"""Parallelism layer (port of ``ray_tpu/parallel``): collective groups.

``collective`` holds the reference's three backends under the port's
names: ``local`` (a list of devices in one process), ``torch_dist`` (one
``torch.distributed`` world, NCCL on CUDA, gloo on the CPU) and ``store``
(numpy through a coordinator actor). Meshes, sharding rules and pipeline
schedules are not ported yet; they build on these groups.
"""

from ray_tpu_torch.parallel import collective  # noqa: F401

__all__ = ["collective"]
