"""Parallelism layer (port of ``ray_tpu/parallel``): device meshes, sharding
rules, collectives and the pipeline schedule.

``collective`` holds the reference's three backends under the port's
names: ``local`` (a list of devices in one process), ``torch_dist`` (one
``torch.distributed`` world, NCCL on CUDA, gloo on the CPU or for ranks
that share a GPU) and ``store`` (numpy through a coordinator actor), plus
the differentiable collectives of an SPMD body (``psum``, ``all_gather``,
``ppermute``) and ``shard_map_compat``. A mesh is a ``DeviceMesh`` over the
ranks of the world (``mesh``); logical-axis rules lay DTensors out on it
(``sharding``); ``pipeline`` runs GPipe over its ``pp`` dim.
"""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    make_mesh,
    mesh_shape_for,
    topology_info,
    best_mesh_axes,
)
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    AxisRules,
    logical_sharding,
    shard_pytree,
    with_logical_constraint,
    DEFAULT_RULES,
)
from ray_tpu_torch.parallel import collective  # noqa: F401

__all__ = [
    "MeshConfig",
    "make_mesh",
    "mesh_shape_for",
    "topology_info",
    "best_mesh_axes",
    "AxisRules",
    "logical_sharding",
    "shard_pytree",
    "with_logical_constraint",
    "DEFAULT_RULES",
    "collective",
]
