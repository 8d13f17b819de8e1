"""Device meshes over a ``torch.distributed`` world (port of
``ray_tpu/parallel/mesh.py``).

The reference's mesh is a ``jax.sharding.Mesh`` of the devices of one SPMD
program. Here one rank (one process) stands for one device, and a mesh is a
``DeviceMesh`` over the ranks of the current ``torch.distributed`` world,
its dims named by the reference's axis names in the reference's order
(dp, fsdp, pp, ep, sp, tp), outermost first: later axes get adjacent ranks.

Every function here that reads the world (``make_mesh``, ``topology_info``,
``local_device_count``, ``host_mesh_devices``) is collective: every rank of
the world calls it.
"""

from __future__ import annotations

import dataclasses
import math
import socket
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ray_tpu_torch.device import DeviceLike, resolve_device

# Canonical axis order, outermost first.
AXIS_ORDER: Tuple[str, ...] = ("dp", "fsdp", "pp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes of each parallelism axis. ``-1`` on at most one axis means
    "absorb all remaining devices" (like torch's DeviceMesh -1)."""

    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes ({fixed})")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return MeshConfig(**sizes)

    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def nontrivial(self) -> Dict[str, int]:
        return {a: s for a, s in self.axis_sizes().items() if s > 1}


def _world():
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed world in this process: join one first "
            "(parallel.collective.join_world), one rank per device")
    return dist


def _hostnames() -> List[str]:
    """Each rank's host name, in rank order (collective)."""
    dist = _world()
    names: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return [str(n) for n in names]


def topology_info(device: DeviceLike = None) -> dict:
    """The accelerators of this world: platform ``gpu`` (``cpu`` for a
    world on the CPU), the card's name, the world's ranks as its devices
    and its hosts counted by host name. Collective when a world exists;
    without one, this process's devices."""
    dev = resolve_device(device)
    import torch.distributed as dist

    if dev.type == "cuda":
        platform, kind = "gpu", torch.cuda.get_device_name(dev)
    else:
        platform, kind = "cpu", "cpu"
    if dist.is_initialized():
        n, hosts = dist.get_world_size(), len(set(_hostnames()))
    else:
        n, hosts = (torch.cuda.device_count() if dev.type == "cuda" else 1), 1
    return {"platform": platform, "device_kind": kind, "num_devices": n,
            "num_hosts": hosts, "coords": None}


def best_mesh_axes(n_devices: int, model_parallel: int = 1) -> MeshConfig:
    """Heuristic default: put ``model_parallel`` on tp (innermost), the
    rest on dp."""
    if n_devices % model_parallel:
        raise ValueError(
            f"{n_devices} devices not divisible by tp={model_parallel}")
    return MeshConfig(dp=n_devices // model_parallel, tp=model_parallel)


def mesh_shape_for(config: MeshConfig,
                   n_devices: int) -> Tuple[Tuple[str, int], ...]:
    resolved = config.resolve(n_devices)
    return tuple((a, getattr(resolved, a)) for a in AXIS_ORDER)


def make_mesh(
    config: Optional[MeshConfig] = None,
    *,
    axes: Optional[Dict[str, int]] = None,
    ranks: Optional[Sequence[int]] = None,
    keep_trivial: bool = False,
    device: DeviceLike = None,
):
    """A ``DeviceMesh`` over ``ranks`` (default: every rank of the world,
    in order) with the reference's axis names and order, its tensors on
    ``device``'s type (default ``cuda``). Collective over the world.

    ``axes`` is the dict form ({"dp": 2, "tp": 4}); unlisted axes are 1.
    Trivial (size-1) axes are dropped unless ``keep_trivial`` ({"dp": 1}
    when none is left)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    dev = resolve_device(device)
    dist = _world()
    world = dist.get_world_size()
    rank_list = list(range(world) if ranks is None else ranks)
    if config is None:
        cfg_axes = dict(axes or {})
        unknown = set(cfg_axes) - set(AXIS_ORDER)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; "
                             f"have {AXIS_ORDER}")
        config = MeshConfig(**{a: cfg_axes.get(a, 1) for a in AXIS_ORDER})
    config = config.resolve(len(rank_list))

    sizes = config.axis_sizes()
    if not keep_trivial:
        sizes = {a: s for a, s in sizes.items() if s > 1} or {"dp": 1}
    names = tuple(sizes)
    shape = tuple(sizes.values())
    if math.prod(shape) != len(rank_list):
        raise ValueError(f"mesh {sizes} != {len(rank_list)} devices")
    if ranks is None:
        return init_device_mesh(dev.type, shape, mesh_dim_names=names)
    if len(set(rank_list)) != len(rank_list) or not all(
            0 <= r < world for r in rank_list):
        raise ValueError(f"ranks {rank_list} are not distinct ranks of a "
                         f"world of {world}")
    return DeviceMesh(dev.type, torch.tensor(rank_list).view(shape),
                      mesh_dim_names=names)


def axis_size(mesh, name: str) -> int:
    """The size of ``mesh``'s dim ``name``, 1 when the mesh has none."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def local_device_count() -> int:
    """The ranks of the world on this host (collective), or this process's
    CUDA devices without a world."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return torch.cuda.device_count()
    return len(host_mesh_devices(None))


def host_mesh_devices(mesh=None) -> List[int]:
    """The ranks of ``mesh`` (default: the world) on this host, for
    per-host data feeding (collective over the world)."""
    names = _hostnames()
    here = socket.gethostname()
    ranks = (range(len(names)) if mesh is None
             else mesh.mesh.flatten().tolist())
    return [r for r in ranks if names[r] == here]
