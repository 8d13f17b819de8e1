"""Logical-axis sharding rules (port of ``ray_tpu/parallel/sharding.py``).

A rule table maps logical tensor axes ("batch", "embed", "mlp", ...) to
mesh axes, and DP vs FSDP vs TP is a different table, never a model
change. Where the reference builds a ``NamedSharding`` from a
``PartitionSpec``, the port builds DTensor placements: ``Shard(d)`` on
every mesh dim that tensor dim ``d`` maps to (a tuple entry such as
``batch=("dp", "fsdp")`` shards one dim over two mesh dims, the first
outermost, as DTensor shards a dim named twice in mesh-dim order), and
``Replicate()`` on the rest.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

MeshAxis = Union[str, Tuple[str, ...], None]


class PartitionSpec(tuple):
    """Mesh axes per tensor dim, as ``jax.sharding.PartitionSpec``: each
    entry None, a mesh axis name or a tuple of them."""

    def __new__(cls, *entries: MeshAxis):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def spec_placements(mesh, spec: Sequence[MeshAxis]) -> List[Any]:
    """DTensor placements on ``mesh`` for ``spec``: ``Shard(d)`` on each
    mesh dim that dim ``d``'s entry names, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = []
        for a in axes:
            if a not in names:
                raise ValueError(f"mesh axis {a!r} of {spec} is not one of "
                                 f"the mesh's {names}")
            m = names.index(a)
            if out[m] != Replicate():
                raise ValueError(f"mesh axis {a!r} shards two dims in {spec}")
            dims.append(m)
            out[m] = Shard(d)
        if dims != sorted(dims):
            raise ValueError(
                f"{entry} shards dim {d} over mesh axes out of the mesh's "
                f"order {names}; DTensor shards in mesh-dim order")
    return out


class NamedSharding:
    """A mesh and a ``PartitionSpec`` over its axes; ``placements`` are the
    DTensor placements they give."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def placements(self) -> List[Any]:
        return spec_placements(self.mesh, self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


class AxisRules(dict):
    """Mapping of logical axis name -> mesh axis (str, tuple of str, or None).

    Unknown logical axes resolve to None (replicated).
    """

    def spec(self, *logical_axes: Optional[str]) -> PartitionSpec:
        return PartitionSpec(*(self.get(a) for a in logical_axes))

    def mesh_axes(self, mesh, logical_axis: Optional[str]) -> Tuple[str, ...]:
        """The axes of ``mesh`` that ``logical_axis`` maps to, in the
        rule's order, without axes the mesh does not have."""
        m = self.get(logical_axis) if logical_axis is not None else None
        if m is None:
            return ()
        names = tuple(mesh.mesh_dim_names or ())
        ms = (m,) if isinstance(m, str) else tuple(m)
        return tuple(x for x in ms if x in names)

    def sharding(self, mesh, *logical_axes: Optional[str]) -> NamedSharding:
        # Drop rule entries naming axes the mesh doesn't have (lets one rule
        # table serve dp-only and dp×tp meshes alike).
        parts = []
        for a in logical_axes:
            ms = self.mesh_axes(mesh, a)
            parts.append(None if not ms else ms[0] if len(ms) == 1 else ms)
        return NamedSharding(mesh, PartitionSpec(*parts))


# Fully-sharded-data-parallel + tensor-parallel rule table for transformer
# blocks. "batch" spans dp+fsdp (params sharded over fsdp like ZeRO-3),
# sequence over sp (context parallelism), hidden over tp.
DEFAULT_RULES = AxisRules(
    batch=("dp", "fsdp"),
    seq="sp",
    embed="fsdp",
    heads="tp",
    kv=None,
    mlp="tp",
    vocab="tp",
    stages="pp",
    experts="ep",
)


def logical_sharding(
    mesh, logical_axes: Sequence[Optional[str]],
    rules: Optional[AxisRules] = None,
) -> NamedSharding:
    rules = rules if rules is not None else DEFAULT_RULES
    return rules.sharding(mesh, *logical_axes)


def distribute(x, sharding: NamedSharding):
    """``x`` (a tensor or numpy array with the same value on every rank of
    the mesh) as a DTensor laid out by ``sharding``: each rank keeps a copy
    of its own shard; nothing is sent. A leaf that requires grad stays
    one."""
    from torch.distributed.tensor import DTensor, Replicate

    from ray_tpu_torch.parallel.collective import redistribute_local

    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    mesh, placements = sharding.mesh, sharding.placements
    local = redistribute_local(t.detach().to(mesh.device_type), mesh,
                               [Replicate()] * len(placements), placements)
    out = DTensor.from_local(local.clone(), mesh, placements,
                             run_check=False)
    return out.requires_grad_(t.requires_grad)


def gather_full(x) -> torch.Tensor:
    """The whole tensor of DTensor ``x`` on every rank (collective over the
    dims that shard it), through ``torch.distributed``'s plain ops."""
    from torch.distributed.tensor import Replicate

    from ray_tpu_torch.parallel.collective import redistribute_local

    return redistribute_local(x.to_local(), x.device_mesh, x.placements,
                              [Replicate()] * len(x.placements))


def shard_pytree(tree: Any, mesh, axes_tree: Any,
                 rules: Optional[AxisRules] = None) -> Any:
    """A tree (nested dicts) of DTensors laid out by a matching tree of
    logical-axis tuples (None entries replicate); see ``distribute``."""
    rules = rules if rules is not None else DEFAULT_RULES

    def put(x, axes):
        if isinstance(x, dict):
            return {k: put(x[k], axes[k]) for k in x}
        return distribute(x, rules.sharding(mesh, *(axes or ())))

    return put(tree, axes_tree)


class _Constrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, placements):
        from torch.distributed.tensor import DTensor

        from ray_tpu_torch.parallel.collective import redistribute_local

        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        local = redistribute_local(x.to_local(), ctx.mesh, ctx.placements,
                                   placements)
        return DTensor.from_local(local.view_as(local), ctx.mesh, placements,
                                  run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        from ray_tpu_torch.parallel.collective import redistribute_local

        local = redistribute_local(g.to_local(), ctx.mesh, g.placements,
                                   ctx.placements)
        return DTensor.from_local(local, ctx.mesh, ctx.placements,
                                  run_check=False), None


def with_logical_constraint(x, mesh, *logical_axes: Optional[str],
                            rules: Optional[AxisRules] = None):
    """``x`` (a DTensor on ``mesh``) laid out by logical axis names, the
    port of ``lax.with_sharding_constraint``: differentiable, its gradient
    laid out back as ``x``. Collective over the mesh dims that change."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError("with_logical_constraint takes a DTensor; "
                        "distribute a plain tensor with shard_pytree")
    rules = rules if rules is not None else DEFAULT_RULES
    return _Constrain.apply(x, tuple(rules.sharding(mesh, *logical_axes)
                                     .placements))
