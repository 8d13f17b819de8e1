"""Pipeline parallelism over the ``pp`` mesh axis, GPipe schedule (port of
``ray_tpu/parallel/pipeline.py``).

Stages are the ranks of the ``pp`` mesh dim, all running one program:
activations hop stage to stage through ``collective.ppermute`` and
microbatches fill the pipeline GPipe-style (P-1 bubble ticks, then steady
state). The stacked layer params [L, ...] are sharded over pp on the
leading dim: stage s holds layers [s*L/P, (s+1)*L/P). Each tick every stage
runs its layer block on its current activation, then the activations
rotate +1 around the ring. As in the reference every stage runs every tick
(a stage's result outside the schedule is never emitted) and choices that
depend on the stage are ``torch.where`` selections, so each rank records
the same autograd graph and the backward's collectives line up.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ray_tpu_torch.parallel.collective import ppermute, psum, shard_map_compat
from ray_tpu_torch.parallel.sharding import PartitionSpec as P


def pipeline_body(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  params: Any, x_mb: torch.Tensor, mesh_dim) -> torch.Tensor:
    """The schedule on one rank: ``params`` this stage's layer shard,
    ``x_mb`` [M, mb, ...] the microbatches (the same on every stage).
    Returns the last stage's outputs [M, mb, ...] on every stage (summed
    over pp, the other stages contributing zeros)."""
    pp = mesh_dim.size()
    idx = mesh_dim.get_local_rank()
    M = x_mb.shape[0]
    perm = [(i, (i + 1) % pp) for i in range(pp)]
    first = torch.tensor(idx == 0, device=x_mb.device)
    last = torch.tensor(idx == pp - 1, device=x_mb.device)
    state = torch.zeros_like(x_mb[0])        # in-flight activation
    outputs = [torch.zeros_like(x_mb[0]) for _ in range(M)]
    T = M + pp - 1
    for t in range(T):
        # Stage 0 ingests microbatch t (the last one again past the end).
        state = torch.where(first, x_mb[min(t, M - 1)], state)
        state = stage_fn(params, state)
        # The last stage emits microbatch t-(P-1) once the fill is done.
        slot = t - (pp - 1)
        if slot >= 0:
            outputs[slot] = torch.where(last, state, outputs[slot])
        # Rotate activations one stage forward (the reference rotates after
        # the last tick too and drops the result).
        if t < T - 1:
            state = ppermute(state, perm, mesh_dim)
    out = torch.stack(outputs)
    return psum(torch.where(last, out, torch.zeros_like(out)), mesh_dim)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x,
    mesh,
    *,
    axis: str = "pp",
    num_microbatches: Optional[int] = None,
    data_spec: P = P(),
    param_spec_fn: Optional[Callable[[Any], Any]] = None,
):
    """Run ``x`` through P pipeline stages (collective over ``mesh``).

    stage_fn(stage_params_shard, mb) applies ONE stage's layers to a
    microbatch [mb, ...] -> same shape. ``stage_params`` leaves (DTensors)
    must have a leading layers dim divisible by P (sharded over ``axis``).
    ``x``: [B, ...]; B must divide by num_microbatches (default P);
    ``data_spec`` lays out the microbatch stack [M, B/M, ...]. Returns the
    outputs as that stack, a DTensor laid out by ``data_spec`` (the
    reference reshapes it to [B, ...])."""
    pp = mesh.size(mesh.mesh_dim_names.index(axis))
    M = num_microbatches or pp
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    x_mb = x.reshape((M, B // M) + tuple(x.shape[1:]))
    pspec = param_spec_fn(stage_params) if param_spec_fn else P(axis)
    fn = shard_map_compat(
        lambda params, xs: pipeline_body(stage_fn, params, xs, mesh[axis]),
        mesh=mesh, in_specs=(pspec, data_spec), out_specs=data_spec)
    return fn(stage_params, x_mb)


def stage_scan_fn(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor]):
    """Lift a single-layer fn into a stage fn looping over its layer shard
    (a dict of tensors with a leading layers dim). The layers are unbound
    once: indexing one out would give each a backward that writes a
    full-size zero gradient."""

    def stage(params_shard, x):
        split = {k: v.unbind(0) for k, v in params_shard.items()}
        for i in range(len(next(iter(split.values())))):
            x = layer_fn({k: v[i] for k, v in split.items()}, x)
        return x

    return stage
