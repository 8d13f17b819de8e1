"""Gloo worlds of spawned CPU ranks for the port's sharded tests.

``World(n)`` spawns ``n`` processes that join one gloo
``torch.distributed`` world and then run, all of them, every function
``World.run`` hands them (a function of this module or another importable
one, pickled by name), returning each rank's result. The ranks import
torch, numpy and ``ray_tpu_torch`` only: the JAX side of a test runs in the
pytest process. The rank functions below build a mesh over the first ranks
of the world (``make_mesh(ranks=...)``; every rank of the world takes part
in making it) and return numpy arrays.

A world that timed out, lost a rank, or got an error from some of its
ranks and not the same one from all, kills its ranks and refuses every
later call at once with that first error: a rank that failed
mid-collective leaves the others waiting in it, so a later call could
only wait out its own timeout. The same error from every rank (a check
each rank makes before any collective) leaves the world in step, and it
stays usable.
"""

from __future__ import annotations

import functools
import math
import multiprocessing as mp
import os
import traceback

import numpy as np
import torch

RANK_TIMEOUT_S = 240.0


def _rank_main(rank, world, addr, conn):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    from ray_tpu_torch.parallel.collective import join_world

    try:
        join_world(addr, world, rank, device="cpu", timeout_s=60.0)
        conn.send((True, None))
    except Exception:
        conn.send((False, traceback.format_exc()))
        return
    while True:
        msg = conn.recv()
        if msg is None:
            break
        fn, args = msg
        try:
            conn.send((True, fn(*args)))
        except Exception:
            conn.send((False, traceback.format_exc()))
    import torch.distributed as dist

    dist.destroy_process_group()


class World:
    def __init__(self, n: int):
        from ray_tpu_torch.parallel.collective import _free_port

        ctx = mp.get_context("spawn")
        addr = f"127.0.0.1:{_free_port()}"
        self.n = n
        self.error: Exception = None
        self.conns, self.procs = [], []
        for r in range(n):
            here, there = ctx.Pipe()
            p = ctx.Process(target=_rank_main, args=(r, n, addr, there),
                            daemon=True)
            p.start()
            self.conns.append(here)
            self.procs.append(p)
        self._collect()

    def _collect(self):
        out, errors = [], {}
        for r, c in enumerate(self.conns):
            if not c.poll(RANK_TIMEOUT_S):
                self._fail(TimeoutError(f"rank {r} gave no answer in "
                                        f"{RANK_TIMEOUT_S} s"))
            try:
                ok, val = c.recv()
            except (EOFError, OSError) as e:
                self._fail(RuntimeError(f"rank {r} is gone: {e!r}"))
            if ok:
                out.append(val)
            else:
                errors[r] = val
        if errors:
            error = RuntimeError("\n".join(
                f"rank {r}: {val}" for r, val in errors.items()))
            if len(errors) < self.n or len(set(errors.values())) > 1:
                self._fail(error)
            raise error
        return out

    def _fail(self, error: Exception):
        """Kill the ranks, keep ``error`` for every later call, raise it."""
        self.error = error
        self._kill()
        raise error

    def run(self, fn, *args):
        """``fn(*args)`` on every rank; the ranks' results in rank order.
        Raises the world's first error at once after a failed call."""
        if self.error is not None:
            raise RuntimeError(
                f"this world failed before: {self.error}") from self.error
        try:
            for c in self.conns:
                c.send((fn, args))
        except OSError as e:
            self._fail(RuntimeError(f"a rank is gone: {e!r}"))
        return self._collect()

    def _kill(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(timeout=5)

    def close(self):
        if self.error is not None:
            return  # the ranks were killed when the world failed
        for c in self.conns:
            try:
                c.send(None)
            except OSError:
                pass
        for p in self.procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)


# ------------------------------------------------------------ rank functions


def mesh_of(axes):
    from ray_tpu_torch.parallel import make_mesh

    n = math.prod(axes.values())
    return make_mesh(axes=axes, ranks=range(n), device="cpu"), n


def member(n):
    import torch.distributed as dist

    return dist.get_rank() < n


def tcfg(**kw):
    from ray_tpu_torch.models import GPTConfig

    return GPTConfig.preset("tiny", dtype=torch.float32, **kw)


def full(x):
    from ray_tpu_torch.parallel.sharding import gather_full

    return gather_full(x).detach().numpy()


def forward(axes, cfg_kw, tree, tokens):
    """The port's sharded forward: full logits."""
    from ray_tpu_torch import models as tm

    mesh, n = mesh_of(axes)
    if not member(n):
        return None
    cfg = tcfg(**cfg_kw)
    params = tm.params_from_numpy(tree, cfg, device="cpu", mesh=mesh)
    return full(tm.forward(params, torch.from_numpy(tokens), cfg, mesh=mesh))


def train_step(axes, cfg_kw, tree, tokens, lr, wd):
    """One sharded step of AdamW(lr, wd) with optax's defaults: the loss,
    the gradient norm and the params after, whole."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch.models import transformer as tt

    mesh, n = mesh_of(axes)
    if not member(n):
        return None
    cfg = tcfg(**cfg_kw)
    params = tm.params_from_numpy(tree, cfg, device="cpu", mesh=mesh)
    state = tt.new_train_state(params, functools.partial(
        torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=wd))
    t = torch.from_numpy(tokens)
    batch = {"inputs": t[:, :-1], "targets": t[:, 1:]}
    state, m = tm.make_train_step(cfg, mesh=mesh)(state, batch)

    def whole(tree):
        return {k: whole(v) if isinstance(v, dict) else full(v)
                for k, v in tree.items()}

    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": whole(state.params)}


def ring_op(axes, q, k, v, causal):
    """``ring_attention_sharded`` over sp: the output and the gradients of
    sum(out * w) for q, k and v (w seeded), whole."""
    from ray_tpu_torch.ops.attention import ring_attention_sharded
    from ray_tpu_torch.parallel.sharding import (
        NamedSharding, PartitionSpec as P, distribute,
    )

    mesh, n = mesh_of(axes)
    if not member(n):
        return None
    sh = NamedSharding(mesh, P(None, "sp", None, None))
    qs, ks, vs = (distribute(torch.from_numpy(a).requires_grad_(), sh)
                  for a in (q, k, v))
    out = ring_attention_sharded(qs, ks, vs, mesh, causal=causal)
    w = torch.from_numpy(np.random.default_rng(7).normal(
        size=q.shape).astype(np.float32))
    (out.to_local() * w.narrow(1, out.to_local().shape[1]
                               * mesh.get_local_rank("sp"),
                               out.to_local().shape[1])).sum().backward()
    return [full(x) for x in (out, qs.grad, ks.grad, vs.grad)]


def mesh_facts(axes, keep_trivial):
    """(dim names, shape) of ``make_mesh`` over the world."""
    from ray_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axes=axes, keep_trivial=keep_trivial, device="cpu")
    return tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape)


def topology():
    from ray_tpu_torch.parallel import topology_info
    from ray_tpu_torch.parallel.mesh import host_mesh_devices, \
        local_device_count

    return topology_info(device="cpu"), local_device_count(), \
        host_mesh_devices()


def rules_facts():
    """AxisRules on {dp 2, fsdp 2, tp 2} and on {dp 8}: specs and
    placements, as strings."""
    from ray_tpu_torch.parallel import AxisRules, make_mesh

    rules = AxisRules(batch=("dp", "fsdp"), embed="fsdp", mlp="tp")
    mesh = make_mesh(axes={"dp": 2, "fsdp": 2, "tp": 2}, device="cpu")
    sh = rules.sharding(mesh, "batch", None, "mlp")
    mesh_dp = make_mesh(axes={"dp": 8}, device="cpu")
    sh2 = rules.sharding(mesh_dp, "batch", "mlp")
    return (tuple(sh.spec), [str(p) for p in sh.placements],
            tuple(sh2.spec), [str(p) for p in sh2.placements],
            tuple(rules.spec("batch", "embed", "heads")))


def shard_tree(w, b):
    """``shard_pytree`` on {dp 4, tp 2}: placements, this rank's shard and
    the gathered whole of each leaf."""
    from ray_tpu_torch.parallel import AxisRules, make_mesh, shard_pytree
    from ray_tpu_torch.parallel.sharding import gather_full

    mesh = make_mesh(axes={"dp": 4, "tp": 2}, device="cpu")
    out = shard_pytree({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                       mesh, {"w": ("batch", "mlp"), "b": None},
                       AxisRules(batch="dp", mlp="tp"))
    return {k: ([str(p) for p in v.placements], v.to_local().numpy(),
                gather_full(v).numpy(), tuple(mesh.get_coordinate()))
            for k, v in out.items()}


def param_placements(axes):
    """Each GPT param's placements under ``shard_params`` on ``axes``."""
    from ray_tpu_torch import models as tm

    mesh, n = mesh_of(axes)
    if not member(n):
        return None
    cfg = tcfg(moe_experts=4)
    params = tm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    sharded = tm.shard_params(params, cfg, mesh)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict)
                else [str(p) for p in v.placements] for k, v in t.items()}

    return walk(sharded)


def ppermute_case(perm, x):
    """``ppermute`` over a 1-D mesh of the world: the result and the
    gradient of sum(result * (rank + 1)) for this rank's ``x[rank]``."""
    from ray_tpu_torch.parallel import make_mesh
    from ray_tpu_torch.parallel.collective import ppermute

    import torch.distributed as dist

    mesh = make_mesh(axes={"sp": dist.get_world_size()}, device="cpu")
    r = dist.get_rank()
    t = torch.from_numpy(x[r]).requires_grad_()
    out = ppermute(t, perm, mesh["sp"])
    (out * (r + 1)).sum().backward()
    return out.detach().numpy(), t.grad.numpy()


def redistribute_case(src, dst, full_np):
    """``redistribute_local`` on a {dp 2, tp 2} mesh between placement
    lists (strings "S0", "S1", "R", "P"): the result gathered whole. A
    Partial source holds full / 2 on each of its ranks' coordinates."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ray_tpu_torch.parallel.collective import redistribute_local

    def pl(s):
        return {"R": Replicate(), "P": Partial()}.get(s) or Shard(int(s[1]))

    mesh, n = mesh_of({"dp": 2, "tp": 2})
    if not member(n):
        return None
    full = torch.from_numpy(full_np)
    rep = [Replicate(), Replicate()]
    src_p, dst_p = [pl(s) for s in src], [pl(s) for s in dst]
    local = redistribute_local(full, mesh, rep,
                               [Replicate() if p.is_partial() else p
                                for p in src_p])
    for m, p in enumerate(src_p):
        if p.is_partial():
            local = local / mesh.size(m)
    out = redistribute_local(local, mesh, src_p, dst_p)
    return redistribute_local(out, mesh, dst_p, rep).numpy()


def constrain_case(full_np):
    """``with_logical_constraint`` from (batch over dp) to (mlp over tp):
    the local shard after, and the gradient of sum(out * coord) whole."""
    from ray_tpu_torch.parallel import AxisRules
    from ray_tpu_torch.parallel.sharding import (
        distribute, gather_full, with_logical_constraint,
    )

    mesh, n = mesh_of({"dp": 2, "tp": 2})
    if not member(n):
        return None
    rules = AxisRules(batch="dp", mlp="tp")
    x = distribute(torch.from_numpy(full_np).requires_grad_(),
                   rules.sharding(mesh, "batch", None))
    y = with_logical_constraint(x, mesh, None, "mlp", rules=rules)
    (y.to_local() * 2.0).sum().backward()
    return ([str(p) for p in y.placements], y.to_local().detach().numpy(),
            gather_full(x.grad).numpy())


def pipeline_case(w_np, x_np, microbatches):
    """``pipeline_apply`` over {pp 2} of ``stage_scan_fn`` stages, h ->
    tanh(h @ w[i]) for each local layer i: the output and the gradient of
    its sum for w, whole."""
    from ray_tpu_torch.parallel.pipeline import pipeline_apply, stage_scan_fn
    from ray_tpu_torch.parallel.sharding import (
        NamedSharding, PartitionSpec as P, distribute, gather_full,
    )

    mesh, n = mesh_of({"pp": 2})
    if not member(n):
        return None
    w = distribute(torch.from_numpy(w_np).requires_grad_(),
                   NamedSharding(mesh, P("pp")))

    stage = stage_scan_fn(lambda lp, h: torch.tanh(h @ lp["w"]))
    out = pipeline_apply(stage, {"w": w}, torch.from_numpy(x_np), mesh,
                         num_microbatches=microbatches)
    out.to_local().sum().backward()
    return gather_full(out).detach().numpy(), gather_full(w.grad).numpy()


def fail_on(rank):
    """Raise on ``rank`` only: the world's ranks answer unlike."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails")
    return dist.get_rank()


def same_error():
    """Raise the same error on every rank."""
    raise ValueError("every rank fails alike")


def whoami():
    import torch.distributed as dist

    return dist.get_rank()
