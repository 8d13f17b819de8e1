"""Entry points of the port (the counterpart of the JAX package's
``__graft_entry__.py``).

``entry()``                — the flagship model's forward (GPT-2 125M at two
                             layers, seq 256) and example arguments.
``dryrun_multichip(n)``    — the full sharded training step on an n-rank
                             mesh (dp x fsdp x sp x tp, ring attention on
                             sp), then a pp x ep Switch-MoE step, each one
                             step on tiny shapes; ranks are ``n`` spawned
                             processes where the reference has n virtual
                             devices. Returns both losses.
``dryrun_multichip_gang(n, runtime=...)`` — the sharded step through
                             ``TorchDistTrainer``: the mesh spans the gang's
                             ``torch.distributed`` world.

Both dryruns start from the reference's own init (``jax.random.key`` 0
and 1, drawn by the port's threefry: ``random.normal`` gives
``jax.random.normal``'s values to 3 ulp) and the reference's batches, so
their losses are the JAX dryrun's.
"""

from __future__ import annotations

import functools
import math
import multiprocessing as mp
import queue
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike, resolve_device


def entry():
    """Return (fn, example_args): the flagship model's forward on the card
    (GPT-2 125M at reduced depth)."""
    from ray_tpu_torch.models import GPTConfig, forward, init_params

    cfg = GPTConfig.preset("gpt2-125m", n_layers=2, max_seq=256)
    dev = resolve_device(None)
    params = init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 256))).to(dev)

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)


def reference_init(cfg, seed: int, device: DeviceLike = None):
    """The JAX package's ``init_params(jax.random.key(seed), cfg)`` drawn by
    the port's threefry: the same keys, draws and scales."""
    from ray_tpu_torch import random as rnd
    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.models.transformer import tree_leaves

    dev = resolve_device(device)
    keys = rnd.split(rnd.key(seed, device=dev), 8)
    res = 0.02 / math.sqrt(2 * cfg.n_layers)
    params = init_params(cfg, generator=torch.Generator(device=dev),
                         device=dev)
    draws = {"tok_embed": (0, 0.02), "pos_embed": (1, 0.02),
             "wqkv": (2, 0.02), "wo": (3, res), "w_up": (4, 0.02),
             "w_down": (5, res), "wg": (6, 0.02)}
    with torch.no_grad():
        for tree in (params, params["blocks"]):
            for name, (k, s) in draws.items():
                if name in tree:
                    p = tree[name]
                    p.copy_(rnd.normal(keys[k], p.shape) * s)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def dryrun_axes(n: int) -> Dict[str, int]:
    """The reference dryrun's mesh: n factored onto (dp, fsdp, sp, tp),
    innermost (tp) first."""
    axes = {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1}
    rem = n
    for name in ("tp", "sp", "fsdp", "dp"):
        take = 2 if rem % 2 == 0 and rem > 1 else 1
        if name == "dp":
            take = rem  # absorb the remainder
        axes[name] = take
        rem //= take
    return axes


def _tiny(**kw):
    from ray_tpu_torch.models import GPTConfig

    return GPTConfig.preset("tiny", n_heads=4, d_model=64, d_ff=256,
                            dtype=torch.float32, **kw)


def _one_step(cfg, axes, seed: int, batch_size: int, seq: int,
              device: torch.device) -> float:
    """One AdamW step (optax.adamw(1e-3)'s settings) of ``cfg`` on a mesh
    of ``axes`` over this process's world; the loss."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch.models.transformer import new_train_state
    from ray_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axes=axes, keep_trivial=True, device=device)
    params = tm.shard_params(reference_init(cfg, seed, device), cfg, mesh)
    state = new_train_state(params, functools.partial(
        torch.optim.AdamW, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4))
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch_size, seq + 1))).to(device)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    state, metrics = tm.make_train_step(cfg, mesh=mesh)(state, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss) or state.step != 1:
        raise RuntimeError(f"dryrun step on {axes}: loss {loss}, step "
                           f"{state.step}")
    return loss


def dryrun_steps(n: int, device: torch.device) -> Dict[str, float]:
    """Both of the reference dryrun's steps on this rank of an n-rank
    world: (a) the dp x fsdp x sp x tp mesh with ring attention on sp, (b)
    pp 2 x ep 2 x dp n/4 on a 4-expert Switch MoE (when 4 divides n)."""
    axes = dryrun_axes(n)
    out = {"sharded": _one_step(
        _tiny(ring_attention=True), axes, 0,
        max(4, axes["dp"] * axes["fsdp"] * 2), 32 * axes["sp"], device)}
    if n % 4 == 0:
        axes2 = {"pp": 2, "ep": 2, "dp": n // 4}
        out["pp_ep_moe"] = _one_step(_tiny(moe_experts=4), axes2, 1,
                                     max(4, axes2["dp"] * 2), 32, device)
    return out


# A rank's whole dryrun, spawn included (about 10 s on the CPU here).
DRYRUN_TIMEOUT_S = 600.0


def _dryrun_rank(rank: int, n: int, addr: str, device: str,
                 backend: Optional[str], results) -> None:
    from ray_tpu_torch.parallel.collective import join_world, leave_world

    try:
        dev = join_world(addr, n, rank, device=device, backend=backend)
        try:
            out = dryrun_steps(n, dev)
        finally:
            leave_world()
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def dryrun_multichip(n: int, *, device: DeviceLike = None,
                     backend: Optional[str] = None) -> Dict[str, float]:
    """Run ``dryrun_steps`` on ``n`` spawned ranks of one
    ``torch.distributed`` world on ``device`` (default ``cuda``): NCCL on
    CUDA unless ``backend`` says otherwise, gloo on the CPU. Ranks that
    share one GPU need ``backend="gloo"``, which NCCL refuses. Returns rank
    0's losses; every rank's must be equal."""
    from ray_tpu_torch.parallel.collective import _free_port

    dev = resolve_device(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    addr = f"127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_dryrun_rank,
                         args=(r, n, addr, str(dev), backend, results))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        got = {}
        for _ in range(n):
            try:
                rank, ok, val = results.get(timeout=DRYRUN_TIMEOUT_S)
            except queue.Empty:
                raise TimeoutError(f"dryrun_multichip({n}): ranks "
                                   f"{sorted(set(range(n)) - set(got))} "
                                   f"gave no result in {DRYRUN_TIMEOUT_S} s")
            if not ok:
                raise RuntimeError(f"dryrun_multichip({n}) rank {rank}:\n"
                                   f"{val}")
            got[rank] = val
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if any(got[r] != got[0] for r in got):
        raise RuntimeError(f"dryrun_multichip({n}): ranks disagree {got}")
    return got[0]


def _gang_loop(config):
    from ray_tpu_torch import train

    import torch.distributed as dist

    if dist.get_world_size() != config["workers"]:
        raise RuntimeError(f"world of {dist.get_world_size()}, expected "
                           f"{config['workers']}")
    axes = config["axes"]
    cfg = _tiny(ring_attention=axes.get("sp", 1) > 1)
    loss = _one_step(cfg, axes, 0,
                     max(4, axes.get("dp", 1) * axes.get("fsdp", 1) * 2),
                     32 * axes.get("sp", 1), train.get_device())
    train.report({"loss": loss, "world_size": dist.get_world_size()})


def dryrun_multichip_gang(n: int, *, runtime, device: DeviceLike = None,
                          storage_path: Optional[str] = None) -> float:
    """The sharded step through the runtime: a ``TorchDistTrainer`` gang
    of ``n`` ranks (actors of ``runtime``, e.g. the ``ray_tpu`` module)
    joins one ``torch.distributed`` world and each rank builds the mesh
    over it: the reference gang's axes (dp 1, fsdp 2, sp 2, tp 2 for 8
    ranks, else dp n). Returns the loss."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchDistTrainer

    axes = ({"dp": 1, "fsdp": 2, "sp": 2, "tp": 2} if n == 8
            else {"dp": n})
    trainer = TorchDistTrainer(
        _gang_loop, train_loop_config={"workers": n, "axes": axes},
        scaling_config=ScalingConfig(num_workers=n),
        run_config=RunConfig(name="gang_dryrun", storage_path=storage_path),
        runtime=runtime, device=device)
    result = trainer.fit()
    if result.error is not None:
        raise result.error
    if result.metrics["world_size"] != n:
        raise RuntimeError(f"gang world {result.metrics}")
    return float(result.metrics["loss"])


if __name__ == "__main__":
    print("dryrun_multichip(4):", dryrun_multichip(4))
    fn, args = entry()
    out = fn(*args)
    print("entry forward:", tuple(out.shape), out.dtype)
