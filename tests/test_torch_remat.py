"""The port's remat policies (ray_tpu_torch.models.transformer, torch on
the CPU) against the JAX package's ``jax.checkpoint`` policies: "matmuls"
and "dots" give "full"'s loss and gradients and the JAX package's under the
same policy; one block keeps for backward exactly the tensors that
``jax.ad_checkpoint.print_saved_residuals`` lists for the reference's block
(besides its input and params), dense and MoE, with and without flash
attention; and the products a policy keeps are not computed again in
backward."""

import contextlib
import dataclasses
import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.ad_checkpoint import print_saved_residuals

from ray_tpu import models as jm
from ray_tpu.models import transformer as jt
from ray_tpu.parallel.sharding import DEFAULT_RULES
from ray_tpu_torch import models as tm
from ray_tpu_torch.models import transformer as tt

POLICIES = ["full", "matmuls", "dots"]
MODELS = {"dense": {}, "moe": {"moe_experts": 4}}


def _cfgs(model, policy, dtype="f32", **kw):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(MODELS[model], remat_policy=policy, **kw)
    return (jm.GPTConfig.preset("tiny", dtype=jd, **kw),
            tm.GPTConfig.preset("tiny", dtype=td, **kw))


def _batches(seed=2, b=2, l=64):
    toks = np.random.default_rng(seed).integers(0, 256, (b, l + 1))
    return ({"inputs": jnp.asarray(toks[:, :-1], jnp.int32),
             "targets": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"inputs": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])})


@functools.lru_cache(maxsize=None)
def _jax_tree(model):
    jcfg, _ = _cfgs(model, "full")
    return jax.tree.map(np.asarray, jm.init_params(jax.random.key(0), jcfg))


def _port_loss_and_grads(model, policy, dtype="f32", **kw):
    _, tcfg = _cfgs(model, policy, dtype, **kw)
    tp = tm.params_from_numpy(_jax_tree(model), tcfg, device="cpu")
    loss = tm.loss_fn(tp, _batches()[1], tcfg)
    loss.backward()
    return loss.detach(), [p.grad for p in tt.tree_leaves(tp)]


@pytest.mark.parametrize("flash", [False, True], ids=["reference", "flash"])
@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("policy", ["matmuls", "dots"])
def test_policy_matches_full_and_jax(policy, model, flash):
    """f32: the port's loss and every gradient under the policy equal its
    own under "full" (the same products in the same order: 1e-6), and the
    JAX package's under the same policy (the model tolerances of
    tests/test_torch_models.py)."""
    loss, grads = _port_loss_and_grads(model, policy, flash_attention=flash)
    full_loss, full_grads = _port_loss_and_grads(model, "full",
                                                 flash_attention=flash)
    torch.testing.assert_close(loss, full_loss, rtol=1e-6, atol=0)
    for a, b in zip(grads, full_grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    jcfg, _ = _cfgs(model, policy, flash_attention=flash)
    jp = jax.tree.map(jnp.asarray, _jax_tree(model))
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn),
                            static_argnums=2)(jp, _batches()[0], jcfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for a, b in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=1e-3)


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("policy", ["matmuls", "dots"])
def test_policy_matches_full_bf16(policy, model):
    """bf16 compute: the kept tensors are the ones "full" recomputes, bit
    for bit, so loss and gradients agree to f32 rounding of the
    accumulated gradients."""
    loss, grads = _port_loss_and_grads(model, policy, "bf16")
    full_loss, full_grads = _port_loss_and_grads(model, "full", "bf16")
    torch.testing.assert_close(loss, full_loss, rtol=1e-6, atol=0)
    for a, b in zip(grads, full_grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _jax_kept(model, policy, flash):
    """The residuals that print_saved_residuals lists for one reference
    block in bf16 under ``policy``, other than its arguments, as sorted
    (dtype name, shape) pairs."""
    jcfg, _ = _cfgs(model, policy, "bf16", flash_attention=flash)
    bp = jax.tree.map(lambda a: jnp.asarray(a[0]), _jax_tree(model)["blocks"])
    block = jax.checkpoint(functools.partial(
        jt._block, cfg=jcfg, mesh=None, rules=DEFAULT_RULES,
        positions=jnp.arange(64)), policy=jt._remat_policy(jcfg))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        print_saved_residuals(
            lambda x, bp: block(x, bp).astype(jnp.float32).sum(),
            jnp.ones((2, 64, 64), jnp.bfloat16), bp)
    kept = []
    for line in out.getvalue().splitlines():
        m = re.match(r"(\w+)\[([\d,]*)\] (.*)", line)
        if m and "from the argument" not in m[3]:
            kept.append((m[1], tuple(int(d) for d in m[2].split(",") if d)))
    return sorted(kept)


def _port_kept(model, policy, flash):
    """What one of the port's blocks saves for backward under ``policy``
    (every tensor its autograd graph packs, seen through
    saved_tensors_hooks), other than its input and params, as sorted
    (dtype name, shape) pairs; and how many of those it saved."""
    _, tcfg = _cfgs(model, policy, "bf16", flash_attention=flash)
    tp = tm.params_from_numpy(_jax_tree(model), tcfg, device="cpu")
    bp = tt._layer_params(tp["blocks"], tcfg.dtype)[0]
    x = torch.ones(2, 64, 64, dtype=torch.bfloat16, requires_grad=True)
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: packed.append(t) or t, lambda t: t):
        out = tt._Remat.apply(tcfg, torch.arange(64), tuple(bp), None, x,
                              *bp.values())
    args = [x, *bp.values()]

    def is_arg(t):
        return any(t.data_ptr() == a.data_ptr() and t.shape == a.shape
                   for a in args)

    kept = sorted((_DTYPE_NAMES[t.dtype], tuple(t.shape))
                  for t in packed if not is_arg(t))
    out.float().sum().backward()
    return kept, sum(map(is_arg, packed))


@pytest.mark.parametrize("flash", [False, True], ids=["reference", "flash"])
@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("policy", POLICIES)
def test_saved_set_is_the_references(policy, model, flash):
    kept, n_args = _port_kept(model, policy, flash)
    assert kept == _jax_kept(model, policy, flash)
    assert n_args == 1 + len(_jax_tree(model)["blocks"])
    want = {("full", "dense"): 0, ("full", "moe"): 0,
            ("matmuls", "dense"): 3, ("matmuls", "moe"): 2,
            ("dots", "dense"): 3, ("dots", "moe"): 4}[policy, model]
    assert len(kept) == want


def _backward_products(model, policy):
    """aten::mm calls in one backward pass of the tiny model (f32)."""
    _, tcfg = _cfgs(model, policy)
    tp = tm.params_from_numpy(_jax_tree(model), tcfg, device="cpu")
    loss = tm.loss_fn(tp, _batches()[1], tcfg)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        loss.backward()
    return sum(e.count for e in prof.key_averages() if e.key == "aten::mm")


@pytest.mark.parametrize("model", list(MODELS))
def test_kept_products_are_not_recomputed(model):
    """Backward recomputes every block under "full"; under "matmuls" and
    "dots" the kept products are not computed again: per layer 3 fewer
    products dense (qkv, output and up projections), and 2 ("matmuls":
    qkv, output) or 3 ("dots": and the router) fewer MoE."""
    n = _cfgs(model, "full")[1].n_layers
    full = _backward_products(model, "full")
    fewer = {"dense": (3, 3), "moe": (2, 3)}[model]
    assert (full - _backward_products(model, "matmuls"),
            full - _backward_products(model, "dots")) == tuple(
                f * n for f in fewer)


def test_unknown_policy_raises():
    _, tcfg = _cfgs("dense", "full")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tm.init_params(dataclasses.replace(tcfg, remat_policy="nope"),
                       generator=torch.Generator(), device="cpu")
