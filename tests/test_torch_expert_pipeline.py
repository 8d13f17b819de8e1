"""The port's expert-parallel MoE and GPipe pipeline under a mesh against
the JAX package's on the same init and batch: the twins of
tests/test_models.py's MoE and pipeline tests.

The JAX side runs here on the conftest's 8 virtual CPU devices; the port
runs in a gloo world of 8 spawned CPU ranks (``torch_spmd.World``). Both
start from one ``jax.random.key(0)`` init carried over by
``params_from_numpy``. Tolerances are tests/test_models.py's: atol 2e-4 on
f32 logits; one AdamW step's loss within 2e-4 and params within 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_spmd
from ray_tpu.models import (
    GPTConfig, forward, init_params, make_train_state, make_train_step,
    param_logical_axes,
)
from ray_tpu.parallel import make_mesh
from ray_tpu.parallel.sharding import shard_pytree


@pytest.fixture(scope="module")
def world():
    w = torch_spmd.World(8)
    yield w
    w.close()


def _mesh(axes):
    n = math.prod(axes.values())
    return make_mesh(axes=axes, devices=jax.devices()[:n])


def _tokens(seed, b, l):
    return np.random.default_rng(seed).integers(0, 256, (b, l + 1))


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _check_forward(world, cfg, cfg_kw, axes, shard_params=True):
    params = init_params(jax.random.key(0), cfg)
    toks = _tokens(1, 4, 32)[:, :-1]
    mesh = _mesh(axes)
    p = shard_pytree(params, mesh, param_logical_axes(cfg)) \
        if shard_params else params
    want = np.asarray(jax.jit(lambda p, t: forward(p, t, cfg, mesh=mesh))(
        p, jnp.asarray(toks, jnp.int32)))
    got = world.run(torch_spmd.forward, axes, cfg_kw, _tree(params), toks)
    for r in range(math.prod(axes.values())):
        np.testing.assert_allclose(got[r], want, atol=2e-4)
    return want


@pytest.mark.parametrize("axes,cf", [
    ({"dp": 2, "ep": 4}, 2.0),
    # Capacity binds at cf 0.5 (C = 32 of 128 tokens, 4 experts): a
    # shard-local C or rank count drops other tokens than the whole
    # batch's.
    ({"dp": 2}, 0.5),
])
def test_moe_sharded_parity(world, axes, cf):
    kw = dict(moe_experts=4, moe_capacity_factor=cf)
    cfg = GPTConfig.preset("tiny", dtype=jnp.float32, **kw)
    _check_forward(world, cfg, kw, axes)


def test_pipeline_parity(world):
    """pp=2 pipelined forward == the JAX pipelined forward."""
    kw = dict(remat=False)
    cfg = GPTConfig.preset("tiny", dtype=jnp.float32, **kw)
    _check_forward(world, cfg, kw, {"pp": 2}, shard_params=False)


def test_pipeline_training_step(world):
    """One step over {dp 2, pp 2} (gradients through ppermute):
    optax.adamw(1e-3) against torch's AdamW with optax's defaults; the loss
    within 2e-4, the params within 1e-5. AdamW's first step moves a param
    by lr * g / (|g| + eps), so where |g| is near eps (1e-8) the two sides'
    float-level gradient differences reach the params at lr's scale: the
    JAX twin's lr 1e-2 puts those at 2.5e-5, lr 1e-3 keeps them inside
    the tolerance, as test_torch_sharded's step test runs."""
    kw = dict(remat=False)
    cfg = GPTConfig.preset("tiny", dtype=jnp.float32, **kw)
    axes = {"dp": 2, "pp": 2}
    mesh = _mesh(axes)
    opt = optax.adamw(1e-3)
    state = make_train_state(jax.random.key(0), cfg, opt, mesh=mesh)
    init = _tree(state.params)
    toks = _tokens(1, 4, 32)
    batch = {"inputs": jnp.asarray(toks[:, :-1], jnp.int32),
             "targets": jnp.asarray(toks[:, 1:], jnp.int32)}
    state, m = jax.jit(make_train_step(cfg, opt, mesh=mesh))(state, batch)
    got = world.run(torch_spmd.train_step, axes, kw, init, toks, 1e-3, 1e-4)
    want = _tree(state.params)
    for r in range(4):
        assert abs(got[r]["loss"] - float(m["loss"])) < 2e-4
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=1e-5),
                     got[r]["params"], want)
