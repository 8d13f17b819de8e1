"""The port's sharded GPT step (``ray_tpu_torch.models`` with ``mesh=``,
ring attention, the train step) against the JAX package's on the same
init and batch: the twins of tests/test_models.py's sharded tests.

The JAX side runs here on the conftest's 8 virtual CPU devices; the port
runs in a gloo world of 8 spawned CPU ranks (``torch_spmd.World``, one per
module), each mesh over its first ranks. Both start from one
``jax.random.key(0)`` init carried over by ``params_from_numpy``, with
token batches from a numpy seed. Tolerances are tests/test_models.py's:
atol 2e-4 on f32 logits, and for one AdamW step the loss within 2e-4 and
the params within 1e-5.
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


def _jax_forward(cfg, params, axes, toks):
    mesh = _mesh(axes)
    sp = shard_pytree(params, mesh, param_logical_axes(cfg))
    return np.asarray(jax.jit(lambda p, t: forward(p, t, cfg, mesh=mesh))(
        sp, jnp.asarray(toks, jnp.int32)))


@pytest.mark.parametrize("axes", [
    {"dp": 2}, {"fsdp": 2}, {"dp": 2, "tp": 2}, {"dp": 2, "sp": 2, "tp": 2},
])
def test_sharded_forward_parity(world, axes):
    cfg = GPTConfig.preset("tiny", dtype=jnp.float32)
    params = init_params(jax.random.key(0), cfg)
    toks = _tokens(1, 4, 32)[:, :-1]
    want = _jax_forward(cfg, params, axes, toks)
    got = world.run(torch_spmd.forward, axes, {}, _tree(params), toks)
    n = math.prod(axes.values())
    for r in range(n):
        np.testing.assert_allclose(got[r], want, atol=2e-4)


def test_ring_attention_model_parity(world):
    cfg = GPTConfig.preset("tiny", dtype=jnp.float32, ring_attention=True)
    params = init_params(jax.random.key(0), cfg)
    toks = _tokens(2, 2, 32)[:, :-1]
    want = _jax_forward(cfg, params, {"sp": 4}, toks)
    got = world.run(torch_spmd.forward, {"sp": 4},
                    {"ring_attention": True}, _tree(params), toks)
    for r in range(4):
        np.testing.assert_allclose(got[r], want, atol=2e-4)


def _jax_ring(q, k, v, causal):
    from ray_tpu.ops.attention import ring_attention_sharded

    mesh = _mesh({"sp": 4})
    w = jnp.asarray(np.random.default_rng(7).normal(size=q.shape),
                    jnp.float32)

    def f(q, k, v):
        out = ring_attention_sharded(q, k, v, mesh, causal=causal)
        return jnp.sum(out * w), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    return [np.asarray(x) for x in (out, *grads)]


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_op_parity(world, causal):
    """``ring_attention_sharded`` on {sp 4}: the output and the gradients
    of sum(out * w) for q, k and v against jax.grad of the JAX one."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = _jax_ring(*map(jnp.asarray, (q, k, v)), causal)
    got = world.run(torch_spmd.ring_op, {"sp": 4}, q, k, v, causal)
    for r in range(4):
        for name, g, w in zip(("out", "dq", "dk", "dv"), got[r], want):
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)


def _train_step_parity(world, axes, **cfg_kw):
    cfg = GPTConfig.preset("tiny", dtype=jnp.float32, **cfg_kw)
    mesh = _mesh(axes)
    opt = optax.adamw(1e-3)
    state = make_train_state(jax.random.key(0), cfg, opt, mesh=mesh)
    init = _tree(state.params)
    toks = _tokens(1, 4, 32)
    batch = {"inputs": jnp.asarray(toks[:, :-1], jnp.int32),
             "targets": jnp.asarray(toks[:, 1:], jnp.int32)}
    state, m = jax.jit(make_train_step(cfg, opt, mesh=mesh))(state, batch)
    got = world.run(torch_spmd.train_step, axes, cfg_kw, init, toks, 1e-3,
                    1e-4)
    want = _tree(state.params)
    for r in range(math.prod(axes.values())):
        assert abs(got[r]["loss"] - float(m["loss"])) < 2e-4
        assert abs(got[r]["grad_norm"] - float(m["grad_norm"])) < 1e-4 * max(
            1.0, float(m["grad_norm"]))
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=1e-5),
                     got[r]["params"], want)


def test_sharded_train_step_parity(world):
    """One step on {dp 2, fsdp 2, tp 2}: optax.adamw(1e-3) against
    torch.optim.AdamW(lr=1e-3, weight_decay=1e-4) with optax's defaults
    spelled out; the loss within 2e-4, the params within 1e-5."""
    _train_step_parity(world, {"dp": 2, "fsdp": 2, "tp": 2})


def test_seq_sharded_flash_train_step_parity(world):
    """One step on {dp 2, sp 2, tp 2} with ``flash_attention=True`` and no
    ring: q, k and v gathered over sp, the flash path (the reference's
    Pallas kernel, interpreted) over the whole sequence, each rank keeping
    its queries; the gradients of k and v summed back over sp. Tolerances
    as above."""
    _train_step_parity(world, {"dp": 2, "sp": 2, "tp": 2},
                       flash_attention=True)
