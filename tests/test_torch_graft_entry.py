"""The port's dryruns (``ray_tpu_torch.graft_entry``) against the JAX
package's same two configs: ``dryrun_multichip(4, device="cpu")`` on 4
spawned gloo ranks, and ``dryrun_multichip_gang(4, runtime=ray_tpu)``
through a 4-rank ``TorchDistTrainer`` on a ``ray_tpu`` cluster. Both start
from the reference's init (keys 0 and 1, drawn by the port's threefry) and
batches, so each loss is the JAX step's loss on its mesh to 1e-4 (the
port's ``normal`` is within 3 ulp of jax's).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu
from ray_tpu.models import GPTConfig, make_train_state, make_train_step
from ray_tpu.parallel import make_mesh
from ray_tpu_torch import graft_entry
from ray_tpu_torch.models import GPTConfig as TGPTConfig
from ray_tpu_torch.models.transformer import tree_leaves


def _jax_loss(axes, seed, batch_size, seq, **kw):
    n = math.prod(axes.values())
    mesh = make_mesh(axes=axes, devices=jax.devices()[:n], keep_trivial=True)
    cfg = GPTConfig.preset("tiny", n_heads=4, d_model=64, d_ff=256,
                           dtype=jnp.float32, **kw)
    opt = optax.adamw(1e-3)
    state = make_train_state(jax.random.key(seed), cfg, opt, mesh=mesh)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch_size, seq + 1))
    batch = {"inputs": jnp.asarray(toks[:, :-1], jnp.int32),
             "targets": jnp.asarray(toks[:, 1:], jnp.int32)}
    _, m = jax.jit(make_train_step(cfg, opt, mesh=mesh))(state, batch)
    return float(m["loss"])


def test_reference_init_is_jax_init():
    from ray_tpu.models import init_params

    for kw, seed in (({}, 0), ({"moe_experts": 4}, 1)):
        jp = init_params(jax.random.key(seed), GPTConfig.preset(
            "tiny", n_heads=4, d_model=64, d_ff=256, **kw))
        tp = graft_entry.reference_init(TGPTConfig.preset(
            "tiny", n_heads=4, d_model=64, d_ff=256, **kw), seed,
            device="cpu")
        for j, t in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                       rtol=1e-6, atol=1e-9)


def test_dryrun_multichip_matches_jax():
    got = graft_entry.dryrun_multichip(4, device="cpu")
    axes = graft_entry.dryrun_axes(4)
    want = _jax_loss(axes, 0, max(4, axes["dp"] * axes["fsdp"] * 2),
                     32 * axes["sp"], ring_attention=True)
    want2 = _jax_loss({"pp": 2, "ep": 2, "dp": 1}, 1, 4, 32, moe_experts=4)
    assert abs(got["sharded"] - want) < 1e-4, (got, want)
    assert abs(got["pp_ep_moe"] - want2) < 1e-4, (got, want2)


@pytest.fixture(scope="module")
def ray_4cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ctx = ray_tpu.init(num_cpus=4,
                           object_store_memory=128 * 1024 * 1024)
    yield ctx
    ray_tpu.shutdown()
    torch.set_num_threads(threads)


def test_dryrun_multichip_gang_matches_jax(ray_4cpu, tmp_path):
    got = graft_entry.dryrun_multichip_gang(
        4, runtime=ray_tpu, device="cpu", storage_path=str(tmp_path))
    want = _jax_loss({"dp": 4}, 0, 8, 32)
    assert abs(got - want) < 1e-4, (got, want)
