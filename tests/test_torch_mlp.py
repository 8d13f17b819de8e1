"""The port's small dense nets (ray_tpu_torch.models.mlp, torch on the CPU)
against the JAX package's ``ray_tpu.models.mlp`` on the same weights,
carried over from numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import models as jm
from ray_tpu_torch import models as tm


def _cfgs(**kw):
    return jm.MLPConfig(**kw), tm.MLPConfig(**kw)


@pytest.mark.parametrize("kw", [{}, {"in_dim": 32, "hidden": (), "out_dim": 3},
                                {"in_dim": 16, "hidden": (64, 32, 8)}],
                         ids=["fashion_mnist", "linear", "deep"])
def test_mlp_forward_matches_jax(kw):
    """f32, the reference's sizes and two others: the same relu stack.
    Only the order of the f32 sums differs (784 terms into outputs up to
    about 5): atol 1e-6, and 1e-5 relative for the few ulps of the
    largest outputs."""
    jcfg, tcfg = _cfgs(**kw)
    jp = jm.mlp_init(jax.random.key(0), jcfg)
    tp = tm.mlp_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                  device="cpu")
    x = np.random.default_rng(1).standard_normal(
        (8, jcfg.in_dim)).astype(np.float32)
    ref = np.asarray(jm.mlp_forward(jp, jnp.asarray(x)))
    with torch.no_grad():
        out = tm.mlp_forward(tp, torch.from_numpy(x))
    assert out.shape == (8, jcfg.out_dim) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-5)


def test_mlp_converter_round_trip_and_checks():
    """numpy -> port -> numpy gives the same arrays, copied (training the
    port's params leaves the caller's arrays alone); a wrong layer count or
    shape raises, by name."""
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jm.mlp_init(jax.random.key(2), jcfg))
    tp = tm.mlp_params_from_numpy(tree, tcfg, device="cpu")
    for t, j in zip(tp["layers"], tree["layers"]):
        for name in ("w", "b"):
            assert t[name].requires_grad
            np.testing.assert_array_equal(t[name].detach().numpy(), j[name])
    with torch.no_grad():
        tp["layers"][0]["w"].add_(1.0)
    assert not np.array_equal(tp["layers"][0]["w"].detach().numpy(),
                              tree["layers"][0]["w"])
    with pytest.raises(ValueError, match="expected 3 layers"):
        tm.mlp_params_from_numpy({"layers": tree["layers"][:2]}, tcfg,
                                 device="cpu")
    bad = [dict(tree["layers"][0], b=np.zeros(7, np.float32)),
           *tree["layers"][1:]]
    with pytest.raises(ValueError, match=r"layers\[0\]\['b'\]"):
        tm.mlp_params_from_numpy({"layers": bad}, tcfg, device="cpu")


def test_mlp_init_shapes_scale_and_training():
    """The port's own init: the reference's shapes, He-normal scale, zero
    biases, on the device asked for; a few SGD steps fit a fixed batch."""
    _, tcfg = _cfgs(in_dim=64, hidden=(256,), out_dim=10)
    tp = tm.mlp_init(tcfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    (w0, b0), (w1, b1) = ((l["w"], l["b"]) for l in tp["layers"])
    assert w0.shape == (64, 256) and w1.shape == (256, 10)
    assert not b0.any() and not b1.any()
    assert abs(w0.std().item() - (2 / 64) ** 0.5) < 0.01
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(32, 64, generator=gen)
    y = torch.randint(0, 10, (32,), generator=gen)
    params = [t for l in tp["layers"] for t in l.values()]
    opt = torch.optim.SGD(params, lr=0.1)
    losses = []
    for _ in range(10):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(tm.mlp_forward(tp, x), y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0] / 2
