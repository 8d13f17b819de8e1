"""The port's threefry random numbers (ray_tpu_torch.random) against
jax.random on the same keys: key data and random bits exactly equal, the
floats within rtol 1e-6, and sampled tokens (categorical, and the serving
path's _sample_one) equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generate as jg
from ray_tpu_torch import random as tr
from ray_tpu_torch.models import generate as tg

SEEDS = [0, 1, 42, 7919, 2**31 - 1]


def _data(key):
    return np.asarray(jax.random.key_data(key))


def _tkey(seed):
    return tr.key(seed, device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_bits_equal(seed):
    assert (tr.key(seed, device="cpu").numpy() ==
            _data(jax.random.key(seed))).all()
    for data in (0, 3, 567, 2**31 - 1, -5):
        want = _data(jax.random.fold_in(jax.random.key(seed),
                                        jnp.int32(data)))
        assert (tr.fold_in(_tkey(seed), data).numpy() == want).all(), data


def test_fold_in_batch_is_vmap():
    """A batch of data folds into one key each, as vmap(fold_in)."""
    data = np.asarray([0, 1, 99, 12345], np.int32)
    want = _data(jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.key(3), jnp.asarray(data)))
    got = tr.fold_in(_tkey(3), torch.from_numpy(data))
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("num", [1, 2, 7])
def test_split_bits_equal(num):
    key = jax.random.fold_in(jax.random.key(11), 5)
    want = _data(jax.random.split(key, num))
    got = tr.split(tr.fold_in(_tkey(11), 5), num)
    assert got.shape == (num, 2) and (got.numpy() == want).all()


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 4), (2, 3, 5)])
def test_random_bits_equal(shape):
    key = jax.random.fold_in(jax.random.key(2), 77)
    want = np.asarray(jax.random.bits(key, shape, dtype=jnp.uint32))
    got = tr.random_bits(tr.fold_in(_tkey(2), 77), shape)
    assert got.shape == shape
    assert (got.numpy() == want.astype(np.int64)).all()


@pytest.mark.parametrize("seed", [0, 9])
def test_uniform_and_gumbel_close(seed):
    """Uniform floats from the same bits: within rtol 1e-6 (they are equal
    bit for bit). Gumbel -log(-log(u)) goes through each library's log,
    which may differ in the last ulp; near g = 0 (-log(u) near 1) that ulp
    is large relative to g, hence the atol."""
    key = jax.random.fold_in(jax.random.key(seed), 1)
    tkey = tr.fold_in(_tkey(seed), 1)
    u = tr.uniform(tkey, (4096,))
    np.testing.assert_allclose(u.numpy(), np.asarray(
        jax.random.uniform(key, (4096,))), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tr.uniform(tkey, (64,), 2.0, 5.0).numpy(),
                               np.asarray(jax.random.uniform(
                                   key, (64,), minval=2.0, maxval=5.0)),
                               rtol=1e-6, atol=0)
    g = tr.gumbel(tkey, (4096,))
    np.testing.assert_allclose(g.numpy(), np.asarray(
        jax.random.gumbel(key, (4096,))), rtol=1e-6, atol=1e-6)
    assert u.min() >= 0 and u.max() < 1 and torch.isfinite(g).all()



def _ulps(a, b):
    """Distance in float32 units in the last place (same-sign values)."""
    return np.abs(a.view(np.int32).astype(np.int64) -
                  b.view(np.int32).astype(np.int64))


# jax.random.normal is sqrt(2) * erf_inv(u) on the same uniform bits; the
# port repeats XLA's erfinv polynomial in plain torch, but XLA's CPU code
# fuses the Horner steps into FMAs and has its own log1p. Measured here:
# at most 3 ulp apart on 1.2M draws, 4.7% of them differing at all. The
# bound leaves room for the CPU's vector unit choosing other log1p code.
NORMAL_MAX_ULP = 8


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("shape", [(64, 64), (3, 7), (100000,)])
def test_normal_close_to_jax(seed, shape):
    key = jax.random.fold_in(jax.random.key(seed), 2)
    want = np.asarray(jax.random.normal(key, shape))
    got = tr.normal(tr.fold_in(_tkey(seed), 2), shape)
    assert got.shape == shape and got.dtype == torch.float32
    assert _ulps(got.numpy(), want).max() <= NORMAL_MAX_ULP
    # the uniform bits under it are exact
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    assert (tr.uniform(tr.fold_in(_tkey(seed), 2), shape, lo, 1.0).numpy()
            == np.asarray(jax.random.uniform(key, shape, minval=lo,
                                             maxval=1.0))).all()


def test_erfinv_edges_match_xla():
    x = np.asarray([-1.0, -0.999999, -0.5, 0.0, 1e-6, 0.3, 0.99, 1.0],
                   np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = tr.erfinv(torch.from_numpy(x)).numpy()
    assert np.isinf(got[[0, -1]]).all() and (np.sign(got) ==
                                              np.sign(want)).all()
    assert _ulps(got[1:-1], want[1:-1]).max() <= NORMAL_MAX_ULP

def _logits(seed, shape, scale=3.0):
    return np.random.default_rng(seed).normal(
        0, scale, shape).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_categorical_tokens_equal(seed):
    lg = _logits(seed, (6, 200))
    key = jax.random.fold_in(jax.random.key(seed), 8)
    want = np.asarray(jax.random.categorical(key, lg))
    got = tr.categorical(tr.fold_in(_tkey(seed), 8), torch.from_numpy(lg))
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("top_k", [0, 12])
def test_sample_one_tokens_equal(top_k):
    """_sample_one on one slot's logits over many (seed, counter) pairs,
    and the batched form (one key per row, the reference's vmap) on the
    same pairs: every token equals the JAX package's."""
    lg = _logits(5, (40, 256))
    seeds = np.arange(40, dtype=np.int32) * 37 + 1
    ctrs = np.arange(40, dtype=np.int32) + 9
    want = np.asarray(jax.vmap(
        lambda l, s, c: jg._sample_one(l, s, c, 0.9, top_k))(
            jnp.asarray(lg), jnp.asarray(seeds), jnp.asarray(ctrs)))
    got = tg._sample_one(torch.from_numpy(lg), torch.from_numpy(seeds),
                         torch.from_numpy(ctrs), 0.9, top_k)
    assert (got.numpy() == want).all()
    for i in range(0, 40, 7):
        one = tg._sample_one(torch.from_numpy(lg[i]), int(seeds[i]),
                             int(ctrs[i]), 0.9, top_k)
        assert int(one) == int(want[i])
    greedy = tg._sample_one(torch.from_numpy(lg), torch.from_numpy(seeds),
                            torch.from_numpy(ctrs), 0.0, top_k)
    assert (greedy.numpy() == lg.argmax(-1)).all()


def test_chip_smoke_golden_words_are_jax_random():
    """chip_smoke.py holds jax.random's outputs as constants (the card's
    machine has no jax): they are jax.random's here, and the port's."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def rk(s, c):
        return jax.random.fold_in(jax.random.fold_in(jax.random.key(0), s), c)

    logits = jnp.linspace(-2, 2, 64).reshape(2, 32)
    want = {
        "fold_in(key(0), 42)": _data(jax.random.fold_in(jax.random.key(0),
                                                        42)),
        "request_key(1234, 567)": _data(rk(1234, 567)),
        "split(key(7), 4)": _data(jax.random.split(jax.random.key(7), 4)),
        "bits(request_key(3, 100), (8,))": np.asarray(
            jax.random.bits(rk(3, 100), (8,), dtype=jnp.uint32)),
        "categorical": np.asarray(jax.random.categorical(rk(9, 300),
                                                         logits)),
    }
    got = smoke.threefry_outputs("cpu")
    assert set(want) == set(smoke.THREEFRY_GOLDEN) == set(got)
    for name, words in want.items():
        assert words.ravel().tolist() == smoke.THREEFRY_GOLDEN[name], name
        assert got[name].flatten().tolist() == smoke.THREEFRY_GOLDEN[name]
