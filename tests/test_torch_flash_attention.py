"""Parity of the port's flash attention (ray_tpu_torch, torch on the CPU,
through the kernels' plain versions) with the JAX package's Pallas kernels
run in interpret mode, on the same numpy-seeded inputs. Counterparts of the
eight cases of test_flash_attention.py, with the same tolerances, plus
per-kernel checks of the logsumexp and the two backward kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.models import GPTConfig, init_params
from ray_tpu_torch.ops import flash_attention as tfa


def _qkv(seed, b=2, l=256, h=4, d=64, lk=None):
    rng = np.random.default_rng(seed)
    shapes = [(b, l, h, d), (b, lk or l, h, d), (b, lk or l, h, d)]
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


def _jax_out(qkv, **kw):
    return np.asarray(jfa.flash_attention(*map(jnp.asarray, qkv),
                                          interpret=True, **kw))


def _torch_out(qkv, **kw):
    return tfa.flash_attention(*map(torch.from_numpy, qkv), **kw).numpy()


def _jax_grads(qkv, **kw):
    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, interpret=True, **kw) ** 2)

    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, qkv))]


def _torch_grads(qkv, **kw):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in qkv]
    (tfa.flash_attention(*ts, **kw) ** 2).sum().backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax(causal):
    qkv = _qkv(0)
    kw = dict(causal=causal, block_q=64, block_k=64)
    np.testing.assert_allclose(_torch_out(qkv, **kw), _jax_out(qkv, **kw),
                               atol=2e-5, rtol=1e-4)


def test_flash_multiblock_seq():
    qkv = _qkv(1, l=512)
    kw = dict(causal=True, block_q=128, block_k=128)
    np.testing.assert_allclose(_torch_out(qkv, **kw), _jax_out(qkv, **kw),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradients_match(causal):
    qkv = _qkv(2, l=128)
    kw = dict(causal=causal, block_q=64, block_k=64)
    for a, b in zip(_torch_grads(qkv, **kw), _jax_grads(qkv, **kw)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)


def test_flash_gradients_long_seq():
    """Backward multi-block both ways (16 tiles of the port's kernel, 8
    blocks of the reference's) vs the reference kernels' VJP."""
    qkv = _qkv(4, b=1, l=1024, h=2)
    kw = dict(causal=True, block_q=128, block_k=128)
    for a, b in zip(_torch_grads(qkv, **kw), _jax_grads(qkv, **kw)):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-3)


def _no_kernel_path(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the fallback must not reach the kernels")

    monkeypatch.setattr(tfa, "flash_forward", refuse)


def test_fallback_on_causal_cross_length(monkeypatch):
    """causal with lq != lk takes the reference path, as in the reference."""
    _no_kernel_path(monkeypatch)
    qkv = _qkv(5, b=1, l=256, h=2, lk=128)
    out = _torch_out(qkv, causal=True)
    assert not np.any(np.isnan(out))
    np.testing.assert_allclose(out, _jax_out(qkv, causal=True),
                               atol=2e-5, rtol=1e-4)


def test_fallback_on_ragged_seq(monkeypatch):
    qkv = _qkv(3, l=100)
    # Default blocks: min(128, 100) = 100 divides the sequence, so both
    # packages take their kernel path (the port's in one ragged tile).
    np.testing.assert_allclose(_torch_out(qkv, causal=True),
                               _jax_out(qkv, causal=True),
                               atol=2e-5, rtol=1e-4)
    # Blocks of 64 do not divide 100: the reference path.
    _no_kernel_path(monkeypatch)
    kw = dict(causal=True, block_q=64, block_k=64)
    np.testing.assert_allclose(_torch_out(qkv, **kw), _jax_out(qkv, **kw),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("l,block", [(48, 16), (80, 16), (192, 64)])
def test_flash_kernel_tile_padding(l, block):
    """Lengths that the API's blocks divide but the kernels' 64-row tile
    does not: the ragged last tile must contribute nothing."""
    qkv = _qkv(6, l=l, h=2)
    kw = dict(causal=True, block_q=block, block_k=block)
    np.testing.assert_allclose(_torch_out(qkv, **kw), _jax_out(qkv, **kw),
                               atol=2e-5, rtol=1e-4)
    for a, b in zip(_torch_grads(qkv, **kw), _jax_grads(qkv, **kw)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)
    # The plain forward's outputs are laid out as the kernel writes them, so
    # they can feed the backward kernels.
    o3, lse = tfa.flash_forward(*(tfa._to3(torch.from_numpy(x)) for x in qkv),
                                scale=64 ** -0.5, causal=True)
    assert o3.is_contiguous() and lse.is_contiguous()


def _three(qkv):
    return [np.array(jfa._to3(jnp.asarray(x))) for x in qkv]


@pytest.mark.parametrize("causal", [True, False])
def test_forward_kernel_lse_matches_jax(causal):
    """K1 on its own: O and the per-row logsumexp against the reference
    kernel's (its [BH, 1, L] is the port's [BH, L])."""
    q3, k3, v3 = _three(_qkv(7, l=256))
    scale = 64 ** -0.5
    jo, jlse = jfa._flash_forward(*map(jnp.asarray, (q3, k3, v3)),
                                  scale=scale, causal=causal, block_q=128,
                                  block_k=128, interpret=True)
    to, tlse = tfa.flash_forward(*map(torch.from_numpy, (q3, k3, v3)),
                                 scale=scale, causal=causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, 0],
                               atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_kernels_match_jax(causal):
    """K2 and K3 on their own, fed the same dO, lse and delta as the
    reference's backward kernels."""
    q3, k3, v3 = _three(_qkv(8, l=256))
    do3 = _three(_qkv(9, l=256))[0]
    scale = 64 ** -0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q3, k3, v3, do3))
    jo, jlse = jfa._flash_forward(jq, jk, jv, scale=scale, causal=causal,
                                  block_q=128, block_k=128, interpret=True)
    jdelta = jnp.sum(jdo * jo, axis=-1)[:, None, :]
    jdq, jdk, jdv = jfa._flash_backward(
        jq, jk, jv, jdo, jlse, jdelta, scale=scale, causal=causal,
        block_q=128, block_k=128, interpret=True)
    tq, tk, tv, tdo = map(torch.from_numpy, (q3, k3, v3, do3))
    tlse = torch.from_numpy(np.array(jlse)[:, 0])
    tdelta = torch.from_numpy(np.array(jdelta)[:, 0])
    tdq = tfa.flash_backward_dq(tq, tk, tv, tdo, tlse, tdelta, scale=scale,
                                causal=causal)
    tdk, tdv = tfa.flash_backward_dkv(tq, tk, tv, tdo, tlse, tdelta,
                                      scale=scale, causal=causal)
    for a, b in ((tdq, jdq), (tdk, jdk), (tdv, jdv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=1e-4, rtol=1e-3)


def test_cpu_call_leaves_launch_counters_at_zero():
    tfa.reset_launches()
    _torch_grads(_qkv(10, l=128), causal=True, block_q=64, block_k=64)
    assert [k.launches for k in tfa.KERNELS] == [0, 0, 0]


def test_default_device_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(GPTConfig.preset("tiny"), generator=torch.Generator())


def test_kernel_wrapper_refuses_other_devices():
    q = torch.empty(4, 128, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_forward(q, q, q, scale=0.125, causal=True)


# bf16: the port's plain versions repeat the tensor-core kernels' rounding
# (each probability tile, and in dQ and dK/dV each dS tile, rounded to bf16
# before its product; the forward in the kernel's k tiles). The JAX kernels in
# interpret mode compute in f32 from the same bf16 inputs. A rounded P is
# off by at most 2^-9 relative, which moves a sum of p*x by at most 2^-9 of
# sum |p*x|, and both sides round their outputs to bf16 (2^-9 relative):
# atol 1e-2 + rtol 1e-2 on O and the gradients (measured excess over the
# rtol term: <= 6.5e-3). lse is an f32 sum of unrounded terms on both
# sides: the f32 tolerance of the tests above.
_BF16 = dict(atol=1e-2, rtol=1e-2)
_BF16_CASES = [
    # (causal, head dim, length, JAX block)
    (True, 64, 256, 64), (False, 64, 256, 64),
    (True, 128, 256, 64), (False, 128, 256, 64),
    (True, 64, 80, 16),   # ragged: every port tile is cut short
]


def _bf16_three(seed, l, d, bh=4):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal((bh, l, d)).astype(np.float32),
                        jnp.bfloat16) for _ in range(4)]


def _t(x):
    return torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("causal,d,l,block", _BF16_CASES)
def test_bf16_forward_plain_matches_jax(causal, d, l, block):
    q, k, v, _ = _bf16_three(20, l, d)
    scale = d ** -0.5
    jo, jlse = jfa._flash_forward(q, k, v, scale=scale, causal=causal,
                                  block_q=block, block_k=block,
                                  interpret=True)
    to, tlse = tfa.flash_forward(_t(q), _t(k), _t(v), scale=scale,
                                 causal=causal)
    assert to.dtype == torch.bfloat16 and tlse.dtype == torch.float32
    np.testing.assert_allclose(_f32(to), _f32(jo), **_BF16)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, 0],
                               atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,d,l,block", _BF16_CASES)
def test_bf16_backward_plain_matches_jax(causal, d, l, block):
    """dK/dV (rounded P and dS) and dQ (rounded dS), as their kernels
    compute them, fed the JAX forward's lse and delta."""
    q, k, v, do = _bf16_three(21, l, d)
    scale = d ** -0.5
    kw = dict(scale=scale, causal=causal, block_q=block, block_k=block,
              interpret=True)
    jo, jlse = jfa._flash_forward(q, k, v, **kw)
    jdelta = jnp.sum(do.astype(jnp.float32) * jo.astype(jnp.float32),
                     axis=-1)[:, None, :]
    jgrads = jfa._flash_backward(q, k, v, do, jlse, jdelta, **kw)
    args = (_t(q), _t(k), _t(v), _t(do),
            torch.from_numpy(np.array(jlse)[:, 0]),
            torch.from_numpy(np.array(jdelta)[:, 0]))
    tdq = tfa.flash_backward_dq(*args, scale=scale, causal=causal)
    tdk, tdv = tfa.flash_backward_dkv(*args, scale=scale, causal=causal)
    for a, b in zip((tdq, tdk, tdv), jgrads):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(a), _f32(b), **_BF16)


def test_bf16_plain_rounds_where_the_kernels_do():
    """The bf16 forward rounds P to bf16 in the kernel's k tiles: it differs
    from the same arithmetic unrounded, and from 64-column tiles at D=64."""
    q, k, v = (_t(x) for x in _bf16_three(22, 256, 64)[:3])
    kw = dict(scale=0.125, causal=True)
    o128, _ = tfa.flash_forward_plain(q, k, v, **kw)
    o64, _ = tfa.flash_forward_plain(q, k, v, tile=64, **kw)
    o32, _ = tfa.flash_forward_plain(q.float(), k.float(), v.float(), **kw)
    assert tfa.FWD_BF16_BLOCK_K[64] == 128
    assert not torch.equal(o128, o64)
    assert not torch.equal(o128, o32.bfloat16())


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_plain_dq_rounds_ds(causal):
    """The bf16 dQ rounds dS to bf16 before dS K, as its kernel does: it
    differs from the same arithmetic unrounded, and stays within the bf16
    tolerance of it."""
    q, k, v, do = (_t(x) for x in _bf16_three(23, 256, 64))
    kw = dict(scale=0.125, causal=causal)
    o, lse = tfa.flash_forward_plain(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    dq = tfa.flash_backward_dq_plain(q, k, v, do, lse, delta, **kw)
    dq32 = tfa.flash_backward_dq_plain(q.float(), k.float(), v.float(),
                                       do.float(), lse, delta, **kw)
    assert dq.dtype == torch.bfloat16 and dq32.dtype == torch.float32
    assert not torch.equal(dq, dq32.bfloat16())
    np.testing.assert_allclose(_f32(dq), dq32.numpy(), **_BF16)
