"""Parity of the port's GPT model (ray_tpu_torch.models, torch on the CPU)
with the JAX package's, on the same weights carried over with
``params_from_numpy`` (tiny preset, f32) and the same numpy-seeded tokens."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu import models as jm
from ray_tpu_torch import models as tm
from ray_tpu_torch.models import transformer as tt

_LR = 1e-3


def _cfgs(**kw):
    return (jm.GPTConfig.preset("tiny", dtype=jnp.float32, **kw),
            tm.GPTConfig.preset("tiny", dtype=torch.float32, **kw))


def _params(jcfg, tcfg, seed=0):
    jp = jm.init_params(jax.random.key(seed), jcfg)
    return jp, tm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")


def _tokens(seed, b=2, l=64, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, l + 1))


def _batches(toks):
    jb = {"inputs": jnp.asarray(toks[:, :-1], jnp.int32),
          "targets": jnp.asarray(toks[:, 1:], jnp.int32)}
    tb = {"inputs": torch.from_numpy(toks[:, :-1]),
          "targets": torch.from_numpy(toks[:, 1:])}
    return jb, tb


def _leaves(params):
    return [p.detach().numpy() for p in tt.tree_leaves(params)]


@pytest.mark.parametrize("kw", [
    {}, {"flash_attention": True}, {"rotary": True},
], ids=["reference_attention", "flash_attention", "rotary"])
def test_forward_matches_jax(kw):
    jcfg, tcfg = _cfgs(**kw)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(1)[:, :-1]
    ref = jax.jit(jm.forward, static_argnums=2)(
        jp, jnp.asarray(toks, jnp.int32), jcfg)
    with torch.no_grad():
        out = tm.forward(tp, torch.from_numpy(toks), tcfg)
    assert out.shape == (2, 64, 256) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


def test_loss_and_grads_match_jax():
    """loss_fn and one step's gradients against jax.grad, through the flash
    path with remat on (the port's recompute launches the forward again)."""
    jcfg, tcfg = _cfgs(flash_attention=True)
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batches(_tokens(2))
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn),
                            static_argnums=2)(jp, jb, jcfg)
    loss = tm.loss_fn(tp, tb, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jg = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    tg = [p.grad.numpy() for p in tt.tree_leaves(tp)]
    assert len(jg) == len(tg)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-3)


@functools.lru_cache(maxsize=None)
def _jax_step(weight_decay):
    """The reference's params after one train step, and that step's
    gradients (numpy; cached, both are read-only)."""
    jcfg, _ = _cfgs(remat=False)
    jb, _ = _batches(_tokens(3, b=4, l=32))
    jopt = optax.adamw(_LR, weight_decay=weight_decay)
    jstate = jm.make_train_state(jax.random.key(0), jcfg, jopt)
    jgrads = jax.jit(jax.grad(jm.loss_fn), static_argnums=2)(
        jstate.params, jb, jcfg)
    jstate, _ = jax.jit(jm.make_train_step(jcfg, jopt))(jstate, jb)
    return ([np.asarray(x) for x in jax.tree.leaves(jstate.params)],
            [np.asarray(x) for x in jax.tree.leaves(jgrads)])


def _one_step(weight_decay_torch, weight_decay_jax):
    """Params after one train step in each package (torch AdamW at its
    default decay when ``weight_decay_torch`` is None), and the reference's
    gradients of that step."""
    jcfg, tcfg = _cfgs(remat=False)
    _, tb = _batches(_tokens(3, b=4, l=32))
    _, tp = _params(jcfg, tcfg)
    opt = (torch.optim.AdamW(tt.tree_leaves(tp), lr=_LR)
           if weight_decay_torch is None else
           torch.optim.AdamW(tt.tree_leaves(tp), lr=_LR,
                             weight_decay=weight_decay_torch))
    state = tm.TrainState(step=0, params=tp, opt_state=opt)
    state, metrics = tm.make_train_step(tcfg)(state, tb)
    assert state.step == 1 and torch.isfinite(metrics["grad_norm"])
    return (_leaves(state.params), *_jax_step(weight_decay_jax))


def _assert_adam_step_close(ours, ref, grads):
    """Adam's first step moves an entry by lr*g/(|g|+eps): where |g| is at
    the level of rounding noise (the key bias, whose gradient is zero in
    exact arithmetic, is all such entries) the two packages may land
    anywhere in [-lr, lr]; everywhere else they must agree closely."""
    for a, b, g in zip(ours, ref, grads):
        noisy = np.abs(g) < 1e-6
        np.testing.assert_allclose(a[~noisy], b[~noisy], atol=2e-6, rtol=1e-5)
        assert np.abs(a[noisy] - b[noisy]).max(initial=0.0) <= 2 * _LR


@pytest.mark.parametrize("wd", [0.1, 1e-4])
def test_adamw_step_matches_optax(wd):
    """One step of torch AdamW vs optax.adamw at the same lr and decay."""
    _assert_adam_step_close(*_one_step(wd, wd))


def test_adamw_default_weight_decay_differs_from_optax():
    """The trap: torch's AdamW decays by 1e-2 by default, optax's by 1e-4,
    so ``optax.adamw(lr, weight_decay=0.1)`` (bench.py's) ported without
    its weight_decay decays 10x less: the check above catches it."""
    with pytest.raises(AssertionError):
        _assert_adam_step_close(*_one_step(None, 0.1))


def test_gelu_is_tanh_approximation():
    """jax.nn.gelu defaults to the tanh approximation; the port's FFN must
    use it, and the exact (erf) GELU would be told apart at this size."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    t = torch.from_numpy(x)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(t, approximate="tanh").numpy(), ref,
        atol=1e-6)
    assert np.abs(torch.nn.functional.gelu(t).numpy() - ref).max() > 1e-4
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, tcfg)
    bp = {k: v[0] for k, v in tp["blocks"].items()}
    h = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 8, 64)).astype(np.float32))
    up = h @ bp["w_up"] + bp["b_up"]
    want = torch.nn.functional.gelu(up, approximate="tanh") @ bp["w_down"] \
        + bp["b_down"]
    torch.testing.assert_close(tt._ffn(h, bp, tcfg), want)


def test_causality():
    """Future tokens must not influence earlier logits."""
    _, tcfg = _cfgs()
    tp = tm.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    toks = torch.from_numpy(_tokens(5, b=1, l=16)[:, :-1])
    with torch.no_grad():
        base = tm.forward(tp, toks, tcfg)
        perturbed = toks.clone()
        perturbed[0, -1] = (toks[0, -1] + 1) % tcfg.vocab_size
        out = tm.forward(tp, perturbed, tcfg)
    np.testing.assert_allclose(base[0, :-1], out[0, :-1], atol=1e-5)
    assert not np.allclose(base[0, -1], out[0, -1])


def test_param_count_gpt2_125m_on_meta():
    tcfg = tm.GPTConfig.preset("gpt2-125m")
    tp = tm.init_params(tcfg, generator=torch.Generator(), device="meta")
    n = tm.count_params(tp)
    assert 120e6 < n < 135e6  # ~124M + vocab padding
    jshapes = jax.eval_shape(lambda: jm.init_params(
        jax.random.key(0), jm.GPTConfig.preset("gpt2-125m")))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes))


def test_training_reduces_loss():
    _, tcfg = _cfgs(remat=True, flash_attention=True)
    state = tm.make_train_state(
        tcfg, functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=0.1),
        generator=torch.Generator().manual_seed(0), device="cpu")
    step = tm.make_train_step(tcfg)
    _, tb = _batches(_tokens(6, b=4, l=32))
    losses = [step(state, tb)[1]["loss"].item() for _ in range(6)]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("kw", [
    {"ring_attention": True}, {"pp_microbatches": 2},
])
def test_unported_options_raise(kw):
    _, tcfg = _cfgs(**kw)
    with pytest.raises(NotImplementedError):
        tm.init_params(tcfg, generator=torch.Generator(), device="cpu")


def test_mesh_argument_raises():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, tcfg)
    with pytest.raises(NotImplementedError):
        tm.forward(tp, torch.zeros(1, 4, dtype=torch.long), tcfg,
                   mesh=object())


def test_params_from_numpy_checks_names_and_shapes():
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0), jcfg))
    missing = dict(tree, blocks={k: v for k, v in tree["blocks"].items()
                                 if k != "wo"})
    with pytest.raises(ValueError, match="expected keys"):
        tm.params_from_numpy(missing, tcfg, device="cpu")
    wrong = dict(tree, lnf_scale=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="expected shape"):
        tm.params_from_numpy(wrong, tcfg, device="cpu")


def _bf16_cfgs(**kw):
    return (jm.GPTConfig.preset("tiny", dtype=jnp.bfloat16, **kw),
            tm.GPTConfig.preset("tiny", dtype=torch.bfloat16, **kw))


def _big_embed_params(jcfg, tcfg):
    """Reference and port params with tok_embed of std ~1, so that logits
    reach ~10, where bf16's spacing (2^-4) would show in the logits."""
    jp, _ = _params(jcfg, tcfg)
    jp = dict(jp, tok_embed=jp["tok_embed"] * 50.0)
    return jp, tm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")


def test_bf16_logits_are_f32_sums_of_bf16_operands():
    """With dtype=bf16 the tied head keeps f32 logits: the port's forward
    equals jnp.einsum(..., preferred_element_type=float32) on the bf16
    hidden state and embedding that the head is handed, to f32 rounding."""
    jcfg, tcfg = _bf16_cfgs()
    _, tp = _big_embed_params(jcfg, tcfg)
    toks = torch.from_numpy(_tokens(11)[:, :-1])
    with torch.no_grad():
        logits = tm.forward(tp, toks, tcfg)
        # The head's operands, by the steps forward takes before it.
        cd = tcfg.dtype
        x = tp["tok_embed"][toks].to(cd) + tp["pos_embed"][:64].to(cd)
        positions = torch.arange(64)
        for layer in range(tcfg.n_layers):
            bp = {k: w[layer] for k, w in tp["blocks"].items()}
            x = tt._block(x, bp, tcfg, positions)
        x = tt._layer_norm(x, tp["lnf_scale"], tp["lnf_bias"], tcfg.eps)
        embed = tp["tok_embed"].to(cd)
    want = jnp.einsum("bld,vd->blv", jnp.asarray(x.float().numpy(), jnp.bfloat16),
                      jnp.asarray(embed.float().numpy(), jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    assert logits.dtype == torch.float32 and logits.abs().max() > 8
    # Only the order of the f32 sums differs: 1e-5 relative.
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_bf16_loss_matches_jax():
    """bf16 compute end to end against the JAX loss_fn on the same weights
    and tokens. The two packages round bf16 activations at the same places
    but sum in other orders, so a bf16 activation can differ by an ulp
    (2^-8 relative); on this model the losses differ by ~2e-5 of their
    value: 1e-4 relative."""
    jcfg, tcfg = _bf16_cfgs()
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batches(_tokens(12))
    jloss = jax.jit(jm.loss_fn, static_argnums=2)(jp, jb, jcfg)
    with torch.no_grad():
        loss = tm.loss_fn(tp, tb, tcfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)


def test_bf16_lm_head_gradients_match_jax():
    """The head's backward against jax.vjp of the reference's einsum: the
    port rounds the f32 cotangent to bf16 before its two products (as a
    TPU's default-precision product does), the JAX CPU VJP multiplies it in
    f32; both round the gradients to bf16. 2^-9 relative on each term and
    on the result: rtol 2e-2 of the largest gradient entry."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    embed = rng.standard_normal((256, 64)).astype(np.float32)
    g = rng.standard_normal((2, 16, 256)).astype(np.float32)
    jx, je = (jnp.asarray(a, jnp.bfloat16) for a in (x, embed))
    _, vjp = jax.vjp(lambda a, b: jnp.einsum(
        "bld,vd->blv", a, b, preferred_element_type=jnp.float32), jx, je)
    want = [np.asarray(d.astype(jnp.float32)) for d in vjp(jnp.asarray(g))]
    tx, te = (torch.from_numpy(a).bfloat16().requires_grad_(True)
              for a in (x, embed))
    tt._lm_head(tx, te).backward(torch.from_numpy(g))
    for got, ref in zip((tx.grad, te.grad), want):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), ref,
                                   atol=2e-2 * np.abs(ref).max())
