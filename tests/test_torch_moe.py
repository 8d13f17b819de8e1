"""The port's Switch top-1 MoE FFN (ray_tpu_torch.models.transformer,
torch on the CPU) against the JAX package's on the same weights: the FFN
alone (the port's index version and its one-hot plain version), the tiny
MoE model's loss and gradients, training, the serving functions with
dropping (run in the same order on both sides), and the engine's contracts
where nothing is dropped.

The reference's capacity C = max(1, int(cf * T / E)) counts every token of
a call, so the rows of a batch compete for it: an idle decode slot or a
prefill pad row can push a live token past its expert's capacity. The port
reproduces that; the engine's contracts (prefix cache on or off, resume
after preemption) hold only where nothing is dropped, here
``moe_capacity_factor = moe_experts`` (C = T)."""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import models as jm
from ray_tpu.models import generate as jg
from ray_tpu.models import transformer as jt
from ray_tpu.serve.llm import engine as je
from ray_tpu.serve.llm.replicas import _build_model as jax_build_model
from ray_tpu_torch import models as tm
from ray_tpu_torch.models import generate as tg
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.serve.llm.engine import (
    EngineConfig, InflightBatchEngine, _build_model,
)

E = 4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype="f32", **kw):
    jd, td = DTYPES[dtype]
    kw = dict(moe_experts=E, **kw)
    return (jm.GPTConfig.preset("tiny", dtype=jd, **kw),
            tm.GPTConfig.preset("tiny", dtype=td, **kw))


def _params(jcfg, tcfg, seed=0):
    jp = jm.init_params(jax.random.key(seed), jcfg)
    return jp, tm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")


@pytest.fixture
def routes(monkeypatch):
    """Every routing decision of the port's MoE layers while the test
    runs: (expert of each token [T], capacity C) per call."""
    seen = []
    real = tt._route

    def spy(x, bp, cfg, tape):
        gate, expert, C = real(x, bp, cfg, tape)
        seen.append((expert.tolist(), C))
        return gate, expert, C

    monkeypatch.setattr(tt, "_route", spy)
    return seen


def _dropped(experts, C):
    """Indices of the tokens past their expert's capacity, counted in token
    order (a plain loop, independent of the port's cumsum)."""
    count, out = {}, []
    for t, e in enumerate(experts):
        count[e] = count.get(e, 0) + 1
        if count[e] > C:
            out.append(t)
    return out


def _n_dropped(seen):
    return sum(len(_dropped(e, c)) for e, c in seen)


# ------------------------------------------------------------ the FFN alone


def _ffn_case(case, dtype):
    """(JAX cfg, port cfg, layer-0 params as numpy, h [2, 32, 64]) for a
    case: "binds" routes most tokens to expert 0 at cf 1.0, so capacity
    drops many; "loose" has cf 2.0 and drops none; "ties" gives experts 1
    and 2 the same router column, so their gates tie exactly and the first
    index wins."""
    cf = 1.0 if case == "binds" else 2.0
    jcfg, tcfg = _cfgs(dtype, moe_capacity_factor=cf)
    jp = jm.init_params(jax.random.key(3), jcfg)
    bp = {k: np.array(v[0]) for k, v in jp["blocks"].items()}
    h = np.random.default_rng(5).standard_normal((2, 32, 64)).astype(
        np.float32)
    if case == "binds":
        h += 1.0
        bp["wg"][:, 0] += 0.05
    if case == "ties":
        bp["wg"][:, 2] = bp["wg"][:, 1]
    return jcfg, tcfg, bp, h


def _jax_moe(jcfg, bp, h):
    return jt._moe_ffn(h, bp, jcfg, lambda y, *a: y)


def _torch_bp(bp, dtype):
    """Layer params as the port's blocks see them: weights and biases in
    the compute dtype, layer norm's in f32."""
    return {k: torch.from_numpy(v).to(torch.float32 if k in tt._LN_PARAMS
                                      else dtype) for k, v in bp.items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["binds", "loose", "ties"])
def test_moe_ffn_matches_jax_and_onehot(case, dtype):
    jcfg, tcfg, bp, h = _ffn_case(case, dtype)
    cd = tcfg.dtype
    ref = np.asarray(_jax_moe(jcfg, bp, jnp.asarray(h, jcfg.dtype)).astype(
        jnp.float32))
    tbp, th = _torch_bp(bp, cd), torch.from_numpy(h).to(cd)
    with torch.no_grad():
        out = tt._moe_ffn(th, tbp, tcfg)
        plain = tt._moe_ffn_onehot(th, tbp, tcfg)
        _, expert, C = tt._route(th.reshape(-1, 64), tbp, tcfg, None)
    assert out.dtype == cd and out.shape == (2, 32, 64)
    # Index and one-hot versions add the same single term per token.
    torch.testing.assert_close(out, plain, atol=0, rtol=0)
    # f32: only summation orders differ. bf16: an expert's products may
    # round to a neighbouring bf16 value on either side, which moves an
    # output by up to about an ulp at the output's scale (the power of two
    # above its largest value).
    scale = 2.0 ** np.ceil(np.log2(np.abs(ref).max()))
    atol = 1e-5 if dtype == "f32" else scale * 2.0 ** -7
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol, rtol=0)
    dropped = _dropped(expert.tolist(), C)
    zero_rows = np.flatnonzero(~ref.reshape(-1, 64).any(-1)).tolist()
    assert zero_rows == dropped == np.flatnonzero(
        ~out.reshape(-1, 64).any(-1).numpy()).tolist()
    if case == "binds":
        assert len(dropped) > 20
    else:
        assert not dropped
    if case == "ties":
        assert 1 in expert.tolist() and 2 not in expert.tolist()


@pytest.mark.parametrize("case", ["binds", "loose", "ties"])
@pytest.mark.parametrize("version", ["index", "onehot"])
def test_moe_ffn_gradients_match_jax(case, version):
    """Gradients of sum(ffn(h) * g) for h and every FFN param, f32. The
    gate is the only path to the router, and tied gates share its
    gradient (jnp.max's rule; ``amax``'s in the port)."""
    jcfg, tcfg, bp, h = _ffn_case(case, "f32")
    names = ("wg", "w_up", "b_up", "w_down", "b_down")
    g = np.random.default_rng(6).standard_normal(h.shape).astype(np.float32)

    def jloss(h, ffn):
        return (_jax_moe(jcfg, dict(bp, **ffn), h) * g).sum()

    jgrads = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), {k: jnp.asarray(bp[k]) for k in names})
    tbp = {k: v.requires_grad_() for k, v in _torch_bp(bp, torch.float32)
           .items()}
    th = torch.from_numpy(h).requires_grad_()
    fn = tt._moe_ffn if version == "index" else tt._moe_ffn_onehot
    (fn(th, tbp, tcfg) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgrads[0]),
                               atol=2e-5, rtol=1e-3)
    for k in names:
        np.testing.assert_allclose(tbp[k].grad.numpy(),
                                   np.asarray(jgrads[1][k]), atol=2e-5,
                                   rtol=1e-3, err_msg=k)


# ---------------------------------------------------------------- the model


def test_moe_params_carry_over_and_axis_order_is_checked():
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0), jcfg))
    tp = tm.params_from_numpy(tree, tcfg, device="cpu")
    assert tp["blocks"]["w_up"].shape == (2, E, 64, 256)
    assert tp["blocks"]["wg"].shape == (2, 64, E)
    meta = tm.init_params(tcfg, generator=torch.Generator(), device="meta")
    assert tm.count_params(meta) == tm.count_params(tp) == sum(
        x.size for x in jax.tree.leaves(tree))
    swapped = dict(tree, blocks=dict(
        tree["blocks"], w_up=tree["blocks"]["w_up"].transpose(0, 2, 1, 3)))
    with pytest.raises(ValueError, match=r"\['w_up'\]: expected shape"):
        tm.params_from_numpy(swapped, tcfg, device="cpu")


def test_moe_param_count_gpt2_125m_moe8_on_meta():
    """gpt2-125m with 8 experts: 521,233,920 params, 124,549,632 of them
    active per token (one expert per layer, plus the router)."""
    tcfg = tm.GPTConfig.preset("gpt2-125m", moe_experts=8)
    tp = tm.init_params(tcfg, generator=torch.Generator(), device="meta")
    blocks = tp["blocks"]
    experts = sum(blocks[k].numel() for k in ("w_up", "b_up", "w_down",
                                               "b_down"))
    assert tm.count_params(tp) == 521_233_920
    assert tm.count_params(tp) - experts * 7 // 8 == 124_549_632
    jshapes = jax.eval_shape(lambda: jm.init_params(
        jax.random.key(0), jm.GPTConfig.preset("gpt2-125m", moe_experts=8)))
    assert tm.count_params(tp) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes))


def _batches(seed, b=2, l=64):
    toks = np.random.default_rng(seed).integers(0, 256, (b, l + 1))
    return ({"inputs": jnp.asarray(toks[:, :-1], jnp.int32),
             "targets": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"inputs": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])})


@pytest.mark.parametrize("kw", [{}, {"flash_attention": True}],
                         ids=["reference_attention", "flash_attention"])
def test_moe_forward_loss_and_grads_match_jax(kw, routes):
    """The tiny MoE model (cf 1.25, which drops tokens at this size):
    logits, loss and every param's gradient against jax.grad, with remat
    on (the port recomputes each block in backward)."""
    jcfg, tcfg = _cfgs(**kw)
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batches(2)
    ref = jax.jit(jm.forward, static_argnums=2)(jp, jb["inputs"], jcfg)
    with torch.no_grad():
        out = tm.forward(tp, tb["inputs"], tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)
    assert _n_dropped(routes) > 0
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn),
                            static_argnums=2)(jp, jb, jcfg)
    loss = tm.loss_fn(tp, tb, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jg_ = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    tg_ = [p.grad.numpy() for p in tt.tree_leaves(tp)]
    assert len(jg_) == len(tg_) == 17
    for a, b in zip(tg_, jg_):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-3)


def test_moe_training_reduces_loss():
    """The port's side of tests/test_models.py's MoE training check."""
    _, tcfg = _cfgs("bf16", flash_attention=True)
    state = tm.make_train_state(
        tcfg, functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=0.1),
        generator=torch.Generator().manual_seed(0), device="cpu")
    step = tm.make_train_step(tcfg)
    _, tb = _batches(6, b=4, l=32)
    losses = [step(state, tb)[1]["loss"].item() for _ in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ---------------------------------------------- serving functions, dropping

# cf 1.0: a decode step of 4 slots or a prefill chunk of 4 tokens has
# capacity 1 per expert, so any two tokens of a call on one expert drop one.
SERVE = dict(preset="tiny", model_overrides={
    "dtype": "float32", "moe_experts": E, "moe_capacity_factor": 1.0},
    max_slots=4, max_len=64, prompt_buckets=(16,), max_new_tokens=16)


def _serve_model(base):
    jcfg, jp = jax_build_model(je.EngineConfig.from_dict(base))
    tcfg = EngineConfig.from_dict(base).gpt_config()
    return jcfg, jp, tcfg, tm.params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def test_moe_chunked_prefill_and_decode_with_idle_slots_match_jax(routes):
    """Chunked prefill (chunks of 4, the last one padded) into slot 2's
    pages, then decode steps with slots 0, 1 and 3 idle: the pad rows and
    the idle slots take expert capacity on both sides, so the same live
    tokens are dropped, and tokens and pools agree."""
    jcfg, jp, tcfg, tp = _serve_model(SERVE)
    prompt = [7, 3, 1, 12, 9, 4, 2]
    bs, M, S, NB, chunk = 4, 8, 4, 16, 4
    bt = np.zeros((S, M), np.int64)
    bt[2, :4] = [11, 3, 7, 1]
    pool = tg.init_paged_pool(tcfg, NB, bs, S, M, device="cpu")
    jpool = jg.init_paged_pool(jcfg, NB, bs, S, M)
    kv, jkv = ({"k": p["k"], "v": p["v"]} for p in (pool, jpool))
    for start in range(0, len(prompt), chunk):
        c = prompt[start:start + chunk]
        padded = np.zeros((1, chunk), np.int64)
        padded[0, :len(c)] = c
        first, kv = tg.prefill_chunk_paged(
            tp, kv, torch.from_numpy(bt[2]), torch.from_numpy(padded), start,
            len(c), 0, cfg=tcfg, block_size=bs)
        jfirst, jkv = jg.prefill_chunk_paged(
            jp, jkv, jnp.asarray(bt[2], jnp.int32),
            jnp.asarray(padded, jnp.int32), jnp.int32(start),
            jnp.int32(len(c)), jnp.int32(0), cfg=jcfg, block_size=bs)
    assert int(first[0]) == int(jfirst[0])
    np.testing.assert_allclose(kv["k"].numpy(), np.asarray(jkv["k"]),
                               atol=1e-4)
    prefill_drops = _n_dropped(routes)
    pool.update(kv, block_tables=torch.from_numpy(bt))
    jpool.update(jkv, block_tables=jnp.asarray(bt, jnp.int32))
    lengths = np.zeros(S, np.int64)
    lengths[2] = len(prompt)
    pool["lengths"] = torch.from_numpy(lengths)
    jpool["lengths"] = jnp.asarray(lengths, jnp.int32)
    active = np.arange(S) == 2
    last = np.zeros(S, np.int64)
    last[2] = int(first[0])
    n_calls = len(routes)
    for _ in range(6):
        nxt, pool = tg.decode_step_paged(
            tp, pool, torch.from_numpy(last), torch.from_numpy(active),
            torch.zeros(S, dtype=torch.int64), cfg=tcfg, block_size=bs)
        jnxt, jpool = jg.decode_step_paged(
            jp, jpool, jnp.asarray(last, jnp.int32), jnp.asarray(active),
            jnp.zeros((S,), jnp.int32), cfg=jcfg, block_size=bs)
        assert nxt.tolist() == np.asarray(jnxt).tolist()
        last[2] = int(nxt[2])
    np.testing.assert_allclose(pool["k"].numpy(), np.asarray(jpool["k"]),
                               atol=1e-4)
    assert pool["lengths"].tolist() == np.asarray(jpool["lengths"]).tolist()
    # Both kinds of coupling happened: pad rows in prefill, and the live
    # slot (row 2) dropped behind an idle one in decode.
    assert prefill_drops > 0
    assert any(2 in _dropped(e, c) for e, c in routes[n_calls:])


def test_moe_prefill_slots_match_jax(routes):
    """Batched prefill of 3 prompts and a dummy row, padded to 16: 64
    tokens compete for capacity 16 per expert, pad rows included."""
    jcfg, jp, tcfg, tp = _serve_model(SERVE)
    prompts = [[5, 9, 2], [7, 7, 7, 7, 1, 3], [3, 1, 4, 1, 5]]
    padded = np.zeros((4, 16), np.int64)
    lens, seeds = np.ones(4, np.int64), np.zeros(4, np.int64)
    for i, p in enumerate(prompts):
        padded[i, :len(p)], lens[i], seeds[i] = p, len(p), 10 + i
    kw = dict(temperature=0.9, top_k=8)
    firsts, kv = tg.prefill_slots(tp, torch.from_numpy(padded),
                                  torch.from_numpy(lens),
                                  torch.from_numpy(seeds), cfg=tcfg, **kw)
    jfirsts, jkv = jg.prefill_slots(
        jp, jnp.asarray(padded, jnp.int32), jnp.asarray(lens, jnp.int32),
        jnp.asarray(seeds, jnp.int32), cfg=jcfg, **kw)
    assert firsts.tolist() == np.asarray(jfirsts).tolist()
    np.testing.assert_allclose(kv["k"].numpy(), np.asarray(jkv["k"]),
                               atol=1e-4)
    np.testing.assert_allclose(kv["v"].numpy(), np.asarray(jkv["v"]),
                               atol=1e-4)
    assert _n_dropped(routes) > 0


# ------------------------------------ scratch row 0: one writer, fixed bytes


@pytest.fixture
def scratch_writes(monkeypatch):
    """(rows, values) of every indexed write into a pool layer while the
    test runs."""
    seen = []
    real = tg._scatter_rows

    def spy(pool, rows, vals):
        seen.append((rows.clone(), vals.clone()))
        real(pool, rows, vals)

    monkeypatch.setattr(tg, "_scatter_rows", spy)
    return seen


def _duplicates_carry_equal_bytes(writes):
    """Every write's repeated rows get bit-identical values, so the order
    in which the card applies them cannot change the pool. Returns how
    many writes repeated a row."""
    repeated = 0
    for rows, vals in writes:
        for r in rows.unique():
            same = (rows == r).nonzero()[:, 0]
            if len(same) > 1:
                repeated += 1
                assert all(torch.equal(vals[same[0]], vals[i])
                           for i in same[1:]), int(r)
    return repeated


def _paged_both(tcfg, jcfg, S, M, NB, bs, bt):
    pool = tg.init_paged_pool(tcfg, NB, bs, S, M, device="cpu")
    jpool = jg.init_paged_pool(jcfg, NB, bs, S, M)
    pool["block_tables"] = torch.from_numpy(bt)
    jpool["block_tables"] = jnp.asarray(bt, jnp.int32)
    return pool, jpool


def _scratch_row_matches_jax(pool, jpool, bs):
    """Scratch block 0 (row 0 written, the rest zero) as the JAX paged
    functions leave it. The candidate writers' rows differ by far more
    than the tolerance, so this names the writer."""
    for name in ("k", "v"):
        np.testing.assert_allclose(pool[name][:, :bs].numpy(),
                                   np.asarray(jpool[name])[:, :bs],
                                   atol=1e-5, rtol=0)


def test_prefill_pad_rows_write_scratch_row_order_free(scratch_writes):
    """A chunk of 6 real tokens and 10 pad rows: every pad row goes to
    scratch row 0 with the values of the last pad row, which is the row the
    JAX package's in-order scatter leaves there; the pad rows attend to
    row 0 and take expert capacity, so the first token and the pool agree
    with JAX's too."""
    jcfg, jp, tcfg, tp = _serve_model(SERVE)
    bs, M, S, NB, C = 4, 8, 2, 12, 16
    bt = np.zeros((S, M), np.int64)
    bt[1, :2] = [5, 9]
    pool, jpool = _paged_both(tcfg, jcfg, S, M, NB, bs, bt)
    padded = np.arange(C, dtype=np.int64)[None] * 3 % tcfg.vocab_size
    first, kv = tg.prefill_chunk_paged(
        tp, {"k": pool["k"], "v": pool["v"]}, torch.from_numpy(bt[1]),
        torch.from_numpy(padded), 0, 6, 0, cfg=tcfg, block_size=bs)
    jfirst, jkv = jg.prefill_chunk_paged(
        jp, {"k": jpool["k"], "v": jpool["v"]}, jnp.asarray(bt[1], jnp.int32),
        jnp.asarray(padded, jnp.int32), jnp.int32(0), jnp.int32(6),
        jnp.int32(0), cfg=jcfg, block_size=bs)
    assert int(first[0]) == int(jfirst[0])
    _scratch_row_matches_jax(kv, jkv, bs)
    np.testing.assert_allclose(kv["k"].numpy(), np.asarray(jkv["k"]),
                               atol=1e-4)
    assert _duplicates_carry_equal_bytes(scratch_writes) == 2 * tcfg.n_layers
    for rows, vals in scratch_writes:
        assert torch.equal(vals[6:], vals[C - 1].expand_as(vals[6:]))


def test_idle_slots_write_scratch_row_order_free(scratch_writes):
    """Decode steps with slot 2 live and slots 0, 1, 3 idle on other
    tokens (so their K/V rows differ): every idle slot writes the K/V row
    of the highest-numbered idle slot to scratch row 0, the writer the JAX
    paged functions run in order leave there; every idle slot attends to
    that row, and through expert capacity the live slot's tokens depend on
    it."""
    jcfg, jp, tcfg, tp = _serve_model(SERVE)
    bs, M, S, NB = 4, 8, 4, 16
    bt = np.zeros((S, M), np.int64)
    bt[2, :3] = [7, 2, 11]
    pool, jpool = _paged_both(tcfg, jcfg, S, M, NB, bs, bt)
    lengths = np.zeros(S, np.int64)
    lengths[2] = 5
    pool["lengths"] = torch.from_numpy(lengths)
    jpool["lengths"] = jnp.asarray(lengths, jnp.int32)
    active = np.arange(S) == 2
    last = np.asarray([17, 4, 9, 30], np.int64)
    for _ in range(3):
        nxt, pool = tg.decode_step_paged(
            tp, pool, torch.from_numpy(last), torch.from_numpy(active),
            torch.zeros(S, dtype=torch.int64), cfg=tcfg, block_size=bs)
        jnxt, jpool = jg.decode_step_paged(
            jp, jpool, jnp.asarray(last, jnp.int32), jnp.asarray(active),
            jnp.zeros((S,), jnp.int32), cfg=jcfg, block_size=bs)
        assert nxt.tolist() == np.asarray(jnxt).tolist()
        _scratch_row_matches_jax(pool, jpool, bs)
        last[2] = int(nxt[2])
    np.testing.assert_allclose(pool["k"].numpy(), np.asarray(jpool["k"]),
                               atol=1e-4)
    assert _duplicates_carry_equal_bytes(scratch_writes) == (
        3 * 2 * tcfg.n_layers)
    for rows, vals in scratch_writes:
        assert rows.tolist()[:2] == [0, 0] and rows[3] == 0
        assert torch.equal(vals[0], vals[3]) and torch.equal(vals[1], vals[3])


# --------------------------------------------- the engine, drop-free (C = T)

DROP_FREE = dict(SERVE, model_overrides=dict(
    SERVE["model_overrides"], moe_capacity_factor=float(E)))
BS, N = 4, 8
PROMPT = [5, 9, 2, 11, 3]


@pytest.fixture(scope="module")
def drop_free():
    return _serve_model(DROP_FREE)


@functools.lru_cache(maxsize=None)
def _jax_generate(prompt, n):
    jcfg, jp = jax_build_model(je.EngineConfig.from_dict(DROP_FREE))
    return np.asarray(jg.generate(
        jp, jnp.asarray([prompt], jnp.int32), jax.random.key(0), cfg=jcfg,
        max_new_tokens=n, temperature=0.0))[0].tolist()


@functools.lru_cache(maxsize=None)
def _jax_stream(prompt, seed, temperature, top_k):
    """N tokens of one request through the JAX paged functions in order:
    chunked prefill into slot 0's pages, then decode steps."""
    jcfg, jp = jax_build_model(je.EngineConfig.from_dict(DROP_FREE))
    S, M = DROP_FREE["max_slots"], DROP_FREE["max_len"] // BS
    kw = dict(cfg=jcfg, block_size=BS, temperature=temperature, top_k=top_k)
    pool = jg.init_paged_pool(jcfg, S * M + 1, BS, S, M)
    bt = np.zeros((S, M), np.int32)
    bt[0] = np.arange(1, M + 1)
    kv = {"k": pool["k"], "v": pool["v"]}
    for start in range(0, len(prompt), BS):
        c = prompt[start:start + BS]
        padded = np.zeros((1, BS), np.int32)
        padded[0, :len(c)] = c
        first, kv = jg.prefill_chunk_paged(
            jp, kv, jnp.array(bt[0]), jnp.array(padded), jnp.int32(start),
            jnp.int32(len(c)), jnp.int32(seed), **kw)
    lengths = np.zeros(S, np.int32)
    lengths[0] = len(prompt)
    pool = dict(kv, block_tables=jnp.array(bt), lengths=jnp.array(lengths))
    out, last = [int(first[0])], np.zeros(S, np.int32)
    active, seeds = np.arange(S) == 0, np.full(S, seed, np.int32)
    while len(out) < N:
        last[0] = out[-1]
        nxt, pool = jg.decode_step_paged(jp, pool, jnp.array(last),
                                         jnp.array(active),
                                         jnp.array(seeds), **kw)
        out.append(int(nxt[0]))
    return out


def _engine(model, **kw):
    _, _, tcfg, tp = model
    return InflightBatchEngine(tp, tcfg, EngineConfig.from_dict(dict(
        DROP_FREE, paged_kv=True, kv_block_size=BS, prefill_chunk=BS, **kw)),
        device="cpu")


def _run(eng, jobs):
    rids = [eng.submit(p, N, seed=s) for p, s in jobs]
    return [list(itertools.chain.from_iterable(eng.stream(r, max_wait_s=10)))
            for r in rids]


def test_moe_engine_greedy_cache_on_off_match_jax(drop_free, routes):
    """Concurrent greedy requests: the engine with the prefix cache on and
    off gives each request the JAX package's generate() tokens, and no
    token is dropped anywhere (C = T)."""
    common = [7, 3, 9, 1, 4, 4, 2, 8, 6, 5, 1, 2]
    jobs = [(common + tail, 0) for tail in ([12, 13], [14, 15, 16], [11])]
    expect = [_jax_generate(tuple(p), N) for p, _ in jobs]
    on = _engine(drop_free, prefix_cache_enabled=True)
    off = _engine(drop_free)
    try:
        assert _run(off, jobs) == expect
        assert _run(on, jobs[:1]) + _run(on, jobs[1:]) == expect
        assert on.stats()["prefix_cache_hit_tokens"] > 0
        assert on.stats()["kv_blocks_used"] == off.stats()[
            "kv_blocks_used"] == 0
    finally:
        on.stop()
        off.stop()
    assert routes and _n_dropped(routes) == 0


def test_moe_engine_sampled_resume_after_preemption(drop_free):
    """Sampled streams: a contended pool that preempts and resumes by
    recompute, a solo engine, and the JAX paged functions run in order
    give the same tokens, seed by seed."""
    sampled = dict(temperature=0.9, top_k=16)
    jobs = [(PROMPT, 3), ([9, 9, 1, 2], 4), ([6, 2], 5)]
    expect = [_jax_stream(tuple(p), s, 0.9, 16) for p, s in jobs]
    solo = _engine(drop_free, **sampled)
    tight = _engine(drop_free, kv_num_blocks=7, **sampled)
    try:
        assert [_run(solo, [j])[0] for j in jobs] == expect
        assert _run(tight, jobs) == expect
        assert tight.stats()["kv_blocks_used"] == 0
    finally:
        solo.stop()
        tight.stop()


def test_moe_build_model_serves():
    """_build_model takes moe_experts from model_overrides and draws the
    experts' params; an engine serves on them."""
    ec = EngineConfig.from_dict(dict(DROP_FREE, paged_kv=True,
                                     kv_block_size=BS, prefill_chunk=BS))
    cfg, params = _build_model(ec, device="cpu")
    assert cfg.moe_experts == E
    assert params["blocks"]["w_down"].shape == (2, E, 256, 64)
    eng = InflightBatchEngine(params, cfg, ec, device="cpu")
    try:
        out = eng.generate(PROMPT, 5)
        assert len(out) == 5 and all(0 <= t < cfg.vocab_size for t in out)
    finally:
        eng.stop()
