"""The port's KV-cache generation (ray_tpu_torch.models.generate, torch on
the CPU) against the JAX package's on the same weights (params_from_numpy,
tiny preset, f32) and the same numpy-seeded tokens: the torch versions of
tests/test_generate.py, each also held to the JAX function. Logits within
atol 1e-4 (test_generate.py's tolerance); greedy and sampled tokens
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import models as jm
from ray_tpu.models import generate as jg
from ray_tpu_torch import models as tm
from ray_tpu_torch import random as tr
from ray_tpu_torch.models import generate as tg


def _model(**kw):
    jcfg = jm.GPTConfig.preset("tiny", dtype=jnp.float32, **kw)
    tcfg = tm.GPTConfig.preset("tiny", dtype=torch.float32, **kw)
    jp = jm.init_params(jax.random.key(0), jcfg)
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def setup():
    return _model()


@pytest.fixture(scope="module")
def rotary():
    return _model(rotary=True)


def _toks(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def test_cached_forward_matches_full(setup):
    jcfg, jp, tcfg, tp = setup
    toks = _toks(1, (2, 24))
    with torch.no_grad():
        full = tm.forward(tp, torch.from_numpy(toks), tcfg)
    jfull = np.asarray(jm.forward(jp, jnp.asarray(toks, jnp.int32), jcfg))
    np.testing.assert_allclose(full.numpy(), jfull, atol=1e-4)

    cache = tg.init_cache(tcfg, 2, 24, device="cpu")
    logits_p, cache = tg._forward_cached(tp, torch.from_numpy(toks[:, :16]),
                                         cache, tcfg)
    jlogits, _ = jg._forward_cached(jp, jnp.asarray(toks[:, :16], jnp.int32),
                                    jg.init_cache(jcfg, 2, 24), jcfg)
    np.testing.assert_allclose(logits_p.numpy(), jfull[:, :16], atol=1e-4)
    np.testing.assert_allclose(logits_p.numpy(), np.asarray(jlogits),
                               atol=1e-4)
    for i in range(16, 24):
        step, cache = tg._forward_cached(
            tp, torch.from_numpy(toks[:, i:i + 1]), cache, tcfg)
        np.testing.assert_allclose(step[:, 0].numpy(), jfull[:, i],
                                   atol=1e-4)
    assert cache["length"] == 24


def test_cached_forward_rotary(rotary):
    jcfg, jp, tcfg, tp = rotary
    toks = _toks(1, (1, 16))
    jfull = np.asarray(jm.forward(jp, jnp.asarray(toks, jnp.int32), jcfg))
    cache = tg.init_cache(tcfg, 1, 16, device="cpu")
    _, cache = tg._forward_cached(tp, torch.from_numpy(toks[:, :12]), cache,
                                  tcfg)
    for i in range(12, 16):
        sl, cache = tg._forward_cached(tp, torch.from_numpy(toks[:, i:i + 1]),
                                       cache, tcfg)
    np.testing.assert_allclose(sl[:, 0].numpy(), jfull[:, -1], atol=1e-4)


def test_greedy_generation_matches_argmax_rollout(setup):
    jcfg, jp, tcfg, tp = setup
    prompt = _toks(2, (1, 8))
    out = tg.generate(tp, torch.from_numpy(prompt), tr.key(0, device="cpu"),
                      cfg=tcfg, max_new_tokens=6, temperature=0.0)
    assert out.shape == (1, 6)
    jout = jg.generate(jp, jnp.asarray(prompt, jnp.int32), jax.random.key(0),
                       cfg=jcfg, max_new_tokens=6, temperature=0.0)
    assert out.tolist() == np.asarray(jout).tolist()

    seq = torch.from_numpy(prompt)
    naive = []
    with torch.no_grad():
        for _ in range(6):
            nxt = tm.forward(tp, seq, tcfg)[:, -1].argmax(-1)
            naive.append(int(nxt[0]))
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    assert out[0].tolist() == naive


def test_sampled_generation_shapes_and_validity(setup):
    """Sampled generate: the JAX package's tokens exactly, from the same
    key (split per step, categorical over the top-k)."""
    jcfg, jp, tcfg, tp = setup
    prompt = _toks(3, (3, 5))
    kw = dict(max_new_tokens=10, temperature=0.8, top_k=20)
    out = tg.generate(tp, torch.from_numpy(prompt), tr.key(7, device="cpu"),
                      cfg=tcfg, **kw)
    assert out.shape == (3, 10)
    assert ((out >= 0) & (out < tcfg.vocab_size)).all()
    out2 = tg.generate(tp, torch.from_numpy(prompt), tr.key(7, device="cpu"),
                       cfg=tcfg, **kw)
    assert torch.equal(out, out2)
    jout = jg.generate(jp, jnp.asarray(prompt, jnp.int32), jax.random.key(7),
                       cfg=jcfg, **kw)
    assert out.tolist() == np.asarray(jout).tolist()


# ------------------------------------------------- slotted batch programs


def _run_slotted(cfg, params, jobs, *, slots=4, max_len=64, bucket=16, n=6,
                 temperature=0.0, top_k=0):
    """Drive the port's slotted functions by hand, as test_generate.py
    drives the JAX ones: ``jobs`` maps slot -> (prompt, seed, join_step); a
    request joins at its join_step and leaves with n tokens."""
    cache = tg.init_slotted_cache(cfg, slots, max_len, device="cpu")
    last = torch.zeros(slots, dtype=torch.int64)
    active = torch.zeros(slots, dtype=torch.bool)
    seeds = torch.zeros(slots, dtype=torch.int64)
    out = {s: [] for s in jobs}
    max_join = max(j[2] for j in jobs.values())
    step = 0
    while any(len(out[s]) < n for s in jobs) or step <= max_join:
        for s, (prompt, seed, join) in jobs.items():
            if join == step:
                padded = torch.zeros(1, bucket, dtype=torch.int64)
                padded[0, :len(prompt)] = torch.tensor(prompt)
                first, kv = tg.prefill_slot(
                    params, padded, len(prompt), seed, cfg=cfg,
                    temperature=temperature, top_k=top_k)
                cache = tg.adopt_slot(cache, s, kv, len(prompt))
                last[s], active[s], seeds[s] = first[0], True, seed
                out[s].append(int(first[0]))
        if active.any():
            nxt, cache = tg.decode_step(params, cache, last, active, seeds,
                                        cfg=cfg, temperature=temperature,
                                        top_k=top_k)
            for s in jobs:
                if active[s]:
                    out[s].append(int(nxt[s]))
                    if len(out[s]) >= n:
                        active[s] = False
            last = torch.where(active, nxt, last)
        step += 1
        assert step < 10 * n + 10, "slotted rollout never converged"
    return out


def _jax_slotted(cfg, params, jobs, *, slots=4, max_len=64, bucket=16, n=6,
                 temperature=0.0, top_k=0):
    """The same schedule through the JAX package's slotted programs."""
    cache = jg.init_slotted_cache(cfg, slots, max_len)
    last = np.zeros(slots, np.int32)
    active = np.zeros(slots, bool)
    seeds = np.zeros(slots, np.int32)
    out = {s: [] for s in jobs}
    max_join = max(j[2] for j in jobs.values())
    step = 0
    while any(len(out[s]) < n for s in jobs) or step <= max_join:
        for s, (prompt, seed, join) in jobs.items():
            if join == step:
                padded = np.zeros((1, bucket), np.int32)
                padded[0, :len(prompt)] = prompt
                first, kv = jg.prefill_slot(
                    params, jnp.asarray(padded), jnp.int32(len(prompt)),
                    jnp.int32(seed), cfg=cfg, temperature=temperature,
                    top_k=top_k)
                cache = jg.adopt_slot(cache, jnp.int32(s), kv,
                                      jnp.int32(len(prompt)))
                last[s], active[s], seeds[s] = int(first[0]), True, seed
                out[s].append(int(first[0]))
        if active.any():
            nxt, cache = jg.decode_step(
                params, cache, jnp.asarray(last), jnp.asarray(active),
                jnp.asarray(seeds), cfg=cfg, temperature=temperature,
                top_k=top_k)
            nxt = np.asarray(nxt)
            for s in jobs:
                if active[s]:
                    out[s].append(int(nxt[s]))
                    if len(out[s]) >= n:
                        active[s] = False
            last = np.where(active, nxt, last)
        step += 1
    return out


@pytest.mark.parametrize("use_rotary", [False, True])
def test_slotted_prefill_decode_matches_generate(use_rotary, setup, rotary):
    """prefill_slot + N x decode_step reproduces the JAX package's
    generate() token for token (greedy), through the padded bucket, the
    slot splice and the per-slot length masks."""
    jcfg, jp, tcfg, tp = rotary if use_rotary else setup
    prompt = _toks(5, 9).tolist()
    n = 7
    ref = np.asarray(jg.generate(
        jp, jnp.asarray([prompt], jnp.int32), jax.random.key(0), cfg=jcfg,
        max_new_tokens=n, temperature=0.0))[0].tolist()
    out = _run_slotted(tcfg, tp, {2: (prompt, 0, 0)}, n=n)
    assert out[2] == ref


def test_slotted_join_leave_does_not_perturb_other_slots(rotary):
    """Requests joining/leaving mid-decode change no other slot's tokens
    (sampled, so any cross-slot leak shows), and the crowded run's tokens
    are the JAX package's."""
    jcfg, jp, tcfg, tp = rotary
    pa, pb, pc = [5, 9, 2], [7, 7, 7, 7, 1], [3, 1]
    kw = dict(n=8, temperature=0.9, top_k=12)
    jobs = {1: (pa, 42, 0), 0: (pb, 7, 3), 3: (pc, 99, 6)}
    crowd = _run_slotted(tcfg, tp, jobs, **kw)
    assert crowd[1] == _run_slotted(tcfg, tp, {1: (pa, 42, 0)}, **kw)[1]
    assert crowd[0] == _run_slotted(tcfg, tp, {0: (pb, 7, 0)}, **kw)[0]
    assert crowd == _jax_slotted(jcfg, jp, jobs, **kw)


def test_slotted_sampling_tracks_request_seed(rotary):
    jcfg, jp, tcfg, tp = rotary
    kw = dict(n=6, temperature=0.9, top_k=16)
    a = _run_slotted(tcfg, tp, {0: ([4, 4, 4], 1, 0)}, **kw)
    b = _run_slotted(tcfg, tp, {0: ([4, 4, 4], 2, 0)}, **kw)
    c = _run_slotted(tcfg, tp, {0: ([4, 4, 4], 1, 0)}, **kw)
    assert a[0] == c[0]          # deterministic per seed
    assert a[0] != b[0]          # seed actually steers sampling
    assert b == _jax_slotted(jcfg, jp, {0: ([4, 4, 4], 2, 0)}, **kw)


def test_prefill_last_logits(setup):
    jcfg, jp, tcfg, tp = setup
    toks = _toks(4, (2, 12))
    last, cache = tg.prefill(tp, torch.from_numpy(toks), tcfg, max_len=32)
    jlast, jcache = jg.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg,
                               max_len=32)
    with torch.no_grad():
        full = tm.forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), atol=1e-4)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-4)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-4)
    assert cache["length"] == int(jcache["length"]) == 12


@pytest.mark.parametrize("use_rotary", [False, True])
def test_forward_decode_logits_match_jax(use_rotary, setup, rotary):
    """One decode token for slots at different lengths (one inactive, at
    length 0): the logits and the written cache rows are the JAX
    package's, within atol 1e-4."""
    jcfg, jp, tcfg, tp = rotary if use_rotary else setup
    prompts = {0: [5, 9, 2], 2: [7, 7, 7, 7, 1, 3, 4]}
    cache = tg.init_slotted_cache(tcfg, 3, 32, device="cpu")
    jcache = jg.init_slotted_cache(jcfg, 3, 32)
    for slot, p in prompts.items():
        padded = np.zeros((1, 16), np.int64)
        padded[0, :len(p)] = p
        _, kv = tg.prefill_slot(tp, torch.from_numpy(padded), len(p), 0,
                                cfg=tcfg)
        cache = tg.adopt_slot(cache, slot, kv, len(p))
        _, jkv = jg.prefill_slot(jp, jnp.asarray(padded, jnp.int32),
                                 jnp.int32(len(p)), jnp.int32(0), cfg=jcfg)
        jcache = jg.adopt_slot(jcache, jnp.int32(slot), jkv,
                               jnp.int32(len(p)))
    tokens = np.asarray([11, 0, 42])
    logits, cache = tg._forward_decode(tp, torch.from_numpy(tokens), cache,
                                       tcfg)
    jlogits, jcache = jg._forward_decode(
        jp, jnp.asarray(tokens, jnp.int32), jcache, jcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-4)
    assert cache["lengths"].tolist() == [3, 0, 7]


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a GPU and without device="cpu", the cache constructors
    raise instead of drifting to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tm.GPTConfig.preset("tiny", dtype=torch.float32)
    for make in (lambda: tg.init_cache(cfg, 1, 8),
                 lambda: tg.init_slotted_cache(cfg, 2, 8),
                 lambda: tg.init_paged_pool(cfg, 4, 4, 2, 2),
                 lambda: tr.key(0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
