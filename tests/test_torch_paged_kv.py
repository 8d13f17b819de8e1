"""The port's paged KV cache and engine (ray_tpu_torch.models.generate,
ray_tpu_torch.serve.llm; torch on the CPU) against the JAX package on the
same weights: the model-level and engine-level contracts of
tests/test_paged_kv.py, with the expected tokens taken from the JAX
package's generate() (greedy) and from its paged functions driven in order
for one request, as its engine runs a request alone (sampled). The JAX
engine itself is no oracle here: on the CPU ``jnp.asarray`` of its numpy
block-table and length mirrors aliases them, and it updates them in place
while a dispatched step may still read them. Engines are stopped in
``finally``; every wait is bounded."""

import functools
import itertools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generate as jg
from ray_tpu.serve.llm import engine as je
from ray_tpu.serve.llm.replicas import _build_model as jax_build_model
from ray_tpu_torch.exceptions import EngineFailedError, KVCacheExhaustedError
from ray_tpu_torch.models import generate as tg
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.serve.llm.engine import (
    EngineConfig, InflightBatchEngine, _build_model,
)
from ray_tpu_torch.serve.llm.paged import BlockPool

BASE = dict(preset="tiny", model_overrides={"dtype": "float32"},
            max_slots=4, max_len=64, prompt_buckets=(16,),
            max_new_tokens=16)
PROMPT = [5, 9, 2, 11, 3]
N = 8


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, port cfg, port params): the JAX package's
    engine model, carried over by name."""
    jcfg, jp = jax_build_model(je.EngineConfig.from_dict(BASE))
    tcfg = EngineConfig.from_dict(BASE).gpt_config()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@functools.lru_cache(maxsize=None)
def _jax_ref(prompt, n):
    """The JAX package's greedy generate() on its engine model."""
    jcfg, jp = jax_build_model(je.EngineConfig.from_dict(BASE))
    return np.asarray(jg.generate(
        jp, jnp.asarray([prompt], jnp.int32), jax.random.key(0), cfg=jcfg,
        max_new_tokens=n, temperature=0.0))[0].tolist()


def _ref(prompt, n):
    return _jax_ref(tuple(prompt), n)


def _jax_stream(prompt, n, seed=0, temperature=0.0, top_k=0, bs=4,
                chunk=4):
    """One request through the JAX package's paged functions, in order:
    chunked prefill into slot 0's pages of a parity-sized pool, then
    decode steps (the other slots inactive). Arrays are copied in."""
    jcfg, jp = jax_build_model(je.EngineConfig.from_dict(BASE))
    S, M = BASE["max_slots"], BASE["max_len"] // bs
    kw = dict(cfg=jcfg, block_size=bs, temperature=temperature, top_k=top_k)
    pool = jg.init_paged_pool(jcfg, S * M + 1, bs, S, M)
    bt = np.zeros((S, M), np.int32)
    bt[0] = np.arange(1, M + 1)
    kv = {"k": pool["k"], "v": pool["v"]}
    for start in range(0, len(prompt), chunk):
        c = prompt[start:start + chunk]
        padded = np.zeros((1, chunk), np.int32)
        padded[0, :len(c)] = c
        first, kv = jg.prefill_chunk_paged(
            jp, kv, jnp.array(bt[0]), jnp.array(padded), jnp.int32(start),
            jnp.int32(len(c)), jnp.int32(seed), **kw)
    lengths = np.zeros(S, np.int32)
    lengths[0] = len(prompt)
    pool = dict(kv, block_tables=jnp.array(bt), lengths=jnp.array(lengths))
    out, last = [int(first[0])], np.zeros(S, np.int32)
    active, seeds = np.arange(S) == 0, np.full(S, seed, np.int32)
    while len(out) < n:
        last[0] = out[-1]
        nxt, pool = jg.decode_step_paged(jp, pool, jnp.array(last),
                                         jnp.array(active),
                                         jnp.array(seeds), **kw)
        out.append(int(nxt[0]))
    return out


def _engine(model, **kw):
    _, _, tcfg, tp = model
    return InflightBatchEngine(tp, tcfg, EngineConfig.from_dict(
        dict(BASE, **kw)), device="cpu")


def _stream(eng, rid, wait=10):
    return list(itertools.chain.from_iterable(eng.stream(rid, max_wait_s=wait)))


def _wait_until(pred, timeout=10):
    deadline = time.time() + timeout
    while time.time() < deadline and not pred():
        time.sleep(0.005)
    return pred()


# ------------------------------------------------------------ block pool


def test_block_pool_accounting():
    pool = BlockPool(9, 4)          # 8 usable blocks (block 0 scratch)
    assert pool.capacity == 8 and pool.available() == 8
    assert pool.blocks_for(1) == 1 and pool.blocks_for(4) == 1
    assert pool.blocks_for(5) == 2 and pool.blocks_for(0) == 0
    assert pool.can_fit(32) and not pool.can_fit(33)
    a, b = pool.alloc(3), pool.alloc(5)
    assert len(a) == 3 and len(b) == 5 and pool.available() == 0
    assert 0 not in a + b
    assert pool.alloc(1) is None and pool.available() == 0
    pool.free(a)
    assert pool.available() == 3 and pool.used() == 5
    with pytest.raises(ValueError, match="double free"):
        pool.free([a[0]])
    with pytest.raises(ValueError, match="invalid"):
        pool.free([0])
    pool.free(b)
    s = pool.stats()
    assert pool.used() == 0
    assert s["kv_blocks_alloc_total"] == s["kv_blocks_freed_total"] == 8


# ------------------------------------------------- function-level parity


def _prefill_slot_both(model, prompt, seed=0, **kw):
    jcfg, jp, tcfg, tp = model
    padded = np.zeros((1, 16), np.int64)
    padded[0, :len(prompt)] = prompt
    tf, tkv = tg.prefill_slot(tp, torch.from_numpy(padded), len(prompt),
                              seed, cfg=tcfg, **kw)
    jf, jkv = jg.prefill_slot(jp, jnp.asarray(padded, jnp.int32),
                              jnp.int32(len(prompt)), jnp.int32(seed),
                              cfg=jcfg, **kw)
    assert int(tf[0]) == int(jf[0])
    np.testing.assert_allclose(tkv["k"].numpy(), np.asarray(jkv["k"]),
                               atol=1e-4)
    return int(tf[0]), tkv


@pytest.mark.parametrize("C", [3, 4, 16])
def test_chunked_prefill_equivalence_vs_single_shot(model, C):
    """Chunked prefill writes the same K rows and samples the same first
    token as single-shot prefill_slot (greedy; chunk sizes that do and do
    not divide the prompt), and its pool matches the JAX package's."""
    jcfg, jp, tcfg, tp = model
    prompt = np.random.default_rng(3).integers(0, 256, 11).tolist()
    ref_first, ref_kv = _prefill_slot_both(model, prompt)
    bs, M, S, NB = 4, 8, 2, 20
    bt = np.zeros((S, M), np.int64)
    bt[0, :3] = [5, 9, 2]            # ceil(11/4) = 3 blocks, any order
    pool = tg.init_paged_pool(tcfg, NB, bs, S, M, device="cpu")
    kvp = {"k": pool["k"], "v": pool["v"]}
    jpool = jg.init_paged_pool(jcfg, NB, bs, S, M)
    jkvp = {"k": jpool["k"], "v": jpool["v"]}
    start = 0
    while start < len(prompt):
        chunk = prompt[start:start + C]
        padded = np.zeros((1, C), np.int64)
        padded[0, :len(chunk)] = chunk
        first, kvp = tg.prefill_chunk_paged(
            tp, kvp, torch.from_numpy(bt[0]), torch.from_numpy(padded),
            start, len(chunk), 0, cfg=tcfg, block_size=bs)
        jfirst, jkvp = jg.prefill_chunk_paged(
            jp, jkvp, jnp.asarray(bt[0], jnp.int32),
            jnp.asarray(padded, jnp.int32), jnp.int32(start),
            jnp.int32(len(chunk)), jnp.int32(0), cfg=jcfg, block_size=bs)
        start += len(chunk)
    assert int(first[0]) == int(jfirst[0]) == ref_first
    flat = [int(bt[0][p // bs]) * bs + p % bs for p in range(len(prompt))]
    np.testing.assert_allclose(kvp["k"][:, flat].numpy(),
                               ref_kv["k"][:, 0, :len(prompt)].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(kvp["v"].numpy(), np.asarray(jkvp["v"]),
                               atol=1e-4)


def test_paged_decode_parity_and_pool_state(model):
    """Chunked prefill + decode_step_paged, the sequence in scrambled
    pages, gives the JAX package's generate() tokens, and the pool ends
    as the JAX package's paged functions leave theirs."""
    jcfg, jp, tcfg, tp = model
    prompt = [7, 3, 1, 12, 9, 4, 2]
    bs, M, S, NB = 4, 8, 3, 16
    bt = np.zeros((S, M), np.int64)
    bt[2, :4] = [11, 3, 7, 1]
    pool = tg.init_paged_pool(tcfg, NB, bs, S, M, device="cpu")
    pool["block_tables"] = torch.from_numpy(bt)
    jpool = jg.init_paged_pool(jcfg, NB, bs, S, M)
    jpool["block_tables"] = jnp.asarray(bt, jnp.int32)
    toks = np.asarray([prompt])
    first, kvp = tg.prefill_chunk_paged(
        tp, {"k": pool["k"], "v": pool["v"]}, torch.from_numpy(bt[2]),
        torch.from_numpy(toks), 0, len(prompt), 0, cfg=tcfg, block_size=bs)
    jfirst, jkvp = jg.prefill_chunk_paged(
        jp, {"k": jpool["k"], "v": jpool["v"]}, jnp.asarray(bt[2], jnp.int32),
        jnp.asarray(toks, jnp.int32), jnp.int32(0), jnp.int32(len(prompt)),
        jnp.int32(0), cfg=jcfg, block_size=bs)
    pool["k"], pool["v"] = kvp["k"], kvp["v"]
    jpool["k"], jpool["v"] = jkvp["k"], jkvp["v"]
    lengths = np.zeros(S, np.int64)
    lengths[2] = len(prompt)
    pool["lengths"] = torch.from_numpy(lengths)
    jpool["lengths"] = jnp.asarray(lengths, jnp.int32)
    out, last = [int(first[0])], np.zeros(S, np.int64)
    last[2] = out[0]
    active = np.zeros(S, bool)
    active[2] = True
    for _ in range(N - 1):
        nxt, pool = tg.decode_step_paged(
            tp, pool, torch.from_numpy(last), torch.from_numpy(active),
            torch.zeros(S, dtype=torch.int64), cfg=tcfg, block_size=bs)
        jnxt, jpool = jg.decode_step_paged(
            jp, jpool, jnp.asarray(last, jnp.int32), jnp.asarray(active),
            jnp.zeros((S,), jnp.int32), cfg=jcfg, block_size=bs)
        assert nxt.tolist() == np.asarray(jnxt).tolist()
        out.append(int(nxt[2]))
        last[2] = out[-1]
    assert int(jfirst[0]) == out[0]
    assert out == _ref(prompt, N)
    assert pool["lengths"].tolist() == np.asarray(jpool["lengths"]).tolist()
    rows = [int(bt[2][p // bs]) * bs + p % bs
            for p in range(len(prompt) + N - 1)]
    np.testing.assert_allclose(pool["k"][:, rows].numpy(),
                               np.asarray(jpool["k"])[:, rows], atol=1e-4)


def test_prefill_slots_batch_matches_single(model):
    """Batched prefill is row-for-row the single-prompt prefill_slot
    (sampled), and both are the JAX package's."""
    jcfg, jp, tcfg, tp = model
    prompts = [[5, 9, 2], [7, 7, 7, 7, 1, 3], [3, 1, 4, 1, 5]]
    padded = np.zeros((4, 16), np.int64)        # one dummy pad row
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
    for i, p in enumerate(prompts):
        f1, kv1 = _prefill_slot_both(model, p, 10 + i, **kw)
        assert f1 == int(firsts[i]), i
        np.testing.assert_allclose(kv["k"][:, i].numpy(),
                                   kv1["k"][:, 0].numpy(), atol=1e-5)


def test_adopt_slot_paged_scatters_suffix_rows(model):
    """adopt_slot_paged puts a handoff block's rows where the JAX
    package's does: real rows at or past ``start`` into the slot's pages,
    pad and prefix rows to scratch."""
    jcfg, jp, tcfg, tp = model
    _, kv = _prefill_slot_both(model, PROMPT + [1, 4, 6])
    bt = np.asarray([3, 1, 0, 0], np.int64)
    pool = tg.init_paged_pool(tcfg, 6, 4, 1, 4, device="cpu")
    jpool = jg.init_paged_pool(jcfg, 6, 4, 1, 4)
    pool = tg.adopt_slot_paged({"k": pool["k"], "v": pool["v"]},
                               torch.from_numpy(bt), kv, 8, start=4,
                               block_size=4)
    jpool = jg.adopt_slot_paged(
        {"k": jpool["k"], "v": jpool["v"]}, jnp.asarray(bt, jnp.int32),
        {"k": jnp.asarray(kv["k"].numpy()), "v": jnp.asarray(kv["v"].numpy())},
        jnp.int32(8), start=jnp.int32(4), block_size=4)
    live = list(range(4, 24))       # every row but scratch block 0
    np.testing.assert_allclose(pool["k"][:, live].numpy(),
                               np.asarray(jpool["k"])[:, live], atol=0)
    assert not pool["k"][:, 12:16].any()    # prefix rows: not adopted
    np.testing.assert_allclose(pool["k"][:, 4:8].numpy(),
                               kv["k"][:, 0, 4:8].numpy(), atol=0)


# ------------------------------------------------------- engine behavior


def test_paged_engine_parity_and_no_block_leak(model):
    eng = _engine(model, paged_kv=True, kv_block_size=4, prefill_chunk=4)
    try:
        assert eng.generate(PROMPT, N) == _ref(PROMPT, N)
        long_prompt = [1 + (i % 40) for i in range(37)]   # > every bucket
        assert eng.generate(long_prompt, 6) == _ref(long_prompt, 6)
        s = eng.stats()
        assert s["paged_kv"] is True and s["kv_blocks_used"] == 0, s
        assert s["kv_blocks_alloc_total"] == s["kv_blocks_freed_total"]
    finally:
        eng.stop()


def test_reserved_engine_parity(model):
    """The slotted (reserved-cache) engine: prefill_slot, adopt_slot and
    decode_step give the JAX package's generate() tokens too."""
    eng = _engine(model)
    try:
        rids = [eng.submit(p, N) for p in (PROMPT, [7, 7, 3])]
        assert [_stream(eng, r) for r in rids] == [
            _ref(PROMPT, N), _ref([7, 7, 3], N)]
        assert eng.stats()["paged_kv"] is False
    finally:
        eng.stop()


def test_paged_engine_contention_preempts_and_resumes_exactly(model):
    """A pool too small for all sequences at once preempts by recompute,
    and every request still gets exactly the JAX package's tokens."""
    eng = _engine(model, paged_kv=True, kv_block_size=4, prefill_chunk=4,
                  kv_num_blocks=7)    # 6 usable blocks = 24 tokens of KV
    try:
        prompts = [PROMPT, [7, 7, 3], [2, 4, 6, 8]]
        rids = [eng.submit(p, N, seed=0) for p in prompts]
        for p, rid in zip(prompts, rids):
            assert _stream(eng, rid, 5) == _ref(p, N), p
        assert eng.stats()["kv_blocks_used"] == 0
    finally:
        eng.stop()


def test_paged_engine_sampled_resume_continuity(model):
    """Sampled streams: the contended (preempting) engine, a solo engine,
    and the JAX package's paged functions give the same tokens, seed by
    seed."""
    sampled = dict(paged_kv=True, kv_block_size=4, prefill_chunk=4,
                   temperature=0.9, top_k=16)
    jobs = ((3, PROMPT), (4, [9, 9, 1, 2]), (5, [6, 2]))
    expect = {s: _jax_stream(p, N, s, temperature=0.9, top_k=16)
              for s, p in jobs}
    solo = _engine(model, **sampled)
    tight = _engine(model, kv_num_blocks=7, **sampled)
    try:
        for s, p in jobs:
            assert _stream(solo, solo.submit(p, N, seed=s)) == expect[s]
        rids = {s: tight.submit(p, N, seed=s) for s, p in jobs}
        for s, _ in jobs:
            assert _stream(tight, rids[s]) == expect[s], s
    finally:
        solo.stop()
        tight.stop()


def test_long_context_admission_fails_cleanly_when_pool_exhausted(model):
    eng = _engine(model, paged_kv=True, kv_block_size=4, kv_num_blocks=5,
                  prefill_chunk=4)    # 4 usable blocks = 16 tokens
    try:
        with pytest.raises(KVCacheExhaustedError, match="KV blocks"):
            eng.submit([1] * 12, 8)               # 20 tokens > 16
        assert eng.generate([4, 2], 4) == _ref([4, 2], 4)
    finally:
        eng.stop()


def test_kv_byte_budget_reserved_ooms_paged_serves(model):
    """Under one KV byte budget the reserved layout refuses to construct
    while a paged pool admits and serves a long context."""
    _, _, tcfg, tp = model
    long_cfg = dict(BASE, max_len=48, max_slots=4)
    per_tok = EngineConfig.from_dict(long_cfg).kv_bytes_per_token(tcfg)
    assert per_tok == je.EngineConfig.from_dict(long_cfg).kv_bytes_per_token()
    budget = per_tok * 100                 # < 4 slots x 48 tokens = 192
    with pytest.raises(KVCacheExhaustedError, match="max_kv_bytes"):
        InflightBatchEngine(tp, tcfg, EngineConfig.from_dict(
            dict(long_cfg, max_kv_bytes=budget)), device="cpu")
    eng = InflightBatchEngine(tp, tcfg, EngineConfig.from_dict(
        dict(long_cfg, paged_kv=True, kv_block_size=4, kv_num_blocks=25,
             max_kv_bytes=budget, prefill_chunk=8)), device="cpu")
    try:
        long_prompt = [1 + (i % 30) for i in range(40)]
        assert eng.generate(long_prompt, 6) == _ref(long_prompt, 6)
    finally:
        eng.stop()


def test_cancel_frees_slot_and_blocks(model):
    eng = _engine(model, paged_kv=True, kv_block_size=4, prefill_chunk=4,
                  max_new_tokens=64, max_len=64)
    try:
        rid = eng.submit([1, 2, 3], 50)
        assert _wait_until(lambda: eng.stats()["busy_slots"] >= 1)
        eng.cancel(rid)
        assert _wait_until(lambda: not (eng.stats()["kv_blocks_used"] or
                                        eng.stats()["busy_slots"]))
        with pytest.raises(KeyError):
            eng.drain(rid, max_wait_s=0.1)
    finally:
        eng.stop()


def test_poison_frees_all_blocks(model):
    """The 2nd decode step with live work raises (fault injection): every
    request fails with a resume descriptor, every block returns, and the
    engine keeps serving."""
    eng = _engine(model, paged_kv=True, kv_block_size=4, prefill_chunk=4,
                  fault_inject="step_error:after=2")
    try:
        rids = [eng.submit(PROMPT, 32), eng.submit([4, 4], 32)]
        errors = []
        for rid in rids:
            with pytest.raises((EngineFailedError, KeyError)) as info:
                for _ in range(200):
                    eng.drain(rid, max_wait_s=0.2)
            errors.append(info.value)
        failed = [e for e in errors if isinstance(e, EngineFailedError)]
        assert failed and all(e.reason == "step_failure" for e in failed)
        assert failed[0].descriptor["seed"] == 0
        s = eng.stats()
        assert s["kv_blocks_alloc_total"] > 0 and s["kv_blocks_used"] == 0
        assert eng.generate([3, 1], 4) == _ref([3, 1], 4)
    finally:
        eng.stop()


def test_jax_stream_is_the_greedy_reference():
    """The JAX paged functions run in order (``_jax_stream``) agree with
    the JAX package's generate() where both apply (greedy)."""
    assert _jax_stream(PROMPT, N) == _ref(PROMPT, N)


def test_sequence_filling_max_len_exactly_frees_blocks(model):
    eng = _engine(model, max_len=16, max_new_tokens=16, paged_kv=True,
                  kv_block_size=4, prefill_chunk=4)
    try:
        budget = 16 - len(PROMPT)
        assert _stream(eng, eng.submit(PROMPT, budget)) == _ref(PROMPT,
                                                               budget)
        assert eng.stats()["kv_blocks_used"] == 0
    finally:
        eng.stop()


def test_build_model_and_engine_config(model):
    """_build_model draws the port's own params from ``param_seed`` on
    the device asked for; gpt_config maps the dtype name; an engine built
    on them serves."""
    ec = EngineConfig.from_dict(dict(BASE, paged_kv=True, kv_block_size=4,
                                     prefill_chunk=8))
    cfg, params = _build_model(ec, device="cpu")
    assert cfg.dtype == torch.float32 and cfg.n_layers == 2
    assert params["blocks"]["wqkv"].shape == (2, 64, 3, 4, 16)
    again = _build_model(ec, device="cpu")[1]
    assert torch.equal(params["tok_embed"], again["tok_embed"])
    eng = InflightBatchEngine(params, cfg, ec, device="cpu")
    try:
        out = eng.generate(PROMPT, 5)
        assert len(out) == 5 and all(0 <= t < cfg.vocab_size for t in out)
    finally:
        eng.stop()


def test_engine_metrics_in_process(model):
    """The engine's metric instruments keep their values in the process:
    tokens counted, one first-token latency per request, occupancy gauges
    back to zero after stop."""
    from ray_tpu_torch.serve.llm.engine import engine_metrics

    _, _, tcfg, tp = model
    tags = {"deployment": "llm", "replica": "metrics-test"}
    eng = InflightBatchEngine(tp, tcfg, EngineConfig.from_dict(dict(
        BASE, paged_kv=True, kv_block_size=4, prefill_chunk=4)),
        replica_id="metrics-test", device="cpu")
    try:
        outs = [_stream(eng, eng.submit(p, 5)) for p in (PROMPT, [4, 2])]
    finally:
        eng.stop()
    m = engine_metrics()
    assert m["tokens"].value(tags) == sum(map(len, outs)) == 10
    assert m["ttft"].value(tags)["count"] == 2
    assert m["batch_occupancy"].value(tags) == 0.0
    assert m["kv_occupancy"].value(tags) == 0.0
    with pytest.raises(ValueError, match="unknown tags"):
        m["tokens"].inc(1, {"bogus": "x"})
