"""Prefix caching in the port's paged engine (ray_tpu_torch.serve.llm;
torch on the CPU), against the JAX package on the same weights: the
contracts of tests/test_prefix_cache.py. With the cache on or off every
request produces the same tokens (greedy and sampled), which are the JAX
package's (greedy: its generate(); sampled: its paged functions run in
order for one request, see test_torch_paged_kv.py for why not its engine),
and after any churn the pool drains to zero used and zero shared blocks.
Engines are stopped in ``finally``; every wait is bounded."""

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
from ray_tpu_torch.models import generate as tg
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.serve.llm import paged
from ray_tpu_torch.serve.llm.engine import EngineConfig, InflightBatchEngine
from ray_tpu_torch.serve.llm.paged import BlockPool

BASE = dict(preset="tiny", model_overrides={"dtype": "float32"},
            max_slots=4, max_len=64, prompt_buckets=(16,),
            max_new_tokens=16)
BS = 4
N = 8
SAMPLED = dict(temperature=0.9, top_k=16)


@pytest.fixture(scope="module")
def model():
    jcfg, jp = jax_build_model(je.EngineConfig.from_dict(BASE))
    tcfg = EngineConfig.from_dict(BASE).gpt_config()
    return tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_stream(prompt, seed, sampled):
    """N tokens of one request through the JAX package's paged functions
    in order (chunked prefill into slot 0's pages, then decode steps)."""
    jcfg, jp = jax_build_model(je.EngineConfig.from_dict(BASE))
    S, M = BASE["max_slots"], BASE["max_len"] // BS
    kw = dict(cfg=jcfg, block_size=BS, **(SAMPLED if sampled else {}))
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


def _expect(jobs, sampled=False):
    return [_jax_stream(tuple(p), s, sampled) for p, s in jobs]


def _engine(model, prefix_cache, **kw):
    tcfg, tp = model
    ec = EngineConfig.from_dict(dict(
        BASE, paged_kv=True, kv_block_size=BS, prefill_chunk=BS,
        prefix_cache_enabled=prefix_cache, **kw))
    return InflightBatchEngine(tp, tcfg, ec, device="cpu")


def _run(eng, jobs):
    """Submit (prompt, seed) jobs and collect each full token stream."""
    rids = [eng.submit(p, N, seed=s) for p, s in jobs]
    return [list(itertools.chain.from_iterable(
        eng.stream(r, max_wait_s=10))) for r in rids]


def _drained(eng, timeout=10):
    deadline = time.time() + timeout
    while time.time() < deadline:
        s = eng.stats()
        if s["kv_blocks_used"] == 0 and s["busy_slots"] == 0:
            return True
        time.sleep(0.02)
    return False


# --------------------------------------------------------------- pool


def test_pool_chain_sharing_and_refcounts():
    pool = BlockPool(17, BS, prefix_cache=True)   # 16 usable
    toks = list(range(100, 116))                  # 4 full blocks
    blocks, matched = pool.get_or_alloc(toks, pool.blocks_for(len(toks)))
    assert matched == 0 and len(blocks) == 4
    pool.register(toks, blocks)
    assert pool.cached_blocks() == 4
    # A twin shares every full block strictly before its last token.
    blocks2, matched2 = pool.get_or_alloc(toks, 4)
    assert matched2 == 3 * BS and blocks2[:3] == blocks[:3]
    assert blocks2[3] != blocks[3]
    assert pool.shared_blocks() == pool.stats()["kv_shared_blocks"] == 3
    pool.release(blocks2)
    assert pool.shared_blocks() == 0 and pool.used() == 4
    pool.release(blocks)
    assert pool.used() == 0 and pool.cached_blocks() == 4
    assert pool.match_prefix(toks + [1])[1] == 4 * BS


def test_eviction_lru_never_reclaims_referenced_blocks():
    pool = BlockPool(9, BS, prefix_cache=True)    # 8 usable
    hot, cold = list(range(10, 18)), list(range(50, 58))
    hot_blocks, _ = pool.get_or_alloc(hot, 2)
    pool.register(hot, hot_blocks)
    cold_blocks, _ = pool.get_or_alloc(cold, 2)
    pool.register(cold, cold_blocks)
    pool.release(cold_blocks)
    assert pool.available() == 4
    six = pool.alloc(6)
    assert six is not None and len(six) == 6
    assert pool.stats()["kv_prefix_evictions_total"] == 2
    assert pool.match_prefix(cold + [1])[1] == 0
    assert pool.match_prefix(hot + [1])[1] == 2 * BS
    assert set(six).isdisjoint(hot_blocks)
    assert pool.alloc(1) is None
    pool.release(hot_blocks)
    assert pool.alloc(1) is not None


def test_pool_hash_collision_degrades_to_miss(monkeypatch):
    monkeypatch.setattr(paged, "_chain_key",
                        lambda parent, tokens: b"same-key-always")
    pool = BlockPool(17, BS, prefix_cache=True)
    a = list(range(100, 108))
    blocks, _ = pool.get_or_alloc(a, 2)
    pool.register(a, blocks)
    assert pool.match_prefix(list(range(200, 208)) + [1]) == ([], 0)
    got = pool.get_or_alloc(list(range(200, 212)), 3)
    assert got is not None and got[1] == 0
    assert pool.match_prefix(a + [1])[1] == BS


# ------------------------------------------------- bit-identical output


def test_bit_identical_greedy_cache_on_off(model):
    common = [7, 3, 9, 1, 4, 4, 2, 8, 6, 5, 1, 2]   # 3 full blocks
    warm = [(common + [11], 0)]
    jobs = [(common + tail, 0) for tail in ([12, 13], [14, 15, 16, 17],
                                            [11])]
    on, off = _engine(model, True), _engine(model, False)
    try:
        got_off = _run(off, warm) + _run(off, jobs)
        got_on = _run(on, warm) + _run(on, jobs)
        assert got_on == got_off == _expect(warm + jobs)
        s = on.stats()
        assert s["prefix_cache_enabled"] is True
        assert s["prefix_cache_hit_tokens"] > 0
        assert s["prefill_tokens_computed"] < \
            off.stats()["prefill_tokens_computed"]
        assert _drained(on) and _drained(off)
        assert on._pool.shared_blocks() == 0
    finally:
        on.stop()
        off.stop()


def test_bit_identical_sampled_cache_on_off(model):
    common = [5, 1, 8, 8, 2, 9, 3, 7]
    jobs = [(common + [20 + i], 100 + i) for i in range(4)] + \
        [(common + [20], 100)]                      # exact repeat too
    on = _engine(model, True, **SAMPLED)
    off = _engine(model, False, **SAMPLED)
    try:
        got_on = _run(on, jobs)
        assert got_on == _run(off, jobs) == _expect(jobs, sampled=True)
        assert on.stats()["prefix_cache_hit_tokens"] > 0
    finally:
        on.stop()
        off.stop()


@pytest.mark.parametrize("div", [2 * BS - 1, 2 * BS, 2 * BS + 1])
def test_divergence_at_block_boundary_plus_minus_one(model, div):
    """Prompt pairs diverging at a block boundary and one token to either
    side: outputs stay identical, and the matched prefix never covers the
    divergent token."""
    base = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7]
    jobs = [(base[:div] + [30] + base[div:], 0),
            (base[:div] + [40] + base[div:], 0)]
    on, off = _engine(model, True), _engine(model, False)
    try:
        assert _run(on, jobs) == _run(off, jobs) == _expect(jobs)
        assert on.stats()["prefix_cache_hit_tokens"] <= (div // BS) * BS * 2
        assert _drained(on)
    finally:
        on.stop()
        off.stop()


def test_engine_collision_safety_bit_identical(model, monkeypatch):
    """Every chain key colliding: the cache degrades to misses, never to
    wrong KV."""
    monkeypatch.setattr(paged, "_chain_key",
                        lambda parent, tokens: b"collide")
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [9, 8, 7, 6, 5, 4, 3, 2, 1],
               [1, 2, 3, 4, 5, 6, 7, 8, 9]]
    jobs = [(p, 0) for p in prompts]
    on, off = _engine(model, True), _engine(model, False)
    try:
        assert _run(on, jobs) == _run(off, jobs) == _expect(jobs)
    finally:
        on.stop()
        off.stop()


# ------------------------------------------------------- leak checks


def test_preemption_churn_drains_to_zero(model):
    """Recompute-preemption with the cache on: every request still gets
    its solo tokens (the JAX package's), and the pool drains to zero used
    and shared blocks, every block free or idle in the cache."""
    solo = _engine(model, True)
    tight = _engine(model, True, kv_num_blocks=9)   # 8 usable blocks
    try:
        common = [2, 7, 1, 8, 2, 8]
        jobs = [(common + [50 + i], i) for i in range(3)]
        expect = _run(solo, jobs)
        assert _run(tight, jobs) == expect == _expect(jobs)
        assert _drained(tight)
        pool = tight._pool
        assert pool.shared_blocks() == 0 and not pool._refs, pool._refs
        assert pool.available() + len(pool._idle) == pool.capacity
    finally:
        solo.stop()
        tight.stop()


def test_cancel_releases_shared_blocks(model):
    eng = _engine(model, True)
    try:
        warm = [6, 6, 6, 6, 1, 1, 1, 1, 3]
        _run(eng, [(warm, 0)])                      # populate the cache
        rid = eng.submit(warm[:-1] + [4], 40)       # shares 2 blocks
        deadline = time.time() + 10
        while time.time() < deadline and eng.stats()["busy_slots"] == 0:
            time.sleep(0.02)
        eng.cancel(rid)
        assert _drained(eng)
        assert eng._pool.shared_blocks() == 0 and not eng._pool._refs
        assert eng._pool.match_prefix(warm)[1] == 2 * BS
    finally:
        eng.stop()


def test_disagg_handoff_adopts_and_registers(model):
    """submit_prefilled on a prefix-caching pool: the adopted sequence's
    full blocks register (a later twin hits them), its decode is the
    cache-off engine's and the JAX package's, and its blocks release at
    retirement."""
    tcfg, tp = model
    prompt = [5, 9, 2, 11, 3, 7, 1, 4]              # 2 full blocks
    padded = torch.zeros(1, 16, dtype=torch.int64)
    padded[0, :len(prompt)] = torch.tensor(prompt)
    first, kv = tg.prefill_slot(tp, padded, len(prompt), 0, cfg=tcfg)
    on, off = _engine(model, True), _engine(model, False)
    try:
        outs = {}
        for eng in (on, off):
            rid = eng.submit_prefilled(int(first[0]), kv, len(prompt), N,
                                       seed=0, prompt=prompt)
            outs[eng] = list(itertools.chain.from_iterable(
                eng.stream(rid, max_wait_s=10)))
        assert outs[on] == outs[off]
        # The handoff's first token was delivered by the prefill side.
        assert [int(first[0])] + outs[on] == \
            _jax_stream(tuple(prompt), 0, False)
        assert _drained(on)
        assert on._pool.match_prefix(prompt + [1])[1] == 2 * BS
        before = on.stats()["prefix_cache_hit_tokens"]
        assert _run(on, [(prompt + [9], 0)]) == _run(off, [(prompt + [9], 0)])
        assert on.stats()["prefix_cache_hit_tokens"] == before + 2 * BS
        assert _drained(on)
        assert on._pool.shared_blocks() == 0 and not on._pool._refs
    finally:
        on.stop()
        off.stop()
