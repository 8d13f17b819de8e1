"""The port's LLM serving tier (ray_tpu_torch/serve/llm: replicas, router,
KV handoff) on the runtime seam, torch on the CPU.

- Twins of tests/test_serve_llm.py's same-process handoff and app tests, on
  the ``ray_tpu`` runtime (its worker processes import ``ray_tpu_torch``
  like any user module; ``device="cpu"``) and on the port's in-process
  ``LocalRuntime``. The oracle is the port's ``generate`` on the engine's
  model.
- The replicas in process on params converted from the JAX package's
  engine model give the tokens of JAX's ``prefill_slot`` + ``adopt_slot`` +
  ``decode_step`` run in order, exactly, in f32; the prefill batcher gives
  what JAX's ``prefill_slots`` gives.
- ``LocalRuntime.serve`` keeps ``ray_tpu.serve``'s signatures."""

import inspect
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu import serve
from ray_tpu._private import serialization
from ray_tpu.models import generate as jg
from ray_tpu.serve import handle as jhandle
from ray_tpu.serve.llm import engine as je
from ray_tpu.serve.llm.replicas import _build_model as jax_build_model
from ray_tpu_torch import random as rnd
from ray_tpu_torch._private import device_objects as tdo
from ray_tpu_torch.models import generate as tg
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.runtime import (
    DeploymentHandle, DeploymentResponse, LocalRuntime, _MethodCaller,
)
from ray_tpu_torch.serve.llm import (
    DecodeReplica, EngineConfig, PrefillReplica, build_llm_app, replicas,
)
from ray_tpu_torch.serve.llm.kv_transfer import adopt_kv, publish_kv

ENGINE_CONFIG = dict(
    preset="tiny", model_overrides={"dtype": "float32"},
    max_slots=4, max_len=64, prompt_buckets=(16,), max_new_tokens=16)

PROMPT = [5, 9, 2, 11, 3]
N = 8


@pytest.fixture(scope="module")
def serve_cluster():
    """A serve cluster whose processes, and this one, run torch on one
    thread each (workers take OMP_NUM_THREADS from this environment at
    init)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ctx = ray_tpu.init(num_cpus=6,
                           object_store_memory=256 * 1024 * 1024)
    serve.start(http_port=None)
    yield ctx
    serve.shutdown()
    ray_tpu.shutdown()
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def restore_hook():
    """``publish_kv`` installs the port's hook on the ``ray_tpu``
    serializer of this process; put the slot back after each test."""
    serialization._maybe_install_device_hook()  # the JAX hook, if it will
    before = serialization._reducer_hook
    yield
    serialization.register_reducer_hook(before)


@pytest.fixture(params=["ray_tpu", "local"])
def runtime(request):
    if request.param == "ray_tpu":
        request.getfixturevalue("serve_cluster")
        return ray_tpu
    return LocalRuntime()


def _model():
    ec = EngineConfig.from_dict(ENGINE_CONFIG)
    return replicas._build_model(ec, device="cpu")


@pytest.fixture(scope="module")
def ref_tokens():
    """The port's greedy ``generate`` for PROMPT on the engine's model: the
    parity oracle every serving path must reproduce."""
    cfg, params = _model()
    return tg.generate(params, torch.tensor([PROMPT]),
                       rnd.key(0, device="cpu"), cfg=cfg, max_new_tokens=N,
                       temperature=0.0)[0].tolist()


def _delete(rt, *names):
    for name in names:
        rt.serve.delete(name)


def test_kv_handoff_same_process_by_reference(runtime, ref_tokens):
    """Prefill -> publish -> adopt -> decode in this process: the blocks
    come back by reference from the port's registry (local hits, no host
    copy, no rebuild), and decoding off them reproduces generate()."""
    cfg, params = _model()
    padded = torch.zeros(1, 16, dtype=torch.int64)
    padded[0, :len(PROMPT)] = torch.tensor(PROMPT)
    first, kv = tg.prefill_slot(params, padded, len(PROMPT), 0, cfg=cfg)

    tdo.reset_stats()
    handoff = publish_kv(kv, len(PROMPT), int(first[0]), runtime=runtime,
                         n=N, seed=0)
    adopted = adopt_kv(handoff, runtime=runtime)
    s = tdo.stats()
    assert s["host_materializations"] == 0, s
    assert s["local_hits"] == 2, s
    assert s["rebuilds"] == 0, s
    assert adopted["k"] is kv["k"] and adopted["v"] is kv["v"]

    cache = tg.adopt_slot(tg.init_slotted_cache(cfg, 2, 64, device="cpu"),
                          0, adopted, len(PROMPT))
    tokens = [handoff["first_token"]]
    last = torch.zeros(2, dtype=torch.int64)
    last[0] = handoff["first_token"]
    active = torch.tensor([True, False])
    seeds = torch.zeros(2, dtype=torch.int64)
    for _ in range(N - 1):
        nxt, cache = tg.decode_step(params, cache, last, active, seeds,
                                    cfg=cfg)
        tokens.append(int(nxt[0]))
        last[0] = nxt[0]
    assert tokens == ref_tokens


def test_disaggregated_app_end_to_end(runtime, ref_tokens):
    """prefill pool -> KV handoff -> decode pool behind the router, the
    blocking and the streaming path."""
    handle = runtime.serve.run(
        build_llm_app(ENGINE_CONFIG, runtime=runtime, device="cpu",
                      mode="disaggregated", name="tllm"),
        route_prefix="/tllm")
    try:
        out = handle.remote({"prompt": PROMPT, "n": N}).result(timeout=300)
        assert out["tokens"] == ref_tokens
        chunks = list(handle.generate_stream.remote_gen(
            {"prompt": PROMPT, "n": N}))
        assert chunks[0] == [ref_tokens[0]]  # prefill's token arrives first
        assert [t for c in chunks for t in c] == ref_tokens
    finally:
        _delete(runtime, "tllm", "tllm-prefill", "tllm-decode")


def test_combined_app_streaming_and_parity(runtime, ref_tokens):
    handle = runtime.serve.run(
        build_llm_app(ENGINE_CONFIG, runtime=runtime, device="cpu",
                      mode="combined", name="tllmc"),
        route_prefix="/tllmc")
    try:
        out = handle.remote({"prompt": PROMPT, "n": N}).result(timeout=300)
        assert out["tokens"] == ref_tokens
        chunks = list(handle.generate_stream.remote_gen(
            {"prompt": PROMPT, "n": N}))
        assert [t for c in chunks for t in c] == ref_tokens
        # Chunks of tokens as produced: how many depends on how far the
        # engine ran ahead of the consumer's pulls, so only none is empty.
        assert all(isinstance(c, list) and c for c in chunks)
    finally:
        _delete(runtime, "tllmc", "tllmc-engine")


# ------------------------------------------------------- JAX parity

@pytest.fixture(scope="module")
def converted():
    """(JAX cfg, JAX params, port cfg, port params): the JAX package's
    engine model, carried over by name."""
    jcfg, jp = jax_build_model(je.EngineConfig.from_dict(ENGINE_CONFIG))
    tcfg = EngineConfig.from_dict(ENGINE_CONFIG).gpt_config()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture
def on_converted(monkeypatch, converted):
    """Replicas built in this process draw the converted params."""
    _, _, tcfg, tp = converted
    monkeypatch.setattr(replicas, "_build_model",
                        lambda ec, device=None: (tcfg, tp))


SAMPLING = [{}, {"temperature": 0.8, "top_k": 5}]


def _jax_tokens(jcfg, jp, prompt, n, seed, sampling, slots=4):
    """One request through JAX's slotted functions in order: prefill_slot,
    adopt_slot into slot 0, then decode_step with the other slots idle."""
    padded = np.zeros((1, 16), np.int32)
    padded[0, :len(prompt)] = prompt
    first, kv = jg.prefill_slot(jp, jnp.asarray(padded),
                                jnp.int32(len(prompt)), jnp.int32(seed),
                                cfg=jcfg, **sampling)
    cache = jg.adopt_slot(jg.init_slotted_cache(jcfg, slots, 64),
                          jnp.int32(0), kv, jnp.int32(len(prompt)))
    tokens = [int(first[0])]
    last = np.zeros(slots, np.int32)
    active = np.zeros(slots, bool)
    seeds = np.zeros(slots, np.int32)
    last[0], active[0], seeds[0] = tokens[0], True, seed
    for _ in range(n - 1):
        nxt, cache = jg.decode_step(jp, cache, jnp.asarray(last),
                                    jnp.asarray(active), jnp.asarray(seeds),
                                    cfg=jcfg, **sampling)
        tokens.append(int(nxt[0]))
        last[0] = tokens[-1]
    return tokens


@pytest.mark.parametrize("sampling", SAMPLING, ids=["greedy", "sampled"])
def test_replicas_match_jax_slotted_functions(converted, on_converted,
                                              sampling):
    jcfg, jp, _, _ = converted
    ec = dict(ENGINE_CONFIG, **sampling)
    rt = LocalRuntime()
    prefill = PrefillReplica(ec, rt, "cpu")
    decode = DecodeReplica(ec, rt, "cpu")
    try:
        for prompt, seed in ((PROMPT, 3), ([7, 1, 30, 4, 4, 8, 2, 9, 60],
                                           11)):
            handoff = prefill.prefill({"prompt": prompt, "n": N,
                                       "seed": seed})
            got = [handoff["first_token"]] + decode.decode(handoff)["tokens"]
            want = _jax_tokens(jcfg, jp, prompt, N, seed, sampling)
            assert got == want, (prompt, got, want)
    finally:
        decode._engine.stop()


def test_prefill_batcher_matches_jax_prefill_slots(converted, on_converted,
                                                   monkeypatch):
    """Four client threads at once ride one ``prefill_slots`` run: first
    tokens exact and KV rows to 1e-5 against JAX's ``prefill_slots``."""
    jcfg, jp, _, _ = converted
    sampling = {"temperature": 0.8, "top_k": 5}
    ec = dict(ENGINE_CONFIG, prefill_batch_size=4,
              prefill_batch_window_ms=2000.0, **sampling)
    rt = LocalRuntime()
    prefill = PrefillReplica(ec, rt, "cpu")
    runs = []
    real = tg.prefill_slots

    def spy(params, prompts, *args, **kw):
        runs.append(prompts.shape[0])
        return real(params, prompts, *args, **kw)

    monkeypatch.setattr(replicas.gen, "prefill_slots", spy)
    prompts = [PROMPT, [3, 3, 9], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12],
               [40, 2]]
    seeds = [0, 1, 2, 3]
    out = [None] * 4

    def client(i):
        out[i] = prefill.prefill({"prompt": prompts[i], "n": N,
                                  "seed": seeds[i]})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert runs == [4]
    assert prefill.serve_stats()["prefill_batched_total"] == 4

    padded = np.zeros((4, 16), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    firsts, kv = jg.prefill_slots(
        jp, jnp.asarray(padded), jnp.asarray([len(p) for p in prompts],
                                             jnp.int32),
        jnp.asarray(seeds, jnp.int32), cfg=jcfg, **sampling)
    for i, handoff in enumerate(out):
        assert handoff["first_token"] == int(firsts[i])
        got = adopt_kv(handoff, runtime=rt)
        for name in ("k", "v"):
            np.testing.assert_allclose(
                got[name].numpy(), np.asarray(kv[name][:, i:i + 1]),
                atol=1e-5, rtol=0)


# ------------------------------------------------------- the serve facet

def _params(fn, drop_self=False):
    ps = list(inspect.signature(fn).parameters.values())
    if drop_self:
        ps = ps[1:]
    return [(p.name, p.kind, p.default) for p in ps]


def test_serve_facet_signatures_match_ray_tpu_serve():
    facet = LocalRuntime().serve
    for name in ("deployment", "run", "delete", "get_deployment_handle"):
        assert _params(getattr(facet, name)) == \
            _params(getattr(serve, name)), name
    for mine, theirs in ((DeploymentHandle, jhandle.DeploymentHandle),
                         (_MethodCaller, jhandle._MethodCaller)):
        for name in ("remote", "remote_gen"):
            assert _params(getattr(mine, name)) == \
                _params(getattr(theirs, name)), (mine, name)
    assert _params(DeploymentResponse.result) == \
        _params(jhandle.DeploymentResponse.result)


def test_local_runtime_context_is_per_thread():
    """Callers on many threads at once each see the actor they are in."""
    rt = LocalRuntime()
    seen, barrier = {}, threading.Barrier(4)

    def worker(i):
        with rt._in_actor(f"a{i}"):
            barrier.wait(timeout=10)
            seen[i] = rt.get_runtime_context().get_actor_id()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert seen == {i: f"a{i}" for i in range(4)}
    assert rt.get_runtime_context().get_actor_id() is None


def test_build_llm_app_needs_runtime_serve():
    class NoServe:
        pass

    with pytest.raises(RuntimeError, match="runtime.serve"):
        build_llm_app(ENGINE_CONFIG, runtime=NoServe(), device="cpu")
