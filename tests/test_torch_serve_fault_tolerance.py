"""The port's serving tier under faults: the ``serve_cluster`` contracts of
tests/test_serve_fault_tolerance.py with the port's replicas, router and KV
handoff on the ``ray_tpu`` runtime (``device="cpu"``), plus a poisoned
engine step whose stream migrates through the ``EngineFailedError`` the
replicas translate at the seam, on both runtimes.

Every disturbed stream must equal an undisturbed one, greedy and sampled.
The expected tokens come from the port's engine run in order, never from
the JAX engine (its aliased host mirrors race on the CPU)."""

import os
import signal
import time

import pytest
import torch

import ray_tpu
from ray_tpu import serve
from ray_tpu._private import serialization
from ray_tpu._private.ids import ObjectID
from ray_tpu._private.worker import ObjectRef
from ray_tpu.serve.handle import DeploymentHandle
from ray_tpu.serve.migration import migration_stats as ray_migration_stats
from ray_tpu_torch._private.config import config
from ray_tpu_torch.exceptions import EngineFailedError, KVAdoptTimeoutError
from ray_tpu_torch.runtime import LocalRuntime
from ray_tpu_torch.serve import migration
from ray_tpu_torch.serve.llm import EngineConfig, build_llm_app
from ray_tpu_torch.serve.llm.engine import InflightBatchEngine
from ray_tpu_torch.serve.llm.kv_transfer import adopt_kv
from ray_tpu_torch.serve.llm.replicas import _build_model

ENGINE_CONFIG = dict(
    preset="tiny", model_overrides={"dtype": "float32"},
    max_slots=4, max_len=64, prompt_buckets=(16,), max_new_tokens=16)

PROMPT = [5, 9, 2, 11, 3]
N = 10
SAMPLING = [{}, {"temperature": 0.8, "top_k": 5}]
SAMPLING_IDS = ["greedy", "sampled"]


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
    serialization._maybe_install_device_hook()  # the JAX hook, if it will
    before = serialization._reducer_hook
    yield
    serialization.register_reducer_hook(before)


def _make_engine(**overrides) -> InflightBatchEngine:
    ec = EngineConfig.from_dict(dict(ENGINE_CONFIG, **overrides))
    cfg, params = _build_model(ec, device="cpu")
    return InflightBatchEngine(params, cfg, ec, device="cpu")


def _reference(seed, **sampling):
    eng = _make_engine(**sampling)
    try:
        return eng.generate(PROMPT, N, seed=seed)
    finally:
        eng.stop()


def _controller():
    from ray_tpu.serve.controller import CONTROLLER_NAME

    return ray_tpu.get_actor(CONTROLLER_NAME)


def _pids_of(name):
    out = {}
    for r in ray_tpu.get(_controller().get_replicas.remote(name),
                         timeout=30):
        s = ray_tpu.get(r.stats.remote(), timeout=30)
        out[s["pid"]] = s
    return out


def _run(name, mode, **kw):
    ec = dict(ENGINE_CONFIG, **kw.pop("engine", {}))
    return serve.run(build_llm_app(ec, runtime=ray_tpu, device="cpu",
                                   mode=mode, name=name, **kw),
                     route_prefix=f"/{name}")


def _delete(*names):
    for name in names:
        serve.delete(name)


def test_fault_inject_config_fallback():
    """The ``serve_fault_inject`` knob arms engines built WITHOUT an
    ``EngineConfig.fault_inject``."""
    config.set("serve_fault_inject", "step_error:after=2")
    try:
        eng = _make_engine()
    finally:
        config.set("serve_fault_inject", "")
    try:
        with pytest.raises(EngineFailedError):
            eng.generate(PROMPT, N, seed=0)
    finally:
        eng.stop()
    with pytest.raises(ValueError, match="unknown serve_fault_inject"):
        _make_engine(fault_inject="explode:after=1")


@pytest.mark.parametrize("sampling", SAMPLING, ids=SAMPLING_IDS)
def test_stream_survives_engine_replica_death(serve_cluster, sampling):
    """die:after_tokens ends the engine replica's process mid-stream; the
    router migrates the stream to the surviving replica and the client
    sees the undisturbed tokens. The router's stats report the migration
    that ``ray_tpu``'s handle counted in the router process."""
    ref = _reference(5, **sampling)
    name = "tdie" + ("s" if sampling else "g")
    handle = _run(name, "combined", num_replicas=2,
                  engine=dict(fault_inject="die:after_tokens=8", **sampling))
    try:
        chunks = list(handle.generate_stream.remote_gen(
            {"prompt": PROMPT, "n": N, "seed": 5}))
        flat = [t for c in chunks for t in c]
        assert flat == ref, (flat, ref)
        migrations = sum(s.get("request_migrations_total", 0)
                         for s in _pids_of(name).values())
        assert migrations >= 1
        fs = ray_tpu.get(_controller().fault_stats.remote(), timeout=30)
        assert fs["replica_restarts_total"] >= 1
    finally:
        _delete(name, f"{name}-engine")


def test_stream_survives_real_sigkill(serve_cluster):
    """A real SIGKILL of the serving engine replica before the first pull,
    with the stream opened against the pool handle (the migration happens
    in this process, with the port's resume rewriter)."""
    ref = _reference(0)
    _run("tkill", "combined", num_replicas=2)
    try:
        pool = DeploymentHandle("tkill-engine", "generate_stream")
        req = {"prompt": PROMPT, "n": N, "seed": 0}
        before = ray_migration_stats()["request_migrations_total"]
        gen = pool.remote_gen(req, _resume=migration.llm_stream_resume(req))
        pid = ray_tpu.get(gen._replica.stats.remote(), timeout=30)["pid"]
        os.kill(pid, signal.SIGKILL)
        flat = [t for chunk in gen for t in chunk]
        assert flat == ref, (flat, ref)
        assert ray_migration_stats()["request_migrations_total"] >= \
            before + 1
    finally:
        _delete("tkill", "tkill-engine")


def test_disaggregated_stream_survives_decode_death(serve_cluster):
    """SIGKILL the decode replica serving the stream after the prefill
    token: the router's rewriter re-prefills prompt + delivered on the
    surviving decode replica (``resume_stream``)."""
    ref = _reference(0)
    handle = _run("tdis", "disaggregated", num_decode_replicas=2)
    try:
        gen = handle.generate_stream.remote_gen(
            {"prompt": PROMPT, "n": N, "seed": 0})
        got = [list(next(gen))]            # the prefill (TTFT) token
        busy = [s["pid"] for s in _pids_of("tdis-decode").values()
                if s.get("ongoing", 0) > 0]
        assert busy, "no decode replica holds the stream"
        for pid in busy:
            os.kill(pid, signal.SIGKILL)
        got += [list(chunk) for chunk in gen]
        flat = [t for c in got for t in c]
        assert flat == ref, (flat, ref)
    finally:
        _delete("tdis", "tdis-prefill", "tdis-decode")


def test_kv_adopt_timeout_typed(serve_cluster):
    """``adopt_kv`` on refs whose producer is gone raises the port's typed
    ``KVAdoptTimeoutError`` (a ``TimeoutError``) within
    ``serve_kv_adopt_timeout_s``."""
    ghost = ObjectRef(ObjectID.from_random())
    config.set("serve_kv_adopt_timeout_s", 0.5)
    try:
        t0 = time.monotonic()
        with pytest.raises(KVAdoptTimeoutError) as ei:
            adopt_kv({"k_ref": ghost, "v_ref": ghost, "length": 5,
                      "first_token": 1}, runtime=ray_tpu)
        assert time.monotonic() - t0 < 30
        assert ei.value.timeout_s == 0.5
        assert isinstance(ei.value, TimeoutError)
    finally:
        config.set("serve_kv_adopt_timeout_s", 60.0)


@pytest.mark.parametrize("sampling", SAMPLING, ids=SAMPLING_IDS)
def test_step_error_stream_migrates_through_translated_error(
        serve_cluster, sampling):
    """``step_error:after=3`` poisons the engine mid-stream: the replica
    raises ``ray_tpu``'s ``EngineFailedError`` (translated from the port's,
    descriptor kept), the handle in the router migrates the stream, and
    the client sees the undisturbed tokens."""
    ref = _reference(7, **sampling)
    name = "tstep" + ("s" if sampling else "g")
    handle = _run(name, "combined",
                  engine=dict(fault_inject="step_error:after=3", **sampling))
    try:
        chunks = list(handle.generate_stream.remote_gen(
            {"prompt": PROMPT, "n": N, "seed": 7}))
        flat = [t for c in chunks for t in c]
        assert flat == ref, (flat, ref)
        migrations = sum(s.get("request_migrations_total", 0)
                         for s in _pids_of(name).values())
        assert migrations >= 1
    finally:
        _delete(name, f"{name}-engine")


@pytest.mark.parametrize("sampling", SAMPLING, ids=SAMPLING_IDS)
def test_step_error_stream_migrates_in_process(sampling):
    """The same on the in-process runtime: its serve facet migrates on the
    port's ``EngineFailedError``, streamed and blocking."""
    ref = _reference(7, **sampling)
    rt = LocalRuntime()
    ec = dict(ENGINE_CONFIG, fault_inject="step_error:after=3", **sampling)
    before = migration.migration_stats()["request_migrations_total"]
    handle = rt.serve.run(build_llm_app(ec, runtime=rt, device="cpu",
                                        mode="combined", name="tlocal"))
    try:
        chunks = list(handle.generate_stream.remote_gen(
            {"prompt": PROMPT, "n": N, "seed": 7}))
        assert [t for c in chunks for t in c] == ref
        assert migration.migration_stats()["request_migrations_total"] == \
            before + 1
    finally:
        rt.serve.delete("tlocal")
        rt.serve.delete("tlocal-engine")
    handle = rt.serve.run(build_llm_app(ec, runtime=rt, device="cpu",
                                        mode="combined", name="tlocal"))
    try:
        out = handle.remote({"prompt": PROMPT, "n": N, "seed": 7}).result()
        assert out["tokens"] == ref
        assert migration.migration_stats()["request_migrations_total"] == \
            before + 2
    finally:
        rt.serve.delete("tlocal")
        rt.serve.delete("tlocal-engine")


def test_queue_full_sheds_as_the_runtime_overload_error(serve_cluster):
    """An engine whose queue is full (``max_queue=0``: every submit is
    shed) raises ``ray_tpu``'s own ``ServeOverloadedError`` at the handle,
    retry-after and reason kept: the class ``ray_tpu``'s HTTP ingress maps
    to 429 with Retry-After (``ingress/server.py`` ``_classify_error``)."""
    handle = _run("tshed", "combined", engine=dict(max_queue=0))
    try:
        for call in (
                lambda: handle.remote(
                    {"prompt": PROMPT, "n": N, "seed": 0}).result(),
                lambda: list(handle.generate_stream.remote_gen(
                    {"prompt": PROMPT, "n": N, "seed": 0}))):
            with pytest.raises(ray_tpu.exceptions.ServeOverloadedError) \
                    as ei:
                call()
            assert ei.value.retry_after_s == 1.0
            assert ei.value.reason == "engine_queue_full"
    finally:
        _delete("tshed", "tshed-engine")
