"""The reference's tests of observability and runtime environments as
programs, run on both runtimes: ``tests/test_pubsub.py``,
``test_tracing.py``, ``test_profiler.py``, ``test_observability_agent.py``,
``test_log_streaming.py``, ``test_metrics_dashboard.py`` and
``test_runtime_env.py``, one group each ("pubsub", "tracing",
"profiler", "agent", "logs", "metrics", "runtime_env").

As in ``torch_api_programs``: each program is the body of the reference
test of the same name (without ``test_``), on the cluster its fixture
starts, and returns what that test asserts on as plain values (ids and
timestamps differ between runs, so a program returns whether they link
up, not the ids). The "metrics" group's cluster programs share one
cluster, as the reference's module-scoped fixture does; the others start
their own. The port's collective store groups, gang and KV hand-off take
``runtime=``; the programs pass it on the port only. The serve programs
start no HTTP proxy (``http_port=None``), and the dashboard programs bind
free ports: the reference's fixed ports (8000, 18265-18267) would collide
with its own tests running beside them.

The module imports neither runtime, nor jax: a worker of the port's
runtime that unpickles one of its functions by name imports it and stays
free of both (the reference's KV hand-off builds its jax array inside the
replica, on ``ray_tpu`` only). ``python tests/torch_obs_programs.py GROUP
DIR`` runs a group on ``ray_tpu``.
"""

from __future__ import annotations

import glob
import importlib
import json
import logging
import os
import queue
import socket
import sys
import textwrap
import threading
import time
import urllib.request

from torch_api_programs import MiB, cluster, main, raises, run_programs, sub

TWO_CPUS = dict(num_cpus=2, object_store_memory=64 * MiB)
FOUR_CPUS = dict(num_cpus=4, object_store_memory=128 * MiB)
RENV = dict(num_cpus=2, object_store_memory=128 * MiB)


def _priv(rt, name):
    return sub(rt, f"_private.{name}")


def _wait_for(cond, timeout, msg):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {msg}")


def _on_port(rt, accel):
    """The keywords the port's collective groups, gang and KV hand-off
    take, which the reference's do not: its runtime."""
    return {} if accel == "TPU" else {"runtime": rt}


def _approx(a, b):
    """``a == pytest.approx(b)`` (relative 1e-6)."""
    return abs(a - b) <= max(1e-6 * abs(b), 1e-12)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ pubsub


@cluster(**TWO_CPUS)
def publish_subscribe_roundtrip(rt, accel, tmp):
    pubsub = sub(rt, "experimental.pubsub")
    s = pubsub.subscribe("alerts")
    pubsub.publish("alerts", {"sev": 1, "msg": "hi"})
    got = s.get(timeout=10)
    s.unsubscribe()
    return got


@cluster(**TWO_CPUS)
def publish_from_worker_reaches_driver(rt, accel, tmp):
    s = sub(rt, "experimental.pubsub").subscribe("events")

    @rt.remote
    def announce(i):
        importlib.import_module(
            f"{rt.__name__}.experimental.pubsub").publish("events", {"i": i})
        return i

    return rt.get(announce.remote(7), timeout=60), s.get(timeout=10)


@cluster(**TWO_CPUS)
def actor_state_channel(rt, accel, tmp):
    s = sub(rt, "experimental.pubsub").subscribe("actor_state")

    @rt.remote
    class Blip:
        def ping(self):
            return True

    b = Blip.remote()
    ping = rt.get(b.ping.remote(), timeout=60)
    msg = s.get(timeout=15)
    alive = (msg["state"], msg["class_name"])
    rt.kill(b)
    deadline = time.time() + 15
    while time.time() < deadline:
        try:
            msg = s.get(timeout=5)
        except queue.Empty:
            continue
        if msg["state"] == "DEAD":
            return ping, alive, True
    return ping, alive, False


@cluster(**TWO_CPUS)
def unsubscribed_channel_silent(rt, accel, tmp):
    pubsub = sub(rt, "experimental.pubsub")
    s = pubsub.subscribe("chan_a")
    pubsub.publish("chan_b", "nope")
    pubsub.publish("chan_a", "yes")
    return s.get(timeout=10), raises(s.get_nowait, queue.Empty)


# ----------------------------------------------------------- tracing


def _events_by_name(rt, names, timeout=20):
    deadline = time.time() + timeout
    evs = {}
    while time.time() < deadline:
        evs = {e["name"]: e for e in rt.timeline()
               if e.get("name") in names}
        if set(names) <= set(evs):
            return evs
        time.sleep(0.2)
    raise AssertionError(f"events {names} not all reported: {evs}")


@cluster(**TWO_CPUS)
def trace_spans_driver_task_nested(rt, accel, tmp):
    @rt.remote
    def inner():
        return "leaf"

    @rt.remote
    def outer():
        return rt.get(inner.remote())

    got = rt.get(outer.remote(), timeout=60)
    evs = _events_by_name(rt, ["outer", "inner"])
    o, i = evs["outer"], evs["inner"]
    return (got, bool(o["trace_id"] and o["span_id"]),
            i["trace_id"] == o["trace_id"],
            i["parent_span_id"] == o["span_id"], o["parent_span_id"])


@cluster(**TWO_CPUS)
def trace_spans_actor_hop(rt, accel, tmp):
    @rt.remote
    def from_actor():
        return 1

    @rt.remote
    class A:
        def call(self):
            return rt.get(from_actor.remote())

    a = A.remote()
    got = rt.get(a.call.remote(), timeout=60)
    evs = _events_by_name(rt, ["call", "from_actor"])
    c, f = evs["call"], evs["from_actor"]
    return (got, bool(c["trace_id"]), f["trace_id"] == c["trace_id"],
            f["parent_span_id"] == c["span_id"])


@cluster(**TWO_CPUS)
def separate_roots_get_separate_traces(rt, accel, tmp):
    @rt.remote
    def t_a():
        return None

    @rt.remote
    def t_b():
        return None

    rt.get([t_a.remote(), t_b.remote()], timeout=60)
    evs = _events_by_name(rt, ["t_a", "t_b"])
    return evs["t_a"]["trace_id"] != evs["t_b"]["trace_id"]


@cluster(**TWO_CPUS)
def two_hop_chain_renders_connected_chrome_trace(rt, accel, tmp):
    build_chrome_trace = sub(rt, "scripts.cli").build_chrome_trace

    @rt.remote
    def hop2():
        return "leaf"

    @rt.remote
    def hop1():
        return rt.get(hop2.remote())

    got = rt.get(hop1.remote(), timeout=60)
    evs = _events_by_name(rt, ["hop1", "hop2"])
    trace = build_chrome_trace(list(evs.values()))
    slices = {t["name"]: t for t in trace if t["ph"] == "X"}
    starts = [t for t in trace if t["ph"] == "s"]
    finishes = [t for t in trace if t["ph"] == "f"]
    one_pair = len(starts) == 1 and len(finishes) == 1
    return (got,
            slices["hop1"]["args"]["span_id"] == evs["hop1"]["span_id"],
            slices["hop2"]["args"]["parent_span_id"] ==
            evs["hop1"]["span_id"],
            len(starts), len(finishes),
            one_pair and starts[0]["id"] == finishes[0]["id"] ==
            evs["hop2"]["span_id"],
            one_pair and _approx(starts[0]["ts"],
                                 evs["hop1"]["start"] * 1e6),
            one_pair and _approx(finishes[0]["ts"],
                                 evs["hop2"]["start"] * 1e6),
            one_pair and finishes[0]["bp"])


@cluster(**TWO_CPUS)
def collective_ops_emit_spans_under_task(rt, accel, tmp):
    kw = _on_port(rt, accel)

    @rt.remote
    class Rank:
        def __init__(self, rank):
            self.rank = rank

        def join_and_reduce(self, world):
            import numpy as np

            collective = importlib.import_module(
                f"{rt.__name__}.parallel.collective")
            collective.init_collective_group(
                world, self.rank, backend="store", group_name="span_g",
                **kw)
            return collective.allreduce(
                np.ones(2), group_name="span_g").tolist()

    r0, r1 = Rank.remote(0), Rank.remote(1)
    out = rt.get([r0.join_and_reduce.remote(2),
                  r1.join_and_reduce.remote(2)], timeout=120)
    # The reference test reads the task events once, right after the
    # spans: a rank's task event can land a flush (1 s) after its span,
    # so this waits for both (the reference's harness race).
    deadline = time.time() + 20
    spans, parents = [], []
    while time.time() < deadline:
        evs = rt.timeline()
        spans = [e for e in evs if e.get("kind") == "collective"
                 and "allreduce" in e["name"]]
        tasks = {e["span_id"]: e for e in evs
                 if e.get("name") == "join_and_reduce"}
        parents = [tasks.get(s["parent_span_id"]) for s in spans]
        if len(spans) >= 2 and all(p is not None for p in parents):
            break
        time.sleep(0.2)
    return (out, len(spans) >= 2,
            all(p is not None for p in parents),
            all(p is not None and s["trace_id"] == p["trace_id"]
                for s, p in zip(spans, parents)))


@cluster(**TWO_CPUS)
def serve_device_object_round_trip_single_trace(rt, accel, tmp):
    serve = sub(rt, "serve")
    kw = _on_port(rt, accel)

    @serve.deployment
    class KVEcho:
        def __call__(self, n):
            kt = importlib.import_module(
                f"{rt.__name__}.serve.llm.kv_transfer")
            if accel == "TPU":
                import jax.numpy as jnp

                arr = jnp.ones((8, 8), jnp.float32)
            else:
                import torch

                arr = torch.ones((8, 8), dtype=torch.float32)
            handoff = kt.publish_kv({"k": arr, "v": arr}, 8, 5, **kw)
            kv = kt.adopt_kv(handoff, **kw)
            return float(kv["k"].sum())

    handle = serve.run(KVEcho.bind(), name="kvecho", http_port=None)
    _one_replica(rt)
    try:
        got = handle.remote(1).result(timeout=120)
        deadline = time.time() + 20
        evs, hops = [], []
        while time.time() < deadline:
            evs = rt.timeline()
            hops = [e for e in evs if e.get("kind") == "serve_handle"
                    and "kvecho" in e["name"]]
            if hops:
                run_evs = [e for e in evs
                           if e.get("parent_span_id") ==
                           hops[0]["span_id"]]
                dev = [e for e in evs
                       if e.get("kind") in ("device_put", "device_get")]
                if run_evs and dev:
                    break
            time.sleep(0.2)
        if not hops:
            return got, False, None
        hop = hops[0]
        runs = [e for e in evs
                if e.get("parent_span_id") == hop["span_id"]
                and e.get("kind") == "actor_task"]
        if not runs:
            return got, True, False
        run_ev = runs[0]
        kv_spans = [e for e in evs
                    if e.get("parent_span_id") == run_ev["span_id"]
                    and e.get("kind") in ("device_put", "device_get")]
        trace_ids = {hop["trace_id"], run_ev["trace_id"]} | \
            {e["trace_id"] for e in kv_spans}
        connected = [hop, run_ev] + kv_spans
        flows = [t for t in sub(rt, "scripts.cli").build_chrome_trace(
            connected) if t["ph"] in ("s", "f")]
        return (got, True, True, sorted({e["kind"] for e in kv_spans}),
                len(trace_ids), len(flows) == 2 * (1 + len(kv_spans)))
    finally:
        serve.shutdown()


@cluster(**TWO_CPUS)
def span_helpers_driverside(rt, accel, tmp):
    tracing = sub(rt, "util.tracing")
    state = sub(rt, "experimental.state")
    with tracing.span("outer_op", kind="bench") as outer_sid:
        with tracing.span("inner_op", kind="bench"):
            pass
    tracing.flush_spans()
    deadline = time.time() + 15
    evs = {}
    while time.time() < deadline:
        evs = {e["name"]: e for e in rt.timeline()
               if e.get("kind") == "bench"}
        if {"outer_op", "inner_op"} <= set(evs):
            break
        time.sleep(0.2)
    names = {t["name"] for t in state.list_tasks()}
    return ({"outer_op", "inner_op"} <= set(evs),
            evs["inner_op"]["parent_span_id"] == outer_sid,
            evs["inner_op"]["trace_id"] == evs["outer_op"]["trace_id"],
            "outer_op" in names or "inner_op" in names,
            "outer_op" in state.summarize_tasks())


_SPAN_KINDS = ("serve_handle", "serve_replica", "serve_ingress")


def _one_replica(rt, timeout=30.0):
    """Wait until the deployment's replicas have settled at one live
    replica for 1 s (5 reconcile periods). The reference's controller can
    fill one deficit twice (``deploy`` and its reconcile loop race) and
    kill the extra replica a tick later, with the spans it had not
    flushed yet (its 1 s event period): a request it served then loses
    its replica-side spans. The port's controller claims in-flight
    spawns (ROADMAP §3)."""
    state = sub(rt, "experimental.state")
    deadline = time.time() + timeout
    since = None
    while time.time() < deadline:
        live = [a for a in state.list_actors()
                if a.get("class_name") == "Replica"
                and a.get("state") != "DEAD"]
        if len(live) != 1:
            since = None
        elif since is None:
            since = time.time()
        elif time.time() - since >= 1.0:
            return
        time.sleep(0.1)
    raise AssertionError("the deployment never settled at one replica")


def _serve_spans(rt):
    return [e for e in rt.timeline() if e.get("kind") in _SPAN_KINDS]


def sampled_out(prog):
    """The reference's ``sampled_out`` fixture: ``trace_sample_rate`` 0
    for the program, 1.0 after it (the config registry is
    process-global)."""
    def run(rt, accel, tmp):
        config = _priv(rt, "config").config
        config.set("trace_sample_rate", 0.0)
        try:
            return prog(rt, accel, tmp)
        finally:
            config.set("trace_sample_rate", 1.0)
    run.__name__ = prog.__name__
    return run


def _echo_deployment(serve, rt):
    @serve.deployment
    class Echo:
        def __call__(self, fail=False):
            t = importlib.import_module(f"{rt.__name__}.util.tracing")
            with t.span("replica_work", kind="serve_replica"):
                if fail:
                    raise ValueError("boom")
                return 1
    return Echo


@cluster(**TWO_CPUS)
@sampled_out
def sampled_out_serve_round_trip_emits_zero_spans(rt, accel, tmp):
    serve = sub(rt, "serve")
    handle = serve.run(_echo_deployment(serve, rt).bind(),
                       name="sampled_echo", http_port=None)
    _one_replica(rt)
    try:
        got = handle.remote(False).result(timeout=120)
        sub(rt, "util.tracing").flush_spans()
        time.sleep(1.5)   # > the worker event-flush period
        return got, len(_serve_spans(rt))
    finally:
        serve.shutdown()


@cluster(**TWO_CPUS)
@sampled_out
def errored_serve_round_trip_keeps_all_spans(rt, accel, tmp):
    serve = sub(rt, "serve")
    handle = serve.run(_echo_deployment(serve, rt).bind(),
                       name="sampled_echo2", http_port=None)
    _one_replica(rt)
    try:
        err = raises(lambda: handle.remote(True).result(timeout=120),
                     ValueError, "boom")
        sub(rt, "util.tracing").flush_spans()
        deadline = time.time() + 20
        spans = []
        while time.time() < deadline:
            spans = _serve_spans(rt)
            if {"serve_handle", "serve_replica"} <= \
                    {s["kind"] for s in spans}:
                break
            time.sleep(0.2)
        kinds = {s["kind"]: s for s in spans}
        both = "serve_handle" in kinds and "serve_replica" in kinds
        return (err, both,
                both and kinds["serve_handle"]["status"],
                both and kinds["serve_replica"]["status"],
                both and kinds["serve_handle"]["trace_id"] ==
                kinds["serve_replica"]["trace_id"])
    finally:
        serve.shutdown()


@cluster(**TWO_CPUS)
def sampled_in_serve_round_trip_keeps_spans(rt, accel, tmp):
    serve = sub(rt, "serve")

    @serve.deployment
    class Echo3:
        def __call__(self):
            return 1

    handle = serve.run(Echo3.bind(), name="sampled_echo3", http_port=None)
    _one_replica(rt)
    try:
        got = handle.remote().result(timeout=120)
        sub(rt, "util.tracing").flush_spans()
        deadline = time.time() + 20
        hops = []
        while time.time() < deadline:
            hops = [e for e in rt.timeline()
                    if e.get("kind") == "serve_handle"
                    and "sampled_echo3" in e["name"]]
            if hops:
                break
            time.sleep(0.2)
        return got, bool(hops), hops[0]["status"] if hops else None
    finally:
        serve.shutdown()


# ---------------------------------------------------------- profiler


def _profiler_threads():
    return [t for t in threading.enumerate()
            if t.name == "rtpu-profiler" and t.is_alive()]


def _golden_busy_loop(stop):
    x = 0
    while not stop.is_set():
        x = (x + 1) % 1000003
    return x


def folded_and_speedscope_golden(rt, accel, tmp):
    prof_mod = _priv(rt, "profiler")
    stop = threading.Event()
    t = threading.Thread(target=_golden_busy_loop, args=(stop,),
                         daemon=True, name="golden-busy")
    t.start()
    prof = prof_mod.SamplingProfiler()
    try:
        started = prof.start(hz=200)
        time.sleep(0.6)
        out = prof.collect(reset=True)
    finally:
        prof.stop()
        stop.set()
        t.join(timeout=5)
    busy = [s for s in out["stacks"] if "_golden_busy_loop" in s]
    proc = dict(out, kind="worker", node_id="ab" * 6)
    lines = prof_mod.folded_lines([proc])
    label, _, _rest = lines[0].partition(";")
    doc = prof_mod.speedscope_document([proc], name="golden")
    frames = doc["shared"]["frames"]
    profiles_ok = all(
        p["type"] == "sampled" and len(p["samples"]) == len(p["weights"])
        and p["endValue"] == sum(p["weights"])
        and all(0 <= idx < len(frames) for s in p["samples"] for idx in s)
        for p in doc["profiles"])
    clean = json.loads(json.dumps(doc)) is not None   # JSON-clean
    names = {s["name"]: s["value"]
             for s in sub(rt, "util.metrics").collect_samples()}
    return (started, out["samples"] > 0, out["pid"] == os.getpid(),
            bool(busy), any(s.startswith("golden-busy;") for s in busy),
            bool(lines) and all(" " in ln for ln in lines),
            label.startswith("worker node="),
            lines[0].rsplit(" ", 1)[1].isdigit(),
            doc["$schema"].endswith("file-format-schema.json"),
            bool(frames and doc["profiles"]), profiles_ok,
            any("golden-busy" in p["name"] for p in doc["profiles"]),
            clean,
            names.get("profiler_samples_total", 0) >= out["samples"])


def cpu_mode_counts_idle_leaves_separately(rt, accel, tmp):
    prof = _priv(rt, "profiler").SamplingProfiler()
    stop = threading.Event()

    def sleeper():
        while not stop.is_set():
            stop.wait(0.05)   # leaf frame: threading Condition.wait

    t = threading.Thread(target=sleeper, daemon=True, name="idle-sleeper")
    t.start()
    try:
        started = prof.start(hz=200, mode="cpu")
        time.sleep(0.5)
        out = prof.collect(reset=True)
    finally:
        prof.stop()
        stop.set()
        t.join(timeout=5)
    return (started, out["mode"], out["idle_samples"] > 0,
            any(s.startswith("idle-sleeper;") for s in out["stacks"]))


def bounded_table_eviction_under_churning_stacks(rt, accel, tmp):
    config = _priv(rt, "config").config
    old = config.get("profiler_max_stacks")
    config.set("profiler_max_stacks", 16)
    try:
        prof = _priv(rt, "profiler").SamplingProfiler()
        for i in range(200):
            prof._add(f"churn;stack_{i:03d}", count=i + 1)
        out = prof.collect()
        return (len(out["stacks"]) <= 16,
                out["samples"] == sum(range(1, 201)), out["dropped"] > 0,
                sum(out["stacks"].values()) + out["dropped"] ==
                out["samples"],
                "churn;stack_199" in out["stacks"])
    finally:
        config.set("profiler_max_stacks", old)


def deep_stack_truncated_with_marker(rt, accel, tmp):
    config = _priv(rt, "config").config
    old = config.get("profiler_max_frames")
    config.set("profiler_max_frames", 8)
    try:
        prof = _priv(rt, "profiler").SamplingProfiler()
        stop = threading.Event()
        ready = threading.Event()

        def deep(n):
            if n > 0:
                return deep(n - 1)
            ready.set()
            stop.wait(10)

        t = threading.Thread(target=deep, args=(40,), daemon=True,
                             name="deep-rec")
        t.start()
        was_ready = ready.wait(5)
        started = prof.start(hz=200)
        time.sleep(0.3)
        out = prof.collect(reset=True)
        prof.stop()
        stop.set()
        t.join(timeout=5)
        deep_stacks = [s.split(";")[1:] for s in out["stacks"]
                       if s.startswith("deep-rec;")]
        return (was_ready, started, bool(deep_stacks),
                all(len(f) <= 10 for f in deep_stacks),
                all("<truncated>" in f[0] for f in deep_stacks))
    finally:
        config.set("profiler_max_frames", old)


def sampler_start_stop_idempotent(rt, accel, tmp):
    prof = _priv(rt, "profiler").SamplingProfiler()
    before = len(_profiler_threads())
    first, second = prof.start(), prof.start()
    one_more = len(_profiler_threads()) == before + 1
    prof.stop()
    prof.stop()
    _wait_for(lambda: len(_profiler_threads()) == before, 5,
              "sampler thread join")
    return first, second, one_more


def always_on_no_thread_stacking_across_init_shutdown(rt, accel, tmp):
    config = _priv(rt, "config").config
    old = config.get("profiler_always_on")
    config.set("profiler_always_on", True)
    counts = []
    try:
        for _ in range(2):
            rt.init(num_cpus=1, object_store_memory=64 * MiB)
            counts.append(len(_profiler_threads()))
            rt.shutdown()
            _wait_for(lambda: len(_profiler_threads()) == 0, 5,
                      "sampler joined on shutdown")
    finally:
        config.set("profiler_always_on", old)
    return counts


@cluster(**FOUR_CPUS)
def cluster_profile_covers_every_process_kind(rt, accel, tmp):
    state = sub(rt, "experimental.state")

    @rt.remote
    def warm():
        return 1

    warmed = rt.get([warm.remote() for _ in range(2)], timeout=60)

    @rt.remote
    def spin(sec):
        t0 = time.time()
        x = 0
        while time.time() - t0 < sec:
            x += 1
        return x

    refs = [spin.remote(4.0) for _ in range(2)]
    time.sleep(0.3)
    t0 = time.time()
    processes = state.profile(duration_s=1.0)
    bounded = time.time() - t0 < 30
    kinds = {p.get("kind") for p in processes if not p.get("error")}
    workers = [p for p in processes if p.get("kind") == "worker"]
    doc = _priv(rt, "profiler").speedscope_document(processes)
    rt.get(refs, timeout=60)
    return (warmed, bounded,
            {"gcs", "node_manager", "driver", "worker"} <= kinds,
            any("spin" in s for p in workers
                for s in (p.get("stacks") or {})),
            len(doc["profiles"]) >= len(
                [p for p in processes if not p.get("error")]))


@cluster(**FOUR_CPUS)
def worker_scoped_profile_filters(rt, accel, tmp):
    @rt.remote
    class P:
        def ping(self):
            return 1

    a = P.remote()
    pinged = rt.get(a.ping.remote(), timeout=30)
    aid = a._actor_id.hex()
    processes = sub(rt, "experimental.state").profile(duration_s=0.3,
                                                      actor_id=aid)
    ok = [p for p in processes if not p.get("error")]
    return pinged, bool(ok) and all(p["kind"] == "worker" and
                                    p["actor_id"] == aid for p in ok)


def _wedge_rank(rt, kw, group_name):
    """The reference's two-rank store group whose rank 0 wedges in an
    allreduce rank 1 never joins."""
    @rt.remote
    class Rank:
        def __init__(self, rank):
            self.rank = rank

        def join(self, world):
            collective = importlib.import_module(
                f"{rt.__name__}.parallel.collective")
            collective.init_collective_group(
                world, self.rank, backend="store", group_name=group_name,
                **kw)
            return True

        def reduce(self):
            import numpy as np

            collective = importlib.import_module(
                f"{rt.__name__}.parallel.collective")
            return collective.allreduce(
                np.ones(4), group_name=group_name).tolist()

    return Rank


@cluster(**FOUR_CPUS)
def wedged_collective_rank_still_profiles(rt, accel, tmp):
    kw = _on_port(rt, accel)
    Rank = _wedge_rank(rt, kw, "prof_wedge")
    r0, r1 = Rank.remote(0), Rank.remote(1)
    joined = rt.get([r0.join.remote(2), r1.join.remote(2)], timeout=60)
    wedged_ref = r0.reduce.remote()   # rank 1 never calls reduce
    time.sleep(1.5)                   # let rank 0 enter the op
    t0 = time.time()
    processes = sub(rt, "experimental.state").profile(
        duration_s=1.0, actor_id=r0._actor_id.hex())
    bounded = time.time() - t0 < 30
    ok = [p for p in processes if not p.get("error")]
    wedged = [p for p in ok
              if any("allreduce" in s or "_exchange" in s
                     for s in (p.get("stacks") or {}))]
    sub(rt, "parallel.collective").poison_group("prof_wedge",
                                                "test teardown", **kw)
    unwedged = raises(lambda: rt.get(wedged_ref, timeout=30))
    return joined, bounded, bool(ok), bool(wedged), unwedged[1]


def gcs_subprocess_self_profile_over_bootstrap_address(rt, accel, tmp):
    config = _priv(rt, "config").config
    old = config.get("gcs_out_of_process")
    config.set("gcs_out_of_process", True)
    try:
        rt.init(num_cpus=2, object_store_memory=64 * MiB)
        w = _priv(rt, "worker").require_worker()
        gcs_pid = w.gcs.request("control_plane_stats",
                                timeout=30)["gcs_process"]["pid"]
        conn = _priv(rt, "protocol").connect(w.gcs_address,
                                             name="prof-probe")
        try:
            out = conn.request("profile", {"gcs": True, "duration_s": 0.5},
                               timeout=30)
        finally:
            conn.close()
        one = isinstance(out, list) and len(out) == 1
        prof = out[0] if one else {}
        return (gcs_pid != os.getpid(), one,
                prof.get("kind") == "gcs" and not prof.get("error"),
                prof.get("pid") == gcs_pid,
                prof.get("samples", 0) > 0 and bool(prof.get("stacks")),
                any("gcs" in s or "serve" in s or "wait" in s
                    for s in prof.get("stacks") or {}))
    finally:
        try:
            rt.shutdown()
        finally:
            config.set("gcs_out_of_process", old)


def profile_window_rearms_running_sampler_with_requested_knobs(rt, accel,
                                                                tmp):
    prof = _priv(rt, "profiler").SamplingProfiler()
    started = prof.start(hz=30, mode="wall")
    try:
        out = prof.profile(duration_s=0.2, hz=200, mode="cpu")
        return (started, out["mode"], out["hz"], prof.running, prof._hz,
                prof._mode)
    finally:
        prof.stop()


# ------------------------------------------------- observability agent


def _session_dir(rt):
    return _priv(rt, "worker")._global_cluster.session_dir


def _flight_pattern(rt):
    return os.path.join(_session_dir(rt), "flight_recorder", "flight-*.json")


@cluster(**FOUR_CPUS)
def wedged_collective_rank_stack_capture(rt, accel, tmp):
    kw = _on_port(rt, accel)
    state = sub(rt, "experimental.state")
    Rank = _wedge_rank(rt, kw, "wedge_g")
    r0, r1 = Rank.remote(0), Rank.remote(1)
    joined = rt.get([r0.join.remote(2), r1.join.remote(2)], timeout=60)
    wedged_ref = r0.reduce.remote()   # rank 1 never calls reduce
    time.sleep(1.5)                   # let rank 0 enter the op
    t0 = time.time()
    nodes = state.dump_stacks(timeout_s=5)
    bounded = time.time() - t0 < 20
    wedged = [w for n in nodes for w in n.get("workers", [])
              if any("_exchange" in t["stack"] or "allreduce" in t["stack"]
                     for t in w.get("threads", []))]
    report = sub(rt, "scripts.cli").format_stack_report(nodes)
    sub(rt, "parallel.collective").poison_group("wedge_g", "test teardown",
                                                **kw)
    unwedged = raises(lambda: rt.get(wedged_ref, timeout=30))
    return (joined, bounded, bool(nodes and nodes[0].get("node_id")),
            bool(wedged),
            bool(wedged) and wedged[0]["actor_id"] == r0._actor_id.hex(),
            "_exchange" in report or "allreduce" in report,
            "=== node" in report and "--- worker" in report, unwedged[1])


@cluster(**FOUR_CPUS)
def stack_capture_includes_node_manager_threads(rt, accel, tmp):
    nm = sub(rt, "experimental.state").dump_stacks(
        timeout_s=5)[0]["node_manager"]
    names = {t["thread_name"] for t in nm["threads"]}
    return nm["pid"] == os.getpid(), any(n.startswith("rtpu-nm-")
                                         for n in names)


@cluster(**FOUR_CPUS)
def worker_log_fan_in(rt, accel, tmp):
    state = sub(rt, "experimental.state")

    @rt.remote
    def chatty():
        print("OBS_MARKER_fan_in")
        return 1

    got = rt.get(chatty.remote(), timeout=30)

    def marker_seen():
        return any("OBS_MARKER_fan_in" in ln
                   for e in state.get_log(lines=200)
                   for ln in e.get("lines", []))

    _wait_for(marker_seen, 15, "log marker through the agent fan-in")
    listing = state.list_logs()
    entries = state.get_log(lines=200)
    target = next(e for e in entries
                  if any("OBS_MARKER_fan_in" in ln for ln in e["lines"]))
    only = state.get_log(ident=target["worker_id"][:12], lines=200)
    return (got, bool(listing and listing[0]["workers"]),
            all({"worker_id", "alive", "streams"} <= set(w)
                for w in listing[0]["workers"]),
            bool(only) and all(e["worker_id"] == target["worker_id"]
                               for e in only))


@cluster(**FOUR_CPUS)
def actor_log_fan_in_routes_by_actor_id(rt, accel, tmp):
    state = sub(rt, "experimental.state")

    @rt.remote
    class Talker:
        def say(self):
            print("OBS_MARKER_actor_log")
            return True

    a = Talker.remote()
    said = rt.get(a.say.remote(), timeout=30)
    aid = a._actor_id.hex()

    def seen():
        return any("OBS_MARKER_actor_log" in ln
                   for e in state.get_log(actor_id=aid, lines=200)
                   for ln in e.get("lines", []))

    _wait_for(seen, 15, "actor log lines through the agent")
    return said, all(e["actor_id"] == aid
                     for e in state.get_log(actor_id=aid, lines=200))


@cluster(**FOUR_CPUS)
def dead_workers_logs_reachable_by_actor_and_full_id(rt, accel, tmp):
    state = sub(rt, "experimental.state")

    @rt.remote
    class Doomed:
        def say(self):
            print("OBS_MARKER_dead_actor")
            return True

    a = Doomed.remote()
    said = rt.get(a.say.remote(), timeout=30)
    aid = a._actor_id.hex()

    def entries_for(**kw):
        return [e for e in state.get_log(lines=200, **kw)
                if any("OBS_MARKER_dead_actor" in ln
                       for ln in e.get("lines", []))]

    _wait_for(lambda: entries_for(actor_id=aid), 15,
              "actor logs before death")
    wid_full = entries_for(actor_id=aid)[0]["worker_id"]
    rt.kill(a)
    _wait_for(lambda: any(not e.get("alive", True)
                          for e in state.get_log(actor_id=aid,
                                                 lines=1) or [{}])
              or entries_for(actor_id=aid), 15, "post-death rows")
    deadline = time.time() + 15
    while time.time() < deadline:
        by_actor = entries_for(actor_id=aid)
        by_full_wid = entries_for(worker_id=wid_full)
        if by_actor and by_full_wid:
            break
        time.sleep(0.3)
    return (said, len(wid_full) > 12, bool(by_actor), bool(by_full_wid),
            bool(by_actor) and by_actor[0]["actor_id"] == aid)


def flight_recorder_dump_on_gang_death(rt, accel, tmp):
    config = _priv(rt, "config").config
    old = config.get("gang_heartbeat_s")
    config.set("gang_heartbeat_s", 0.5)
    rt.init(num_cpus=4, object_store_memory=128 * MiB)
    WorkerGroup = sub(rt, "train.worker_group").WorkerGroup
    group = None
    try:
        # The port's gang runs on CUDA unless asked for the CPU.
        on_port = _on_port(rt, accel)
        if on_port:
            on_port["device"] = "cpu"
        group = WorkerGroup(2, {"CPU": 1}, backend="store",
                            group_name="frgang", experiment_name="fr",
                            **on_port)
        dead_actor = group.workers[1]._actor_id.hex()
        # Give the workers' 0.2 s event flush a beat so the recorder
        # holds their setup_collective task events before the kill.
        time.sleep(1.0)
        rt.kill(group.workers[1])
        pattern = _flight_pattern(rt)
        _wait_for(lambda: glob.glob(pattern), 20,
                  "a flight-recorder dump after gang death")
        dumps = []
        for p in sorted(glob.glob(pattern)):
            with open(p) as f:
                dumps.append(json.load(f))
        events = [e for d in dumps for e in d["events"]]
        return (any("frgang" in (d.get("reason") or "")
                    or "rank 1" in (d.get("reason") or "")
                    or "died" in (d.get("reason") or "") for d in dumps),
                any(e.get("name") == "setup_collective" for e in events),
                any(e.get("kind") == "worker_death"
                    and e.get("actor_id") == dead_actor for e in events),
                any(e.get("kind") == "hw_sample" for e in events))
    finally:
        if group is not None:
            group.shutdown(graceful=False)
        rt.shutdown()
        config.set("gang_heartbeat_s", old)


@cluster(**FOUR_CPUS)
def flight_recorder_dump_on_unexpected_worker_death(rt, accel, tmp):
    @rt.remote(max_retries=0)
    def suicide():
        import os as _os
        import signal as _signal

        _os.kill(_os.getpid(), _signal.SIGKILL)

    err = raises(lambda: rt.get(suicide.remote(), timeout=30))
    pattern = _flight_pattern(rt)
    _wait_for(lambda: glob.glob(pattern), 15,
              "a dump after an unexpected worker death")
    with open(sorted(glob.glob(pattern))[-1]) as f:
        dump = json.load(f)
    return (err is not None, "died unexpectedly" in dump["reason"],
            any(e.get("kind") == "worker_death" for e in dump["events"]))


@cluster(**FOUR_CPUS)
def flight_snapshot_over_node_agent_endpoint(rt, accel, tmp):
    @rt.remote
    def nop():
        return None

    rt.get([nop.remote() for _ in range(3)], timeout=30)
    w = _priv(rt, "worker").require_worker()
    addr = w.nodes()[0]["NodeManagerAddress"]

    def kinds():
        snap = w.nm_conn(addr).request("flight_snapshot", {}, timeout=10)
        return {e.get("kind") for e in snap["events"]}

    # Worker event flush is 0.2 s; the hw sample rides the next 1 s
    # heartbeat tick — poll rather than guess the interleaving.
    _wait_for(lambda: {"task", "hw_sample"} <= kinds(), 15,
              "task events + hw samples in the flight ring")
    return True


def _reporter_threads():
    return [t for t in threading.enumerate() if t.name == "rtpu-metrics"]


def metrics_reporter_idempotent_and_joined_on_shutdown(rt, accel, tmp):
    metrics = sub(rt, "util.metrics")
    out = []
    for _ in range(2):
        rt.init(num_cpus=2, object_store_memory=64 * MiB)
        try:
            t1 = metrics.start_reporter(period_s=0.2)
            t2 = metrics.start_reporter(period_s=5.0)
            t3 = metrics.start_reporter()
            out.append((t1 is t2 is t3, len(_reporter_threads())))
        finally:
            rt.shutdown()
        _wait_for(lambda: not _reporter_threads(), 5,
                  "reporter thread to be joined on shutdown")
    return out, len(_reporter_threads())


@cluster(**FOUR_CPUS)
def metrics_drop_dead_client_series(rt, accel, tmp):
    metrics = sub(rt, "util.metrics")
    w = _priv(rt, "worker").require_worker()
    w.gcs.notify("report_metrics", {
        "client_id": "worker-deadbeef", "ts": time.time(),
        "period_s": 2.0,
        "samples": [{"name": "serve_llm_queue_depth",
                     "tags": {"replica": "deadbeef"}, "value": 9.0,
                     "kind": "gauge", "help": "stale"}]})
    g = metrics.Gauge("obs_live_gauge", "x")
    g.set(1.0)
    reported = metrics.report_to_gcs()

    def flat():
        return [s for grp in w.gcs.request("get_metrics") for s in grp]

    _wait_for(lambda: any(s["name"] == "obs_live_gauge"
                          for s in flat()), 10, "live gauge visible")
    stale = any(s["name"] == "serve_llm_queue_depth"
                and s["tags"].get("replica") == "deadbeef" for s in flat())
    w.gcs.notify("report_metrics", {
        "client_id": w.client_id + ":probe", "ts": time.time(),
        "period_s": 0.1,
        "samples": [{"name": "obs_silent_gauge", "tags": {},
                     "value": 2.0, "kind": "gauge", "help": ""}]})
    _wait_for(lambda: not any(s["name"] == "obs_silent_gauge"
                              for s in flat()), 10,
              "silent client's series to expire")
    return reported, stale


def report_to_gcs_logs_failures_once_per_kind(rt, accel, tmp):
    """The reference test reads ``caplog`` at WARNING on its metrics
    logger; the program attaches its own handler there."""
    metrics = sub(rt, "util.metrics")
    worker_mod = _priv(rt, "worker")

    class _BoomGcs:
        def notify(self, *a, **k):
            raise ConnectionResetError("boom")

    class _FakeWorker:
        gcs = _BoomGcs()
        client_id = "fake"

    records = []

    class _Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    log = logging.getLogger(f"{rt.__name__}.metrics")
    handler, old_level = _Keep(logging.WARNING), log.level
    log.addHandler(handler)
    log.setLevel(logging.WARNING)
    old_worker = worker_mod._global_worker
    metrics._report_failures_logged.clear()
    worker_mod._global_worker = _FakeWorker()
    try:
        first, second = metrics.report_to_gcs(), metrics.report_to_gcs()
    finally:
        worker_mod._global_worker = old_worker
        log.removeHandler(handler)
        log.setLevel(old_level)
    warnings = [r.getMessage() for r in records
                if "metrics report" in r.getMessage()]
    return (first, second, len(warnings),
            bool(warnings) and "ConnectionResetError" in warnings[0])


# -------------------------------------------------------------- logs


@cluster(**TWO_CPUS)
def get_log_follow_streams_new_lines_in_order(rt, accel, tmp):
    state = sub(rt, "experimental.state")

    @rt.remote
    class Chatty:
        def __init__(self):
            self._stop = False

            def loop():
                i = 0
                while not self._stop and i < 200:
                    print(f"FOLLOW_MARK {i}", flush=True)
                    i += 1
                    time.sleep(0.1)

            threading.Thread(target=loop, daemon=True).start()

        def ping(self):
            return 1

        def stop(self):
            self._stop = True
            return True

    a = Chatty.remote()
    pinged = rt.get(a.ping.remote(), timeout=30)
    time.sleep(0.8)
    gen = state.get_log(actor_id=a._actor_id.hex(), stream="stdout",
                        follow=True, interval_s=0.25)
    seen, shaped = [], True
    deadline = time.time() + 30
    for entry in gen:
        shaped = shaped and entry["stream"] == "stdout" and \
            "path" in entry and "next_offset" in entry
        seen += [ln for ln in entry.get("lines") or []
                 if ln.startswith("FOLLOW_MARK")]
        if len(seen) >= 10 or time.time() > deadline:
            break
    gen.close()
    nums = [int(ln.split()[1]) for ln in seen]
    return (pinged, shaped, len(seen) >= 10, nums == sorted(nums),
            len(set(nums)) == len(nums),
            rt.get(a.stop.remote(), timeout=10))


def follow_cursor_reads_only_complete_lines(rt, accel, tmp):
    read_file_from = sub(rt, "dashboard.agent").read_file_from
    p = os.path.join(tmp, f"follow_{rt.__name__}.log")
    with open(p, "wb") as f:
        f.write(b"one\ntwo\npart")
    out = [read_file_from(p, 0)]
    out.append(read_file_from(p, out[0][1]))
    with open(p, "ab") as f:
        f.write(b"ial\nthree\n")
    out.append(read_file_from(p, out[0][1]))
    with open(p, "wb") as f:
        f.write(b"fresh\n")
    out.append(read_file_from(p, out[2][1]))
    return out


# ----------------------------------------------------------- metrics


def counter_gauge_histogram(rt, accel, tmp):
    metrics = sub(rt, "util.metrics")
    c = metrics.Counter("test_requests_total", "requests",
                        tag_keys=("route",))
    c.inc(tags={"route": "/a"})
    c.inc(2.0, tags={"route": "/a"})
    c.inc(tags={"route": "/b"})
    negative = raises(lambda: c.inc(-1), ValueError)
    g = metrics.Gauge("test_temperature", "temp")
    g.set(21.5)
    h = metrics.Histogram("test_latency_seconds", "latency",
                          boundaries=[0.1, 1.0])
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    samples = metrics.collect_samples()
    by_name = {}
    for s in samples:
        by_name.setdefault(s["name"], []).append(s)
    buckets = {s["tags"]["le"]: s["value"]
               for s in by_name["test_latency_seconds_bucket"]}
    text = metrics.prometheus_text([samples])
    return (negative[1],
            any(s["value"] == 3.0 and s["tags"] == {"route": "/a"}
                for s in by_name["test_requests_total"]),
            by_name["test_temperature"][0]["value"],
            (buckets["0.1"], buckets["1.0"], buckets["+Inf"]),
            by_name["test_latency_seconds_count"][0]["value"],
            "# TYPE test_requests_total counter" in text,
            'test_requests_total{route="/a"} 3.0' in text)


def metrics_report_to_gcs(rt, accel, tmp):
    metrics = sub(rt, "util.metrics")
    g = metrics.Gauge("test_reported_gauge", "x")
    g.set(7.0)
    reported = metrics.report_to_gcs()
    groups = _priv(rt, "worker").require_worker().gcs.request("get_metrics")
    return reported, any(s["name"] == "test_reported_gauge"
                         and s["value"] == 7.0
                         for grp in groups for s in grp)


# Free ports for the dashboard programs, chosen once per group run.
_DASH = {}


def _http(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=15) as r:
        return r.read().decode()


def dashboard_rest(rt, accel, tmp):
    _actor, port = sub(rt, "dashboard").start_dashboard(
        port=_DASH["rest"])
    nodes = json.loads(_http(port, "/api/nodes"))
    status = json.loads(_http(port, "/api/cluster_status"))
    html = _http(port, "/")
    prom = _http(port, "/metrics")
    logs = json.loads(_http(port, "/api/logs?list=1"))
    stacks = json.loads(_http(port, "/api/stacks?timeout_s=5"))
    return (len(nodes), nodes[0]["Alive"], status["total"]["CPU"],
            "ray_tpu" in html, "ray_tpu_cluster_nodes_alive 1" in prom,
            'ray_tpu_cluster_resource_total{resource="CPU"} 4.0' in prom,
            bool(logs and logs[0]["workers"]),
            bool(stacks and stacks[0]["node_manager"]["threads"]),
            isinstance(stacks[0]["workers"], list))


def _dashboard_port(rt, key):
    try:
        _actor, port = sub(rt, "dashboard").start_dashboard(port=_DASH[key])
    except Exception:
        port = _DASH["rest"]   # dashboard_rest already started one
    return port


def node_hardware_reporter(rt, accel, tmp):
    deadline = time.time() + 15
    hw = {}
    while time.time() < deadline:
        nodes = rt.nodes()
        hw = (nodes[0].get("Hardware") or {}) if nodes else {}
        if hw.get("store_capacity_bytes"):
            break
        time.sleep(0.3)
    # The free-accelerator count: chips on the reference, GPUs on the port.
    free_key = "tpu_chips_free" if accel == "TPU" else "gpus_free"
    text = _http(_dashboard_port(rt, "hw"), "/metrics")
    return (bool(hw.get("store_capacity_bytes")),
            bool(hw.get("mem_total_bytes")), free_key in hw, "workers" in hw,
            "ray_tpu_node_store_capacity_bytes" in text,
            "ray_tpu_node_mem_total_bytes" in text,
            "ray_tpu_node_store_pinned_objects" in text,
            "ray_tpu_node_store_pinned_bytes" in text,
            "ray_tpu_node_device_staged_bytes_total" in text)


def scheduler_counters_in_prometheus(rt, accel, tmp):
    @rt.remote
    def nop():
        return None

    rt.get([nop.remote() for _ in range(8)])   # force local grants
    deadline = time.time() + 15
    hw = {}
    while time.time() < deadline:   # next heartbeat carries the counters
        nodes = rt.nodes()
        hw = (nodes[0].get("Hardware") or {}) if nodes else {}
        if hw.get("sched_local_grants_total"):
            break
        time.sleep(0.3)
    port = _dashboard_port(rt, "sched")
    reported = sub(rt, "util.metrics").report_to_gcs()
    text = _http(port, "/metrics")
    return (bool(hw.get("sched_local_grants_total")),
            "sched_spillbacks_total" in hw, reported,
            "scheduler_local_grants_total" in text,
            "scheduler_spillbacks_total" in text,
            "scheduler_lease_grant_latency_seconds_bucket" in text,
            'source="local"' in text)


def prometheus_multiprocess_aggregation(rt, accel, tmp):
    def fam(name, tags, value, kind, help_):
        return {"name": name, "tags": tags, "value": value, "kind": kind,
                "help": help_}

    def lat(le1, le_inf, total, count):
        return [fam("agg_lat_bucket", {"le": "0.1"}, le1, "histogram", "lat"),
                fam("agg_lat_bucket", {"le": "+Inf"}, le_inf, "histogram",
                    "lat"),
                fam("agg_lat_sum", {}, total, "histogram", "lat"),
                fam("agg_lat_count", {}, count, "histogram", "lat")]

    group_a = [fam("agg_requests_total", {}, 3.0, "counter", "req"),
               fam("agg_depth", {"replica": "a"}, 5.0, "gauge", "depth")] \
        + lat(1, 2, 0.3, 2)
    group_b = [fam("agg_requests_total", {}, 4.0, "counter", "req"),
               fam("agg_depth", {"replica": "b"}, 7.0, "gauge", "depth")] \
        + lat(2, 3, 0.9, 3)
    group_c = [fam("agg_depth", {"replica": "b"}, 9.0, "gauge", "depth")]
    text = sub(rt, "util.metrics").prometheus_text(
        [group_a, group_b, group_c])
    contiguous, family, seen_done = True, None, set()
    for ln in text.splitlines():
        if ln.startswith("# HELP "):
            nxt = ln.split()[2]
            contiguous = contiguous and nxt not in seen_done
            if family is not None:
                seen_done.add(family)
            family = nxt
        elif ln.startswith("# TYPE ") or not ln:
            continue
        else:
            name = ln.split("{")[0].split(" ")[0]
            base = name.removesuffix("_bucket").removesuffix(
                "_sum").removesuffix("_count")
            contiguous = contiguous and base == family
    return (contiguous,) + tuple(
        want in text for want in (
            "agg_requests_total 7.0", 'agg_depth{replica="a"} 5.0',
            'agg_depth{replica="b"} 9.0', 'agg_lat_bucket{le="0.1"} 3',
            'agg_lat_bucket{le="+Inf"} 5', "agg_lat_sum 1.2",
            "agg_lat_count 5"))


def multiprocess_counters_sum_on_metrics_endpoint(rt, accel, tmp):
    @rt.remote
    class Replica:
        def __init__(self, tag, inc):
            m = importlib.import_module(f"{rt.__name__}.util.metrics")
            self._c = m.Counter("mp_agg_requests_total", "reqs")
            self._g = m.Gauge("mp_agg_depth", "depth", tag_keys=("replica",))
            self._c.inc(inc)
            self._g.set(inc, tags={"replica": tag})

        def push(self):
            return importlib.import_module(
                f"{rt.__name__}.util.metrics").report_to_gcs()

    a = Replica.remote("ra", 2.0)
    b = Replica.remote("rb", 5.0)
    pushed = rt.get([a.push.remote(), b.push.remote()], timeout=30)
    metrics = sub(rt, "util.metrics")
    w = _priv(rt, "worker").require_worker()
    deadline = time.time() + 15
    text = ""
    while time.time() < deadline:
        text = metrics.prometheus_text(w.gcs.request("get_metrics"))
        if "mp_agg_requests_total 7.0" in text:
            break
        time.sleep(0.3)
    return (pushed, "mp_agg_requests_total 7.0" in text,
            'mp_agg_depth{replica="ra"} 2.0' in text,
            'mp_agg_depth{replica="rb"} 5.0' in text)


def shared_cluster(**init_kw):
    """The program runs on the group's one cluster (the reference's
    module-scoped fixture), started before the first such program."""
    def mark(prog):
        prog.shared_cluster = init_kw
        return prog
    return mark


METRICS_CLUSTER = FOUR_CPUS
for _prog in (metrics_report_to_gcs, dashboard_rest, node_hardware_reporter,
              scheduler_counters_in_prometheus,
              multiprocess_counters_sum_on_metrics_endpoint):
    shared_cluster(**METRICS_CLUSTER)(_prog)


def run_shared(programs, rt, accel, tmp):
    """``run_programs``, with one ``rt.init`` for the programs marked
    ``shared_cluster``: up from the first of them to the group's end."""
    _DASH.update(rest=_free_port(), hw=_free_port(), sched=_free_port())
    out, up = {}, False
    try:
        for prog in programs:
            init_kw = getattr(prog, "shared_cluster", None)
            if init_kw is not None and not up:
                rt.init(**init_kw)
                up = True
            out.update(run_programs([prog], rt, accel, tmp))
    finally:
        if up:
            rt.shutdown()
    return out


# ------------------------------------------------------- runtime env


def _make_module(tmp, name, body):
    mod = os.path.join(tmp, name)
    os.makedirs(mod)
    with open(os.path.join(mod, "__init__.py"), "w") as f:
        f.write(textwrap.dedent(body))
    return mod


def _fresh_dir(tmp, name):
    d = os.path.join(tmp, name)
    os.makedirs(d)
    return d


@cluster(**RENV)
def py_modules_importable_in_task(rt, accel, tmp):
    mod = _make_module(tmp, "shiplib", """
        MAGIC = 1234

        def double(x):
            return 2 * x
    """)

    @rt.remote(runtime_env={"py_modules": [mod]})
    def use_module():
        import shiplib

        return shiplib.MAGIC, shiplib.double(21)

    return rt.get(use_module.remote(), timeout=60)


@cluster(**RENV)
def working_dir_sets_cwd(rt, accel, tmp):
    wd = _fresh_dir(tmp, "appdir")
    with open(os.path.join(wd, "data.txt"), "w") as f:
        f.write("payload-7")

    @rt.remote(runtime_env={"working_dir": wd})
    def read_rel():
        with open("data.txt") as f:
            return f.read()

    return rt.get(read_rel.remote(), timeout=60)


@cluster(**RENV)
def actor_runtime_env(rt, accel, tmp):
    mod = _make_module(tmp, "actorlib", """
        def greet(name):
            return f"hi {name}"
    """)
    wd = _fresh_dir(tmp, "actordir")
    with open(os.path.join(wd, "cfg.txt"), "w") as f:
        f.write("cfgval")

    @rt.remote(runtime_env={"working_dir": wd, "py_modules": [mod]})
    class Envy:
        def probe(self):
            import actorlib

            with open("cfg.txt") as f:
                return actorlib.greet(f.read())

    e = Envy.remote()
    return rt.get(e.probe.remote(), timeout=60)


@cluster(**RENV)
def uri_cache_deduplicates(rt, accel, tmp):
    wd = _fresh_dir(tmp, "shared")
    with open(os.path.join(wd, "f.txt"), "w") as f:
        f.write("same-bytes")

    @rt.remote(runtime_env={"working_dir": wd})
    def probe():
        return sorted(os.listdir("."))

    first = rt.get(probe.remote(), timeout=60)
    second = rt.get(probe.remote(), timeout=60)
    worker_mod = _priv(rt, "worker")
    keys = worker_mod.require_worker().kv().keys(
        namespace=_priv(rt, "runtime_env").KV_NAMESPACE)
    cache = os.path.join(worker_mod._global_cluster.nm.session_dir,
                         "runtime_resources")
    entries = [d for d in os.listdir(cache) if not d.startswith(".")]
    return (first, second, len(keys),
            len(keys) == 1 and entries == [keys[0].decode()])


@cluster(**RENV)
def env_vars_still_honored_with_working_dir(rt, accel, tmp):
    wd = _fresh_dir(tmp, "envdir")
    with open(os.path.join(wd, "x.txt"), "w") as f:
        f.write("x")

    @rt.remote(runtime_env={"working_dir": wd,
                            "env_vars": {"SHIPPED_FLAG": "on"}})
    def probe():
        return os.environ.get("SHIPPED_FLAG"), os.path.exists("x.txt")

    return rt.get(probe.remote(), timeout=60)


@cluster(**RENV)
def runtime_env_plugin_api(rt, accel, tmp):
    renv = _priv(rt, "runtime_env")

    class StampPlugin(renv.RuntimeEnvPlugin):
        name = "stamp"

        def package(self, value, kv):
            return {"packaged": True, **value}

        def needs_isolation(self, value):
            return True

        def create(self, value, context, base_dir):
            assert value["packaged"]   # went through package()
            context["env_vars"]["RTPU_STAMP"] = value["tag"]
            d = os.path.join(base_dir, "stamp_dir")
            os.makedirs(d, exist_ok=True)
            context["py_paths"].append(d)

    renv.register_plugin(StampPlugin())
    try:
        @rt.remote(runtime_env={"stamp": {"tag": "hello-plugin"}})
        def read():
            return (os.environ.get("RTPU_STAMP"),
                    any(p.endswith("stamp_dir") for p in sys.path))

        first = rt.get(read.remote(), timeout=60)

        @rt.remote(runtime_env={"stamp": {"tag": "x"},
                                "env_vars": {"RTPU_STAMP": "explicit"}})
        def read2():
            return os.environ.get("RTPU_STAMP")

        return first, rt.get(read2.remote(), timeout=60)
    finally:
        renv.unregister_plugin("stamp")


def make_wheel(tmp, name, version):
    """Hand-roll a minimal pure-python wheel (installable offline), as the
    reference's ``_make_wheel`` does."""
    import zipfile

    whl = os.path.join(tmp, f"{name}-{version}-py3-none-any.whl")
    dist = f"{name}-{version}.dist-info"
    with zipfile.ZipFile(whl, "w") as zf:
        zf.writestr(f"{name}/__init__.py", f"__version__ = {version!r}\n")
        zf.writestr(f"{dist}/METADATA",
                    f"Metadata-Version: 2.1\nName: {name}\n"
                    f"Version: {version}\n")
        zf.writestr(f"{dist}/WHEEL",
                    "Wheel-Version: 1.0\nGenerator: test\nRoot-Is-"
                    "Purelib: true\nTag: py3-none-any\n")
        zf.writestr(f"{dist}/RECORD", "")
    return whl


@cluster(**RENV)
def pip_env_version_isolation(rt, accel, tmp):
    whl1 = make_wheel(tmp, "verpkg", "1.0")
    whl2 = make_wheel(tmp, "verpkg", "2.0")

    @rt.remote(runtime_env={"pip": [whl1]})
    def v1():
        import verpkg
        return verpkg.__version__

    @rt.remote(runtime_env={"pip": [whl2]})
    def v2():
        import verpkg
        return verpkg.__version__

    @rt.remote
    def none():
        try:
            import verpkg  # noqa: F401
            return "leaked"
        except ImportError:
            return "clean"

    return tuple(rt.get([v1.remote(), v2.remote(), none.remote()],
                        timeout=180))


@cluster(**RENV)
def pip_env_venv_cached(rt, accel, tmp):
    whl = make_wheel(tmp, "cachepkg", "3.1")

    @rt.remote(runtime_env={"pip": [whl]})
    def use():
        import cachepkg
        return cachepkg.__version__

    first = rt.get(use.remote(), timeout=120)
    second = rt.get(use.remote(), timeout=120)
    pip_root = os.path.join(_session_dir(rt), "runtime_resources", "pip")
    venvs = [d for d in os.listdir(pip_root)
             if os.path.isdir(os.path.join(pip_root, d))]
    return first, second, len(venvs)


PROGRAMS = {
    "pubsub": [publish_subscribe_roundtrip,
               publish_from_worker_reaches_driver, actor_state_channel,
               unsubscribed_channel_silent],
    "tracing": [trace_spans_driver_task_nested, trace_spans_actor_hop,
                separate_roots_get_separate_traces,
                two_hop_chain_renders_connected_chrome_trace,
                collective_ops_emit_spans_under_task,
                serve_device_object_round_trip_single_trace,
                span_helpers_driverside,
                sampled_out_serve_round_trip_emits_zero_spans,
                errored_serve_round_trip_keeps_all_spans,
                sampled_in_serve_round_trip_keeps_spans],
    "profiler": [folded_and_speedscope_golden,
                 cpu_mode_counts_idle_leaves_separately,
                 bounded_table_eviction_under_churning_stacks,
                 deep_stack_truncated_with_marker,
                 sampler_start_stop_idempotent,
                 always_on_no_thread_stacking_across_init_shutdown,
                 cluster_profile_covers_every_process_kind,
                 worker_scoped_profile_filters,
                 wedged_collective_rank_still_profiles,
                 gcs_subprocess_self_profile_over_bootstrap_address,
                 profile_window_rearms_running_sampler_with_requested_knobs],
    "agent": [wedged_collective_rank_stack_capture,
              stack_capture_includes_node_manager_threads,
              worker_log_fan_in, actor_log_fan_in_routes_by_actor_id,
              dead_workers_logs_reachable_by_actor_and_full_id,
              flight_recorder_dump_on_gang_death,
              flight_recorder_dump_on_unexpected_worker_death,
              flight_snapshot_over_node_agent_endpoint,
              metrics_reporter_idempotent_and_joined_on_shutdown,
              metrics_drop_dead_client_series,
              report_to_gcs_logs_failures_once_per_kind],
    "logs": [get_log_follow_streams_new_lines_in_order,
             follow_cursor_reads_only_complete_lines],
    "metrics": [counter_gauge_histogram, metrics_report_to_gcs,
                dashboard_rest, node_hardware_reporter,
                scheduler_counters_in_prometheus,
                prometheus_multiprocess_aggregation,
                multiprocess_counters_sum_on_metrics_endpoint],
    "runtime_env": [py_modules_importable_in_task, working_dir_sets_cwd,
                    actor_runtime_env, uri_cache_deduplicates,
                    env_vars_still_honored_with_working_dir,
                    runtime_env_plugin_api, pip_env_version_isolation,
                    pip_env_venv_cached],
}


def run_group(rt, accel, group, tmp):
    tmp = os.path.join(tmp, group)
    os.makedirs(tmp, exist_ok=True)
    if group == "metrics":
        return run_shared(PROGRAMS[group], rt, accel, tmp)
    out = {}
    for prog in PROGRAMS[group]:
        # Each program its own directory (the reference's tmp_path).
        d = os.path.join(tmp, prog.__name__)
        os.makedirs(d)
        out.update(run_programs([prog], rt, accel, d))
    return out


if __name__ == "__main__":
    main(run_group)
