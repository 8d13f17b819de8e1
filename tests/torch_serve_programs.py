"""Serve scenarios for the control-plane parity tests, run on both runtimes.

Each program takes a runtime module (``ray_tpu`` or ``ray_tpu_torch``) and
drives that runtime's ``serve`` package; it returns plain values, so the
results on the two runtimes compare with ``==``. The deployments are this
module's classes and functions: a replica of either runtime imports this
module by name, and it imports neither runtime, nor jax, at module level.
"""

from __future__ import annotations

import importlib
import os
import threading
import time

T = 60    # seconds: every call is bounded, so a stuck runtime fails fast


def _serve(rt):
    return importlib.import_module(rt.__name__ + ".serve")


def _controller(rt):
    return importlib.import_module(rt.__name__ + ".serve.api")._controller()


def _aid(actor) -> str:
    return actor._actor_id.hex()


def _until(pred, timeout: float, period: float = 0.2):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(period)
    return pred()


# ---------------------------------------------------------- deployments

def echo(payload):
    return {"got": payload}


class Counter:
    def __init__(self, start):
        self.start = start
        self.value = start

    def __call__(self, payload):
        return self.value

    def incr(self, by):
        self.value += by
        return self.value

    def peek(self, _):
        return self.start


class Doubler:
    def __call__(self, x):
        return 2 * x


class Adder:
    def __init__(self, inc):
        self.inc = inc

    def __call__(self, x):
        return x + self.inc


class Pipeline:
    def __init__(self, doubler, adder):
        self.doubler = doubler
        self.adder = adder

    def __call__(self, x):
        y = self.doubler.remote(x).result(timeout=T)
        return self.adder.remote(y).result(timeout=T)


class Streamer:
    def counts(self, n):
        for i in range(n):
            yield {"i": i}

    async def acounts(self, n):
        for i in range(n):
            yield i * 10


class Sleeper:
    def __call__(self, seconds):
        time.sleep(seconds)
        return os.getpid()


class Versioned:
    def __init__(self, version):
        self.version = version

    def __call__(self, seconds):
        time.sleep(seconds)
        return self.version


class Adding:
    """The HTTP ingress's catch-all route: the proxy passes
    ``{"path", "query", "method", "json" | "body"}``."""

    def __call__(self, req):
        if "json" in req:
            return {"sum": req["json"]["a"] + req["json"]["b"],
                    "path": req["path"], "query": req["query"],
                    "method": req["method"]}
        if "body" in req:
            return {"raw": len(req["body"])}
        return {"path": req["path"], "method": req["method"]}


class FakeLLM:
    """A deterministic stand-in for the LLM router at the ingress: the
    tokens of ``prompt`` are ``(sum(prompt) + seed + i) % 97``, streamed in
    chunks of two. A prompt that starts with -1 takes 1.5 s (admission and
    shedding), with -2 raises the runtime's
    ``RequestMigrationExhaustedError``, with -3 streams a chunk every 0.2
    s; a stream the consumer abandons counts in ``cancelled``."""

    def __init__(self, runtime_name):
        self._exceptions = importlib.import_module(runtime_name
                                                   + ".exceptions")
        self._cancelled = 0
        self._lock = threading.Lock()

    @staticmethod
    def _tokens(req):
        base = sum(req["prompt"]) + int(req.get("seed") or 0)
        return [(base + i) % 97 for i in range(int(req.get("n") or 4))]

    def __call__(self, req):
        if req["prompt"] and req["prompt"][0] == -1:
            time.sleep(1.5)
        if req["prompt"] and req["prompt"][0] == -2:
            raise self._exceptions.RequestMigrationExhaustedError(
                "request still failing after 3 migrations", migrations=3)
        return {"tokens": self._tokens(req)}

    def generate_stream(self, req):
        toks = self._tokens(req)
        slow = bool(req["prompt"]) and req["prompt"][0] == -3
        try:
            for i in range(0, len(toks), 2):
                yield toks[i:i + 2]
                if slow:
                    time.sleep(0.2)
        except GeneratorExit:
            with self._lock:
                self._cancelled += 1
            raise

    def cancelled(self, _=None):
        with self._lock:
            return self._cancelled


def visible_gpus():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


# -------------------------------------------------------------- programs

def p_function(rt):
    serve = _serve(rt)
    h = serve.run(serve.deployment(echo).bind(), route_prefix="/echo")
    out = h.remote("hi").result(timeout=T)
    serve.delete("echo")
    return out


def p_class_methods_and_options(rt):
    serve = _serve(rt)
    dep = serve.deployment(Counter, num_replicas=2)
    h = serve.run(dep.bind(10), route_prefix="/counter")
    out = (h.remote(None).result(timeout=T),
           h.incr.remote(5).result(timeout=T),
           h.options(method_name="peek").remote(None).result(timeout=T),
           serve.status()["Counter"]["num_replicas"])
    serve.delete("Counter")
    return out


def p_composition(rt):
    serve = _serve(rt)
    app = serve.deployment(Pipeline).bind(
        serve.deployment(Doubler).bind(), serve.deployment(Adder).bind(10))
    h = serve.run(app, http_port=None)
    out = (h.remote(5).result(timeout=T),
           sorted(set(serve.status()) & {"Pipeline", "Doubler", "Adder"}))
    for name in ("Pipeline", "Doubler", "Adder"):
        serve.delete(name)
    return out


def p_remote_gen(rt):
    serve = _serve(rt)
    h = serve.run(serve.deployment(Streamer, name="streamer").bind(),
                  http_port=None)
    items = list(h.counts.remote_gen(4))
    aitems = list(h.acounts.remote_gen(3))
    try:
        h.counts.remote(2).result(timeout=T)
        refused = None
    except Exception as e:  # the replica refuses a generator result
        refused = "remote_gen" in str(e)
    serve.delete("streamer")
    return items, aitems, refused


def p_status_and_delete(rt):
    serve = _serve(rt)
    serve.run(serve.deployment(echo, name="gone").bind(),
              route_prefix="/gone")
    before = "gone" in serve.status()
    info = serve.status()["gone"]
    serve.delete("gone")
    return (before, info["num_replicas"], info["target"],
            info["config"]["route_prefix"], "gone" in serve.status())


def p_autoscale_up_and_down(rt):
    serve = _serve(rt)
    ac = serve.AutoscalingConfig(
        min_replicas=1, max_replicas=3, target_ongoing_requests=1.0,
        upscale_delay_s=0.0, downscale_delay_s=1.0, look_back_period_s=0.5)
    dep = serve.deployment(Sleeper, name="scaler", autoscaling_config=ac,
                           max_ongoing_requests=8)
    h = serve.run(dep.bind(), http_port=None)
    h.remote(0.0).result(timeout=T)

    def target():
        return serve.status()["scaler"]["target"]

    stop = threading.Event()

    def client():
        while not stop.is_set():
            h.remote(0.3).result(timeout=T)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        peak = _until(lambda: target() >= 2 and target(), 20.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=T)
    down = _until(lambda: target() == 1 and
                  serve.status()["scaler"]["num_replicas"] == 1, 30.0)
    serve.delete("scaler")
    return peak >= 2, bool(down)


def p_killed_replica_replaced(rt):
    serve = _serve(rt)
    h = serve.run(serve.deployment(echo, name="fragile",
                                   num_replicas=2).bind(), http_port=None)
    first = h.remote(1).result(timeout=T)
    ctrl = _controller(rt)
    replicas = rt.get(ctrl.get_replicas.remote("fragile"), timeout=T)
    victim = _aid(replicas[0])
    rt.kill(replicas[0])

    def replaced():
        cur = [_aid(r) for r in
               rt.get(ctrl.get_replicas.remote("fragile"), timeout=T)]
        return len(cur) == 2 and victim not in cur

    ok = _until(replaced, 30.0)
    after = h.remote(7).result(timeout=T)
    faults = rt.get(ctrl.fault_stats.remote(), timeout=T)
    serve.delete("fragile")
    return first, bool(ok), after, faults["replica_restarts_total"] >= 1


def p_drain_on_redeploy(rt):
    serve = _serve(rt)
    ctrl = _controller(rt)
    drains = len(rt.get(ctrl.fault_stats.remote(),
                        timeout=T)["drain_duration_s"])
    dep = serve.deployment(Versioned, name="ver")
    h = serve.run(dep.bind("v1"), http_port=None)
    assert h.remote(0.0).result(timeout=T) == "v1"
    inflight = h.remote(2.0)
    time.sleep(0.5)     # the slow call is running on the v1 replica
    serve.run(dep.bind("v2"), http_port=None)
    h2 = serve.get_deployment_handle("ver")
    new = _until(lambda: h2.remote(0.0).result(timeout=T) == "v2", 30.0)
    old = inflight.result(timeout=T)
    drained = _until(lambda: len(rt.get(ctrl.fault_stats.remote(),
                                        timeout=T)["drain_duration_s"])
                     > drains, 30.0)
    serve.delete("ver")
    return old, bool(new), bool(drained)


def gpu_replica_replaced(rt):
    """The port's runtime only (it schedules GPUs as whole devices): a
    replica with ``num_gpus=1`` sees its GPU and a plain one none; a killed
    GPU replica's replacement waits for the GPU it held, then serves."""
    serve = _serve(rt)
    gpu = serve.run(serve.deployment(
        visible_gpus, name="gpu", ray_actor_options={"num_gpus": 1}).bind(),
        http_port=None)
    cpu = serve.run(serve.deployment(visible_gpus, name="cpu").bind(),
                    http_port=None)
    seen = (gpu.remote().result(timeout=T), cpu.remote().result(timeout=T))
    ctrl = _controller(rt)
    (victim,) = rt.get(ctrl.get_replicas.remote("gpu"), timeout=T)
    rt.kill(victim)

    def replaced():
        cur = rt.get(ctrl.get_replicas.remote("gpu"), timeout=T)
        return len(cur) == 1 and _aid(cur[0]) != _aid(victim)

    ok = _until(replaced, 30.0)
    after = gpu.remote().result(timeout=T)
    serve.delete("gpu")
    serve.delete("cpu")
    return seen, bool(ok), after


PROGRAMS = {name[2:]: fn for name, fn in sorted(globals().items())
            if name.startswith("p_")}


def run_all(rt):
    """name -> ("ok", result) or ("raised", "Type: message") for every
    program on the runtime ``rt``."""
    out = {}
    for name in sorted(PROGRAMS):
        try:
            out[name] = ("ok", PROGRAMS[name](rt))
        except Exception as e:  # compared, not hidden: the test shows it
            out[name] = ("raised", f"{type(e).__name__}: {e}")
    return out
