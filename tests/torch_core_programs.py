"""Small programs for the runtime-core parity tests, run on both runtimes.

Each program takes the runtime module (``ray_tpu`` or ``ray_tpu_torch``)
and returns plain values, so its results on the two runtimes compare with
``==``. The module imports neither runtime, nor jax: a worker of the port's
runtime that unpickles one of its functions by name imports it and stays
free of both.
"""

from __future__ import annotations

import importlib
import os
import sys
import time

T = 60    # seconds: every get is bounded, so a stuck runtime fails fast


def square(x):
    return x * x


def slow(x, seconds):
    time.sleep(seconds)
    return x


def fail(msg):
    raise ValueError(msg)


def spin_for(seconds, value=0):
    """Busy for ``seconds`` (a profile window sees this frame), then
    ``value``."""
    end = time.time() + seconds
    while time.time() < end:
        pass
    return value


def nested(modname, n):
    """A task that submits tasks: the sum of squares below ``n``."""
    rt = importlib.import_module(modname)
    f = rt.remote(square)
    return sum(rt.get([f.remote(i) for i in range(n)], timeout=T))


class Counter:
    def __init__(self, start=0):
        self.n = start

    def inc(self, by=1):
        self.n += by
        return self.n

    def context(self, modname):
        ctx = importlib.import_module(modname).get_runtime_context()
        return ctx.get_actor_id() is not None, ctx.get_node_id()


def task_context(modname):
    ctx = importlib.import_module(modname).get_runtime_context()
    return (ctx.get_actor_id() is None, ctx.get_node_id(),
            dict(ctx.get_assigned_resources()))


def process_facts():
    """What a worker sees: its GPUs, its parent, the JAX/TPU variables it
    inherited, and whether the JAX package or jax is loaded."""
    tpu_vars = sorted(k for k in os.environ
                      if k.startswith(("TPU_", "JAX_", "PALLAS_"))
                      or k == "XLA_FLAGS")
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & {"ray_tpu", "jax", "jaxlib", "cloudpickle"})
    return {"cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "pid": os.getpid(), "ppid": os.getppid(),
            "tpu_vars": tpu_vars, "loaded": loaded}


def make_tensor(n):
    """A task's tensor result, staged into the arena by its worker."""
    import torch

    return torch.arange(n, dtype=torch.float32)


class GpuProbe:
    def facts(self):
        return process_facts()


# ------------------------------------------------------------- programs


def p_tasks(rt):
    f = rt.remote(square)
    return rt.get([f.remote(i) for i in range(6)], timeout=T)


def p_nested_tasks(rt):
    return rt.get(rt.remote(nested).remote(rt.__name__, 5), timeout=T)


def p_actor_state(rt):
    c = rt.remote(Counter).remote(10)
    out = rt.get([c.inc.remote() for _ in range(3)] + [c.inc.remote(5)],
                 timeout=T)
    rt.kill(c)
    return out


def p_named_actor(rt):
    c = rt.remote(Counter).options(name="parity_counter").remote(1)
    rt.get(c.inc.remote(), timeout=T)
    again = rt.get_actor("parity_counter")
    out = rt.get(again.inc.remote(2), timeout=T)
    rt.kill(c)
    try:
        rt.get_actor("no_such_actor")
        missing = None
    except ValueError as e:
        missing = type(e).__name__
    return out, missing


def p_put_get_wait(rt):
    a, b = rt.put({"x": [1, 2]}), rt.put(3)
    s = rt.remote(slow).remote(7, 5.0)
    ready, rest = rt.wait([s, a, b], num_returns=2, timeout=30)
    ready_vals = [rt.get(r, timeout=T) for r in ready]
    one, _ = rt.wait([a, b], num_returns=1, timeout=T)
    all_ready, none_left = rt.wait([a, b, s], num_returns=3, timeout=30)
    return (ready_vals, len(rest), rest[0] == s, len(one),
            [rt.get(r, timeout=T) for r in all_ready], len(none_left),
            rt.get([b, a], timeout=T))


def p_errors(rt):
    ref = rt.remote(fail).remote("boom")
    try:
        rt.get(ref, timeout=T)
        return None
    except Exception as e:
        return (isinstance(e, ValueError),
                isinstance(e, rt.exceptions.RayTpuError), "boom" in str(e))


def p_kill(rt):
    c = rt.remote(Counter).remote()
    rt.get(c.inc.remote(), timeout=T)
    rt.kill(c)
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            rt.get(c.inc.remote(), timeout=30)
        except rt.exceptions.RayActorError as e:
            return type(e).__name__
        time.sleep(0.05)
    return "alive"


def p_placement_groups(rt):
    from importlib import import_module

    pgmod = import_module(rt.__name__ + ".util.placement_group")
    pack = pgmod.placement_group([{"CPU": 1}] * 2, strategy="PACK")
    packed = pack.wait(timeout_seconds=30)
    f = rt.remote(square).options(placement_group=pack,
                                  placement_group_bundle_index=1)
    in_pg = rt.get(f.remote(4), timeout=T)
    # Two bundles on distinct nodes of a one-node cluster: never placed.
    spread = pgmod.placement_group([{"CPU": 1}] * 2, strategy="STRICT_SPREAD")
    time.sleep(0.5)
    spread_ok = pgmod.placement_group_table(spread)["state"]
    pgmod.remove_placement_group(spread)
    pgmod.remove_placement_group(pack)
    return packed, in_pg, spread_ok


def p_runtime_context(rt):
    driver_node = rt.get_runtime_context().get_node_id()
    no_actor, node, res = rt.get(
        rt.remote(task_context).remote(rt.__name__), timeout=T)
    c = rt.remote(Counter).remote()
    in_actor, actor_node = rt.get(c.context.remote(rt.__name__), timeout=T)
    rt.kill(c)
    return no_actor, node == driver_node, res, in_actor, \
        actor_node == driver_node


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


if __name__ == "__main__":
    # The programs on the JAX package's runtime, in a fresh interpreter:
    # their results, as a literal, on the last line.
    import ray_tpu

    ray_tpu.init(num_cpus=int(sys.argv[1]))
    try:
        print(repr(run_all(ray_tpu)))
    finally:
        ray_tpu.shutdown()
