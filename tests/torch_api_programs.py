"""The reference's tests of the runtime core's API as programs, run on
both runtimes: ``tests/test_basic.py``, ``test_actors.py``,
``test_wait_semantics.py`` and ``test_generators.py``, one group each.

Each program is the body of the reference test of the same name (without
``test_``). It starts the cluster that test's fixture starts, on the
runtime module it is given (``ray_tpu`` or ``ray_tpu_torch``), and returns
what that test asserts on as plain values: results, the type of an error
and whether its message matched, whether a bound held. Its results on the
two runtimes compare with ``==``; the port's test then holds them to the
reference's own assertions. An error comes back as ``raises`` gives
it; a program that raises is an ``("error", traceback)`` result.

The module imports neither runtime, nor jax: a worker of the port's
runtime that unpickles one of its functions by name imports it and stays
free of both. ``python tests/torch_api_programs.py GROUP DIR`` runs a
group on ``ray_tpu`` and prints its results on its last line.
"""

from __future__ import annotations

import functools
import importlib
import os
import re
import sys
import time
import traceback

import numpy as np

T = 60    # seconds: every get is bounded, so a stuck runtime fails fast
MiB = 1024 * 1024


def sub(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


def raises(fn, expected=Exception, match=None):
    """What ``pytest.raises(expected, match=match)`` around ``fn()`` looks
    at, as plain values: the exception's type name, whether it is an
    ``expected``, and whether ``match`` is found in its text (None when no
    pattern is given); None when ``fn()`` returned."""
    try:
        fn()
    except Exception as e:
        return (type(e).__name__, isinstance(e, expected),
                None if match is None else re.search(match, str(e)) is not
                None)
    return None


def cluster(**init_kw):
    """The program runs on a fresh ``rt.init(**init_kw)``, shut down after
    it, as the reference test's fixture does."""
    def wrap(prog):
        @functools.wraps(prog)
        def run(rt, accel, tmp):
            rt.init(**init_kw)
            try:
                return prog(rt, accel, tmp)
            finally:
                rt.shutdown()
        return run
    return wrap


# conftest.py's ray_start_regular, and the 4-CPU fixtures of
# test_wait_semantics.py and test_generators.py.
REGULAR = dict(num_cpus=4, object_store_memory=256 * MiB)
FOUR_CPUS = dict(num_cpus=4, object_store_memory=128 * MiB)


def two_node_cluster(labels=None):
    """The program runs on the reference's two-node ``Cluster`` (a 2-CPU
    head and a 2-CPU worker node with ``labels``, connected), shut down
    after it; it takes ``(rt, cluster, worker_node)``."""
    def wrap(prog):
        @functools.wraps(prog)
        def run(rt, accel, tmp):
            cu = sub(rt, "cluster_utils")
            c = cu.Cluster(initialize_head=True,
                           head_node_args={"num_cpus": 2})
            try:
                worker_node = c.add_node(num_cpus=2, labels=labels)
                c.connect(object_store_memory=64 * MiB)
                c.wait_for_nodes()
                return prog(rt, c, worker_node)
            finally:
                rt.shutdown()
                c.shutdown()
        return run
    return wrap


def pinned(rt, node):
    ss = sub(rt, "util.scheduling_strategies")
    return ss.NodeAffinitySchedulingStrategy(node_id=node.node_id,
                                             soft=False)


# ------------------------------------------------------------------ basic


@cluster(**REGULAR)
def simple_task(rt, accel, tmp):
    @rt.remote
    def f(x):
        return x + 1

    return rt.get(f.remote(1), timeout=T)


@cluster(**REGULAR)
def task_args_kwargs(rt, accel, tmp):
    @rt.remote
    def f(a, b=2, *, c=3):
        return a + b + c

    return rt.get(f.remote(1), timeout=T), rt.get(f.remote(1, 5, c=10),
                                                 timeout=T)


@cluster(**REGULAR)
def put_get(rt, accel, tmp):
    return [rt.get(rt.put(v), timeout=T)
            for v in [1, "hello", {"a": [1, 2]}, None, (1, 2)]]


@cluster(**REGULAR)
def put_get_numpy(rt, accel, tmp):
    arr = np.random.rand(1000, 100)
    out = rt.get(rt.put(arr), timeout=T)
    return out.shape, str(out.dtype), bool(np.array_equal(arr, out))


@cluster(**REGULAR)
def object_ref_as_arg(rt, accel, tmp):
    @rt.remote
    def plus1(x):
        return x + 1

    return rt.get(plus1.remote(rt.put(10)), timeout=T)


@cluster(**REGULAR)
def task_chain(rt, accel, tmp):
    @rt.remote
    def f(x):
        return x + 1

    ref = f.remote(0)
    for _ in range(10):
        ref = f.remote(ref)
    return rt.get(ref, timeout=T)


@cluster(**REGULAR)
def nested_refs_not_resolved(rt, accel, tmp):
    @rt.remote
    def f(lst):
        # nested refs arrive as ObjectRefs, not values
        return [rt.get(r) for r in lst]

    return rt.get(f.remote([rt.put(i) for i in range(3)]), timeout=T)


@cluster(**REGULAR)
def multiple_returns(rt, accel, tmp):
    @rt.remote(num_returns=3)
    def f():
        return 1, 2, 3

    a, b, c = f.remote()
    return rt.get([a, b, c], timeout=T)


@cluster(**REGULAR)
def num_returns_zero(rt, accel, tmp):
    @rt.remote(num_returns=0)
    def f():
        return None

    return f.remote() is None


@cluster(**REGULAR)
def error_propagation(rt, accel, tmp):
    @rt.remote
    def fail():
        raise ValueError("expected failure")

    return raises(lambda: rt.get(fail.remote(), timeout=T), ValueError,
                   "expected failure")


@cluster(**REGULAR)
def error_through_dependency(rt, accel, tmp):
    @rt.remote
    def fail():
        raise KeyError("dep failed")

    @rt.remote
    def consume(x):
        return x

    return raises(lambda: rt.get(consume.remote(fail.remote()), timeout=T))


@cluster(**REGULAR)
def nested_tasks(rt, accel, tmp):
    @rt.remote
    def inner(x):
        return x * 2

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x)) + 1

    return rt.get(outer.remote(5), timeout=T)


@cluster(**REGULAR)
def wait(rt, accel, tmp):
    @rt.remote
    def slow(t):
        time.sleep(t)
        return t

    fast_ref = slow.remote(0.05)
    slow_ref = slow.remote(10)
    ready, not_ready = rt.wait([fast_ref, slow_ref], num_returns=1,
                               timeout=5)
    return ready == [fast_ref], not_ready == [slow_ref]


@cluster(**REGULAR)
def wait_timeout(rt, accel, tmp):
    @rt.remote
    def hang():
        time.sleep(60)

    ready, not_ready = rt.wait([hang.remote()], timeout=0.2)
    return ready, len(not_ready)


@cluster(**REGULAR)
def get_timeout(rt, accel, tmp):
    @rt.remote
    def hang():
        time.sleep(60)

    return raises(lambda: rt.get(hang.remote(), timeout=0.3),
                   rt.exceptions.GetTimeoutError)


@cluster(**REGULAR)
def large_object(rt, accel, tmp):
    arr = np.ones((4 << 20,), dtype=np.uint8)  # 4 MiB
    return rt.get(rt.put(arr), timeout=T).nbytes


@cluster(**REGULAR)
def large_task_arg(rt, accel, tmp):
    arr = np.ones((2 << 20,), dtype=np.uint8)  # 2 MiB, above inline limit

    @rt.remote
    def size_of(a):
        return a.nbytes

    return rt.get(size_of.remote(arr), timeout=T)


@cluster(**REGULAR)
def many_parallel_tasks(rt, accel, tmp):
    @rt.remote
    def sq(i):
        return i * i

    return rt.get([sq.remote(i) for i in range(100)], timeout=T)


@cluster(**REGULAR)
def options_override(rt, accel, tmp):
    @rt.remote(num_returns=1)
    def f():
        return 1, 2

    a, b = f.options(num_returns=2).remote()
    return rt.get(a, timeout=T), rt.get(b, timeout=T)


@cluster(**REGULAR)
def cluster_resources(rt, accel, tmp):
    nodes = rt.nodes()
    return rt.cluster_resources()["CPU"], len(nodes), nodes[0]["Alive"]


@cluster(**REGULAR)
def runtime_context(rt, accel, tmp):
    @rt.remote
    def ctx_info():
        ctx = rt.get_runtime_context()
        return ctx.get_task_id(), ctx.get_node_id()

    task_id, node_id = rt.get(ctx_info.remote(), timeout=T)
    return task_id is not None, node_id == rt.nodes()[0]["NodeID"]


@cluster(**REGULAR)
def cancel(rt, accel, tmp):
    @rt.remote
    def hang():
        time.sleep(60)
        return "done"

    ref = hang.remote()
    time.sleep(0.3)
    rt.cancel(ref, force=True)
    ex = rt.exceptions
    return raises(lambda: rt.get(ref, timeout=10), (
        ex.TaskCancelledError, ex.WorkerCrashedError, ex.RayActorError))


# ----------------------------------------------------------------- actors


@cluster(**REGULAR)
def basic_actor(rt, accel, tmp):
    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    c = Counter.remote()
    return [rt.get(c.incr.remote(), timeout=T) for _ in range(2)]


@cluster(**REGULAR)
def actor_constructor_args(rt, accel, tmp):
    @rt.remote
    class A:
        def __init__(self, a, b=10):
            self.v = a + b

        def get(self):
            return self.v

    return (rt.get(A.remote(1).get.remote(), timeout=T),
            rt.get(A.remote(1, b=2).get.remote(), timeout=T))


@cluster(**REGULAR)
def actor_ordering(rt, accel, tmp):
    @rt.remote
    class Appender:
        def __init__(self):
            self.log = []

        def add(self, x):
            self.log.append(x)

        def get(self):
            return self.log

    a = Appender.remote()
    for i in range(20):
        a.add.remote(i)
    return rt.get(a.get.remote(), timeout=T)


@cluster(**REGULAR)
def actor_state_isolated(rt, accel, tmp):
    @rt.remote
    class C:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    c1, c2 = C.remote(), C.remote()
    rt.get(c1.incr.remote(), timeout=T)
    return rt.get(c2.incr.remote(), timeout=T)


@cluster(**REGULAR)
def actor_error(rt, accel, tmp):
    @rt.remote
    class A:
        def fail(self):
            raise RuntimeError("method failed")

        def ok(self):
            return "fine"

    a = A.remote()
    err = raises(lambda: rt.get(a.fail.remote(), timeout=T), RuntimeError,
                  "method failed")
    # the actor survives method errors
    return err, rt.get(a.ok.remote(), timeout=T)


@cluster(**REGULAR)
def actor_creation_error(rt, accel, tmp):
    @rt.remote
    class Bad:
        def __init__(self):
            raise ValueError("ctor failed")

        def m(self):
            return 1

    b = Bad.remote()
    return raises(lambda: rt.get(b.m.remote(), timeout=20))


@cluster(**REGULAR)
def named_actor(rt, accel, tmp):
    @rt.remote
    class Store:
        def __init__(self):
            self.v = {}

        def put(self, k, v):
            self.v[k] = v

        def get(self, k):
            return self.v.get(k)

    s = Store.options(name="kvstore").remote()
    rt.get(s.put.remote("a", 1), timeout=T)
    handle = rt.get_actor("kvstore")
    got = rt.get(handle.get.remote("a"), timeout=T)
    return got, raises(lambda: rt.get_actor("missing"), ValueError)


@cluster(**REGULAR)
def duplicate_named_actor(rt, accel, tmp):
    @rt.remote
    class A:
        def m(self):
            return 1

    A.options(name="dup").remote()
    time.sleep(0.1)

    def second():
        h = A.options(name="dup").remote()
        rt.get(h.m.remote(), timeout=10)

    return raises(second)


@cluster(**REGULAR)
def pass_handle_to_task(rt, accel, tmp):
    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    @rt.remote
    def bump(counter):
        return rt.get(counter.incr.remote())

    c = Counter.remote()
    return rt.get(bump.remote(c), timeout=T), rt.get(c.incr.remote(),
                                                    timeout=T)


@cluster(**REGULAR)
def kill_actor(rt, accel, tmp):
    @rt.remote
    class A:
        def m(self):
            return 1

    a = A.remote()
    first = rt.get(a.m.remote(), timeout=T)
    rt.kill(a)
    time.sleep(0.3)
    return first, raises(lambda: rt.get(a.m.remote(), timeout=10),
                          rt.exceptions.RayActorError)


@cluster(**REGULAR)
def actor_restart(rt, accel, tmp):
    @rt.remote(max_restarts=1)
    class Flaky:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def die(self):
            os._exit(1)

    f = Flaky.remote()
    first = rt.get(f.incr.remote(), timeout=T)
    f.die.remote()
    time.sleep(1.0)
    # restarted: state reset
    return first, rt.get(f.incr.remote(), timeout=30)


@cluster(**REGULAR)
def async_actor(rt, accel, tmp):
    @rt.remote
    class AsyncWorker:
        async def work(self, t):
            import asyncio
            await asyncio.sleep(t)
            return t

    w = AsyncWorker.remote()
    rt.get(w.work.remote(0.0), timeout=T)  # warm: actor alive, route cached
    t0 = time.time()
    out = rt.get([w.work.remote(0.3) for _ in range(5)], timeout=30)
    # concurrent: should take ~0.3s, not 1.5s
    return out, time.time() - t0 < 1.2


@cluster(**REGULAR)
def threaded_actor(rt, accel, tmp):
    @rt.remote(max_concurrency=4)
    class Sleeper:
        def nap(self, t):
            time.sleep(t)
            return t

    s = Sleeper.remote()
    rt.get(s.nap.remote(0.0), timeout=T)  # warm: actor alive, route cached
    t0 = time.time()
    out = rt.get([s.nap.remote(0.4) for _ in range(4)], timeout=30)
    return out, time.time() - t0 < 1.3


@cluster(**REGULAR)
def exit_actor(rt, accel, tmp):
    @rt.remote
    class Quitter:
        def quit(self):
            sub(rt, "actor").exit_actor()

        def m(self):
            return 1

    q = Quitter.remote()
    first = rt.get(q.m.remote(), timeout=T)
    rt.get(q.quit.remote(), timeout=10)
    time.sleep(0.5)
    return first, raises(lambda: rt.get(q.m.remote(), timeout=10),
                          rt.exceptions.RayActorError)


@cluster(**REGULAR)
def actor_method_num_returns(rt, accel, tmp):
    @rt.remote
    class M:
        @rt.method(num_returns=2)
        def two(self):
            return 1, 2

    a, b = M.remote().two.remote()
    return rt.get([a, b], timeout=T)


@cluster(**REGULAR)
def actor_pool(rt, accel, tmp):
    @rt.remote
    class Doubler:
        def double(self, x):
            return 2 * x

    pool = sub(rt, "util").ActorPool([Doubler.remote() for _ in range(2)])
    return list(pool.map(lambda a, v: a.double.remote(v), range(6)))


# ------------------------------------------------------------------- wait


@cluster(**FOUR_CPUS)
def wait_preserves_input_order(rt, accel, tmp):
    @rt.remote
    def quick(i):
        return i

    refs = [quick.remote(i) for i in range(6)]
    rt.get(list(refs), timeout=T)  # all complete
    ready, not_ready = rt.wait(refs, num_returns=3, timeout=5)
    return ready == refs[:3], not_ready == refs[3:]


@cluster(**FOUR_CPUS)
def failed_object_counts_as_ready(rt, accel, tmp):
    @rt.remote
    def boom():
        raise ValueError("expected")

    @rt.remote
    def hang():
        time.sleep(30)

    bad, slow = boom.remote(), hang.remote()
    ready, not_ready = rt.wait([bad, slow], num_returns=1, timeout=10)
    return (ready == [bad], not_ready == [slow],
            raises(lambda: rt.get(bad, timeout=T), ValueError, "expected"))


@cluster(**FOUR_CPUS)
def wait_timeout_zero_is_poll(rt, accel, tmp):
    @rt.remote
    def hang():
        time.sleep(30)

    ref = hang.remote()
    t0 = time.time()
    ready, not_ready = rt.wait([ref], timeout=0)
    polled = time.time() - t0 < 2.0
    first = ready == [] and not_ready == [ref]
    done = rt.put(1)
    ready, not_ready = rt.wait([done, ref], timeout=0)
    return polled, first, ready == [done] and not_ready == [ref]


@cluster(**FOUR_CPUS)
def wait_duplicate_refs_rejected(rt, accel, tmp):
    ref = rt.put(1)
    return raises(lambda: rt.wait([ref, ref]), ValueError)


# ------------------------------------------------------------- generators


@cluster(**FOUR_CPUS)
def dynamic_generator_basic(rt, accel, tmp):
    @rt.remote(num_returns="dynamic")
    def gen(n):
        for i in range(n):
            yield i * i

    gen_obj = rt.get(gen.remote(5), timeout=T)
    refs = list(gen_obj)
    return (isinstance(gen_obj, rt.ObjectRefGenerator), len(gen_obj),
            all(isinstance(r, rt.ObjectRef) for r in refs),
            rt.get(refs, timeout=T))


@cluster(**FOUR_CPUS)
def dynamic_generator_variable_counts(rt, accel, tmp):
    """The yield count is data-dependent — the point of 'dynamic'."""
    @rt.remote(num_returns="dynamic")
    def split(n):
        for i in range(n):
            yield np.full(8, i)

    out = []
    for n in (0, 1, 7):
        g = rt.get(split.remote(n), timeout=T)
        out.append((len(g), [int(rt.get(r, timeout=T)[0]) for r in g]))
    return out


@cluster(**FOUR_CPUS)
def dynamic_generator_refs_usable_as_args(rt, accel, tmp):
    @rt.remote(num_returns="dynamic")
    def gen():
        yield 10
        yield 20

    @rt.remote
    def add_one(x):
        return x + 1

    g = rt.get(gen.remote(), timeout=T)
    return rt.get([add_one.remote(r) for r in g], timeout=T)


@cluster(**FOUR_CPUS)
def dynamic_generator_exception(rt, accel, tmp):
    """A generator that raises mid-yield fails the generator ref."""
    @rt.remote(num_returns="dynamic")
    def bad():
        yield 1
        raise ValueError("mid-yield boom")

    return raises(lambda: rt.get(bad.remote(), timeout=T), ValueError,
                   "mid-yield boom")


@cluster(**FOUR_CPUS)
def dynamic_generator_non_generator_return_errors(rt, accel, tmp):
    @rt.remote(num_returns="dynamic")
    def scalar():
        return 42

    return raises(lambda: rt.get(scalar.remote(), timeout=T))


@cluster(**FOUR_CPUS)
def dynamic_generator_retry_after_kill_mid_yield(rt, accel, tmp):
    """Killed mid-yield with retry budget: the rerun re-stores every
    index idempotently and the consumer sees ONE complete generator."""
    worker_mod = sub(rt, "_private.worker")
    tu = sub(rt, "_private.test_utils")

    @rt.remote(num_returns="dynamic", max_retries=2)
    def slow_gen():
        for i in range(6):
            time.sleep(0.4)
            yield i

    ref = slow_gen.remote()
    # Let a few yields land, then kill the executing worker.
    time.sleep(1.0)
    pid = tu.kill_any_busy_worker(worker_mod._global_cluster.nm)
    g = rt.get(ref, timeout=120)
    return pid is not None, len(g), rt.get(list(g), timeout=T)


@two_node_cluster()
def dynamic_generator_lost_yield_reconstructs(rt, c, worker_node):
    """Yields whose only copy lived on a dead node are rebuilt by
    re-running the producing generator task on a surviving node."""
    @rt.remote(num_returns="dynamic", max_retries=2)
    def gen():
        for i in range(3):
            yield np.full(4, i)

    ref = gen.options(scheduling_strategy=pinned(rt, worker_node)).remote()
    refs = list(rt.get(ref, timeout=T))
    c.remove_node(worker_node)
    return [int(v[0]) for v in rt.get(refs, timeout=60)]


@cluster(**FOUR_CPUS)
def data_dynamic_block_splitting(rt, accel, tmp):
    """Data wiring: with a target block size set, read and map_batches
    tasks emit variable block counts via dynamic generator returns."""
    import json
    import tempfile

    rd = sub(rt, "data")
    ctx = sub(rt, "data.dataset").DataContext.get_current()
    ctx.target_max_rows_per_block = 10
    try:
        ds = rd.range(95, parallelism=2).map(lambda x: x + 1)
        # 2 input blocks of ~48 rows -> ceil(48/10)*2 = 10 output blocks.
        n_blocks = len(ds._execute())
        rows = sorted(ds.take_all())
        with tempfile.TemporaryDirectory(dir=tmp) as d:
            p = f"{d}/rows.jsonl"
            with open(p, "w") as f:
                for i in range(37):
                    f.write(json.dumps({"v": i}) + "\n")
            ds2 = rd.read_json(p)
            # ceil(37/10) from ONE file
            return (n_blocks >= 8, rows, ds2.num_blocks(),
                    sorted(r["v"] for r in ds2.take_all()))
    finally:
        ctx.target_max_rows_per_block = None


PROGRAMS = {
    "basic": [simple_task, task_args_kwargs, put_get, put_get_numpy,
              object_ref_as_arg, task_chain, nested_refs_not_resolved,
              multiple_returns, num_returns_zero, error_propagation,
              error_through_dependency, nested_tasks, wait, wait_timeout,
              get_timeout, large_object, large_task_arg,
              many_parallel_tasks, options_override, cluster_resources,
              runtime_context, cancel],
    "actors": [basic_actor, actor_constructor_args, actor_ordering,
               actor_state_isolated, actor_error, actor_creation_error,
               named_actor, duplicate_named_actor, pass_handle_to_task,
               kill_actor, actor_restart, async_actor, threaded_actor,
               exit_actor, actor_method_num_returns, actor_pool],
    "wait": [wait_preserves_input_order, failed_object_counts_as_ready,
             wait_timeout_zero_is_poll, wait_duplicate_refs_rejected],
    "generators": [dynamic_generator_basic,
                   dynamic_generator_variable_counts,
                   dynamic_generator_refs_usable_as_args,
                   dynamic_generator_exception,
                   dynamic_generator_non_generator_return_errors,
                   dynamic_generator_retry_after_kill_mid_yield,
                   dynamic_generator_lost_yield_reconstructs,
                   data_dynamic_block_splitting],
}


def run_programs(programs, rt, accel, tmp):
    """Every program of ``programs`` on ``rt``, one after the other, each
    on its own cluster: ``{name: ("ok", value) or ("error", text)}``."""
    out = {}
    for prog in programs:
        try:
            out[prog.__name__] = ("ok", prog(rt, accel, tmp))
        except Exception:
            out[prog.__name__] = ("error", traceback.format_exc())
    return out


def run_group(rt, accel, group, tmp):
    return run_programs(PROGRAMS[group], rt, accel, tmp)


def main(run_group):
    """``python PROGRAMS_MODULE GROUP DIR``: the group on ``ray_tpu``, its
    results on the last line after ``RESULTS``."""
    import ray_tpu
    from torch_runtimes import REFERENCE_BLOCK_S, deadline

    with deadline(REFERENCE_BLOCK_S,
                  what=f"the {sys.argv[1]} programs on ray_tpu"):
        results = run_group(ray_tpu, "TPU", sys.argv[1], sys.argv[2])
    print("RESULTS " + repr(results), flush=True)


if __name__ == "__main__":
    main(run_group)
