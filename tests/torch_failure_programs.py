"""The reference's tests of the runtime's failure paths as programs, run on
both runtimes: ``tests/test_gcs_fault_tolerance.py``, ``test_chaos.py``
and ``test_oom_monitor.py``, one group each ("gcs", "chaos", "oom").

As in ``torch_api_programs``: each program is the body of the reference
test of the same name (without ``test_``), on the cluster its fixture
starts, and returns what that test asserts on as plain values. The GCS
programs build that fixture's control plane from the runtime's own
modules: a ``GcsServer`` in this process or a ``GcsProcess`` child, each
with durable storage, and one ``NodeManager`` of 2 CPUs and no
accelerator (``num_tpus=0`` on ``ray_tpu``, ``num_gpus=0`` on the port).
The tests that read the GCS's or the node manager's internals, or time
the port's own teardown, run on the port alone, in their files.

The module imports neither runtime, nor jax. ``python
tests/torch_failure_programs.py GROUP DIR`` runs a group on ``ray_tpu``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import signal
import threading
import time

import numpy as np

from torch_api_programs import (MiB, cluster, main, pinned, raises,
                                run_programs, sub)


def _priv(rt, name):
    return sub(rt, f"_private.{name}")


def _no_accel(accel):
    """The node manager's keyword for "no accelerator" on each runtime."""
    return {"num_tpus" if accel == "TPU" else "num_gpus": 0}


def _wait_until(pred, timeout=30.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if pred():
                return
        except Exception:
            pass
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {msg}")


def _rejoined(rt):
    w = _priv(rt, "worker").require_worker()
    _wait_until(lambda: any(n["Alive"] for n in w.nodes()),
                msg="node rejoined restarted gcs")


class _Counter:
    def __init__(self):
        self.n = 0

    def incr(self):
        self.n += 1
        return self.n


class _SlowCounter(_Counter):
    def slow(self, delay):
        time.sleep(delay)
        return "done"


# --------------------------------------------------------------------- gcs


def external_cluster(prog):
    """The program runs on the reference's ``external_cluster`` fixture: a
    ``GcsServer`` in this process with durable storage, one node manager,
    the driver attached by address. It takes ``(rt, state)``; ``state``
    holds "gcs", "nm" and "storage"."""
    @functools.wraps(prog)
    def run(rt, accel, tmp):
        storage = os.path.join(tmp, f"{prog.__name__}.db")
        gcs = _priv(rt, "gcs").GcsServer(storage_path=storage)
        nm = _priv(rt, "node_manager").NodeManager(
            gcs_address=gcs.address,
            session_dir=os.path.join(tmp, f"{prog.__name__}_session"),
            num_cpus=2, resources=None, object_store_memory=64 * MiB,
            is_head=True, node_name="head", **_no_accel(accel))
        rt.init(address=gcs.address)
        state = {"gcs": gcs, "nm": nm, "storage": storage}
        try:
            return prog(rt, state)
        finally:
            rt.shutdown()
            with contextlib.suppress(Exception):
                state["nm"].shutdown()
            with contextlib.suppress(Exception):
                state["gcs"].close()
    return run


def subprocess_cluster(prog):
    """The reference's ``subprocess_cluster`` fixture: the GCS as its own
    process (``GcsProcess``) with durable storage, one node manager, the
    driver attached by address. ``state`` holds "gcs_proc", "nm",
    "storage" and "session"."""
    @functools.wraps(prog)
    def run(rt, accel, tmp):
        storage = os.path.join(tmp, f"{prog.__name__}.db")
        session = os.path.join(tmp, f"{prog.__name__}_session")
        gcs_proc = _priv(rt, "gcs_launcher").GcsProcess(
            session_dir=session, storage_path=storage)
        nm = _priv(rt, "node_manager").NodeManager(
            gcs_address=gcs_proc.address, session_dir=session,
            num_cpus=2, resources=None, object_store_memory=64 * MiB,
            is_head=True, node_name="head", **_no_accel(accel))
        rt.init(address=gcs_proc.address)
        state = {"gcs_proc": gcs_proc, "nm": nm, "storage": storage,
                 "session": session}
        try:
            return prog(rt, state)
        finally:
            with contextlib.suppress(Exception):
                rt.shutdown()
            with contextlib.suppress(Exception):
                state["nm"].shutdown()
            with contextlib.suppress(Exception):
                state["gcs_proc"].terminate()
    return run


@external_cluster
def gcs_crash_restart_preserves_actor_and_kv(rt, st):
    """kill -9 the head GCS mid-run with a detached actor alive; restart on
    the same port with the same storage; the driver reconnects, the node
    rejoins, and the SAME actor process answers with its state."""
    cls = rt.remote(_Counter)
    c = cls.options(name="ctr", lifetime="detached").remote()
    first = rt.get(c.incr.remote(), timeout=30)
    kv = _priv(rt, "worker").require_worker().kv()
    kv.put(b"survives", b"yes")

    port = int(st["gcs"].address.rsplit(":", 1)[1])
    st["gcs"].crash_for_test()
    # Restart the head on the same port with the same durable storage.
    st["gcs"] = _priv(rt, "gcs").GcsServer(port=port,
                                          storage_path=st["storage"])
    # The node manager rejoins on its own and re-reports the live actor.
    _rejoined(rt)
    # Named-actor directory restored; the handle routes to the SAME process
    # (state 1 -> 2, not a restarted 0 -> 1); the original handle too.
    h = rt.get_actor("ctr")
    return (first, kv.get(b"survives"), rt.get(h.incr.remote(), timeout=30),
            rt.get(c.incr.remote(), timeout=30))


@external_cluster
def gcs_restart_task_submission_works(rt, st):
    """Plain tasks submit and run after a head restart (function store
    restored from persistence)."""
    @rt.remote
    def add(a, b):
        return a + b

    before = rt.get(add.remote(1, 2), timeout=30)
    port = int(st["gcs"].address.rsplit(":", 1)[1])
    st["gcs"].crash_for_test()
    st["gcs"] = _priv(rt, "gcs").GcsServer(port=port,
                                          storage_path=st["storage"])
    _rejoined(rt)
    return before, rt.get(add.remote(40, 2), timeout=30)


@subprocess_cluster
def gcs_subprocess_sigkill_mid_workload_recovers(rt, st):
    """SIGKILL the real GCS process with an actor-task get in flight;
    restart it on the same port from the same storage. The NM redials and
    re-registers, the driver's channel redials on its next call, the
    in-flight get COMPLETES, and durable state (KV, detached named actor:
    the same process, not a restarted one) survives."""
    cls = rt.remote(_SlowCounter)
    c = cls.options(name="ctr", lifetime="detached").remote()
    first = rt.get(c.incr.remote(), timeout=30)
    kv = _priv(rt, "worker").require_worker().kv()
    kv.put(b"survives", b"yes")

    # In-flight get across the kill: the actor task takes ~4s; the GCS
    # dies ~0.5s in and comes back ~2s in.
    ref = c.slow.remote(4.0)
    result = {}

    def bg_get():
        t0 = time.time()
        try:
            result["value"] = rt.get(ref, timeout=90)
        except BaseException as e:  # surfaced in the result
            result["error"] = repr(e)
        result["elapsed"] = time.time() - t0

    th = threading.Thread(target=bg_get)
    th.start()
    time.sleep(0.5)

    port = int(st["gcs_proc"].address.rsplit(":", 1)[1])
    os.kill(st["gcs_proc"].pid, signal.SIGKILL)
    st["gcs_proc"].proc.wait(timeout=30)
    time.sleep(1.0)
    st["gcs_proc"] = _priv(rt, "gcs_launcher").GcsProcess(
        session_dir=st["session"], port=port, storage_path=st["storage"])
    _rejoined(rt)

    # The in-flight get completed, within a load-aware budget (on a single
    # core the re-registration storm timeshares with the 4 s actor task).
    budget = 60 if (os.cpu_count() or 1) >= 2 else 85
    th.join(timeout=budget + 25)
    hung = th.is_alive()

    @rt.remote
    def add(a, b):
        return a + b

    h = rt.get_actor("ctr")
    return (first, hung, result.get("value"), result.get("error"),
            result.get("elapsed", budget) < budget, kv.get(b"survives"),
            rt.get(h.incr.remote(), timeout=30),
            rt.get(add.remote(40, 2), timeout=30))


# ------------------------------------------------------------------- chaos

CHAOS = dict(num_cpus=4, object_store_memory=128 * MiB)


def _nm(rt):
    return _priv(rt, "worker")._global_cluster.nm


def two_node(prog):
    """The reference's ``two_node`` fixture: a 2-CPU head and a 2-CPU
    worker node, connected; the program takes ``(rt, cluster, other)``."""
    @functools.wraps(prog)
    def run(rt, accel, tmp):
        c = sub(rt, "cluster_utils").Cluster(
            initialize_head=True, head_node_args={"num_cpus": 2})
        try:
            other = c.add_node(num_cpus=2)
            c.connect(object_store_memory=64 * MiB)
            c.wait_for_nodes()
            return prog(rt, c, other)
        finally:
            rt.shutdown()
            c.shutdown()
    return run


@cluster(**CHAOS)
def sigkill_worker_mid_task_retries(rt, accel, tmp):
    """A task whose worker is SIGKILLed mid-run retries and succeeds."""
    @rt.remote(max_retries=2)
    def slow_square(x):
        time.sleep(1.0)
        return x * x

    ref = slow_square.remote(7)
    pid = _priv(rt, "test_utils").kill_any_busy_worker(_nm(rt))
    return pid is not None, rt.get(ref, timeout=60)


@cluster(**CHAOS)
def sigkill_worker_no_retries_raises(rt, accel, tmp):
    # The kill waits for the task to start: ``kill_any_busy_worker`` counts
    # a leased worker as busy from its grant on, and a kill before the
    # caller's dial leaves no task on the worker to fail (ROADMAP §3).
    started = os.path.join(tmp, "sigkill_worker_no_retries.started")

    @rt.remote(max_retries=0)
    def hang():
        open(started, "w").close()
        time.sleep(30)

    ref = hang.remote()
    _wait_until(lambda: os.path.exists(started), msg="the task to start")
    pid = _priv(rt, "test_utils").kill_any_busy_worker(_nm(rt))
    return pid is not None, raises(lambda: rt.get(ref, timeout=60),
                                   rt.exceptions.WorkerCrashedError)


@cluster(**CHAOS)
def sigkill_actor_process_restarts(rt, accel, tmp):
    @rt.remote(max_restarts=1)
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def pid(self):
            return os.getpid()

    c = Counter.remote()
    first = rt.get(c.incr.remote(), timeout=30)
    pid1 = rt.get(c.pid.remote(), timeout=30)
    os.kill(pid1, signal.SIGKILL)
    # The restarted instance answers with fresh state in a new process.
    deadline = time.time() + 60
    while True:
        try:
            n = rt.get(c.incr.remote(), timeout=30)
            break
        except rt.exceptions.RayActorError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)
    return first, n, rt.get(c.pid.remote(), timeout=30) != pid1


@cluster(**CHAOS)
def actor_task_ordering_across_restart(rt, accel, tmp):
    """Per-caller FIFO holds across an actor restart: the journal of a
    restarted actor is a contiguous 1..k prefix per incarnation, with no
    reordering inside an incarnation."""
    @rt.remote(max_restarts=1, max_task_retries=-1)
    class Journal:
        def __init__(self):
            self.log = []

        def append(self, i):
            self.log.append(i)
            return (os.getpid(), len(self.log), i)

        def pid(self):
            return os.getpid()

    j = Journal.remote()
    pid1 = rt.get(j.pid.remote(), timeout=30)
    refs = [j.append.remote(i) for i in range(20)]
    time.sleep(0.15)  # let a few land in the first incarnation
    os.kill(pid1, signal.SIGKILL)
    out = rt.get(refs, timeout=120)

    # Group by incarnation (pid); within each, the actor-local sequence
    # numbers must be contiguous from 1 and the submitted order preserved.
    by_pid = {}
    for pid, seq, i in out:
        by_pid.setdefault(pid, []).append((seq, i))
    return (len(by_pid) <= 2,
            all([s for s, _ in e] == sorted(s for s, _ in e)
                for e in by_pid.values()),
            all([i for _, i in e] == sorted(i for _, i in e)
                for e in by_pid.values()),
            sorted(i for _, _, i in out))


@two_node
def cross_node_fetch(rt, c, other):
    """An object produced on node B is pulled to the driver's node."""
    @rt.remote
    def produce():
        return np.arange(1 << 18, dtype=np.uint8)

    ref = produce.options(scheduling_strategy=pinned(rt, other)).remote()
    out = rt.get(ref, timeout=60)
    # It was fetched into the driver's local store.
    return (out.shape, _priv(rt, "worker").require_worker().store.contains(
        ref.binary()))


@two_node
def node_kill_mid_task_reschedules(rt, c, other):
    """Killing a node abruptly mid-task reschedules the task elsewhere."""
    ss = sub(rt, "util.scheduling_strategies")

    @rt.remote(max_retries=2)
    def slow():
        time.sleep(1.0)
        return os.getpid()

    ref = slow.options(scheduling_strategy=ss.NodeAffinitySchedulingStrategy(
        node_id=other.node_id, soft=True)).remote()
    time.sleep(0.3)  # task starts on `other`
    _priv(rt, "test_utils").kill_node(c, other)
    return isinstance(rt.get(ref, timeout=60), int)


@two_node
def node_kill_lineage_rebuild(rt, c, other):
    """Abrupt node death + lost objects: lineage rebuilds on survivors."""
    @rt.remote(max_retries=2)
    def produce(seed):
        return np.full((1 << 15,), seed, np.uint8)

    refs = [produce.options(scheduling_strategy=pinned(rt, other)).remote(i)
            for i in range(3)]
    vals = rt.get(refs, timeout=60)
    first = [int(v[0]) for v in vals]
    del vals
    _priv(rt, "test_utils").kill_node(c, other)
    rebuilt = rt.get(refs, timeout=60)
    return first, [int(v[0]) for v in rebuilt]


@cluster(**CHAOS)
def chaos_monkey_task_sweep(rt, accel, tmp):
    """A NodeKiller SIGKILLing busy workers every 300ms cannot lose any
    retriable task."""
    @rt.remote(max_retries=5)
    def work(i):
        time.sleep(0.1)
        return i * 2

    killer = _priv(rt, "test_utils").NodeKiller([_nm(rt)],
                                                period_s=0.3).start()
    try:
        refs = [work.remote(i) for i in range(40)]
        out = rt.get(refs, timeout=180)
    finally:
        killer.stop()
    return out, bool(killer.kills)


@cluster(**CHAOS)
def spill_restore_under_churn(rt, accel, tmp):
    """Objects spilled under memory pressure restore correctly while new
    puts keep forcing eviction/spill."""
    rng = np.random.default_rng(0)
    blobs = [rng.integers(0, 255, 6 << 20, dtype=np.uint8)
             for _ in range(8)]  # 8 x 6MiB through a 128MiB store w/ churn
    refs = [rt.put(b) for b in blobs]
    # Churn: more puts to push earlier objects toward spill.
    churn = [rt.put(rng.integers(0, 255, 6 << 20, dtype=np.uint8))
             for _ in range(12)]
    same = [bool(np.array_equal(rt.get(r, timeout=60), blobs[i]))
            for i, r in enumerate(refs)]
    del churn
    return same


# --------------------------------------------------------------------- oom

# The reference's tight_memory_cluster: about 250 MiB above the workers'
# baseline, so one 500 MiB allocation trips the monitor.
TIGHT = dict(num_cpus=2, object_store_memory=32 * MiB, _system_config={
    "memory_monitor_refresh_ms": 100,
    "memory_limit_bytes": 600 * MiB,
    "memory_usage_threshold": 0.8,
})


@cluster(**TIGHT)
def oom_hog_killed_node_survives(rt, accel, tmp):
    """A task allocating past the limit is killed (surfacing the OOM cause)
    instead of wedging the node; ordinary work keeps running."""
    @rt.remote(max_retries=0)
    def hog():
        ballast = np.ones(500 * MiB // 8, np.float64)
        time.sleep(30)
        return ballast.nbytes

    err = raises(lambda: rt.get(hog.remote(), timeout=90),
                 rt.exceptions.WorkerCrashedError, "memory monitor")

    @rt.remote
    def fine():
        return 42

    return err, rt.get(fine.remote(), timeout=60)


@cluster(**TIGHT)
def oom_kill_is_retriable(rt, accel, tmp):
    """A retriable task killed by the monitor is retried; when it behaves
    on retry (allocation released), it completes."""
    marker = os.path.join(tmp, f"oom_marker_{os.getpid()}")

    @rt.remote(max_retries=2)
    def sometimes_hog():
        if not os.path.exists(marker):
            open(marker, "w").write("x")
            ballast = np.ones(500 * MiB // 8, np.float64)
            time.sleep(30)
            return int(ballast[0])
        return 7

    try:
        return rt.get(sometimes_hog.remote(), timeout=120)
    finally:
        with contextlib.suppress(OSError):
            os.remove(marker)


PROGRAMS = {
    "gcs": [gcs_crash_restart_preserves_actor_and_kv,
            gcs_restart_task_submission_works,
            gcs_subprocess_sigkill_mid_workload_recovers],
    "chaos": [sigkill_worker_mid_task_retries,
              sigkill_worker_no_retries_raises,
              sigkill_actor_process_restarts,
              actor_task_ordering_across_restart, cross_node_fetch,
              node_kill_mid_task_reschedules, node_kill_lineage_rebuild,
              chaos_monkey_task_sweep, spill_restore_under_churn],
    "oom": [oom_hog_killed_node_survives, oom_kill_is_retriable],
}


def run_group(rt, accel, group, tmp):
    return run_programs(PROGRAMS[group], rt, accel, tmp)


if __name__ == "__main__":
    main(run_group)
