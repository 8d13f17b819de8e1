"""The reference's tests of the runtime core's scheduling as programs, run
on both runtimes: ``tests/test_lease.py`` and ``test_worker_pool.py``, one
group each.

As in ``torch_api_programs``: each program is the body of the reference
test of the same name (without ``test_``), on the cluster its fixture
starts, and returns what the test asserts on as plain values. The worker
pool's programs declare the runtime's accelerators, two TPU chips on
``ray_tpu`` and two GPUs on the port, and read the variable each runtime
sets on a worker it binds them to (``TPU_VISIBLE_CHIPS`` or
``CUDA_VISIBLE_DEVICES``). The tests that read the lease manager, the
node manager's pools or the GCS run on the port alone, in their files.

The module imports neither runtime, nor jax. ``python
tests/torch_sched_programs.py GROUP DIR`` runs a group on ``ray_tpu``.
"""

from __future__ import annotations

import functools
import os
import signal
import time

from torch_api_programs import MiB, T, cluster, main, raises, run_programs
from torch_cluster_programs import _accel

LEASE = dict(num_cpus=4, object_store_memory=128 * MiB)


def _visible(accel):
    """The variable a worker bound to accelerators sees them in."""
    return "TPU_VISIBLE_CHIPS" if accel == "TPU" else "CUDA_VISIBLE_DEVICES"


# ------------------------------------------------------------------- lease


@cluster(**LEASE)
def lease_results_and_errors(rt, accel, tmp):
    @rt.remote
    def sq(x):
        return x * x

    out = rt.get([sq.remote(i) for i in range(100)], timeout=T)

    @rt.remote
    def boom():
        raise ValueError("lease boom")

    return out, raises(lambda: rt.get(boom.remote(), timeout=T), ValueError,
                       "lease boom")


@cluster(**LEASE)
def lease_dep_chain(rt, accel, tmp):
    """ObjectRef args between lease tasks resolve (and stay pinned)."""
    @rt.remote
    def inc(x):
        return x + 1

    ref = inc.remote(0)
    for _ in range(10):
        ref = inc.remote(ref)
    return rt.get(ref, timeout=T)


@cluster(**LEASE)
def lease_worker_death_falls_back(rt, accel, tmp):
    """Killing the leased worker mid-task: the spec falls back to the
    scheduled path and still completes (at-least-once, like task retry)."""
    @rt.remote(max_retries=2)
    def slow_pid(sec):
        time.sleep(sec)
        return os.getpid()

    # Warm a lease, find its worker pid.
    pid0 = rt.get(slow_pid.remote(0.0), timeout=T)
    ref = slow_pid.remote(3.0)
    time.sleep(0.5)   # task is now running on the leased worker
    os.kill(pid0, signal.SIGKILL)
    # The lease conn drops; the spec is resubmitted via the GCS.
    return rt.get(ref, timeout=60) != pid0


@cluster(**LEASE)
def lease_capacity_denial_falls_back(rt, accel, tmp):
    """More parallel tasks than CPUs: overflow runs via the scheduled
    path (lease requests denied at capacity) and everything completes."""
    @rt.remote
    def busy(x):
        time.sleep(0.1)
        return x

    return rt.get([busy.remote(i) for i in range(40)], timeout=90)


@cluster(**LEASE)
def lease_cancel(rt, accel, tmp):
    @rt.remote
    def forever():
        time.sleep(600)

    ref = forever.remote()
    time.sleep(0.6)   # let it reach the leased worker
    rt.cancel(ref)
    return raises(lambda: rt.get(ref, timeout=30),
                  rt.exceptions.TaskCancelledError)


@cluster(**LEASE)
def lease_objects_visible_to_other_clients(rt, accel, tmp):
    """Locations flushed to the GCS: an actor (separate process) can get
    an object produced by the driver's lease task."""
    @rt.remote
    def make():
        return {"k": 41}

    ref = make.remote()

    @rt.remote
    class Reader:
        def read(self, r):
            return r["k"] + 1

    return rt.get(Reader.remote().read.remote(ref), timeout=T)


@cluster(**LEASE)
def lease_fairness_actor_not_starved(rt, accel, tmp):
    """Sustained lease traffic saturating every CPU does not starve the
    classic path: an actor created mid-stream still comes up."""
    @rt.remote
    def busy(x):
        time.sleep(0.05)
        return x

    stream = [busy.remote(i) for i in range(120)]   # > 4 CPUs of work

    @rt.remote
    class Probe:
        def ping(self):
            return "up"

    probe = Probe.remote()
    return (rt.get(probe.ping.remote(), timeout=60),
            rt.get(stream, timeout=120))


@cluster(**LEASE)
def lease_fast_result_not_stuck_behind_slow(rt, accel, tmp):
    """A fast task's result reaches the caller promptly even when a long
    task runs right behind it on the same leased worker."""
    @rt.remote
    def job(t):
        time.sleep(t)
        return t

    fast = job.remote(0.05)
    slow = job.remote(20)
    t0 = time.time()
    ready, not_ready = rt.wait([fast, slow], num_returns=1, timeout=10)
    prompt = time.time() - t0 < 5
    rt.cancel(slow, force=True)
    return ready == [fast] and not_ready == [slow], prompt


# ------------------------------------------------------------- worker pool


def accelerator_cluster(prog):
    """The reference's ``tpu_cluster`` fixture: 2 CPUs and two of the
    runtime's accelerators."""
    @functools.wraps(prog)
    def run(rt, accel, tmp):
        rt.init(num_cpus=2, object_store_memory=64 * MiB, **_accel(accel, 2))
        try:
            return prog(rt, accel, tmp)
        finally:
            rt.shutdown()
    return run


@accelerator_cluster
def tpu_pool_reclaim_for_bigger_shape(rt, accel, tmp):
    """When free accelerators cannot cover a larger request, parked
    accelerator-bound workers are evicted and their devices reassigned: a
    parked pool never wedges work of another shape."""
    var = _visible(accel)

    @rt.remote(**_accel(accel, 1))
    def one():
        return os.getpid()

    pid_small = rt.get(one.remote(), timeout=T)

    @rt.remote(**_accel(accel, 2))
    def two():
        return os.getpid(), os.environ.get(var)

    pid_big, devices = rt.get(two.remote(), timeout=60)
    return pid_big != pid_small, sorted(devices.split(","))


@accelerator_cluster
def tpu_worker_not_shared_across_env_vars(rt, accel, tmp):
    """Tasks with different runtime_env env_vars never share a parked
    worker (the env is burned in at spawn)."""
    @rt.remote(**_accel(accel, 1))
    def probe():
        return os.getpid(), os.environ.get("MARK")

    @rt.remote(**_accel(accel, 1), runtime_env={"env_vars": {"MARK": "x"}})
    def probe_marked():
        return os.getpid(), os.environ.get("MARK")

    pid_a, mark_a = rt.get(probe.remote(), timeout=T)
    pid_b, mark_b = rt.get(probe_marked.remote(), timeout=60)
    # Same-env resubmission reuses its own worker.
    pid_b2, _ = rt.get(probe_marked.remote(), timeout=60)
    return mark_a, mark_b, pid_a != pid_b, pid_b2 == pid_b


@accelerator_cluster
def actor_create_rate_improved(rt, accel, tmp):
    """Pool-served actor creation sustains more than one actor a second,
    sequentially."""
    @rt.remote
    class P:
        def ping(self):
            return 1

    t0 = time.time()
    n = 6
    pings = []
    for _ in range(n):
        p = P.remote()
        pings.append(rt.get(p.ping.remote(), timeout=30))
    rate = n / (time.time() - t0)
    return pings, rate > 1.0


PROGRAMS = {
    "lease": [lease_results_and_errors, lease_dep_chain,
              lease_worker_death_falls_back,
              lease_capacity_denial_falls_back, lease_cancel,
              lease_objects_visible_to_other_clients,
              lease_fairness_actor_not_starved,
              lease_fast_result_not_stuck_behind_slow],
    "worker_pool": [tpu_pool_reclaim_for_bigger_shape,
                    tpu_worker_not_shared_across_env_vars,
                    actor_create_rate_improved],
}


def run_group(rt, accel, group, tmp):
    return run_programs(PROGRAMS[group], rt, accel, tmp)


if __name__ == "__main__":
    main(run_group)
