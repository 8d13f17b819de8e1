"""``tests/test_worker_pool.py`` on the port's runtime, test by test, with
GPUs where the reference declares TPU chips.

The reference's cluster holds two TPU chips; the port's twin declares two
GPUs (``init(num_gpus=2)``: no CUDA is touched). A worker bound to GPUs is
spawned with ``CUDA_VISIBLE_DEVICES`` (the reference's
``TPU_VISIBLE_CHIPS``) and parks in the node manager's ``_gpu_idle``
(the reference's ``_tpu_idle``), keyed by its GPU shape and its spawn
environment. The reclaim for a bigger shape, the env-var split and the
actor creation rate give values: they run as programs of
``torch_sched_programs``' "worker_pool" group on both runtimes, each with
its own accelerators, and the results must be equal. The reuse and the
prestarted pool read the node manager, and run on the port alone.
"""

import time

import pytest

import torch_sched_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, ports_runtime, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "worker_pool", tmp_path_factory)


@pytest.fixture
def gpu_cluster():
    with ports_runtime(num_cpus=2, num_gpus=2,
                       object_store_memory=64 * 1024 * 1024) as rt:
        yield rt


def _head_nm():
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod._global_cluster.nm


def test_tpu_worker_reused_same_shape(gpu_cluster):
    """A second GPU task of the same shape reuses the parked worker (same
    pid, same CUDA_VISIBLE_DEVICES) instead of paying a fresh spawn and
    CUDA init."""
    rt = gpu_cluster

    @rt.remote(num_gpus=1)
    def gpu_pid():
        import os
        return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

    pid1, devices1 = rt.get(gpu_pid.remote(), timeout=60)
    pid2, devices2 = rt.get(gpu_pid.remote(), timeout=60)
    assert pid1 == pid2
    assert devices1 == devices2 and devices1 is not None
    nm = _head_nm()
    assert any(pool for pool in nm._gpu_idle.values())


def test_tpu_pool_reclaim_for_bigger_shape(results):
    assert same_result(results, "tpu_pool_reclaim_for_bigger_shape") == \
        (True, ["0", "1"])


def test_tpu_worker_not_shared_across_env_vars(results):
    assert same_result(results, "tpu_worker_not_shared_across_env_vars") \
        == (None, "x", True, True)


def test_actor_served_from_prestarted_pool(gpu_cluster):
    """Plain actors take over a prestarted pool worker (no cold spawn)
    and the pool refills in the background."""
    rt = gpu_cluster
    nm = _head_nm()
    deadline = time.time() + 30
    while time.time() < deadline:   # wait for the prestarted pool
        with nm._lock:
            pool_pids = {w.proc.pid for w in nm._workers.values()
                         if not w.dedicated}
        if len(pool_pids) >= 2 and nm._idle:
            break
        time.sleep(0.1)
    assert pool_pids

    @rt.remote
    class A:
        def pid(self):
            import os
            return os.getpid()

    a = A.remote()
    actor_pid = rt.get(a.pid.remote(), timeout=30)
    assert actor_pid in pool_pids   # took over a prestarted worker
    # Pool refills to max_pool in the background.
    deadline = time.time() + 30
    while time.time() < deadline:
        with nm._lock:
            n = len([w for w in nm._workers.values()
                     if not w.dedicated and w.state != "dead"])
        if n >= nm._max_pool:
            break
        time.sleep(0.1)
    assert n >= nm._max_pool


def test_actor_create_rate_improved(results):
    assert same_result(results, "actor_create_rate_improved") == \
        ([1] * 6, True)


def test_mirrors_every_reference_test():
    assert_mirrored("worker_pool")
