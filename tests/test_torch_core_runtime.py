"""The port's runtime core (``ray_tpu_torch.init`` and the calls it
exports) against the JAX package's runtime, and its GPUs.

Parity: the programs of ``torch_core_programs`` run on a ``ray_tpu``
cluster in a fresh interpreter, which exits, and then on a
``ray_tpu_torch`` cluster in this process; each program's results must be
equal. The two runtimes never run at once. (In this process, a lock-order
witness that an earlier test module of the worker installed would stop
the reference's placement-group task on a rank inversion of its GCS;
ROADMAP §3.)

GPUs: the port's cluster declares ``num_gpus=2`` on this CPU box, as the
reference's tests declare TPU chips. ``num_gpus=1`` actors get disjoint
whole GPUs through ``CUDA_VISIBLE_DEVICES``, a third waits for a freed one,
GPU workers are spawned (never forked from the zygote) without the JAX/TPU
variables, and the heartbeat reports the GPU free list.
"""

import ast
import os
import pathlib
import subprocess
import sys
import time

import pytest

import torch_core_programs as progs
from torch_runtimes import deadline

NAMES = sorted(progs.PROGRAMS)
CPUS = 8
TESTS = pathlib.Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def cluster():
    """Results of every program on each runtime, one after the other; the
    port's cluster (``num_gpus=2``) stays up for the GPU tests."""
    import ray_tpu_torch

    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(TESTS.parent), str(TESTS)] + [p for p in [os.environ.get(
            "PYTHONPATH")] if p]))
    out = subprocess.run(
        [sys.executable, str(TESTS / "torch_core_programs.py"), str(CPUS)],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        with deadline(what="the port's cluster start"):
            ray_tpu_torch.init(num_cpus=CPUS, num_gpus=2)
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old
    try:
        with deadline(what="the programs on the port's runtime"):
            port = progs.run_all(ray_tpu_torch)
        yield {"ray_tpu": ref, "ray_tpu_torch": port}
    finally:
        with deadline(what="the port's cluster shutdown"):
            ray_tpu_torch.shutdown()


@pytest.mark.parametrize("program", NAMES)
def test_same_results_on_both_runtimes(cluster, program):
    ref = cluster["ray_tpu"][program]
    port = cluster["ray_tpu_torch"][program]
    assert ref[0] == "ok", ref
    assert port == ref


def test_programs_cover_the_runtime_calls():
    assert set(NAMES) == {"tasks", "nested_tasks", "actor_state",
                          "named_actor", "put_get_wait", "errors", "kill",
                          "placement_groups", "runtime_context"}


def test_cluster_resources_count_declared_gpus(cluster):
    import ray_tpu_torch as rt

    assert rt.cluster_resources()["GPU"] == 2.0


def _facts(actor):
    import ray_tpu_torch as rt

    return rt.get(actor.facts.remote(), timeout=60)


def test_gpu_actors_get_disjoint_gpus_and_wait_for_a_freed_one(cluster):
    import ray_tpu_torch as rt

    probe = rt.remote(progs.GpuProbe)
    a = probe.options(num_gpus=1).remote()
    b = probe.options(num_gpus=1).remote()
    fa, fb = _facts(a), _facts(b)
    assert {fa["cuda_visible_devices"], fb["cuda_visible_devices"]} \
        == {"0", "1"}
    c = probe.options(num_gpus=1).remote()
    pending = c.facts.remote()
    ready, _ = rt.wait([pending], timeout=1.5)
    assert not ready, "a third one-GPU actor ran with both GPUs held"
    rt.kill(a)
    fc = rt.get(pending, timeout=60)
    assert fc["cuda_visible_devices"] == fa["cuda_visible_devices"]
    for actor in (b, c):
        rt.kill(actor)


def test_gpu_worker_is_spawned_not_forked_and_clean(cluster):
    """A GPU worker's parent is the node manager (this process), not one of
    its zygotes; a CPU worker sees no GPU. Neither inherits the JAX/TPU
    variables (this process has JAX_PLATFORMS), nor loads ray_tpu or
    jax."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker

    assert os.environ.get("JAX_PLATFORMS") == "cpu"
    zygotes = {z["proc"].pid for z in worker._global_cluster.nm._zygotes}
    assert zygotes, "the node manager runs no zygote"
    gpu = rt.get(rt.remote(progs.process_facts).options(num_gpus=1).remote(),
                 timeout=60)
    cpu = rt.get(rt.remote(progs.process_facts).remote(), timeout=60)
    assert gpu["ppid"] == os.getpid()
    assert gpu["ppid"] not in zygotes
    assert gpu["cuda_visible_devices"] in ("0", "1")
    assert cpu["cuda_visible_devices"] == ""
    for facts in (gpu, cpu):
        assert facts["tpu_vars"] == []
        assert facts["loaded"] == []


def test_task_context_reports_its_gpu(cluster):
    import ray_tpu_torch as rt

    f = rt.remote(progs.task_context).options(num_gpus=1)
    no_actor, _, res = rt.get(f.remote("ray_tpu_torch"), timeout=60)
    assert no_actor and res.get("GPU") == 1.0


def test_heartbeat_reports_gpus(cluster):
    import ray_tpu_torch as rt

    deadline = time.time() + 15
    hw = {}
    while time.time() < deadline:
        hw = rt.nodes()[0].get("Hardware") or {}
        if "gpus_total" in hw:
            break
        time.sleep(0.2)
    assert hw.get("gpus_total") == 2
    assert 0 <= hw.get("gpus_free") <= 2


def test_fractional_gpus_are_refused(cluster):
    import ray_tpu_torch as rt

    with pytest.raises(ValueError, match="whole number"):
        rt.remote(progs.square).options(num_gpus=0.5).remote(1)


def test_detect_num_gpus_reads_the_mask_not_cuda(monkeypatch):
    from ray_tpu_torch._private import worker

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    assert worker.detect_num_gpus() == 2
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert worker.detect_num_gpus() == 0
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    monkeypatch.setenv("PATH", "/nonexistent")
    assert worker.detect_num_gpus() == 0
