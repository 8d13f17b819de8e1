"""``tests/test_scheduler_scale.py`` on the port's runtime.

Scheduler ready-queue indexing: with thousands of infeasible tasks queued
(one shape), feasible work schedules with one bucket check per event,
counted as placement attempts on the GCS. It reads the GCS's queue and
its ``_pick_node``, so it runs on the port alone. The cluster declares no
GPU (``num_gpus=0``), so the queued ``num_gpus=1`` tasks are infeasible
on any host, as on the reference's CPU-only cluster.
"""

import time

import pytest

import ray_tpu_torch
from torch_mirror import assert_mirrored
from torch_runtimes import deadline


@pytest.fixture(autouse=True)
def _bounded(monkeypatch):
    """Each test under ``deadline``, its workers on one thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with deadline(what="a test on the port's runtime"):
        yield


@pytest.fixture
def ray_2cpu():
    ctx = ray_tpu_torch.init(num_cpus=2, num_gpus=0,
                             object_store_memory=64 * 1024 * 1024)
    yield ctx
    ray_tpu_torch.shutdown()


def test_blocked_queue_does_not_tax_scheduling(ray_2cpu):
    """With thousands of infeasible tasks queued (one shape), feasible
    work schedules with O(1) bucket checks per event — measured by
    counting placement attempts, not wall clock."""
    from ray_tpu_torch._private import worker as worker_mod

    gcs = worker_mod._global_cluster.gcs

    @ray_tpu_torch.remote
    def wants_gpu():
        return "never"

    @ray_tpu_torch.remote
    def cpu_work(i):
        return i

    n_blocked = 3000
    blocked = [wants_gpu.options(num_gpus=1).remote()
               for _ in range(n_blocked)]
    # Let the queue build up.
    deadline = time.time() + 30
    while len(gcs._queued_tasks) < n_blocked and time.time() < deadline:
        time.sleep(0.05)
    assert len(gcs._queued_tasks) >= n_blocked

    # Count placement attempts while 50 feasible tasks run to completion.
    counter = {"n": 0}
    orig = gcs._pick_node

    def counting_pick(*a, **k):
        counter["n"] += 1
        return orig(*a, **k)

    gcs._pick_node = counting_pick
    try:
        out = ray_tpu_torch.get([cpu_work.remote(i) for i in range(50)],
                          timeout=120)
    finally:
        gcs._pick_node = orig
    assert out == list(range(50))
    # An O(queue) rescan would re-examine the 3000 blocked specs on every
    # event (>100k attempts); the indexed queue checks one bucket head.
    assert counter["n"] < 3000, (
        f"{counter['n']} placement attempts for 50 tasks with a blocked "
        f"queue of {n_blocked} — scheduler is O(queue)")
    del blocked


def test_mirrors_every_reference_test():
    assert_mirrored("scheduler_scale")
