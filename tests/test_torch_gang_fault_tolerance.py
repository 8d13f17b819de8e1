"""Gang fault tolerance of the port's trainer on the ``ray_tpu`` runtime:
twins of tests/test_gang_fault_tolerance.py's SIGKILL, poll-isolation,
poisoning and chaos-sweep tests (the sweep marked ``slow``, as the
reference's is), with a ``torch_dist`` (gloo) gang on the CPU, and the
supervisor's GCS death push (``ray_tpu.experimental.pubsub``, the
runtime's own). The checks live in ``torch_gang_programs``;
``test_torch_gang_fault_tolerance_port`` runs them on ``ray_tpu_torch``.
"""

import pytest
import torch

import ray_tpu
import ray_tpu.experimental.pubsub  # noqa: F401  (the runtime's death push)
import torch_gang_programs as gp
from ray_tpu_torch._private.config import config


@pytest.fixture(scope="module")
def gang_cluster():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    old = {k: config.get(k) for k in gp.GANG_KNOBS}
    for k, v in gp.GANG_KNOBS.items():
        config.set(k, v)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ctx = ray_tpu.init(num_cpus=4,
                           object_store_memory=128 * 1024 * 1024)
    yield ctx
    ray_tpu.shutdown()
    for k, v in old.items():
        config.set(k, v)
    torch.set_num_threads(threads)


def test_sigkill_one_rank_mid_step_recovers(gang_cluster, tmp_path):
    gp.sigkill_one_rank_mid_step_recovers(ray_tpu, tmp_path)


def test_worker_group_poll_isolates_dead_rank(gang_cluster):
    gp.worker_group_poll_isolates_dead_rank(ray_tpu)


def test_poison_unwedges_pending_collective(gang_cluster):
    gp.poison_unwedges_pending_collective(ray_tpu)


def test_death_push_detects_sigkill(gang_cluster, tmp_path):
    gp.death_push_detects_sigkill(ray_tpu, tmp_path)


def test_death_push_before_first_heartbeat(gang_cluster, tmp_path):
    gp.death_push_before_first_heartbeat(ray_tpu, tmp_path)


@pytest.mark.slow
def test_chaos_gang_killer_sweep(gang_cluster, tmp_path):
    gp.chaos_gang_killer_sweep(ray_tpu, tmp_path)
