"""Gang fault tolerance of the port's trainer on the port's own runtime
(``ray_tpu_torch``): the checks of ``torch_gang_programs`` that
``test_torch_gang_fault_tolerance`` runs on ``ray_tpu`` — SIGKILL
recovery, poll isolation, poisoning of a pending collective, the
supervisor's GCS death push with its pings unable to fail, and the chaos
sweep (marked ``slow``, as the reference's is); and, on this
runtime alone, the group's one read of its ranks' states, which finds a
rank that died before the group subscribed."""

import pytest
import torch

import torch_gang_programs as gp
from ray_tpu_torch._private.config import config
from torch_runtimes import deadline


@pytest.fixture(scope="module")
def rt():
    import ray_tpu_torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    old = {k: config.get(k) for k in gp.GANG_KNOBS}
    for k, v in gp.GANG_KNOBS.items():
        config.set(k, v)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ray_tpu_torch.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    for k, v in old.items():
        config.set(k, v)
    torch.set_num_threads(threads)


def test_sigkill_one_rank_mid_step_recovers(rt, tmp_path):
    with deadline(what="a SIGKILLed rank on the port's runtime"):
        gp.sigkill_one_rank_mid_step_recovers(rt, tmp_path)


def test_worker_group_poll_isolates_dead_rank(rt):
    with deadline(what="poll isolation on the port's runtime"):
        gp.worker_group_poll_isolates_dead_rank(rt)


def test_poison_unwedges_pending_collective(rt):
    with deadline(what="a poisoned collective on the port's runtime"):
        gp.poison_unwedges_pending_collective(rt)


def test_death_push_detects_sigkill(rt, tmp_path):
    with deadline(what="the death push on the port's runtime"):
        took = gp.death_push_detects_sigkill(rt, tmp_path)
    print(f"death push: detected {took:.3f} s after the SIGKILL")


def test_death_push_before_first_heartbeat(rt, tmp_path):
    with deadline(what="an early death push on the port's runtime"):
        gp.death_push_before_first_heartbeat(rt, tmp_path)


def test_death_before_subscription_found_by_the_read(rt, tmp_path):
    with deadline(what="the read of the ranks' states on the port's "
                       "runtime"):
        gp.death_before_subscription_found_by_the_read(rt, tmp_path)


@pytest.mark.slow
def test_chaos_gang_killer_sweep(rt, tmp_path):
    with deadline(450, what="the chaos sweep on the port's runtime"):
        gp.chaos_gang_killer_sweep(rt, tmp_path)
