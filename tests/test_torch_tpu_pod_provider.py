"""``tests/test_tpu_pod_provider.py`` on the port's runtime, test by test.

The port's counterpart of the reference's TPU-pod provider is
``ray_tpu_torch/autoscaler/gpu_pool_provider.py``: GPU host pools, each
granted or deleted whole, where the reference has TPU slices. Each test's
body runs as a program of ``torch_libs_programs``' "tpu_pod_provider"
group on both runtimes, each on its own head-only cluster, with GPUs
where the reference declares TPU chips; the results must be equal and
pass the reference's assertions. The scale-up program waits, with a
deadline, for the GCS to see the pools' hosts go before it reads the
cluster's accelerators (the reference's test reads them once, before).
"""

import pytest

import torch_libs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "tpu_pod_provider", tmp_path_factory)


def test_two_slice_scale_up_and_slice_affine_pg(results):
    """Gang demand launches two pools, whose hosts carry their pool's
    label; the cluster has 16 accelerators; a task on each returns; idle
    pools go whole and the accelerators return to 0."""
    launched, ready, pools, total, n_tasks, left, after = same_result(
        results, "two_slice_scale_up_and_slice_affine_pg")
    assert launched and ready
    assert pools == 2 and total == 16.0
    assert n_tasks == 2
    assert left == [] and after == 0.0


def test_capacity_gated_fifo_granting(results):
    """Requests beyond capacity queue and are granted FIFO as capacity
    frees; pending requests count as non-terminated."""
    states, both, left = same_result(results, "capacity_gated_fifo_granting")
    assert states == ["ACTIVE", "WAITING_FOR_RESOURCES", "ACTIVE"]
    assert both
    assert left == []


def test_mirrors_every_reference_test():
    assert_mirrored("tpu_pod_provider")
