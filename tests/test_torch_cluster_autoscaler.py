"""``tests/test_cluster_autoscaler.py`` on the port's runtime, test by
test: the multi-node ``Cluster`` harness and the autoscaler.

Each test's body runs as a program of ``torch_libs_programs``'
"cluster_autoscaler" group on both runtimes, each on its own cluster, with
GPUs where the reference declares TPU chips; the results must be equal
and pass the reference's assertions. The scale-up program submits its
tasks on the lease path, as the reference does, and reconciles until two
nodes are launched, with a deadline: the reference reconciles once, 0.5 s
after the submit, before a lease's backlog has reached the GCS's demand.
"""

import pytest

import torch_libs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "cluster_autoscaler", tmp_path_factory)


def test_multinode_scheduling(results):
    """A task that asks for a resource only the second node has runs
    there."""
    assert same_result(results, "multinode_scheduling") == (True, True)


def test_remove_node_fails_tasks_over(results):
    assert same_result(results, "remove_node_fails_tasks_over") == \
        (True, True)


def test_autoscaler_scales_up_and_down(results):
    """Two or more nodes launched for the saturated head, every task
    done, and the idle nodes gone."""
    up, ready, done, down = same_result(results,
                                        "autoscaler_scales_up_and_down")
    assert up and ready
    assert done == [1, 1, 1, 1]
    assert down


def test_autoscaler_respects_max_workers(results):
    assert same_result(results, "autoscaler_respects_max_workers") is True


def test_min_workers_launched(results):
    assert same_result(results, "min_workers_launched") == (2, 2)


def test_pg_prefers_single_slice_for_tpu_bundles(results):
    """Two 4-GPU bundles pack onto one of two 2-host pools (slices): the
    gang does not straddle ``slice`` labels."""
    ready, n_slices = same_result(
        results, "pg_prefers_single_slice_for_tpu_bundles")
    assert ready
    assert n_slices == 1


def test_mirrors_every_reference_test():
    assert_mirrored("cluster_autoscaler")
