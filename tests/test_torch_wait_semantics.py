"""``tests/test_wait_semantics.py`` on the port's runtime, test by test.

Four tests' results are values: each runs as a program of
``torch_api_programs``' "wait" group on both runtimes (``ray_tpu`` in a
fresh interpreter, then ``ray_tpu_torch`` here, each program on its own
4-CPU cluster); the results must be equal and pass the reference's
assertions. ``test_wait_fetch_local_false_does_not_pull`` reads the
driver's store on a two-node cluster, and runs on the port alone.
"""

import time

import numpy as np
import pytest

import torch_api_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import deadline, group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "wait", tmp_path_factory)


def test_wait_preserves_input_order(results):
    assert same_result(results, "wait_preserves_input_order") == \
        (True, True)


def test_failed_object_counts_as_ready(results):
    ready, not_ready, err = same_result(results,
                                        "failed_object_counts_as_ready")
    assert ready and not_ready
    assert err is not None and err[1] and err[2], err


def test_wait_timeout_zero_is_poll(results):
    assert same_result(results, "wait_timeout_zero_is_poll") == \
        (True, True, True)


def test_wait_fetch_local_false_does_not_pull(monkeypatch):
    """fetch_local=False answers availability without copying the object
    into the caller's store; fetch_local=True pulls it."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with deadline(120, what="the two-node wait"):
        cluster = Cluster(initialize_head=True,
                          head_node_args={"num_cpus": 2})
        other = cluster.add_node(num_cpus=2)
        cluster.connect(object_store_memory=64 * 1024 * 1024)
        cluster.wait_for_nodes()
        try:
            @rt.remote
            def produce():
                return np.ones(1 << 16, np.uint8)

            ref = produce.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=other.node_id, soft=False)).remote()
            w = worker_mod.require_worker()

            ready, _ = rt.wait([ref], timeout=30, fetch_local=False)
            assert ready == [ref]
            assert not w.store.contains(ref.binary())  # stayed remote

            ready, _ = rt.wait([ref], timeout=30, fetch_local=True)
            assert ready == [ref]
            end = time.time() + 10
            while not w.store.contains(ref.binary()) and time.time() < end:
                time.sleep(0.05)
            assert w.store.contains(ref.binary())  # pulled locally
        finally:
            rt.shutdown()
            cluster.shutdown()


def test_wait_duplicate_refs_rejected(results):
    err = same_result(results, "wait_duplicate_refs_rejected")
    assert err is not None and err[1], err


def test_mirrors_every_reference_test():
    assert_mirrored("wait_semantics")
