"""``tests/test_chunked_pull.py`` on the port's runtime, test by test.

Three tests give values: each runs as a program of
``torch_objects_programs``' "chunked" group on both runtimes (two 2-CPU
nodes, 256 KiB chunks, 4 in flight), and the results must be equal and
pass the reference's assertions, the 16 MiB heap bound included. The
restore from spill drives the head node manager's spill and the driver's
fetch path, and runs on the port alone.
"""

import numpy as np
import pytest

import torch_objects_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import deadline, group_results, same_result

MiB = 1024 * 1024


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "chunked", tmp_path_factory)


@pytest.fixture
def two_node_small_chunks(monkeypatch):
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.config import config
    from ray_tpu_torch.cluster_utils import Cluster

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    # 256 KiB chunks so a few-MiB object exercises many chunks fast.
    config.set("fetch_chunk_bytes", 256 * 1024)
    config.set("pull_max_inflight_chunks", 4)
    with deadline(180, what="the two-node chunked cluster"):
        cluster = Cluster(initialize_head=True, head_node_args={
            "num_cpus": 2, "object_store_memory": 256 * MiB})
        cluster.add_node(num_cpus=2, object_store_memory=256 * MiB)
        cluster.connect(object_store_memory=256 * MiB)
        cluster.wait_for_nodes()
        try:
            yield cluster
        finally:
            rt.shutdown()
            cluster.shutdown()
            config.set("fetch_chunk_bytes", 5 * MiB)
            config.set("pull_max_inflight_chunks", 8)


def test_chunked_pull_roundtrip(results):
    assert same_result(results, "chunked_pull_roundtrip") == [True] * 4


def test_chunked_pull_bounded_memory(results):
    assert same_result(results, "chunked_pull_bounded_memory") == \
        (96 * MiB, True)


def test_concurrent_pulls_do_not_blow_store(results):
    assert same_result(results, "concurrent_pulls_do_not_blow_store") == [
        (s, s, 4 * MiB) for s in range(8)]


def test_chunked_restore_from_spill(two_node_small_chunks):
    """A spilled object on the holder node is served to a remote puller
    by range-reading spill storage (no whole-blob materialization)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker()
    blob = np.arange(2 * MiB, dtype=np.uint8)
    ref = rt.put(blob)
    oid = ref.binary()
    head = two_node_small_chunks.nodes[0]
    # Spill everything spillable on the head node.
    head._spill_bytes(1 << 30)
    assert head._spilled_url(oid), "the object was not spilled"
    # Evict the in-memory copy so the fetch must hit spill storage.
    w.store.delete(oid)
    assert not w.store.contains(oid)
    assert w._fetch_from(head.address, oid)
    got, ok = w.store.get_value(oid, timeout_ms=10_000)
    assert ok
    np.testing.assert_array_equal(got, blob)


def test_mirrors_every_reference_test():
    assert_mirrored("chunked_pull")
