"""``tests/test_refcount_lineage.py`` on the port's runtime, test by test.

Lineage reconstruction, the lost put and the in-flight actor argument
give values: each runs as a program of ``torch_objects_programs``'
"refcount" group on both runtimes (the reference's two-node ``Cluster``,
or its fast-free single node), and the results must be equal and pass the
reference's assertions. The reclamation tests read the driver's store,
and run on the port alone.
"""

import gc
import time

import numpy as np
import pytest

import torch_objects_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, ports_runtime, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "refcount", tmp_path_factory)


@pytest.fixture
def fast_free_cluster():
    """Single-node cluster with a short free grace so tests run quickly."""
    with ports_runtime(num_cpus=2, object_store_memory=64 * 1024 * 1024,
                       _system_config={"free_grace_s": 0.2,
                                       "refcount_flush_ms": 30}) as rt:
        yield rt


def _wait_until(pred, timeout=15.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _worker():
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod.require_worker()


def test_out_of_scope_ref_reclaims_store(fast_free_cluster):
    """Dropping the last ObjectRef frees the store copy without free()."""
    rt, w = fast_free_cluster, _worker()
    ref = rt.put(np.ones(1 << 20, np.uint8))  # 1 MiB
    oid = ref.binary()
    assert w.store.contains(oid)
    del ref
    gc.collect()
    _wait_until(lambda: not w.store.contains(oid),
                msg="store copy reclaimed after last ref died")


def test_live_ref_is_not_reclaimed(fast_free_cluster):
    rt, w = fast_free_cluster, _worker()
    ref = rt.put(np.ones(1 << 20, np.uint8))
    time.sleep(1.0)  # several grace windows
    assert w.store.contains(ref.binary())
    assert int(rt.get(ref, timeout=60)[0]) == 1


def test_task_result_reclaimed_after_drop(fast_free_cluster):
    rt, w = fast_free_cluster, _worker()

    @rt.remote
    def produce():
        return np.arange(1 << 18, dtype=np.uint8)

    ref = produce.remote()
    assert rt.get(ref, timeout=60).shape == (1 << 18,)
    oid = ref.binary()
    assert w.store.contains(oid)
    del ref
    gc.collect()
    _wait_until(lambda: not w.store.contains(oid),
                msg="task result reclaimed")


def test_borrowed_ref_keeps_object_alive(fast_free_cluster):
    """A ref handed to an actor (pickled -> restored there) keeps the
    object alive after the driver's copy dies."""
    rt, w = fast_free_cluster, _worker()

    @rt.remote
    class Holder:
        def __init__(self):
            self.ref = None

        def hold(self, box):
            self.ref = box[0]  # nested ref: restored + increfed here
            return True

        def read(self):
            return int(rt.get(self.ref)[0])

    h = Holder.remote()
    ref = rt.put(np.full(1 << 16, 7, np.uint8))
    oid = ref.binary()
    assert rt.get(h.hold.remote([ref]), timeout=60)
    del ref
    gc.collect()
    time.sleep(1.0)  # several grace windows: borrower must keep it alive
    assert w.store.contains(oid) or rt.get(h.read.remote(), timeout=60) == 7
    assert rt.get(h.read.remote(), timeout=60) == 7


def test_lineage_reconstruction_on_node_death(results):
    assert same_result(results, "lineage_reconstruction_on_node_death") == \
        (9, 9, (1 << 16,))


def test_chained_lineage_reconstruction(results):
    assert same_result(results, "chained_lineage_reconstruction") == (6, 6)


def test_lost_put_object_fails_cleanly(results):
    located, err = same_result(results, "lost_put_object_fails_cleanly")
    assert located
    assert err is not None and err[2], err


def test_actor_task_args_pinned_in_flight(results):
    assert same_result(results, "actor_task_args_pinned_in_flight") == \
        (1024, "done")


def test_mirrors_every_reference_test():
    assert_mirrored("refcount_lineage")
