"""The port's repairs of faults it shares with the reference's runtime
core, each with the test that would have caught it (ROADMAP §3).

1. A copy the object directory still lists on the caller's own node, but
which is gone from its store (deleted or evicted) and was never spilled:
the reference's ``get`` asks its node manager to restore it, fails, and
asks the GCS again, which names the same node, for ever, past any
``timeout`` (``ray_tpu/_private/worker.py:1012``, ``:1220``). The port's
``_pull_objects`` drops such a stale entry from the directory when the
node manager answers that it has the object neither in its store nor on
disk, so the next wait sees the object lost: a task's result is rebuilt
from its lineage, a ``put`` object fails as lost. A restore that fails
(a full store, a timed-out request) leaves the entry, and the wait
retries. And ``ensure_local`` raises
``GetTimeoutError`` at its deadline however the pull fails. A pull from a
node that is gone, before the GCS knows it, retried the refused
connection for ``protocol.connect``'s 30 s (the reference's ``get`` of a
lost object took 30 s against its 20 s timeout under load); the port's
fails within ``_FETCH_CONNECT_S`` and asks the GCS again.

2. A burst submitted while a shape's first grants are pending: the
reference's lease manager sends every spec of it after the template
warms down the scheduled path (``ray_tpu/_private/lease.py``
``classic_route``), where it waits in the GCS's queue behind the caller's
own grants, and the GCS's fairness pass revokes the caller's local leases
until it places. The port queues what the pending grants can take
(``lease_pipeline_depth`` each); what a flood submits beyond that, or
while the shape is inside its denial window, still takes the blob route
(``submit_classic_patch``).

3. ObjectRefs nested inside a task's args (a list of refs): both
runtimes pinned only the top-level refs while a task was in flight, and
kept a nested ref alive only through ``free_grace_s`` (1 s) after the
caller dropped it. A task that waited longer than that in a queue (a
busy node, a busy actor, a worker still starting under load) found its
nested objects freed, and its ``get`` of them waited past any timeout
(``test_torch_basic.py::test_nested_refs_not_resolved`` failed so under
load). The port's specs carry those ids (``nested_deps``), pinned and
released with the args (``task_spec.pinned_deps``); they are still not
waited for.

4. The same for an actor's constructor: the GCS holds an actor's args
until the actor is placed, and a ref nested in them lived only through
``free_grace_s``, so an actor that waited longer for a node found its
nested objects freed. ``ActorCreationSpec`` carries ``nested_deps`` too,
and the GCS pins them, with the top-level args, from registration until
the constructor has run with no restart left, or the actor has died: a
restartable actor that loses its node and waits for another still finds
them, and a GCS that restarts pins them again for the actors it restores.
"""

import os
import time

import numpy as np
import pytest

from torch_runtimes import deadline, ports_runtime

MiB = 1024 * 1024


@pytest.fixture
def two_nodes(monkeypatch):
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with deadline(120, what="the two-node cluster"):
        c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
        other = c.add_node(num_cpus=2)
        c.connect(object_store_memory=64 * MiB)
        c.wait_for_nodes()
        try:
            yield rt, c, other
        finally:
            rt.shutdown()
            c.shutdown()


def test_result_whose_pulled_copy_is_gone_is_rebuilt(two_nodes, tmp_path):
    """A result pulled to the head, its head copy deleted, its producing
    node removed: ``get`` rebuilds it on the head by re-running its task,
    within its timeout."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    rt, c, other = two_nodes
    runs = tmp_path / "runs"

    @rt.remote(max_retries=2)
    def produce(path):
        with open(path, "a") as f:
            f.write(rt.get_runtime_context().get_node_id() + "\n")
        return np.full(MiB, 7, np.uint8)

    ref = produce.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        node_id=other.node_id, soft=False)).remote(str(runs))
    assert int(rt.get(ref, timeout=60)[0]) == 7
    w = worker_mod.require_worker()
    assert w.store.contains(ref.binary())      # pulled to the head
    w.store.delete(ref.binary())
    c.remove_node(other)
    t0 = time.time()
    out = rt.get(ref, timeout=30)
    assert time.time() - t0 < 30
    assert out.shape == (MiB,) and int(out[0]) == 7
    assert runs.read_text().split() == [other.node_id, c.nodes[0].node_id]


def test_pull_from_a_removed_node_fails_fast(two_nodes, monkeypatch):
    """The GCS learns of the removed node 1.5 s late, so the first wait
    still names it as the holder: the pull's refused connection fails at
    once, and the ``get`` ends as lost well within its timeout."""
    from ray_tpu_torch._private import gcs as gcs_mod
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    rt, c, other = two_nodes
    late = gcs_mod.GcsServer._handle_disconnect

    def handle_late(self, conn):
        time.sleep(1.5)
        return late(self, conn)

    monkeypatch.setattr(gcs_mod.GcsServer, "_handle_disconnect",
                        handle_late)

    @rt.remote
    class Putter:
        def make(self):
            return [rt.put(np.ones(1 << 14, np.uint8))]

    p = Putter.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        node_id=other.node_id, soft=False)).remote()
    (ref,) = rt.get(p.make.remote(), timeout=60)
    assert rt.wait([ref], timeout=60, fetch_local=False)[0] == [ref]
    c.remove_node(other)
    t0 = time.time()
    with pytest.raises(Exception, match="lost"):
        rt.get(ref, timeout=20)
    assert time.time() - t0 < 10


def test_put_object_whose_only_copy_is_gone_fails_as_lost():
    """A ``put`` object has no lineage: its deleted only copy fails the
    ``get`` as lost, at once, rather than outliving its timeout."""
    with ports_runtime(num_cpus=2, object_store_memory=64 * MiB) as rt:
        from ray_tpu_torch._private import worker as worker_mod

        w = worker_mod.require_worker()
        ref = rt.put(np.ones(MiB, np.uint8))
        w.store.delete(ref.binary())
        t0 = time.time()
        with pytest.raises(Exception, match="lost"):
            rt.get(ref, timeout=20)
        assert time.time() - t0 < 20


def test_get_raises_at_its_timeout_when_a_pull_keeps_failing(monkeypatch):
    """With the stale entry left in the directory (its removal dropped),
    ``get`` still raises ``GetTimeoutError`` at its timeout."""
    with ports_runtime(num_cpus=2, object_store_memory=64 * MiB) as rt:
        from ray_tpu_torch._private import worker as worker_mod

        w = worker_mod.require_worker()
        notify = w.gcs.notify
        monkeypatch.setattr(w.gcs, "notify", lambda mtype, payload=None: (
            None if mtype == "remove_object_location"
            else notify(mtype, payload)))
        ref = rt.put(np.ones(MiB, np.uint8))
        w.store.delete(ref.binary())
        t0 = time.time()
        with pytest.raises(rt.exceptions.GetTimeoutError):
            rt.get(ref, timeout=2)
        assert time.time() - t0 < 10


def test_spilled_put_object_survives_a_failed_restore():
    """The node manager's restore fails once (its store is full): the
    spill file is still there, so ``get`` retries and reads the value,
    rather than dropping the node from the directory and failing the
    ``put`` object as lost."""
    from ray_tpu_torch.object_store import plasma

    with ports_runtime(num_cpus=2, object_store_memory=64 * MiB) as rt:
        from ray_tpu_torch._private import worker as worker_mod

        nm = worker_mod._global_cluster.nm
        value = np.arange(MiB // 8, dtype=np.int64)
        ref = rt.put(value)
        assert nm._spill_one(ref.binary()) > 0
        assert not worker_mod.require_worker().store.contains(ref.binary())
        restore = nm._on_restore_object
        failed = []

        def restore_once_full(conn, p, msg_id):
            if not failed:
                failed.append(p["object_id"])
                raise plasma.StoreFullError("store full during restore")
            return restore(conn, p, msg_id)

        nm._on_restore_object = restore_once_full
        np.testing.assert_array_equal(rt.get(ref, timeout=20), value)
        assert failed == [ref.binary()]


def _deferred_lease_requests(monkeypatch):
    """Hold every lease request the caller makes until ``release()``."""
    from ray_tpu_torch._private import lease as lease_mod

    held = []
    request = lease_mod.LeaseManager._request_lease
    monkeypatch.setattr(lease_mod.LeaseManager, "_request_lease",
                        lambda self, key: held.append((self, key)))

    def release():
        monkeypatch.setattr(lease_mod.LeaseManager, "_request_lease",
                            request)
        while held:
            lm, key = held.pop(0)
            request(lm, key)

    return release


def _count_blob_submits(monkeypatch):
    from ray_tpu_torch._private import lease as lease_mod

    seen = []
    patch = lease_mod.LeaseManager.submit_classic_patch

    def spy(self, tpl, tid_bytes, *a, **k):
        seen.append(tid_bytes)
        return patch(self, tpl, tid_bytes, *a, **k)

    monkeypatch.setattr(lease_mod.LeaseManager, "submit_classic_patch", spy)
    return seen


def test_flood_past_pending_grants_takes_the_blob_route(monkeypatch):
    """A flood submitted while its shape's grants are pending: the first
    ``lease_max_workers_per_shape`` x ``lease_pipeline_depth`` tasks queue
    for those grants, and every task after them is sent as template-patched
    bytes. All of them run."""
    release = _deferred_lease_requests(monkeypatch)
    blob = _count_blob_submits(monkeypatch)
    with ports_runtime(num_cpus=2, object_store_memory=64 * MiB) as rt:
        from ray_tpu_torch._private import worker as worker_mod

        @rt.remote
        def square(i):
            return i * i

        n = 260
        refs = [square.remote(i) for i in range(n)]
        lm = worker_mod.global_worker()._lease_mgr
        (st,) = lm._shapes.values()
        taken = lm._max_per_shape * lm._depth
        assert (st.requesting, len(st.queue)) == (lm._max_per_shape, taken)
        assert len(blob) == n - taken
        release()
        assert rt.get(refs, timeout=60) == [i * i for i in range(n)]


def test_shape_in_its_denial_window_takes_the_blob_route(monkeypatch):
    """A shape the cluster just denied a lease: once its submit template
    is warm, every submission skips the lease queue for the blob route."""
    from ray_tpu_torch._private import lease as lease_mod
    from ray_tpu_torch._private.task_spec import normalize_resources

    blob = _count_blob_submits(monkeypatch)
    with ports_runtime(num_cpus=2, object_store_memory=64 * MiB) as rt:
        from ray_tpu_torch._private import worker as worker_mod

        @rt.remote(num_cpus=0.5)
        def square(i):
            return i * i

        lm = worker_mod.global_worker()._ensure_lease_mgr()
        key = tuple(sorted(normalize_resources(0.5).items()))
        st = lm._shapes[key] = lease_mod._ShapeState()
        st.denied_until = time.monotonic() + 60
        n = 20
        refs = [square.remote(i) for i in range(n)]
        warm = worker_mod.SubmitTemplate.WARMUP_CALLS
        assert len(blob) == n - (warm - 1)
        assert not st.queue and not st.leases and st.requesting == 0
        assert rt.get(refs, timeout=60) == [i * i for i in range(n)]


def test_burst_within_pending_grants_stays_on_leases(monkeypatch):
    """8 tasks on 4 CPUs, submitted while the first grants are pending:
    none goes to the GCS's queue, no local lease is revoked, and the
    caller holds live local leases after them."""
    from ray_tpu_torch._private import gcs as gcs_mod
    from ray_tpu_torch._private import node_manager as nm_mod

    seen = {"classic": 0, "revokes": 0}
    for name in ("_h_submit_task", "_h_submit_task_batch"):
        orig = getattr(gcs_mod.GcsServer, name)

        def spy(self, *a, _orig=orig, **k):
            seen["classic"] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(gcs_mod.GcsServer, name, spy)
    revoke = nm_mod.NodeManager._on_revoke_local_lease

    def counting_revoke(self, *a, **k):
        seen["revokes"] += 1
        return revoke(self, *a, **k)

    monkeypatch.setattr(nm_mod.NodeManager, "_on_revoke_local_lease",
                        counting_revoke)
    with ports_runtime(num_cpus=4, object_store_memory=64 * MiB) as rt:
        from ray_tpu_torch._private import worker as worker_mod

        @rt.remote
        def nop():
            return None

        assert rt.get([nop.remote() for _ in range(8)], timeout=60) == \
            [None] * 8
        lm = worker_mod.global_worker()._lease_mgr
        leases = [l for st in lm._shapes.values() for l in st.leases
                  if l.local and not l.dead]
    assert seen == {"classic": 0, "revokes": 0}, seen
    assert leases


def _nested_after_a_queue(rt, f, *blockers):
    """``f``'s result for a list of three ``put`` refs the caller drops at
    once, submitted behind ``blockers``, which hold its slot for 3 s."""
    out = f.remote([rt.put(i) for i in range(3)])
    value = rt.get(out, timeout=30)
    rt.get(list(blockers), timeout=30)
    return value


def test_nested_refs_survive_a_queued_task():
    with ports_runtime(num_cpus=1, object_store_memory=64 * MiB) as rt:
        @rt.remote
        def block(s):
            time.sleep(s)
            return 1

        @rt.remote
        def f(lst):
            return [rt.get(r, timeout=10) for r in lst]

        assert _nested_after_a_queue(rt, f, block.remote(3.0)) == [0, 1, 2]


def test_nested_refs_survive_a_queued_actor_call():
    with ports_runtime(num_cpus=2, object_store_memory=64 * MiB) as rt:
        @rt.remote
        class A:
            def block(self, s):
                time.sleep(s)
                return 1

            def f(self, lst):
                return [rt.get(r, timeout=10) for r in lst]

        a = A.remote()
        assert rt.get(a.block.remote(0), timeout=60) == 1
        assert _nested_after_a_queue(rt, a.f, a.block.remote(3.0)) == \
            [0, 1, 2]


def test_nested_refs_survive_an_actor_waiting_for_a_node():
    """An actor whose constructor takes ``[ref]`` and needs a resource
    that only a node added 3 s later has: its constructor's ``get``
    returns the value within a bounded time."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    with pytest.MonkeyPatch.context() as mp, \
            deadline(120, what="an actor waiting for a node"):
        mp.setenv("OMP_NUM_THREADS", "1")
        c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
        c.connect(object_store_memory=64 * MiB)
        try:
            @rt.remote(num_cpus=0, resources={"late": 1.0})
            class Holder:
                def __init__(self, refs):
                    self.values = [rt.get(r, timeout=10) for r in refs]

                def values_(self):
                    return self.values

            h = Holder.remote([rt.put(np.arange(4) * 7)])
            time.sleep(3.0)
            c.add_node(num_cpus=1, resources={"late": 1.0})
            got = rt.get(h.values_.remote(), timeout=60)
            assert [v.tolist() for v in got] == [[0, 7, 14, 21]]
        finally:
            rt.shutdown()
            c.shutdown()


def test_nested_refs_survive_an_actor_restarting_on_a_late_node(tmp_path):
    """A restartable actor whose constructor takes ``[ref]`` loses its
    node before the constructor has finished, and the only node that can
    take it again arrives 3.5 s later: the restarted constructor's
    ``get`` still returns the value."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    started = tmp_path / "started"
    with pytest.MonkeyPatch.context() as mp, \
            deadline(120, what="an actor restarting on a late node"):
        mp.setenv("OMP_NUM_THREADS", "1")
        c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
        first = c.add_node(num_cpus=1, resources={"late": 1.0})
        c.connect(object_store_memory=64 * MiB)
        c.wait_for_nodes()
        try:
            # Restarts without limit: the worker's death, the node's, and
            # a re-placement on the node going down may each cost one.
            @rt.remote(num_cpus=0, resources={"late": 1.0}, max_restarts=-1)
            class Holder:
                def __init__(self, refs, path):
                    if not os.path.exists(path):
                        open(path, "w").close()
                        time.sleep(60)   # the first node goes meanwhile
                    self.values = [rt.get(r, timeout=10) for r in refs]

                def values_(self):
                    return self.values

            h = Holder.remote([rt.put(np.arange(4) * 7)], str(started))
            t0 = time.time()
            while not started.exists():
                assert time.time() - t0 < 60, "the constructor never ran"
                time.sleep(0.05)
            c.remove_node(first)
            time.sleep(3.5)
            c.add_node(num_cpus=1, resources={"late": 1.0})
            got = rt.get(h.values_.remote(), timeout=60)
            assert [v.tolist() for v in got] == [[0, 7, 14, 21]]
        finally:
            rt.shutdown()
            c.shutdown()
