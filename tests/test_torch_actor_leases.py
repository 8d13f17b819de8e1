"""``tests/test_actor_leases.py`` on the port's runtime, test by test.

Decentralized actor creation (node-manager-local actor leases): the local
placement's counters and GCS entry, the spillback when the node is full,
a node manager's death with a locally created actor, the driver's
recovery of a lost placement report, and a create/kill race. Every test
reads the node manager or the GCS, so they run on the port alone,
translated name for name. The creation spec of the lost report carries
its class through the port's ``_private/pickler.py`` where the reference
uses cloudpickle.
"""

import gc
import threading
import time

import pytest

import ray_tpu_torch
from torch_mirror import assert_mirrored
from torch_runtimes import deadline
from ray_tpu_torch._private.gcs import DEAD, GcsServer
from ray_tpu_torch._private.node_manager import NodeManager


@pytest.fixture(autouse=True)
def _bounded(monkeypatch):
    """Each test under ``deadline``, its workers on one thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with deadline(what="a test on the port's runtime"):
        yield


def _wait_until(pred, timeout=30, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if pred():
                return
        except Exception:
            pass
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _own_nm():
    # Match the LIVE cluster: earlier tests' (shut down) NodeManagers
    # linger in gc until collected.
    from ray_tpu_torch._private import worker as wm

    w = wm.global_worker()
    return [o for o in gc.get_objects() if isinstance(o, NodeManager)
            and not o._shutdown and o.gcs_address == w.gcs_address][0]


def _gcs():
    from ray_tpu_torch._private import worker as wm

    w = wm.global_worker()
    return [o for o in gc.get_objects() if isinstance(o, GcsServer)
            and o.address == w.gcs_address][0]


@ray_tpu_torch.remote(num_cpus=0)
class Pinger:
    def __init__(self, x=0):
        self.x = x

    def ping(self):
        return self.x


def test_local_creation_happy_path():
    """Eligible actors place through the local NM: no GCS scheduling,
    grant counter bumps, the GCS directory entry is the NM's async
    placement report, and kill returns the local_held resources."""
    ray_tpu_torch.init(num_cpus=4, object_store_memory=64 * 1024 * 1024)
    try:
        nm = _own_nm()
        gcs = _gcs()
        base_grants = nm.local_actor_grants_total
        actors = [Pinger.remote(i) for i in range(8)]
        assert ray_tpu_torch.get([a.ping.remote() for a in actors],
                           timeout=60) == list(range(8))
        assert nm.local_actor_grants_total - base_grants == 8
        # The GCS learned of every placement via actor_placed, flagged
        # as locally-placed (its resources ride the local_held
        # aggregate, never the central ledger).
        with gcs._actor_lock:
            local_entries = [e for e in gcs._actors.values()
                            if e.local_placement and e.state == "ALIVE"]
        assert len(local_entries) >= 8
        for a in actors:
            ray_tpu_torch.kill(a)
        # Death drains both the NM's actor registry and the aggregate.
        _wait_until(lambda: not nm._local_actor_ids,
                    msg="local actor ids drained")
        _wait_until(lambda: nm._local_held.is_zero(),
                    msg="local_held drained after kills")
    finally:
        ray_tpu_torch.shutdown()


def test_ineligible_actor_takes_classic_path():
    """Named actors keep the GCS-scheduled path (name uniqueness is
    central) — and still work."""
    ray_tpu_torch.init(num_cpus=2, object_store_memory=64 * 1024 * 1024)
    try:
        nm = _own_nm()
        base = nm.local_actor_grants_total
        a = Pinger.options(name="pinger-classic").remote(7)
        assert ray_tpu_torch.get(a.ping.remote(), timeout=30) == 7
        assert nm.local_actor_grants_total == base
        got = ray_tpu_torch.get_actor("pinger-classic")
        assert ray_tpu_torch.get(got.ping.remote(), timeout=30) == 7
    finally:
        ray_tpu_torch.shutdown()


def test_spillback_when_node_full():
    """A local decline (no capacity) falls back to the classic
    GCS-scheduled creation; the actor places once capacity frees."""
    ray_tpu_torch.init(num_cpus=4, object_store_memory=64 * 1024 * 1024)
    try:
        nm = _own_nm()

        @ray_tpu_torch.remote(num_cpus=2)
        class Big:
            def ping(self):
                return "big"

        a1 = Big.remote()
        a2 = Big.remote()
        assert ray_tpu_torch.get([a1.ping.remote(), a2.ping.remote()],
                           timeout=60) == ["big", "big"]
        base_spill = nm.local_actor_spillbacks_total
        a3 = Big.remote()
        _wait_until(lambda: nm.local_actor_spillbacks_total > base_spill,
                    msg="local decline recorded")
        # No capacity anywhere: a3 must be pending, not failed.
        ref = a3.ping.remote()
        ready, not_ready = ray_tpu_torch.wait([ref], timeout=1.0)
        assert not ready
        # Free capacity; the GCS-scheduled path places a3.
        ray_tpu_torch.kill(a1)
        assert ray_tpu_torch.get(ref, timeout=60) == "big"
    finally:
        ray_tpu_torch.shutdown()


def test_nm_death_replaces_actor_via_gcs(tmp_path):
    """The node hosting a locally-created actor dies: the GCS (which
    learned of the actor via actor_placed) restarts it on a surviving
    node through the central scheduler."""
    gcs = GcsServer()
    nm_head = NodeManager(
        gcs_address=gcs.address,
        session_dir=str(tmp_path / "s1"),
        num_cpus=2, num_gpus=0, resources=None,
        object_store_memory=64 * 1024 * 1024,
        is_head=True, node_name="head")
    nm2 = NodeManager(
        gcs_address=gcs.address,
        session_dir=str(tmp_path / "s2"),
        num_cpus=2, num_gpus=0, resources=None,
        object_store_memory=64 * 1024 * 1024,
        is_head=False, node_name="side")
    ray_tpu_torch.init(address=gcs.address)
    try:
        # max_restarts=-1 (unlimited): the dying node's worker-death
        # report can race its own node-death detection, burning one
        # restart on a futile same-node re-place first.
        @ray_tpu_torch.remote(num_cpus=0, max_restarts=-1)
        class Survivor:
            def where(self):
                import os
                return os.environ.get("RAY_TPU_TORCH_NODE_ID", "")

        a = Survivor.remote()
        first = ray_tpu_torch.get(a.where.remote(), timeout=60)
        assert first == nm_head.node_id  # placed on the driver's own NM
        aid = a._actor_id.binary()
        with gcs._actor_lock:
            assert gcs._actors[aid].local_placement
        # Kill the hosting node (worker pool dies with it).
        nm_head.shutdown()
        # The GCS restarts the actor centrally on the surviving node.
        _wait_until(lambda: gcs._actors[aid].state == "ALIVE"
                    and gcs._actors[aid].node_id == nm2.node_id,
                    timeout=60, msg="actor re-placed on survivor")
        with gcs._actor_lock:
            assert not gcs._actors[aid].local_placement
        second = ray_tpu_torch.get(a.where.remote(), timeout=60)
        assert second == nm2.node_id
    finally:
        ray_tpu_torch.shutdown()
        for n in (nm_head, nm2):
            try:
                n.shutdown()
            except Exception:
                pass
        gcs.close()


def test_lost_placement_report_recovered_by_driver():
    """NM death before its actor_placed report reaches the GCS: the
    driver's route keeps the creation spec, and resolve_actor's 'actor
    not found' triggers a one-shot re-creation through the GCS."""
    ray_tpu_torch.init(num_cpus=2, object_store_memory=64 * 1024 * 1024)
    try:
        from ray_tpu_torch._private import worker as worker_mod

        w = worker_mod.global_worker()

        # Build a creation spec the GCS never heard of (simulates the
        # lost actor_placed) and park it on the route the way
        # _try_local_create_actor does.
        class Probe:
            def ping(self):
                return "recovered"

        from ray_tpu_torch._private import pickler

        from ray_tpu_torch._private.ids import ActorID
        from ray_tpu_torch._private.task_spec import ActorCreationSpec

        key = w.export_function(pickler.dumps(Probe))
        actor_id = ActorID.of(w.job_id)
        blob, deps = w._serialize_args((), {})
        spec = ActorCreationSpec(
            actor_id=actor_id, job_id=w.job_id, class_key=key,
            args=blob, arg_deps=deps, resources={"CPU": 0.0},
            name=None, namespace=w.namespace, lifetime=None,
            max_restarts=0, max_task_retries=0, max_concurrency=1,
            is_async=False, caller_id=w.client_id,
            scheduling_strategy=None, placement_group_id=None,
            placement_group_bundle_index=-1, runtime_env=None,
            class_name="Probe", sys_path=[], trace_ctx=None)
        aid = actor_id.binary()
        route = w._route_for(aid)
        with w._actor_lock:
            route["create_spec"] = spec
            route["resolving"] = True
        # The GCS does not know this actor: the resolve path must
        # consume create_spec, re-create centrally, and resolve ALIVE.
        w._resolve_actor_route(aid)
        _wait_until(lambda: route.get("address") is not None,
                    timeout=60, msg="recovered actor resolved")
        with w._actor_lock:
            assert "create_spec" not in route  # consumed: one-shot
        refs = w.submit_actor_task(actor_id, "ping", (), {})
        assert ray_tpu_torch.get(refs[0], timeout=60) == "recovered"
    finally:
        ray_tpu_torch.shutdown()


def test_concurrent_create_kill_race():
    """ray.kill can reach the GCS before the NM's actor_placed report.
    The kill is tombstoned and completes when the report arrives — the
    actor must end DEAD, not leak alive forever."""
    ray_tpu_torch.init(num_cpus=2, object_store_memory=64 * 1024 * 1024)
    try:
        gcs = _gcs()
        nm = _own_nm()
        hold = threading.Event()
        orig = gcs._h_actor_placed

        def delayed(conn, p, msg_id):
            # Hold the placement report until the kill has landed (the
            # NM->GCS conn serve thread blocks; bounded by the test).
            hold.wait(10)
            return orig(conn, p, msg_id)

        gcs._h_actor_placed = delayed
        try:
            a = Pinger.remote()
            aid = a._actor_id.binary()
            # The NM granted locally (actor exists there), but the GCS
            # hasn't seen actor_placed yet.
            _wait_until(lambda: aid in nm._actors or aid
                        in nm._local_actor_ids,
                        msg="NM-side actor registered")
            assert aid not in gcs._actors
            ray_tpu_torch.kill(a)   # tombstones at the GCS
            with gcs._actor_lock:
                assert aid in gcs._killed_before_placed
        finally:
            hold.set()
            gcs._h_actor_placed = orig
        _wait_until(lambda: gcs._actors.get(aid) is not None
                    and gcs._actors[aid].state == DEAD,
                    timeout=60, msg="tombstoned kill completed")
        with pytest.raises(ray_tpu_torch.exceptions.RayActorError):
            ray_tpu_torch.get(a.ping.remote(), timeout=30)
        # The NM's local hold drained with the worker.
        _wait_until(lambda: aid not in nm._local_actor_ids,
                    msg="NM local hold released")
    finally:
        ray_tpu_torch.shutdown()


def test_mirrors_every_reference_test():
    assert_mirrored("actor_leases")
