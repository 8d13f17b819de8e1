"""``tests/test_local_scheduler.py`` on the port's runtime, test by test.

Local-first task scheduling at the node manager with GCS spillback: the
grant-vs-spillback decision matrix, revocation and its backoff, the GCS
view's reconciliation (also after a node manager dies holding grants),
the startup-hang bounds, the daemon pool, the spawn-failure ledger and
the centralized baseline with ``RAY_TPU_TORCH_LOCAL_SCHEDULING_ENABLED=0``.
Every test reads the node manager, the lease manager or the GCS's
resource view, so they run on the port alone, translated name for name;
a GPU shape takes the reference's TPU shape in the decision matrix (GPUs
bind at spawn through the GCS path, so the node manager declines them).
"""

import time

import pytest

import ray_tpu_torch
from torch_mirror import assert_mirrored
from torch_runtimes import deadline
from ray_tpu_torch._private import protocol
from ray_tpu_torch._private.config import config


@pytest.fixture(autouse=True)
def _bounded(monkeypatch):
    """Each test under ``deadline``, its workers on one thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with deadline(what="a test on the port's runtime"):
        yield


@pytest.fixture
def local_cluster():
    ctx = ray_tpu_torch.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    yield ctx
    ray_tpu_torch.shutdown()


def _worker():
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod.global_worker()


def _nm():
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod._global_cluster.nm


def _nm_request(payload, timeout=60):
    w = _worker()
    conn = w.nm_conn(w._own_nm_address())
    return conn.request(protocol.REQUEST_LOCAL_LEASE, payload,
                        timeout=timeout)


def _wait_for(pred, timeout=15, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def test_tasks_granted_locally(local_cluster):
    """The steady-state task path is served by the local scheduler: the
    driver's leases are local grants and the NM counters show it."""
    @ray_tpu_torch.remote
    def pid():
        import os
        return os.getpid()

    pids = {ray_tpu_torch.get(pid.remote()) for _ in range(10)}
    assert len(pids) == 1, pids
    nm = _nm()
    assert nm.local_grants_total >= 1
    lm = _worker()._lease_mgr
    leases = [l for st in lm._shapes.values() for l in st.leases]
    assert leases and all(l.local for l in leases)
    # The stats RPC every observer (microbench, tests) uses.
    stats = _worker().nm_conn(_worker()._own_nm_address()).request(
        protocol.SCHEDULER_STATS, {}, timeout=10)
    assert stats["local_grants_total"] >= 1
    assert stats["local_grants_open"] >= 1


def test_grant_vs_spillback_decision_matrix(local_cluster):
    """Fits-locally -> granted; too big / GPU-shaped / unknown custom
    resource -> declined (None reply = spill back to the GCS)."""
    nm = _nm()
    w = _worker()
    spill0 = nm.local_spillbacks_total
    grant = _nm_request({"client_id": w.client_id,
                         "resources": {"CPU": 1.0}})
    assert grant is not None
    assert grant["node_id"] == nm.node_id
    assert grant["lease_id"].startswith(b"nml:")
    assert grant["worker_id"] and grant["direct_address"]

    # Exceeds the node's capacity: decline.
    assert _nm_request({"client_id": w.client_id,
                        "resources": {"CPU": 64.0}}) is None
    # GPU shapes bind GPUs at spawn via the GCS path: decline.
    assert _nm_request({"client_id": w.client_id,
                        "resources": {"CPU": 1.0, "GPU": 1.0}}) is None
    # A custom resource this node doesn't have: decline.
    assert _nm_request({"client_id": w.client_id,
                        "resources": {"CPU": 1.0, "gadget": 1.0}}) is None
    assert nm.local_spillbacks_total >= spill0 + 3

    w.nm_conn(w._own_nm_address()).notify(
        protocol.RETURN_LOCAL_LEASE,
        {"lease_id": grant["lease_id"], "worker_id": grant["worker_id"]})
    _wait_for(lambda: nm._local_held.is_zero(), msg="ledger released")
    assert not nm._local_grants


def test_revoke_signal_backoff_then_recovers(local_cluster):
    """A GCS revoke_local_lease signal puts overlapping shapes on a
    fairness backoff (declined -> spilled back to the central queue);
    after the window the local path grants again."""
    nm = _nm()
    w = _worker()
    old_backoff = config.local_lease_backoff_s
    config.set("local_lease_backoff_s", 0.4)
    try:
        grant = _nm_request({"client_id": w.client_id,
                             "resources": {"CPU": 1.0}})
        assert grant is not None
        nm._on_revoke_local_lease({"demands": [{"CPU": 1.0}]})
        # Overlapping shape declines during the backoff window.
        assert _nm_request({"client_id": w.client_id,
                            "resources": {"CPU": 1.0}}) is None
        time.sleep(0.6)
        g2 = _nm_request({"client_id": w.client_id,
                          "resources": {"CPU": 1.0}})
        assert g2 is not None
        for g in (grant, g2):
            w.nm_conn(w._own_nm_address()).notify(
                protocol.RETURN_LOCAL_LEASE,
                {"lease_id": g["lease_id"], "worker_id": g["worker_id"]})
        _wait_for(lambda: nm._local_held.is_zero(), msg="ledger released")
    finally:
        config.set("local_lease_backoff_s", old_backoff)


def test_gcs_view_reconciles_local_grants(local_cluster):
    """Central placement sees local grants: available_resources() (the
    GCS's effective view) shrinks while a local grant holds capacity and
    recovers once it is returned — the async resource-delta loop."""
    nm = _nm()
    w = _worker()
    grant = _nm_request({"client_id": w.client_id,
                         "resources": {"CPU": 2.0}})
    assert grant is not None
    _wait_for(lambda: ray_tpu_torch.available_resources().get("CPU") == 2.0,
              msg="GCS view to reflect the local grant")
    w.nm_conn(w._own_nm_address()).notify(
        protocol.RETURN_LOCAL_LEASE,
        {"lease_id": grant["lease_id"], "worker_id": grant["worker_id"]})
    _wait_for(lambda: ray_tpu_torch.available_resources().get("CPU") == 4.0,
              msg="GCS view to recover after the return")
    assert nm._local_held.is_zero()


def test_local_lease_revocation_drains(local_cluster):
    """Revoking a locally-granted lease held by a real LeaseManager:
    the holder drains it, returns it to the NM, and the ledger frees —
    without the GCS ever brokering the lease."""
    @ray_tpu_torch.remote
    def nop():
        return None

    ray_tpu_torch.get([nop.remote() for _ in range(8)])
    nm = _nm()
    lm = _worker()._lease_mgr
    leases = [l for st in lm._shapes.values() for l in st.leases
              if l.local and not l.dead]
    assert leases
    held_before = dict(nm._local_held.to_dict())
    assert any(v > 0 for v in held_before.values())
    nm._on_revoke_local_lease({"demands": [{"CPU": 1.0}]})
    _wait_for(lambda: sum(nm._local_held.to_dict().values())
              < sum(held_before.values()),
              msg="a local grant to drain after revocation")


def test_nm_death_with_outstanding_local_grants():
    """A node manager dies while its local grants hold capacity: the GCS
    drops the node (grants die with it), the cluster view converges to
    the survivors, and scheduling keeps working."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2})
    node2 = cluster.add_node(num_cpus=2)
    try:
        cluster.connect(object_store_memory=64 * 1024 * 1024)
        assert cluster.wait_for_nodes()
        w = _worker()
        conn = w.nm_conn(node2.address)
        grant = conn.request(protocol.REQUEST_LOCAL_LEASE,
                             {"client_id": w.client_id,
                              "resources": {"CPU": 1.0}}, timeout=60)
        assert grant is not None
        _wait_for(lambda: ray_tpu_torch.available_resources().get("CPU") == 3.0,
                  msg="GCS view to reflect node2's local grant")
        cluster.remove_node(node2)   # dies holding the grant
        _wait_for(lambda: ray_tpu_torch.available_resources().get("CPU", 0) == 2.0,
                  timeout=30, msg="GCS view to drop the dead node")

        @ray_tpu_torch.remote
        def sq(x):
            return x * x

        assert ray_tpu_torch.get([sq.remote(i) for i in range(4)],
                           timeout=60) == [0, 1, 4, 9]
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


def test_hung_startup_worker_falls_back_to_gcs(local_cluster):
    """A worker that hangs during startup (the NM's
    deferred lease reply never resolves) must not wedge that shape's
    pipeline — the caller bounds the local grant by the worker-start
    timeout and spills back to the GCS-brokered path."""
    nm = _nm()
    lm = _worker()._lease_mgr
    # Simulate the hang: checkout never replies (the spawned worker is
    # alive but never registers, so the deferred reply is parked forever).
    orig_checkout = nm._checkout_worker
    nm._checkout_worker = lambda *a, **k: None
    lm._worker_timeout = 1.0
    try:
        @ray_tpu_torch.remote(num_cpus=2)
        def two_cpu():
            return "ok"

        t0 = time.time()
        # Before the fix this get wedges: the local-lease future never
        # resolves, the shape's queue never drains, no GCS fallback.
        assert ray_tpu_torch.get(two_cpu.remote(), timeout=30) == "ok"
        assert time.time() - t0 < 30
    finally:
        nm._checkout_worker = orig_checkout
        lm._worker_timeout = float(config.worker_start_timeout_s) + 10.0


def test_nm_reaps_hung_startup_lease_worker(local_cluster):
    """NM-side bound for the same finding: a STARTING worker holding a
    deferred lease reply past worker_start_timeout_s is killed, which
    errors the deferred reply (caller falls back) and releases the
    grant's ledger hold via the normal death path."""
    import subprocess
    import sys as _sys

    from ray_tpu_torch._private import node_manager as nm_mod
    from ray_tpu_torch._private.ids import WorkerID

    nm = _nm()
    old_timeout = config.worker_start_timeout_s
    config.set("worker_start_timeout_s", 0.5)
    proc = subprocess.Popen([_sys.executable, "-c",
                             "import time; time.sleep(300)"])

    errored = []

    class _FakeConn:
        def reply_error(self, msg_id, err):
            errored.append(err)

    handle = nm_mod.WorkerHandle(
        worker_id=WorkerID.from_random().binary(), proc=proc)
    handle.lease_reply = (_FakeConn(), 0)   # deferred reply parked
    handle.busy_since = time.time()
    try:
        with nm._lock:
            nm._workers[handle.worker_id] = handle
        _wait_for(lambda: proc.poll() is not None, timeout=15,
                  msg="hung startup worker to be reaped")
        _wait_for(lambda: errored, timeout=15,
                  msg="deferred lease reply to be errored")
    finally:
        config.set("worker_start_timeout_s", old_timeout)
        try:
            proc.kill()
        except Exception:
            pass
        with nm._lock:
            nm._workers.pop(handle.worker_id, None)


def test_daemon_pool_concurrent_submit_spawns(local_cluster):
    """Two back-to-back submits that both observe one
    idle thread must not BOTH skip the spawn — the idle check-and-reserve
    is atomic under the pool lock, so the second submit spawns and both
    fns run concurrently."""
    import threading

    from ray_tpu_torch._private.worker import _DaemonPool

    pool = _DaemonPool(4, "test-pool")
    warm = threading.Event()
    pool.submit(warm.set)
    assert warm.wait(5)
    _wait_for(lambda: pool._idle == 1, timeout=5, msg="one idle thread")

    release = threading.Event()
    started = [threading.Event(), threading.Event()]

    def blocker(i):
        started[i].set()
        release.wait(30)

    # Back-to-back: with the racy accounting both submits see _idle == 1
    # and neither spawns — the second fn strands behind the first.
    pool.submit(lambda: blocker(0))
    pool.submit(lambda: blocker(1))
    try:
        assert started[0].wait(5), "first submit never ran"
        assert started[1].wait(5), \
            "second submit stranded: spawn/idle race lost a worker"
    finally:
        release.set()


def test_spawn_failure_keeps_local_capacity(local_cluster):
    """_on_create_actor/_on_lease_task must release their
    _local_avail mirror-subtract when _spawn_worker raises — repeated
    spawn failures must not permanently shrink local capacity."""
    from ray_tpu_torch._private.ids import ActorID, JobID
    from ray_tpu_torch._private.task_spec import ActorCreationSpec

    nm = _nm()
    baseline = dict(nm._local_avail.to_dict())

    def boom(*a, **k):
        raise OSError("spawn failed (injected)")

    orig_spawn = nm._spawn_worker
    nm._spawn_worker = boom
    try:
        for _ in range(3):
            spec = ActorCreationSpec(
                actor_id=ActorID.from_random(),
                job_id=JobID.from_random(),
                class_key="nonexistent", args=b"", arg_deps=[],
                resources={"CPU": 1.0},
                # env_vars force the fresh-spawn path (no pooled reuse).
                runtime_env={"env_vars": {"X": "1"}})
            nm._on_create_actor(spec)
        _wait_for(lambda: not nm._res_held_actors,
                  msg="actor holds released after spawn failure")
        assert nm._local_avail.to_dict() == baseline, \
            "spawn failures leaked local capacity"
    finally:
        nm._spawn_worker = orig_spawn


def test_local_scheduling_disabled_is_centralized(monkeypatch):
    """The A/B baseline: toggle off -> no local grants, every placement
    serializes through the GCS (classic path), tasks still complete."""
    monkeypatch.setenv("RAY_TPU_TORCH_LOCAL_SCHEDULING_ENABLED", "0")
    config.set("local_scheduling_enabled", False)
    try:
        ray_tpu_torch.init(num_cpus=2, object_store_memory=64 * 1024 * 1024)

        @ray_tpu_torch.remote
        def sq(x):
            return x * x

        assert ray_tpu_torch.get([sq.remote(i) for i in range(10)]) == \
            [i * i for i in range(10)]
        assert _worker()._lease_mgr is None
        assert _nm().local_grants_total == 0
    finally:
        ray_tpu_torch.shutdown()
        config.set("local_scheduling_enabled", True)


def test_mirrors_every_reference_test():
    assert_mirrored("local_scheduler")
