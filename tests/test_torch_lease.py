"""``tests/test_lease.py`` on the port's runtime, test by test.

The tests whose result is a value run as programs of
``torch_sched_programs``' "lease" group on both runtimes (each on its own
4-CPU cluster): the results must be equal and pass the reference's
assertions. The tests that read the driver's lease manager (its shapes,
leases and task map, the grant histogram) run on the port alone; so does
the off-switch case, which reads that no lease manager exists.
"""

import time

import pytest

import torch_sched_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, ports_runtime, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "lease", tmp_path_factory)


@pytest.fixture
def lease_cluster():
    with ports_runtime(num_cpus=4,
                       object_store_memory=128 * 1024 * 1024) as rt:
        yield rt


def _lease_mgr():
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod.global_worker()._lease_mgr


def test_lease_reuse_same_worker(lease_cluster):
    """Sequential same-shape tasks reuse one leased worker (one pid)."""
    rt = lease_cluster

    @rt.remote
    def pid():
        import os
        return os.getpid()

    pids = {rt.get(pid.remote(), timeout=60) for _ in range(10)}
    assert len(pids) == 1, pids
    lm = _lease_mgr()
    assert lm is not None
    key = (("CPU", 1.0),)
    assert key in lm._shapes and len(lm._shapes[key].leases) >= 1


def test_lease_results_and_errors(results):
    out, err = same_result(results, "lease_results_and_errors")
    assert out == [i * i for i in range(100)]
    assert err is not None and err[1] and err[2], err


def test_lease_dep_chain(results):
    assert same_result(results, "lease_dep_chain") == 11


def test_lease_idle_return_releases_resources(lease_cluster):
    """After the idle timeout, leases are returned and the GCS resource
    view recovers to full capacity."""
    from ray_tpu_torch._private.config import config

    rt = lease_cluster

    @rt.remote
    def nop():
        return None

    rt.get([nop.remote() for _ in range(20)], timeout=60)
    lm = _lease_mgr()
    deadline = time.time() + float(config.lease_idle_timeout_s) + 6
    while time.time() < deadline:
        if not any(st.leases for st in lm._shapes.values()):
            break
        time.sleep(0.2)
    assert not any(st.leases for st in lm._shapes.values())
    # The GCS view recovers via the NM's async resource reports.
    deadline = time.time() + 10
    avail = {}
    while time.time() < deadline:
        avail = rt.available_resources()
        if avail.get("CPU", 0) == 4.0:
            break
        time.sleep(0.2)
    assert avail.get("CPU", 0) == 4.0, avail


def test_lease_worker_death_falls_back(results):
    assert same_result(results, "lease_worker_death_falls_back") is True


def test_lease_capacity_denial_falls_back(results):
    assert same_result(results, "lease_capacity_denial_falls_back") == \
        list(range(40))


def test_lease_cancel(results):
    err = same_result(results, "lease_cancel")
    assert err is not None and err[1], err


def test_lease_objects_visible_to_other_clients(results):
    assert same_result(results,
                       "lease_objects_visible_to_other_clients") == 42


def test_lease_disabled_still_works(monkeypatch):
    """The classic path is intact when leases are off."""
    from ray_tpu_torch._private.config import config

    monkeypatch.setenv("RAY_TPU_TORCH_LEASE_ENABLED", "0")
    config.set("lease_enabled", False)
    try:
        with ports_runtime(num_cpus=2,
                           object_store_memory=64 * 1024 * 1024) as rt:
            @rt.remote
            def sq(x):
                return x * x

            assert rt.get([sq.remote(i) for i in range(10)], timeout=60) == \
                [i * i for i in range(10)]
            assert _lease_mgr() is None
    finally:
        config.set("lease_enabled", True)


def test_lease_force_cancel_kills_worker(lease_cluster):
    """force=True on a lease task kills the worker process and the ref
    resolves to TaskCancelledError, never a hang or a resubmission."""
    rt = lease_cluster

    @rt.remote
    def stuck():
        import time as _t
        _t.sleep(600)

    ref = stuck.remote()
    deadline = time.time() + 30
    lm = _lease_mgr()
    while time.time() < deadline:   # wait until it's running on a lease
        if ref.task_id().binary() in lm._task_lease:
            break
        time.sleep(0.1)
    time.sleep(0.5)
    rt.cancel(ref, force=True)
    with pytest.raises((rt.exceptions.TaskCancelledError,
                        rt.exceptions.WorkerCrashedError)):
        rt.get(ref, timeout=30)


def test_lease_fairness_actor_not_starved(results):
    assert same_result(results, "lease_fairness_actor_not_starved") == \
        ("up", list(range(120)))


def test_lease_revoke_drains_without_double_execution(lease_cluster,
                                                      tmp_path):
    """Fairness revocation is a policy decision, not a failure: tasks in
    flight on the revoked worker run exactly once, a max_retries=0 task
    sees no WorkerCrashedError, and the worker is surrendered only after
    its batch drains."""
    rt = lease_cluster
    marker = tmp_path / "runs.txt"

    @rt.remote(max_retries=0)
    def side_effect(path, sec):
        import time as _t
        with open(path, "a") as f:
            f.write("ran\n")
        _t.sleep(sec)
        return "done"

    # Warm the lease, then put a slow side-effecting task in flight.
    assert rt.get(side_effect.remote(str(marker), 0.0), timeout=60) == "done"
    ref = side_effect.remote(str(marker), 2.0)
    lm = _lease_mgr()
    key = (("CPU", 1.0),)
    deadline = time.time() + 10
    while time.time() < deadline:
        st = lm._shapes.get(key)
        if st and any(l.pending for l in st.leases):
            break
        time.sleep(0.05)
    st = lm._shapes.get(key)
    lease = next(l for l in st.leases if l.pending)
    lm.revoke(lease.lease_id)
    # No WorkerCrashedError, no re-execution.
    assert rt.get(ref, timeout=30) == "done"
    assert marker.read_text().count("ran") == 2  # warm-up + the one task
    # The drained lease is eventually dropped (worker surrendered).
    deadline = time.time() + 15
    while time.time() < deadline:
        if lease not in (lm._shapes.get(key).leases
                         if lm._shapes.get(key) else []):
            break
        time.sleep(0.1)
    st = lm._shapes.get(key)
    assert st is None or lease not in st.leases


def test_infeasible_queued_task_does_not_block_leases(lease_cluster):
    """A permanently unplaceable queued task does not deny lease grants
    or thrash healthy leases: CPU tasks keep the direct transport."""
    rt = lease_cluster

    @rt.remote(resources={"no_such_resource": 1})
    def never():
        return None

    _parked = never.remote()   # queues in the GCS forever  # noqa: F841

    @rt.remote
    def pid():
        import os
        return os.getpid()

    time.sleep(0.5)   # let the infeasible spec reach the GCS queue
    pids = {rt.get(pid.remote(), timeout=60) for _ in range(10)}
    assert len(pids) == 1, pids   # direct transport engaged + stable
    lm = _lease_mgr()
    st = lm._shapes.get((("CPU", 1.0),))
    assert st is not None and any(not l.dead for l in st.leases)


def test_lease_grants_are_local_first(lease_cluster):
    """With local scheduling on (default), steady-state leases come from
    the caller's own node manager, and the grant-latency histogram
    records them under source="local"."""
    from ray_tpu_torch._private.lease import _grant_latency_hist

    rt = lease_cluster

    @rt.remote
    def nop():
        return None

    rt.get([nop.remote() for _ in range(10)], timeout=60)
    lm = _lease_mgr()
    leases = [l for st in lm._shapes.values() for l in st.leases]
    assert leases and any(l.local for l in leases)
    assert any(name.endswith("_count") and tags.get("source") == "local"
               and value >= 1
               for name, tags, value in _grant_latency_hist().samples())


def test_lease_fast_result_not_stuck_behind_slow(results):
    assert same_result(results,
                       "lease_fast_result_not_stuck_behind_slow") == \
        (True, True)


def test_mirrors_every_reference_test():
    assert_mirrored("lease")
