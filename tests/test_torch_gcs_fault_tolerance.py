"""``tests/test_gcs_fault_tolerance.py`` on the port's runtime, test by test.

The restart tests, whose results are values, run as programs of
``torch_failure_programs``' "gcs" group on both runtimes, each on the
control plane its reference fixture builds (a ``GcsServer`` in the
process or a ``GcsProcess`` child, with durable storage, and one node of
2 CPUs and no accelerator: ``num_gpus=0`` where the reference has
``num_tpus=0``). The lockdep guard's check runs on both packages in this
process, the guard switched on for it alone (the reference's conftest
installs its lockdep for the whole module). The tests that read the GCS's
internals, drive its child with the port's lockdep, or time the dead
GCS's error run on the port alone.

The dead-GCS twin also times its cluster's teardown: with the GCS killed
and not restarted, the reference's teardown waits out its 60 s
``gcs_rpc_timeout_s``, and the port's ends within
``DEAD_GCS_TEARDOWN_S``.
"""

import importlib
import time

import pytest

import torch_failure_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result

DEAD_GCS_TEARDOWN_S = 10.0


def _wait_until(pred, timeout=30.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if pred():
                return
        except Exception:
            pass
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "gcs", tmp_path_factory)


def _teardown(state):
    """The reference fixture's teardown, on the port."""
    import ray_tpu_torch

    for close in (ray_tpu_torch.shutdown, state["nm"].shutdown,
                  state["gcs_proc"].terminate):
        try:
            close()
        except Exception:
            pass


@pytest.fixture
def subprocess_cluster(tmp_path):
    """The REAL split topology: GCS as its own subprocess (own interpreter)
    with durable storage, one NodeManager and the driver attached purely by
    address. A test may tear it down itself (``state["down"]``)."""
    import ray_tpu_torch
    from ray_tpu_torch._private.gcs_launcher import GcsProcess
    from ray_tpu_torch._private.node_manager import NodeManager

    storage = str(tmp_path / "gcs.db")
    session = str(tmp_path / "session")
    gcs_proc = GcsProcess(session_dir=session, storage_path=storage)
    nm = NodeManager(
        gcs_address=gcs_proc.address,
        session_dir=session,
        num_cpus=2, num_gpus=0, resources=None,
        object_store_memory=64 * 1024 * 1024,
        is_head=True, node_name="head")
    ray_tpu_torch.init(address=gcs_proc.address)
    state = {"gcs_proc": gcs_proc, "nm": nm, "storage": storage,
             "session": session, "down": False}
    yield state
    if not state["down"]:
        _teardown(state)


def test_gcs_crash_restart_preserves_actor_and_kv(results):
    """kill -9 the head GCS mid-run with a detached actor alive; restart on
    the same port with the same storage; the driver reconnects, the node
    rejoins, and the SAME actor process answers with its state."""
    first, kv, by_name, by_handle = same_result(
        results, "gcs_crash_restart_preserves_actor_and_kv")
    assert first == 1
    assert kv == b"yes"          # KV table restored from storage
    assert by_name == 2          # state 1 -> 2, not a restarted 0 -> 1
    assert by_handle == 3        # the original handle works too


def test_gcs_restart_task_submission_works(results):
    assert same_result(results, "gcs_restart_task_submission_works") == \
        (3, 42)


# ------------------------------------------- real out-of-process GCS


def test_gcs_subprocess_sigkill_mid_workload_recovers(results):
    """SIGKILL the real GCS process with an actor-task get in flight;
    restart it on the same port from the same storage. The in-flight get
    COMPLETES within its budget, and durable state survives."""
    (first, hung, value, error, in_budget, kv, by_name,
     add) = same_result(results,
                        "gcs_subprocess_sigkill_mid_workload_recovers")
    assert first == 1
    assert not hung, "in-flight get hung across the GCS kill"
    assert value == "done", error
    assert in_budget
    assert kv == b"yes"
    assert by_name == 2
    assert add == 42


def test_gcs_subprocess_dead_typed_error_within_rpc_timeout(
        subprocess_cluster):
    """GCS SIGKILLed and NOT restarted: control RPCs and in-flight gets fail
    with a typed error within ~gcs_rpc_timeout_s — never a hang. The
    cluster's teardown then ends within DEAD_GCS_TEARDOWN_S."""
    import ray_tpu_torch
    from ray_tpu_torch import exceptions
    from ray_tpu_torch._private import protocol
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.config import config
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.worker import ObjectRef

    st = subprocess_cluster
    w = worker_mod.require_worker()
    assert w.kv().put(b"a", b"b")
    old_timeout = config.gcs_rpc_timeout_s
    config.set("gcs_rpc_timeout_s", 5.0)
    try:
        st["gcs_proc"].kill()
        typed = (ConnectionError, protocol.ConnectionClosed, OSError,
                 TimeoutError, exceptions.GetTimeoutError)

        t0 = time.time()
        with pytest.raises(typed):
            w.kv().get(b"a")
        assert time.time() - t0 < 3 * 5.0

        # An in-flight get of an object the dead GCS would have to resolve:
        # typed failure, bounded.
        ref = ObjectRef(ObjectID.from_random())
        t0 = time.time()
        with pytest.raises(typed):
            ray_tpu_torch.get(ref, timeout=3)
        assert time.time() - t0 < 3 * 5.0
    finally:
        config.set("gcs_rpc_timeout_s", old_timeout)
    # The fixture's teardown, here so it is timed, with the timeout back
    # at its default of 60 s as the reference's teardown runs it.
    t0 = time.time()
    st["down"] = True
    _teardown(st)
    took = time.time() - t0
    print(f"teardown with a dead GCS: {took:.2f} s")
    assert took < DEAD_GCS_TEARDOWN_S, \
        f"teardown with a dead GCS took {took:.1f} s"


# ------------------------------- lockdep over the bootstrap/serve loop


def test_blocking_region_guard_detects_held_lock():
    """The runtime guard the launcher plants before child-process waits:
    entering a blocking region while holding a tracked lock is recorded as
    a violation."""
    def check(pkg):
        lockdep = importlib.import_module(f"{pkg}._private.lockdep")
        # The guard is a no-op unless lockdep is installed, which the
        # reference's conftest does for its module; here it is on for this
        # check only, without wrapping the process's lock factories.
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lockdep, "_installed", True)
            lockdep.take_violations()
            lk = lockdep.tracked(key="test_gcs_ft:guard-probe")
            with lk:
                lockdep.note_blocking_region("probe")
            found = lockdep.take_violations()
        return (len(found), "blocking:probe" in str(found[0]),
                "guard-probe" in str(found[0]))

    ref, port = (check(p) for p in ("ray_tpu", "ray_tpu_torch"))
    assert port == ref
    assert port == (1, True, True)


def test_gcs_bootstrap_shutdown_takes_no_shard_lock(tmp_path):
    """Spawn the GCS entrypoint with lockdep enabled IN THE CHILD (shipped
    via the config diff), drive its serve loop, and tear it down gracefully.
    The child asserts its own serve/shutdown path witnessed no lock-order
    cycle — a violated child exits rc=3, so rc==0 IS the assertion."""
    from ray_tpu_torch._private import lockdep, protocol
    from ray_tpu_torch._private.config import config
    from ray_tpu_torch._private.gcs_launcher import GcsProcess

    old = config.lockdep_enabled
    config.set("lockdep_enabled", True)
    try:
        gcs_proc = GcsProcess(session_dir=str(tmp_path / "session"))
        conn = protocol.connect(gcs_proc.address, name="lockdep-probe",
                                timeout=10)
        try:
            assert conn.request("kv_put", {
                "ns": "", "key": b"k", "value": b"v"}, timeout=10)
            assert conn.request("kv_get", {"ns": "", "key": b"k"},
                                timeout=10) == b"v"
            stats = conn.request("control_plane_stats", timeout=10)
            assert stats["gcs_process"]["out_of_process"] is True
            assert stats["gcs_process"]["pid"] == gcs_proc.pid
        finally:
            conn.close()
        rc = gcs_proc.terminate(timeout=30)
        assert rc == 0, (
            f"gcs child exited rc={rc}: lockdep witnessed a violation in "
            f"the serve/shutdown path (rc=3) or the drain failed")
        # The parent's bootstrap/terminate waits ran under the blocking
        # region guard: none with a tracked lock held.
        assert not [v for v in lockdep.take_violations()
                    if "blocking:" in str(v)]
    finally:
        config.set("lockdep_enabled", old)


def test_health_check_marks_wedged_node_dead(tmp_path):
    """A node that stops heartbeating (but keeps its socket open) is
    declared dead by the GCS health checker."""
    from ray_tpu_torch._private.config import config
    from ray_tpu_torch._private.gcs import GcsServer
    from ray_tpu_torch._private.node_manager import NodeManager

    old_period = config.raylet_heartbeat_period_ms
    old_hc = config.health_check_period_ms
    old_thresh = config.health_check_failure_threshold
    config.set("raylet_heartbeat_period_ms", 100)
    config.set("health_check_period_ms", 100)
    config.set("health_check_failure_threshold", 5)
    nm = None
    try:
        gcs = GcsServer()
        nm = NodeManager(
            gcs_address=gcs.address,
            session_dir=str(tmp_path / "session"),
            num_cpus=1, num_gpus=0, resources=None,
            object_store_memory=32 * 1024 * 1024,
            is_head=True, node_name="head")
        _wait_until(lambda: any(n.alive for n in gcs._nodes.values()),
                    msg="node registered")
        # Wedge: stop the heartbeat loop without closing the socket.
        nm._shutdown = True  # heartbeat/reap loops exit; conn stays open
        _wait_until(
            lambda: all(not n.alive for n in gcs._nodes.values()),
            timeout=30,
            msg="gcs declared the silent node dead")
    finally:
        config.set("raylet_heartbeat_period_ms", old_period)
        config.set("health_check_period_ms", old_hc)
        config.set("health_check_failure_threshold", old_thresh)
        try:
            if nm is not None:
                nm._shutdown = False
                nm.shutdown()
        except Exception:
            pass
        gcs.close()


def test_mirrors_every_reference_test():
    assert_mirrored("gcs_fault_tolerance")
