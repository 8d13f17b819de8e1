"""The port's checks beside its mirrored failure tests
(``test_torch_{gcs_fault_tolerance,chaos,oom_monitor}.py``).

``test_push_during_unsubscribe_does_not_stall_the_connection`` and
``test_killed_node_takes_its_zygotes``: the port's fixes of faults both
runtimes share (ROADMAP §3); each fails on the code before its fix.

``test_usage_report_redials_a_closed_gcs_connection``: the shutdown's
usage report skips only a GCS that does not answer one bounded dial, so
a connection a GCS restart closed still gets its report.

``test_shutdown_with_a_ref_delta_left_and_a_dead_gcs``: the driver's
shutdown flushes its ref tracker's last deltas; with the GCS gone, that
flush redialed it for ``gcs_rpc_timeout_s`` and took 91 s
(``test_torch_gcs_fault_tolerance.py``'s dead-GCS teardown failed so
under load). The shutdown now closes a channel whose GCS does not answer
first.

``test_worker_dead_before_the_lease_dial_falls_back_at_once``: a leased
worker that dies between its grant and the caller's dial; the caller's
task waited out ``protocol.connect``'s 30 s before it fell back (both
runtimes; ROADMAP §3).

``test_workers_fit_the_reference_budget``: the reference's OOM fixture
sizes its 600 MiB limit (threshold 0.8) for workers that import jax. The
port keeps that limit, so the node's usage with its workers up, as the
memory monitor samples it, must stay under the threshold, and a 500 MiB
hog on top of it must cross it.
"""

import os
import signal
import socket
import time

MiB = 1024 * 1024
LIMIT, THRESHOLD, HOG = 600 * MiB, 0.8, 500 * MiB


def test_workers_fit_the_reference_budget():
    import ray_tpu_torch
    from ray_tpu_torch._private import worker as worker_mod

    ray_tpu_torch.init(num_cpus=2, object_store_memory=32 * MiB,
                       _system_config={"memory_monitor_refresh_ms": 100})
    try:
        @ray_tpu_torch.remote
        def pid():
            import os

            time.sleep(0.2)
            return os.getpid()

        # The node's pool (a worker a CPU) is up once tasks have run.
        pids = set(ray_tpu_torch.get([pid.remote() for _ in range(4)],
                                     timeout=60))
        nm = worker_mod._global_cluster.nm
        with nm._lock:
            workers = [w for w in nm._workers.values()
                       if w.proc.poll() is None]
        usage = sum(nm._proc_rss(w.proc.pid) for w in workers) + \
            nm.store.stats().get("used_bytes", 0)
        print(f"{len(workers)} workers ({len(pids)} ran tasks): node usage "
              f"{usage / MiB:.1f} MiB against the threshold "
              f"{LIMIT * THRESHOLD / MiB:.0f} MiB")
        assert usage < LIMIT * THRESHOLD
        assert usage + HOG > LIMIT * THRESHOLD
    finally:
        ray_tpu_torch.shutdown()


def test_push_during_unsubscribe_does_not_stall_the_connection(monkeypatch):
    """A push that reaches the driver while its unsubscribe request waits
    for the GCS's reply must be dispatched, and the reply read, at once:
    the connection's reader thread dispatches pushes, so a request made
    under the dispatch lock waited out ``gcs_rpc_timeout_s`` and stalled
    every other reply on the connection (the gang's re-formed placement
    group among them)."""
    import ray_tpu_torch
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.config import config
    from ray_tpu_torch.experimental import pubsub

    ray_tpu_torch.init(num_cpus=1, object_store_memory=32 * MiB)
    old = config.gcs_rpc_timeout_s
    config.set("gcs_rpc_timeout_s", 10.0)
    try:
        gcs = worker_mod._global_cluster.gcs
        a = pubsub.subscribe("repair-a")
        b = pubsub.subscribe("repair-b")
        unsubscribe = gcs._h_unsubscribe

        def push_first(conn, p, msg_id):
            # A push on another channel goes out ahead of the reply.
            gcs._publish("repair-a", "ping")
            time.sleep(0.5)
            unsubscribe(conn, p, msg_id)

        monkeypatch.setattr(gcs, "_h_unsubscribe", push_first)
        t0 = time.time()
        b.unsubscribe()
        took = time.time() - t0
        assert a.get(timeout=5) == "ping"
        assert took < 5.0, f"unsubscribe took {took:.1f} s"
        a.unsubscribe()
    finally:
        config.set("gcs_rpc_timeout_s", old)
        ray_tpu_torch.shutdown()


def test_killed_node_takes_its_zygotes():
    """``test_utils.kill_node`` removes a node as a SIGKILLed raylet goes,
    with the fork-servers it started: the node leaves the cluster's list,
    so the cluster's shutdown never reaches them, and each chaos test
    that killed a node left four zygote processes running."""
    import ray_tpu_torch
    from ray_tpu_torch._private import test_utils as tu
    from ray_tpu_torch.cluster_utils import Cluster

    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    try:
        other = c.add_node(num_cpus=1)
        c.connect(object_store_memory=32 * MiB)
        c.wait_for_nodes()
        procs = [z["proc"] for z in other._zygotes]
        assert procs
        tu.kill_node(c, other)
        assert all(p.poll() is not None for p in procs), \
            [p.pid for p in procs if p.poll() is None]
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()


def test_usage_report_redials_a_closed_gcs_connection():
    """A driver whose GCS connection is closed while the GCS lives (as a
    GCS restart leaves it until the next call) still writes its usage
    report at shutdown; with the GCS gone, the report is skipped at once
    rather than after ``gcs_rpc_timeout_s``."""
    import ray_tpu_torch
    from ray_tpu_torch._private import usage
    from ray_tpu_torch._private import worker as worker_mod

    ray_tpu_torch.init(num_cpus=1, object_store_memory=32 * MiB)
    try:
        cluster = worker_mod._global_cluster
        session = cluster.session_dir
        path = os.path.join(os.path.dirname(session),
                            f"usage_stats_{os.path.basename(session)}.json")
        gcs = worker_mod.global_worker().gcs
        gcs._conn.close()
        assert gcs.closed and gcs.reachable()
        usage.on_driver_disconnect()
        assert os.path.exists(path)
        os.unlink(path)
        cluster.gcs.crash_for_test()
        deadline = time.time() + 10
        while not gcs.closed and time.time() < deadline:
            time.sleep(0.05)
        t0 = time.time()
        usage.on_driver_disconnect()
        took = time.time() - t0
        assert not gcs.reachable()
        assert not os.path.exists(path)
        assert took < 5.0, f"the skipped report took {took:.1f} s"
        # Another process's listener on the dead GCS's port, which accepts
        # and never answers, is no GCS either.
        host, port = cluster.address.rsplit(":", 1)
        other = socket.socket()
        other.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        other.bind((host, int(port)))
        other.listen(8)
        try:
            t0 = time.time()
            usage.on_driver_disconnect()
            took = time.time() - t0
        finally:
            other.close()
        assert not os.path.exists(path)
        assert took < 5.0, f"the skipped report took {took:.1f} s"
    finally:
        ray_tpu_torch.shutdown()


def test_shutdown_with_a_ref_delta_left_and_a_dead_gcs():
    import ray_tpu_torch
    from ray_tpu_torch._private import worker as worker_mod

    ray_tpu_torch.init(num_cpus=1, object_store_memory=32 * MiB)
    try:
        w = worker_mod.global_worker()
        worker_mod._global_cluster.gcs.crash_for_test()
        deadline = time.time() + 10
        while not w.gcs.closed and time.time() < deadline:
            time.sleep(0.05)
        assert w.gcs.closed
        # The tracker's 100 ms loop takes a first delta and redials the
        # dead GCS with it; a second one waits for the shutdown's flush.
        w._refs.incref(b"\x01" * 28)
        time.sleep(0.5)
        w._refs.incref(b"\x02" * 28)
    finally:
        t0 = time.time()
        ray_tpu_torch.shutdown()
        took = time.time() - t0
    assert took < 10.0, f"shutdown with a dead GCS took {took:.1f} s"


def test_worker_dead_before_the_lease_dial_falls_back_at_once(monkeypatch):
    """A leased worker SIGKILLed after its node manager granted it and
    before the caller dials it refuses the dial: the caller gives up
    within ``DIRECT_DIAL_S`` and its task runs on the scheduled path.
    ``protocol.connect``'s 30 s default held the task that long."""
    import ray_tpu_torch
    from ray_tpu_torch._private import lease
    from ray_tpu_torch._private import worker as worker_mod

    ray_tpu_torch.init(num_cpus=2, object_store_memory=32 * MiB)
    try:
        nm = worker_mod._global_cluster.nm
        address = lease.LeaseManager._direct_address
        killed = []

        def kill_then_address(self, grant):
            if not killed:
                with nm._lock:
                    proc = nm._workers[grant["worker_id"]].proc
                os.kill(proc.pid, signal.SIGKILL)
                deadline = time.time() + 10
                while proc.poll() is None and time.time() < deadline:
                    time.sleep(0.01)
                killed.append(proc.pid)
            return address(self, grant)

        monkeypatch.setattr(lease.LeaseManager, "_direct_address",
                            kill_then_address)

        @ray_tpu_torch.remote
        def f():
            return 42

        t0 = time.time()
        assert ray_tpu_torch.get(f.remote(), timeout=60) == 42
        took = time.time() - t0
        assert killed
        assert took < lease.DIRECT_DIAL_S + 10.0, \
            f"the task took {took:.1f} s"
    finally:
        ray_tpu_torch.shutdown()
