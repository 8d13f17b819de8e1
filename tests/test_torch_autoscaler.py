"""The port's autoscaler (``ray_tpu_torch.autoscaler``), its multi-node
test cluster (``cluster_utils``) and node daemon, against the JAX
package's.

Parity: the programs of ``torch_cluster_programs`` (the six of
tests/test_cluster_autoscaler.py, the two of tests/test_cluster_launcher.py
and the pool provider's FIFO granting of tests/test_tpu_pod_provider.py)
run on ``ray_tpu`` in a fresh interpreter, which exits, and then on
``ray_tpu_torch`` in this process; each program's results must be equal.
TPU chips on one side are GPUs on the other.

The port's own: a two-pool scale-up from GPU gang demand with pool-affine
placement and pool-atomic scale-down on declared GPUs, and the process
provider's repair (a registered node daemon is judged by its GCS entry,
so a busy node outlives ``boot_grace_s``).
"""

import os

import pytest

import torch_cluster_programs as progs
from torch_runtimes import deadline, ports_runtime, reference_results

NAMES = [p.__name__ for p in progs.PROGRAMS["autoscaler"]]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ref = reference_results("torch_cluster_programs.py",
                            ["autoscaler", tmp_path_factory.mktemp("ref")],
                            tmp_path_factory.mktemp("ref_out"))
    import ray_tpu_torch

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        with deadline(what="the autoscaler programs on the port's runtime"):
            port = progs.run_group(ray_tpu_torch, "GPU", "autoscaler",
                                   str(tmp_path_factory.mktemp("port")))
    return {"ray_tpu": ref, "ray_tpu_torch": port}


@pytest.mark.parametrize("program", NAMES)
def test_same_results_on_both_runtimes(results, program):
    ref = results["ray_tpu"][program]
    port = results["ray_tpu_torch"][program]
    assert ref[0] == "ok", ref
    assert port == ref


def test_programs_cover_the_reference_tests():
    assert set(NAMES) == {
        "p_multinode_scheduling", "p_remove_node_fails_tasks_over",
        "p_autoscaler_scales_up_and_down",
        "p_autoscaler_respects_max_workers", "p_min_workers_launched",
        "p_pg_prefers_single_pool", "p_launch_min_workers_and_autoscale",
        "p_bad_yaml_rejected", "p_pool_fifo_granting"}


def _port(prog, tmp_path):
    import ray_tpu_torch

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        with deadline(what=prog.__name__):
            return prog(ray_tpu_torch, "GPU", str(tmp_path))


def test_two_pool_scale_up_pool_affine_and_scale_down(tmp_path):
    """Four 4-GPU bundles launch two 2-host pools of 8 GPUs, whose hosts
    carry their pool's label; a ``num_gpus=1`` task sees one GPU; idle
    pools go whole and the cluster's GPUs return to 0."""
    launched, ready, pools, gpus, seen, left, after = _port(
        progs.p_two_pool_scale_up_and_down, tmp_path)
    assert launched >= 2 and ready
    assert pools == 2 and gpus == 16.0
    assert seen == [1, 1]
    assert left == [] and after == 0.0


def test_pool_provider_maps_gpus_per_host():
    """A pool's aggregate GPUs split evenly over its hosts, and its
    default shape names a GPU."""
    from ray_tpu_torch.autoscaler import GpuPoolCloud, GpuPoolProvider

    class Recorder(GpuPoolCloud):
        def __init__(self):
            self.made = []

        def create_queued_resources(self, requests):
            self.made.extend(requests)

        def delete_queued_resources(self, names):
            pass

        def list_queued_resources(self):
            return {r["name"]: {"state": "ACTIVE", "node_type": "pool"}
                    for r in self.made}

    cloud = Recorder()
    provider = GpuPoolProvider(cloud)
    name = provider.create_node("pool", {"CPU": 16, "GPU": 16,
                                         "hosts": 2}, 1)[0]
    (req,) = cloud.made
    assert (req["name"], req["hosts"], req["gpus_per_host"],
            req["cpus_per_host"], req["accelerator_type"]) == (
        name, 2, 8.0, 8.0, "h100-80gb")
    assert provider.node_tags(name) == {"node-type": "pool", "slice": name,
                                        "state": "ACTIVE"}


def test_busy_process_node_outlives_boot_grace(tmp_path):
    """The process provider tags each registered daemon with its GCS node
    id: the autoscaler keeps a node busy past ``boot_grace_s`` (its clock
    stepped 30 s past it while the task runs) and removes it once idle,
    one launch in all."""
    ran, launched, busy_terminations, terminated, left = _port(
        progs.p_local_node_busy_past_boot_grace, tmp_path)
    assert ran is True
    assert (launched, busy_terminations, terminated, left) == (1, 0, 1, [])


def test_node_daemon_writes_its_gcs_node_id(tmp_path):
    """``--node-id-file`` receives the id the node registered under, and
    the daemon leaves on SIGTERM."""
    import signal
    import subprocess
    import sys
    import time

    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster

    c = Cluster(head_node_args={"num_cpus": 1})
    path = tmp_path / "id"
    proc = None
    try:
        with deadline(60, what="the node daemon"):
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.scripts.node_daemon",
                 "--gcs-address", c.address, "--num-cpus", "1",
                 "--num-gpus", "1", "--object-store-memory",
                 str(64 << 20), "--node-id-file", str(path)],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                cwd=os.path.dirname(os.path.dirname(
                    ray_tpu_torch.__file__)))
            while not path.exists():
                assert proc.poll() is None
                time.sleep(0.1)
            node_id = path.read_text()
            with c.gcs._sched_lock:
                entry = c.gcs._nodes[node_id]
                assert entry.alive
                assert entry.total.to_dict()["GPU"] == 1.0
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
        c.shutdown()


def test_pending_group_places_when_capacity_returns():
    """A placement group made while its resources are held places as soon
    as they return, with no node joining (the reference's GCS retries
    pending groups only when a node registers: an autoscaler then sees the
    freed node idle and removes it under the waiting group). A bounded
    ``wait`` returns at its bound, and a removed pending group never
    places."""
    import importlib
    import time

    import ray_tpu_torch as rt

    pgm = importlib.import_module("ray_tpu_torch.util.placement_group")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        with deadline(120, what="the pending group"):
            rt.init(num_cpus=4)
            try:
                @rt.remote(num_cpus=3)
                class Hog:
                    def ping(self):
                        return 1

                hog = Hog.remote()
                assert rt.get(hog.ping.remote(), timeout=60) == 1
                pg = pgm.placement_group([{"CPU": 2}])
                never = pgm.placement_group([{"CPU": 8}])
                t0 = time.time()
                assert pg.wait(timeout_seconds=0.5) is False
                waited = time.time() - t0
                pgm.remove_placement_group(never)
                rt.kill(hog)
                t0 = time.time()
                assert pg.wait(timeout_seconds=30)
                placed = time.time() - t0
                table = pgm.placement_group_table(never)
                pgm.remove_placement_group(pg)
            finally:
                rt.shutdown()
    assert waited < 5, waited
    assert placed < 5, placed
    assert table["state"] == "REMOVED", table


def test_leased_backlog_is_missing_from_pending_demand():
    """An open fault of both runtimes (ROADMAP §3), recorded as it stands:
    tasks the driver pipelines behind its own leased worker (up to
    ``lease_pipeline_depth``) never reach the GCS's queue, so
    ``pending_demand``, which the autoscaler reads, shows none of them.
    On 1 CPU, 8 tasks on one lease: 7 wait, 0 are shown. A repair
    that makes the backlog visible changes the count asserted here."""
    import time

    with ports_runtime(num_cpus=1, object_store_memory=64 << 20) as rt:
        from ray_tpu_torch._private import worker as worker_mod

        @rt.remote
        def hold(t):
            time.sleep(t)
            return 1

        assert rt.get(hold.remote(0), timeout=60) == 1
        refs = [hold.remote(2.0) for _ in range(8)]
        time.sleep(0.5)
        lm = worker_mod.global_worker()._lease_mgr
        inflight = [l.inflight for st in lm._shapes.values()
                    for l in st.leases if not l.dead]
        shown = worker_mod.require_worker().gcs.request(
            "pending_demand")["tasks"]
        # One lease holds the 8: one runs, the rest wait behind it.
        assert len(inflight) == 1 and inflight[0] >= 7, inflight
        assert shown == []
        assert rt.get(refs, timeout=60) == [1] * 8
