"""Gang fault tolerance of the port's trainer on the ``ray_tpu`` runtime:
twins of tests/test_gang_fault_tolerance.py's SIGKILL and poll-isolation
tests, with a ``torch_dist`` (gloo) gang on the CPU.

The bound: a SIGKILLed peer closes its gloo connections, so the survivor's
pending allreduce fails at once and raises GangMemberDiedError; the test
allows the reference's bound, one step (0.3 s) + 2x the gang heartbeat
(1 s) + 3 s of slack + 0.3 s. Every wait is deadline-driven: a regression
in detection fails fast instead of hanging the suite.
"""

import os
import signal
import threading
import time

import pytest
import torch

import ray_tpu
from ray_tpu_torch.exceptions import GangMemberDiedError
from ray_tpu_torch.train import (
    FailureConfig, RunConfig, ScalingConfig, TorchDistTrainer,
)
from ray_tpu_torch.train.worker_group import WorkerGroup, _metrics
from ray_tpu_torch._private.config import config

HEARTBEAT_S = 1.0
DETECT_BOUND_S = 2 * HEARTBEAT_S + 3.0   # 2x heartbeat + CI slack
STEP_S = 0.3


@pytest.fixture(scope="module")
def gang_cluster():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    old = {k: config.get(k)
           for k in ("gang_heartbeat_s", "gang_restart_backoff_s")}
    config.set("gang_heartbeat_s", HEARTBEAT_S)
    config.set("gang_restart_backoff_s", 0.1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ctx = ray_tpu.init(num_cpus=4,
                           object_store_memory=128 * 1024 * 1024)
    yield ctx
    ray_tpu.shutdown()
    for k, v in old.items():
        config.set(k, v)
    torch.set_num_threads(threads)


def _fit_bounded(trainer, timeout_s):
    """fit() under a hard deadline."""
    out = {}

    def run():
        try:
            out["result"] = trainer.fit()
        except BaseException as e:   # surfaced below
            out["error"] = e

    th = threading.Thread(target=run, daemon=True, name="fit-bounded")
    th.start()
    th.join(timeout_s)
    assert out, f"fit() exceeded its {timeout_s}s deadline (wedged?)"
    if "error" in out:
        raise out["error"]
    return out["result"]


def _wait_for(pred, timeout, msg):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _gang_loop(cfg):
    """A per-step allreduce over the gang's gloo world; rank 0 checkpoints
    every step. Side files give the test each rank's pid and the
    survivor's time in the failed collective."""
    import os
    import time

    import numpy as np

    from ray_tpu_torch import train
    from ray_tpu_torch.parallel import collective
    from ray_tpu_torch.train import Checkpoint

    side = cfg["side_dir"]
    g = collective.get_group(train.session._get_session()
                             .collective_group_name)
    rank = train.get_world_rank()

    start_step = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        start_step = ckpt.to_dict()["step"] + 1

    tmp = os.path.join(side, f"rank{rank}.pid.tmp")
    with open(tmp, "w") as f:
        f.write(str(os.getpid()))
    os.replace(tmp, os.path.join(side, f"rank{rank}.pid"))

    for step in range(start_step, cfg["steps"]):
        # Rank 0 enters the collective at once and waits there while the
        # others "compute": a SIGKILL of rank 1 lands while the survivor
        # is inside the op.
        if rank != 0:
            time.sleep(cfg["step_s"])
        t_op = time.time()
        try:
            out = g.allreduce(np.full((4,), float(rank + 1), np.float32))
        except BaseException as e:
            with open(os.path.join(side, f"unwedge_rank{rank}"), "w") as f:
                f.write(f"{type(e).__name__}:{time.time() - t_op:.3f}")
            raise
        if rank == 0:
            train.report(
                {"step": step, "allreduce0": float(out[0])},
                checkpoint=Checkpoint.from_dict({"step": step}))


def _run_dir_has_checkpoint(run_dir):
    try:
        return any(d.startswith("checkpoint_") for d in os.listdir(run_dir))
    except OSError:
        return False


def test_sigkill_one_rank_mid_step_recovers(gang_cluster, tmp_path):
    """SIGKILL one torch_dist rank during the run: the survivor raises
    GangMemberDiedError within the bound, the gang re-forms, training
    resumes from the latest checkpoint, and the result is correct with at
    least one restart."""
    side = str(tmp_path / "side")
    os.makedirs(side, exist_ok=True)
    steps = 8
    run_dir = str(tmp_path / "gangkill")
    restarts0 = _metrics()["restarts"].value()
    poisoned0 = _metrics()["poisoned"].value()

    record = {}

    def killer():
        # Kill rank 1 once, after its pid and one checkpoint exist.
        pid_path = os.path.join(side, "rank1.pid")
        deadline = time.time() + 60
        while time.time() < deadline:
            if os.path.exists(pid_path) and _run_dir_has_checkpoint(run_dir):
                try:
                    pid = int(open(pid_path).read())
                except (OSError, ValueError):
                    time.sleep(0.05)
                    continue
                record["t_kill"] = time.time()
                os.kill(pid, signal.SIGKILL)
                return
            time.sleep(0.05)
        record["error"] = "killer never found a target"

    trainer = TorchDistTrainer(
        _gang_loop,
        train_loop_config={"side_dir": side, "steps": steps,
                           "step_s": STEP_S},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            name="gangkill", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=2)),
        runtime=ray_tpu, device="cpu")
    kth = threading.Thread(target=killer, daemon=True)
    kth.start()
    result = _fit_bounded(trainer, timeout_s=180)
    t_done = time.time()

    assert "t_kill" in record, record.get("error", "kill never happened")
    assert result.ok, result.error
    assert result.num_restarts >= 1
    assert any("GangMemberDied" in r for r in result.restart_reasons), \
        result.restart_reasons
    assert t_done - record["t_kill"] < 120

    # Every reported step saw the full gang's allreduce (1 + 2), the last
    # step completed, and the restart resumed from a checkpoint.
    hist = result.metrics_history
    assert hist and all(m["allreduce0"] == 3.0 for m in hist)
    assert hist[-1]["step"] == steps - 1
    assert {m["step"] for m in hist} == set(range(steps))
    assert result.checkpoint.to_dict()["step"] == steps - 1

    # The survivor left the dead collective as GangMemberDiedError within
    # the bound, not at the op deadline.
    unwedge = os.path.join(side, "unwedge_rank0")
    assert os.path.exists(unwedge), \
        "survivor never recorded an unwedge (killed while idle?)"
    err_name, elapsed = open(unwedge).read().split(":")
    assert err_name == "GangMemberDiedError", err_name
    assert float(elapsed) <= STEP_S + DETECT_BOUND_S + 0.3, \
        f"survivor sat {elapsed}s in the dead collective"

    assert _metrics()["restarts"].value() >= restarts0 + 1
    assert _metrics()["poisoned"].value() >= poisoned0 + 1


def _poll_gang_loop(cfg=None):
    import time

    from ray_tpu_torch import train

    for i in range(1200):
        time.sleep(0.05)
        if train.get_world_rank() == 0 and i % 20 == 0:
            train.report({"i": i})


def test_worker_group_poll_isolates_dead_rank(gang_cluster):
    """A dead rank surfaces as state='dead' instead of one actor error
    aborting the whole poll batch, and the supervisor records a gang error
    (poisoning the group) within a bounded time."""
    group = WorkerGroup(2, {"CPU": 1}, backend="store",
                        group_name="pollgang", experiment_name="pg",
                        runtime=ray_tpu, device="cpu")
    try:
        group.start(_poll_gang_loop, None, None)
        states = group.poll()          # healthy: no raise, all running
        assert [s["state"] for s in states] == ["running", "running"]

        ray_tpu.kill(group.workers[1])
        deadline = time.time() + 15
        while time.time() < deadline:
            states = group.poll()      # must never raise
            if states[1]["state"] == "dead":
                break
            time.sleep(0.2)
        assert states[1]["state"] == "dead", states
        assert states[0]["state"] == "running", states

        _wait_for(lambda: group.gang_error is not None,
                  timeout=DETECT_BOUND_S + 5,
                  msg="supervisor to record the gang error")
        assert isinstance(group.gang_error, GangMemberDiedError)
        assert group.gang_error.rank == 1
    finally:
        group.shutdown(graceful=False)
