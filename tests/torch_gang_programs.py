"""Gang fault-tolerance checks of the port's trainer, run on either runtime.

Twins of tests/test_gang_fault_tolerance.py's SIGKILL, poll-isolation,
poisoning and chaos-sweep tests, and a check of the supervisor's GCS death push. Each
check takes the runtime module (``ray_tpu`` or ``ray_tpu_torch``), whose
cluster the calling test module holds; a ``torch_dist`` gang is a gloo
world on the CPU. The loops run in the runtime's worker processes, which
import this module by name: it imports neither runtime, nor jax.

The bound: a SIGKILLed peer closes its gloo connections, so the survivor's
pending allreduce fails at once and raises GangMemberDiedError; the checks
allow the reference's bound, one step (0.3 s) + 2x the gang heartbeat
(1 s) + 3 s of slack + 0.3 s. Every wait is deadline-driven: a regression
in detection fails fast instead of hanging the suite.
"""

from __future__ import annotations

import os
import signal
import threading
import time

HEARTBEAT_S = 1.0
SLACK_S = 3.0
DETECT_BOUND_S = 2 * HEARTBEAT_S + SLACK_S   # 2x heartbeat + CI slack
STEP_S = 0.3
GANG_KNOBS = {"gang_heartbeat_s": HEARTBEAT_S, "gang_restart_backoff_s": 0.1}


def fit_bounded(trainer, timeout_s):
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


def wait_for(pred, timeout, msg):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _write_pid(side, rank):
    tmp = os.path.join(side, f"rank{rank}.pid.tmp")
    with open(tmp, "w") as f:
        f.write(str(os.getpid()))
    os.replace(tmp, os.path.join(side, f"rank{rank}.pid"))


def _read_pid(side, rank):
    try:
        return int(open(os.path.join(side, f"rank{rank}.pid")).read())
    except (OSError, ValueError):
        return None


def gang_loop(cfg):
    """A per-step allreduce over the gang's gloo world; rank 0 checkpoints
    every step. Side files give the test each rank's pid and the
    survivor's time in the failed collective."""
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
    _write_pid(side, rank)

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


def poll_gang_loop(cfg=None):
    from ray_tpu_torch import train

    if cfg and cfg.get("side_dir"):
        _write_pid(cfg["side_dir"], train.get_world_rank())
    for i in range(1200):
        time.sleep(0.05)
        if train.get_world_rank() == 0 and i % 20 == 0:
            train.report({"i": i})


def _run_dir_has_checkpoint(run_dir):
    try:
        return any(d.startswith("checkpoint_") for d in os.listdir(run_dir))
    except OSError:
        return False


def sigkill_one_rank_mid_step_recovers(rt, tmp_path):
    """SIGKILL one torch_dist rank during the run: the survivor raises
    GangMemberDiedError within the bound, the gang re-forms, training
    resumes from the latest checkpoint, and the result is correct with at
    least one restart."""
    from ray_tpu_torch.train import (
        FailureConfig, RunConfig, ScalingConfig, TorchDistTrainer,
    )
    from ray_tpu_torch.train.worker_group import _metrics

    side = str(tmp_path / "side")
    os.makedirs(side, exist_ok=True)
    steps = 8
    run_dir = str(tmp_path / "gangkill")
    restarts0 = _metrics()["restarts"].value()
    poisoned0 = _metrics()["poisoned"].value()

    record = {}

    def killer():
        # Kill rank 1 once, after its pid and one checkpoint exist.
        deadline = time.time() + 60
        while time.time() < deadline:
            pid = _read_pid(side, 1)
            if pid is not None and _run_dir_has_checkpoint(run_dir):
                record["t_kill"] = time.time()
                os.kill(pid, signal.SIGKILL)
                return
            time.sleep(0.05)
        record["error"] = "killer never found a target"

    trainer = TorchDistTrainer(
        gang_loop,
        train_loop_config={"side_dir": side, "steps": steps,
                           "step_s": STEP_S},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            name="gangkill", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=2)),
        runtime=rt, device="cpu")
    kth = threading.Thread(target=killer, daemon=True)
    kth.start()
    result = fit_bounded(trainer, timeout_s=180)
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


def chaos_gang_killer_sweep(rt, tmp_path):
    """NodeKiller-style chaos: up to two SIGKILLs of random ranks of a
    2-rank ``torch_dist`` gang during a 10-step ``fit``, each after a
    checkpoint and after the last killed gang re-formed; the trainer keeps
    re-forming from checkpoints and finishes correctly."""
    import random

    from ray_tpu_torch.train import (
        FailureConfig, RunConfig, ScalingConfig, TorchDistTrainer,
    )

    side = str(tmp_path / "side")
    os.makedirs(side, exist_ok=True)
    steps = 10
    run_dir = str(tmp_path / "gangchaos")
    stop = threading.Event()
    kills = []

    def killer():
        rng = random.Random(0)
        killed_pids = set()
        deadline = time.time() + 240
        while (not stop.is_set() and len(kills) < 2
               and time.time() < deadline):
            if not _run_dir_has_checkpoint(run_dir):
                time.sleep(0.1)
                continue
            rank = rng.choice([0, 1])
            pid = _read_pid(side, rank)
            if pid is None:
                time.sleep(0.1)
                continue
            if pid in killed_pids:   # wait for the re-formed gang
                time.sleep(0.2)
                continue
            killed_pids.add(pid)
            kills.append((rank, pid, time.time()))
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
            time.sleep(3.0)   # let the gang re-form and progress

    trainer = TorchDistTrainer(
        gang_loop,
        train_loop_config={"side_dir": side, "steps": steps,
                           "step_s": 0.25},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            name="gangchaos", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=6)),
        runtime=rt, device="cpu")
    kth = threading.Thread(target=killer, daemon=True)
    kth.start()
    try:
        result = fit_bounded(trainer, timeout_s=420)
    finally:
        stop.set()
    assert result.ok, result.error
    assert kills, "chaos killer never fired"
    assert result.num_restarts >= 1
    hist = result.metrics_history
    assert hist[-1]["step"] == steps - 1
    assert all(m["allreduce0"] == 3.0 for m in hist)


def worker_group_poll_isolates_dead_rank(rt):
    """A dead rank surfaces as state='dead' instead of one actor error
    aborting the whole poll batch, and the supervisor records a gang error
    (poisoning the group) within a bounded time."""
    from ray_tpu_torch.exceptions import GangMemberDiedError
    from ray_tpu_torch.train.worker_group import WorkerGroup

    group = WorkerGroup(2, {"CPU": 1}, backend="store",
                        group_name="pollgang", experiment_name="pg",
                        runtime=rt, device="cpu")
    try:
        group.start(poll_gang_loop, None, None)
        states = group.poll()          # healthy: no raise, all running
        assert [s["state"] for s in states] == ["running", "running"]

        rt.kill(group.workers[1])
        deadline = time.time() + 15
        while time.time() < deadline:
            states = group.poll()      # must never raise
            if states[1]["state"] == "dead":
                break
            time.sleep(0.2)
        assert states[1]["state"] == "dead", states
        assert states[0]["state"] == "running", states

        wait_for(lambda: group.gang_error is not None,
                 timeout=DETECT_BOUND_S + 5,
                 msg="supervisor to record the gang error")
        assert isinstance(group.gang_error, GangMemberDiedError)
        assert group.gang_error.rank == 1
    finally:
        group.shutdown(graceful=False)


def poison_unwedges_pending_collective(rt):
    """Collective poisoning in isolation: a rank pending in a store-backend
    collective (its peer never shows up) raises GangMemberDiedError within
    ~2x the gang heartbeat of the group being poisoned — it does NOT wait
    out the collective op deadline."""
    from ray_tpu_torch.exceptions import GangMemberDiedError
    from ray_tpu_torch.parallel import collective

    g = collective.init_collective_group(
        2, 0, backend="store", group_name="poison_unit", runtime=rt)
    res = {}

    def run():
        t0 = time.time()
        try:
            g.barrier()
            res["err"] = None
        except BaseException as e:
            res["err"] = e
            res["elapsed"] = time.time() - t0

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        time.sleep(0.5)   # the barrier is now pending (rank 1 never joins)
        t_poison = time.time()
        assert collective.poison_group("poison_unit",
                                       "rank 1 SIGKILLed (test)",
                                       runtime=rt)
        th.join(DETECT_BOUND_S + 2)
        assert not th.is_alive(), \
            "poisoned collective still pending past the detection bound"
        assert isinstance(res["err"], GangMemberDiedError), res
        assert time.time() - t_poison <= DETECT_BOUND_S + 2
        assert "SIGKILLed" in str(res["err"])
    finally:
        collective.destroy_collective_group("poison_unit")


# The GCS's death cause for an actor whose worker process died, as both
# runtimes' node managers write it.
GCS_DEATH_CAUSE = "actor worker died"


def death_push_detects_sigkill(rt, tmp_path):
    """The supervisor's GCS death push alone: with the gang's liveness pings
    made unable to fail, a SIGKILLed rank is still detected within one
    heartbeat plus the slack, and the gang error carries the GCS's death
    cause."""
    from ray_tpu_torch.exceptions import GangMemberDiedError
    from ray_tpu_torch.train.worker_group import WorkerGroup, runtime_pubsub

    assert runtime_pubsub(rt) is not None
    side = str(tmp_path / "side")
    os.makedirs(side, exist_ok=True)
    group = WorkerGroup(2, {"CPU": 1}, backend="store",
                        group_name="pushgang", experiment_name="push",
                        runtime=rt, device="cpu")
    # Pings that cannot fail: only the push can see the death.
    group._ping_round = lambda misses: None
    try:
        group.start(poll_gang_loop, {"side_dir": side}, None)
        wait_for(lambda: _read_pid(side, 1) is not None, 30,
                 "rank 1's pid")
        t_kill = time.time()
        os.kill(_read_pid(side, 1), signal.SIGKILL)
        wait_for(lambda: group.gang_error is not None,
                 timeout=HEARTBEAT_S + SLACK_S,
                 msg="the death push to reach the supervisor")
        took = time.time() - t_kill
        err = group.gang_error
        assert isinstance(err, GangMemberDiedError)
        assert err.rank == 1
        assert GCS_DEATH_CAUSE in str(err), str(err)
        return took
    finally:
        group.shutdown(graceful=False)


def _actor_dead(rt, actor):
    """Whether the GCS lists ``actor`` as DEAD (the runtime's own state
    API, imported by the runtime module's name)."""
    import importlib

    api = importlib.import_module(f"{rt.__name__}.experimental.state.api")
    aid = actor._actor_id.hex()
    return any(a["actor_id"] == aid and a["state"] == "DEAD"
               for a in api.list_actors())


def death_push_before_first_heartbeat(rt, tmp_path):
    """A rank SIGKILLed after ``start()`` and before the supervisor thread
    has run at all (its loop held until the GCS lists the rank DEAD, so
    the push has been published) is still found by the push alone, with
    the pings unable to fail: the group subscribed when its ranks were
    made, not in the supervisor thread."""
    from ray_tpu_torch.exceptions import GangMemberDiedError
    from ray_tpu_torch.train import worker_group as wg

    side = str(tmp_path / "side")
    os.makedirs(side, exist_ok=True)
    gate = threading.Event()
    loop = wg.WorkerGroup._supervise_loop

    def held_loop(self):
        gate.wait(60)
        loop(self)

    wg.WorkerGroup._supervise_loop = held_loop
    try:
        group = wg.WorkerGroup(2, {"CPU": 1}, backend="store",
                               group_name="earlygang",
                               experiment_name="early", runtime=rt,
                               device="cpu")
    finally:
        wg.WorkerGroup._supervise_loop = loop
    group._ping_round = lambda misses: None
    try:
        group.start(poll_gang_loop, {"side_dir": side}, None)
        wait_for(lambda: _read_pid(side, 1) is not None, 30,
                 "rank 1's pid")
        os.kill(_read_pid(side, 1), signal.SIGKILL)
        wait_for(lambda: _actor_dead(rt, group.workers[1]), 30,
                 "the GCS to list rank 1 DEAD")
        gate.set()
        t_open = time.time()
        wait_for(lambda: group.gang_error is not None,
                 timeout=HEARTBEAT_S + SLACK_S,
                 msg="the death push to reach the supervisor")
        err = group.gang_error
        assert isinstance(err, GangMemberDiedError)
        assert err.rank == 1
        assert GCS_DEATH_CAUSE in str(err), str(err)
        return time.time() - t_open
    finally:
        gate.set()
        group.shutdown(graceful=False)


def death_before_subscription_found_by_the_read(rt, tmp_path):
    """The group's one read of its ranks' states, by actor id: a rank
    SIGKILLed before ``_subscribe_deaths`` runs (the group's subscription
    taken down first, so the GCS's push of the death goes to no one) is
    found by that read itself, with the supervisor thread held and the
    pings unable to fail."""
    from ray_tpu_torch.exceptions import GangMemberDiedError
    from ray_tpu_torch.train import worker_group as wg

    side = str(tmp_path / "side")
    os.makedirs(side, exist_ok=True)
    gate = threading.Event()
    loop = wg.WorkerGroup._supervise_loop

    def held_loop(self):
        gate.wait(60)
        loop(self)

    wg.WorkerGroup._supervise_loop = held_loop
    try:
        group = wg.WorkerGroup(2, {"CPU": 1}, backend="store",
                               group_name="readgang",
                               experiment_name="read", runtime=rt,
                               device="cpu")
    finally:
        wg.WorkerGroup._supervise_loop = loop
    group._ping_round = lambda misses: None
    try:
        group.start(poll_gang_loop, {"side_dir": side}, None)
        wait_for(lambda: _read_pid(side, 1) is not None, 30,
                 "rank 1's pid")
        # Back to the moment before the subscription.
        sub, group._sub = group._sub, None
        sub.unsubscribe()
        os.kill(_read_pid(side, 1), signal.SIGKILL)
        wait_for(lambda: _actor_dead(rt, group.workers[1]), 30,
                 "the GCS to list rank 1 DEAD")
        assert group.gang_error is None, group.gang_error
        group._subscribe_deaths()
        err = group.gang_error
        assert isinstance(err, GangMemberDiedError), err
        assert err.rank == 1
        assert GCS_DEATH_CAUSE in str(err), str(err)
    finally:
        gate.set()
        group.shutdown(graceful=False)
