"""The port's lock-order witness (``ray_tpu_torch/_private/lockdep.py``).

- The detector on constructed orders, as the reference's own unit tests
  (``tests/test_raylint.py``) hold it: an AB/BA inversion is one witnessed
  cycle; a consistent order, recursion and a try-acquire are clean; the
  factory wraps only the port's locks.
- The port's runtime with ``RAY_TPU_TORCH_LOCKDEP_ENABLED=1`` runs
  ``tests/torch_core_programs.py``'s ``p_placement_groups`` (a task in a
  placement-group bundle) in a fresh interpreter, with the GCS in the
  driver and in its own process. No cycle is witnessed: before the fix a
  PG task's completion took ``_actor_lock`` under ``_obj_lock`` in
  ``_release_for`` on the GCS connection thread, against
  ``_h_register_node``'s ``_actor_lock`` -> ``_obj_lock``.
"""

import json
import os
import pathlib
import subprocess
import sys
import threading

import pytest

from ray_tpu_torch._private import lockdep

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def witness():
    was_installed = lockdep.installed()
    lockdep.install()
    lockdep.reset()
    try:
        yield lockdep
    finally:
        lockdep.reset()
        if not was_installed:
            lockdep.uninstall()


def test_witnesses_ab_ba_cycle(witness):
    A = lockdep.tracked(key="fixture:A")
    B = lockdep.tracked(key="fixture:B")

    def order(first, second):
        with first:
            with second:
                pass

    for pair in ((A, B), (B, A)):
        t = threading.Thread(target=order, args=pair)
        t.start()
        t.join()
    found = lockdep.take_violations()
    assert len(found) == 1, found
    witness_ = found[0]
    assert "fixture:A" in witness_.cycle and "fixture:B" in witness_.cycle
    assert witness_.cycle[0] == witness_.cycle[-1]
    assert len(witness_.edge_sites) == len(witness_.cycle) - 1
    assert all(s != "?" for s in witness_.edge_sites)
    assert "lock-order cycle" in str(witness_)


def test_consistent_order_recursion_and_reentry_are_clean(witness):
    A = lockdep.tracked(threading.RLock(), key="fixture:A2")
    B = lockdep.tracked(key="fixture:B2")
    for _ in range(3):
        with A:
            with B:
                pass
    with A:
        with B:
            with A:   # re-entering a held RLock never waits: no B -> A
                pass
    assert lockdep.take_violations() == []
    graph = lockdep.graph_snapshot()
    assert "fixture:B2" in graph.get("fixture:A2", set())
    assert "fixture:A2" not in graph.get("fixture:B2", set())


def test_trylock_creates_no_blocking_edge(witness):
    A = lockdep.tracked(key="fixture:TA")
    B = lockdep.tracked(key="fixture:TB")
    C = lockdep.tracked(key="fixture:TC")
    with A:
        with B:
            pass
    with B:
        assert A.acquire(blocking=False)
        A.release()
    assert lockdep.take_violations() == []
    assert "fixture:TA" not in lockdep.graph_snapshot().get("fixture:TB",
                                                           set())
    assert A.acquire(blocking=False)
    try:
        with C:
            pass
    finally:
        A.release()
    assert "fixture:TC" in lockdep.graph_snapshot().get("fixture:TA", set())


def test_condition_over_tracked_lock(witness):
    cv = threading.Condition(lockdep.tracked(key="fixture:CVL"))
    hits = []

    def waiter():
        with cv:
            cv.wait(timeout=5)
            hits.append(1)

    t = threading.Thread(target=waiter)
    t.start()
    while not hits:
        with cv:
            cv.notify_all()
        t.join(timeout=0.05)
    t.join(timeout=5)
    assert hits == [1]
    assert lockdep.take_violations() == []


def test_factory_wraps_only_the_ports_locks(witness):
    from ray_tpu._private.config import Config as RefConfig
    from ray_tpu_torch._private.config import Config

    assert type(Config()._lock).__name__ == "_TrackedLock"
    assert "ray_tpu_torch/_private/config.py" in Config()._lock.class_key
    assert type(threading.Lock()).__name__ != "_TrackedLock"
    ref_lock = RefConfig()._lock
    assert "ray_tpu_torch" not in getattr(ref_lock, "class_key", "")


_PROGRAM = r"""
import json, sys
sys.path[:0] = [{repo!r}, {tests!r}]
import ray_tpu_torch as rt
from ray_tpu_torch._private import lockdep, worker
import torch_core_programs as P

rt.init(num_cpus=4)
proc = worker._global_cluster.gcs_proc
gcs = None
if proc is not None:
    terminate = proc.terminate

    def read_log_after(*a, **k):
        # The session directory goes at shutdown: read the child's log
        # as soon as it has exited.
        global gcs
        rc = terminate(*a, **k)
        log = open(proc.log_path).read().splitlines()
        gcs = {{"rc": rc, "lockdep": [l for l in log if "gcs lockdep" in l]}}
        return rc

    proc.terminate = read_log_after
try:
    result = P.p_placement_groups(rt)
finally:
    rt.shutdown()
print(json.dumps({{"installed": lockdep.installed(), "result": list(result),
                   "violations": [str(v) for v in lockdep.take_violations()],
                   "gcs": gcs}}))
"""


@pytest.mark.parametrize("gcs", ["in_driver", "own_process"])
def test_placement_group_task_witnesses_no_cycle(gcs):
    env = dict(os.environ, RAY_TPU_TORCH_LOCKDEP_ENABLED="1",
               OMP_NUM_THREADS="1")
    env.pop("RAY_TPU_TORCH_GCS_OUT_OF_PROCESS", None)
    if gcs == "own_process":
        env["RAY_TPU_TORCH_GCS_OUT_OF_PROCESS"] = "1"
    code = _PROGRAM.format(repo=str(REPO), tests=str(REPO / "tests"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         stdin=subprocess.DEVNULL, capture_output=True,
                         text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["installed"] is True
    assert got["result"] == [True, 16, "PENDING"]
    if gcs == "in_driver":
        assert got["gcs"] is None
        assert got["violations"] == [], got["violations"]
    else:
        # The GCS child inherits the knob, witnesses its own locks, and
        # would exit 3 with each cycle on its log.
        assert got["gcs"] == {"rc": 0, "lockdep": []}, got["gcs"]
        # The driver holds only init()'s lifecycle lock across the
        # child's bootstrap and terminate waits, by design (a concurrent
        # init() must wait for it); no lock-to-lock cycle.
        cycles = [v for v in got["violations"] if "<blocking:" not in v]
        assert cycles == [], cycles
        assert all("_private/worker.py" in v for v in got["violations"])
