"""``tests/test_chaos.py`` on the port's runtime, test by test.

Every test's result is a value: each runs as a program of
``torch_failure_programs``' "chaos" group on both runtimes, on the
cluster its reference fixture starts (one 4-CPU node, or a 2-CPU head
and a 2-CPU worker node), SIGKILLing workers and nodes through the
runtime's own ``_private/test_utils``. The results must be equal and pass
the reference's assertions; the ordering test's values are its verdicts
(which calls land in which incarnation is timing).
"""

import pytest

import torch_failure_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "chaos", tmp_path_factory)


def test_sigkill_worker_mid_task_retries(results):
    """A task whose worker is SIGKILLed mid-run retries and succeeds."""
    killed, value = same_result(results, "sigkill_worker_mid_task_retries")
    assert killed, "no busy worker appeared to kill"
    assert value == 49


def test_sigkill_worker_no_retries_raises(results):
    killed, err = same_result(results, "sigkill_worker_no_retries_raises")
    assert killed
    assert err is not None and err[1], err


def test_sigkill_actor_process_restarts(results):
    first, n, new_pid = same_result(results,
                                    "sigkill_actor_process_restarts")
    assert first == 1
    # The restarted instance answers with fresh state in a new process.
    assert n == 1
    assert new_pid


def test_actor_task_ordering_across_restart(results):
    """Per-caller FIFO holds across an actor restart: a contiguous 1..k
    prefix per incarnation, no reordering inside one, every call once."""
    two_at_most, seqs_sorted, fifo, calls = same_result(
        results, "actor_task_ordering_across_restart")
    assert two_at_most
    assert seqs_sorted, "reordered within an incarnation"
    assert fifo, "caller FIFO violated"
    assert calls == list(range(20))


def test_cross_node_fetch(results):
    """An object produced on node B is pulled to the driver's node."""
    shape, local = same_result(results, "cross_node_fetch")
    assert shape == (1 << 18,)
    assert local


def test_node_kill_mid_task_reschedules(results):
    """Killing a node abruptly mid-task reschedules the task elsewhere."""
    assert same_result(results, "node_kill_mid_task_reschedules") is True


def test_node_kill_lineage_rebuild(results):
    """Abrupt node death + lost objects: lineage rebuilds on survivors."""
    first, rebuilt = same_result(results, "node_kill_lineage_rebuild")
    assert first == [0, 1, 2]
    assert rebuilt == [0, 1, 2]


def test_chaos_monkey_task_sweep(results):
    """A NodeKiller SIGKILLing busy workers every 300ms cannot lose any
    retriable task."""
    out, killed = same_result(results, "chaos_monkey_task_sweep")
    assert out == [i * 2 for i in range(40)]
    assert killed, "chaos monkey never killed anything"


def test_spill_restore_under_churn(results):
    """Objects spilled under memory pressure restore correctly while new
    puts keep forcing eviction/spill."""
    assert same_result(results, "spill_restore_under_churn") == [True] * 8


def test_mirrors_every_reference_test():
    assert_mirrored("chaos")
