"""``tests/test_oom_monitor.py`` on the port's runtime, test by test.

Both tests' results are values: each runs as a program of
``torch_failure_programs``' "oom" group on both runtimes, on the
reference fixture's cluster (2 CPUs, a 32 MiB store, the monitor every
100 ms, a 600 MiB limit at threshold 0.8). The limit is the reference's:
the port's CPU workers import no torch and sit below the reference's,
which import jax (``test_workers_fit_the_reference_budget`` in
``test_torch_failure_repairs.py`` holds the port's baseline to it). The
results must be equal and pass the reference's assertions.
"""

import pytest

import torch_failure_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "oom", tmp_path_factory)


def test_oom_hog_killed_node_survives(results):
    """A task allocating past the limit is killed (surfacing the OOM cause)
    instead of wedging the node; ordinary work keeps running."""
    err, fine = same_result(results, "oom_hog_killed_node_survives")
    assert err == ("WorkerCrashedError", True, True), err
    assert fine == 42


def test_oom_kill_is_retriable(results):
    """A retriable task killed by the monitor is retried; when it behaves
    on retry (allocation released), it completes."""
    assert same_result(results, "oom_kill_is_retriable") == 7


def test_mirrors_every_reference_test():
    assert_mirrored("oom_monitor")
