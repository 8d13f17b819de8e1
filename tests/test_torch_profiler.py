"""``tests/test_profiler.py`` on the port's runtime, test by test.

Every test's result is a value: each runs as a program of
``torch_obs_programs``' "profiler" group on both runtimes, the cluster
tests on the reference fixture's cluster (4 CPUs, a 128 MiB store), and
the sampler's own tests in the runtime's process. The results must be
equal and pass the reference's assertions.

The folded and speedscope goldens hold each runtime's output against its
own expected shape (thread label, root-to-leaf frames, the speedscope
schema, the samples counter), not against the other's bytes: module
paths, and so frame names, differ. The wedged rank's group is the
port's store group (``runtime=``), poisoned at teardown through
``poison_group``.
"""

import pytest

import torch_obs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "profiler", tmp_path_factory)


def test_folded_and_speedscope_golden(results):
    """A busy thread's hot function shows up in the folded output, and
    the merged speedscope document is schema-shaped and JSON-clean."""
    got = same_result(results, "folded_and_speedscope_golden")
    assert all(got), got


def test_cpu_mode_counts_idle_leaves_separately(results):
    started, mode, idle, attributed = same_result(
        results, "cpu_mode_counts_idle_leaves_separately")
    assert started and mode == "cpu"
    assert idle
    assert not attributed


def test_bounded_table_eviction_under_churning_stacks(results):
    """The folded table never exceeds its bound; evictions are counted,
    the largest stacks survive."""
    got = same_result(results,
                      "bounded_table_eviction_under_churning_stacks")
    assert all(got), got


def test_deep_stack_truncated_with_marker(results):
    got = same_result(results, "deep_stack_truncated_with_marker")
    assert all(got), got


def test_sampler_start_stop_idempotent(results):
    first, second, one_thread = same_result(
        results, "sampler_start_stop_idempotent")
    assert first and not second   # second start: no new thread
    assert one_thread


def test_always_on_no_thread_stacking_across_init_shutdown(results):
    """profiler_always_on across init()/shutdown() cycles: one sampler
    while up, none after shutdown."""
    assert same_result(
        results, "always_on_no_thread_stacking_across_init_shutdown") == \
        [1, 1]


def test_cluster_profile_covers_every_process_kind(results):
    """One state.profile() window covers driver + node manager + GCS +
    workers, and the merged speedscope document holds them all."""
    warmed, bounded, kinds, spin, profiles = same_result(
        results, "cluster_profile_covers_every_process_kind")
    assert warmed == [1, 1] and bounded
    assert kinds
    assert spin, "submit-phase hot path not attributed"
    assert profiles


def test_worker_scoped_profile_filters(results):
    assert same_result(results, "worker_scoped_profile_filters") == \
        (1, True)


def test_wedged_collective_rank_still_profiles(results):
    """A rank blocked inside a collective still answers the profile verb,
    and the capture attributes the collective frames."""
    joined, bounded, ok, wedged, unwedged = same_result(
        results, "wedged_collective_rank_still_profiles")
    assert joined == [True, True]
    assert bounded and ok
    assert wedged
    assert unwedged   # poison_group ended the wedged op with an error


def test_gcs_subprocess_self_profile_over_bootstrap_address(results):
    """The out-of-process GCS profiles itself over its bare bootstrap
    address."""
    got = same_result(
        results, "gcs_subprocess_self_profile_over_bootstrap_address")
    assert all(got), got


def test_profile_window_rearms_running_sampler_with_requested_knobs(
        results):
    assert same_result(
        results,
        "profile_window_rearms_running_sampler_with_requested_knobs") == \
        (True, "cpu", 200.0, True, 30.0, "wall")


def test_mirrors_every_reference_test():
    assert_mirrored("profiler")
