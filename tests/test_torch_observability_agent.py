"""``tests/test_observability_agent.py`` on the port's runtime, test by
test.

Every test's result is a value: each runs as a program of
``torch_obs_programs``' "agent" group on both runtimes, each on the
reference fixture's cluster (4 CPUs, a 128 MiB store) or the cluster its
test starts itself; the results must be equal and pass the reference's
assertions. The wedged rank and the gang are the port's store group and
``WorkerGroup`` (``runtime=``; the gang's ranks on the CPU). Flight
dumps are read from the runtime's own session directory
(``$TMPDIR/ray_tpu_torch/...`` on the port). The reference's
``caplog`` check of the metrics reporter's warnings reads the runtime's
metrics logger through a handler of the program's own.
"""

import pytest

import torch_obs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "agent", tmp_path_factory)


def test_wedged_collective_rank_stack_capture(results):
    """A rank blocked in an allreduce its peer never joins is diagnosable
    cluster-wide through the in-band stack path, bounded."""
    (joined, bounded, node_id, wedged, actor, frames, report,
     unwedged) = same_result(results,
                             "wedged_collective_rank_stack_capture")
    assert joined == [True, True]
    assert bounded and node_id
    assert wedged and actor       # rank 0's main thread, by actor id
    assert frames and report      # the CLI renderer shows them too
    assert unwedged               # poison_group ends the wedged op


def test_stack_capture_includes_node_manager_threads(results):
    assert same_result(
        results, "stack_capture_includes_node_manager_threads") == \
        (True, True)   # head NM in-process, rtpu-nm-* threads


def test_worker_log_fan_in(results):
    got, listed, shaped, filtered = same_result(results,
                                                "worker_log_fan_in")
    assert got == 1
    assert listed and shaped
    assert filtered   # prefix filtering narrows to that worker only


def test_actor_log_fan_in_routes_by_actor_id(results):
    assert same_result(results,
                       "actor_log_fan_in_routes_by_actor_id") == \
        (True, True)


def test_dead_workers_logs_reachable_by_actor_and_full_id(results):
    said, full, by_actor, by_wid, actor = same_result(
        results, "dead_workers_logs_reachable_by_actor_and_full_id")
    assert said and full
    assert by_actor, "dead actor's logs unreachable by actor id"
    assert by_wid, "dead worker's logs unreachable by full id"
    assert actor


def test_flight_recorder_dump_on_gang_death(results):
    """A gang death leaves a flight-recorder dump holding the dead rank's
    last task events, its death and hardware samples."""
    reason, setup, death, hw = same_result(
        results, "flight_recorder_dump_on_gang_death")
    assert reason
    assert setup    # setup_collective task events
    assert death    # worker_death against the dead rank's actor id
    assert hw       # hw_sample rides the same ring


def test_flight_recorder_dump_on_unexpected_worker_death(results):
    assert same_result(
        results, "flight_recorder_dump_on_unexpected_worker_death") == \
        (True, True, True)


def test_flight_snapshot_over_node_agent_endpoint(results):
    assert same_result(results, "flight_snapshot_over_node_agent_endpoint")


def test_metrics_reporter_idempotent_and_joined_on_shutdown(results):
    """start_reporter calls share one thread, shutdown joins it: no
    stacking across init/shutdown cycles."""
    assert same_result(
        results, "metrics_reporter_idempotent_and_joined_on_shutdown") == \
        ([(True, 1), (True, 1)], 0)


def test_metrics_drop_dead_client_series(results):
    """A dead client's series leave /metrics at the next read; a silent
    client's expire after missing its reporting periods."""
    reported, stale = same_result(results,
                                  "metrics_drop_dead_client_series")
    assert reported
    assert not stale


def test_report_to_gcs_logs_failures_once_per_kind(results):
    first, second, n_warnings, named = same_result(
        results, "report_to_gcs_logs_failures_once_per_kind")
    assert first is False and second is False
    assert n_warnings == 1          # once per failure kind
    assert named                    # ConnectionResetError in the message


def test_mirrors_every_reference_test():
    assert_mirrored("observability_agent")
