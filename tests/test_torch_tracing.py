"""``tests/test_tracing.py`` on the port's runtime, test by test.

Every test's result is a value: each runs as a program of
``torch_obs_programs``' "tracing" group on both runtimes, each on the
reference fixture's cluster (2 CPUs, a 64 MiB store); the results must be
equal and pass the reference's assertions. Span and trace ids differ
between runs, so the programs return whether they link up. The port's
store group and KV hand-off take ``runtime=``; its replica publishes a
``torch.Tensor`` where the reference's publishes a jax array. The serve
programs start no HTTP proxy. ``sampled_out`` sets ``trace_sample_rate``
to 0 on the runtime's own config and back to 1.0 after, as the
reference's fixture does.
"""

import pytest

import torch_obs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "tracing", tmp_path_factory)


def test_trace_spans_driver_task_nested(results):
    """driver -> task -> nested task: one trace id, parent links follow
    the submission chain."""
    got, ids, same_trace, nested, root_parent = same_result(
        results, "trace_spans_driver_task_nested")
    assert got == "leaf"
    assert ids
    assert same_trace
    assert nested                # nested under outer
    assert root_parent is None   # driver-side root


def test_trace_spans_actor_hop(results):
    """driver -> actor method -> task submitted from the actor."""
    assert same_result(results, "trace_spans_actor_hop") == \
        (1, True, True, True)


def test_separate_roots_get_separate_traces(results):
    assert same_result(results, "separate_roots_get_separate_traces")


def test_two_hop_chain_renders_connected_chrome_trace(results):
    """The chrome-trace export binds a two-hop chain with one flow pair
    from inside hop1's slice to hop2's start."""
    (got, span_arg, parent_arg, n_starts, n_finishes, ids, start_ts,
     finish_ts, bp) = same_result(
        results, "two_hop_chain_renders_connected_chrome_trace")
    assert got == "leaf"
    assert span_arg and parent_arg
    assert n_starts == 1 and n_finishes == 1
    assert ids and start_ts and finish_ts
    assert bp == "e"


def test_collective_ops_emit_spans_under_task(results):
    """Collective ops join the task-event stream as spans parented under
    the rank's running task."""
    out, two, parented, same_trace = same_result(
        results, "collective_ops_emit_spans_under_task")
    assert out == [[2.0, 2.0], [2.0, 2.0]]
    assert two              # one span per rank
    assert parented and same_trace


def test_serve_device_object_round_trip_single_trace(results):
    """A serve -> replica -> device-object (KV publish/adopt) round trip
    is one connected trace."""
    got, hop, run, kinds, n_traces, flows = same_result(
        results, "serve_device_object_round_trip_single_trace")
    assert got == 64.0
    assert hop, "no serve_handle span reported"
    assert run
    assert kinds == ["device_get", "device_put"]
    assert n_traces == 1
    assert flows


def test_span_helpers_driverside(results):
    """Driverside spans buffer and flush over the GCS channel; nesting
    links parents; span events stay out of the task views."""
    both, parent, trace, in_tasks, in_summary = same_result(
        results, "span_helpers_driverside")
    assert both and parent and trace
    assert not in_tasks and not in_summary


def test_sampled_out_serve_round_trip_emits_zero_spans(results):
    """With the root sampled out, no span of the round trip is emitted on
    either side of the process hop."""
    assert same_result(
        results, "sampled_out_serve_round_trip_emits_zero_spans") == (1, 0)


def test_errored_serve_round_trip_keeps_all_spans(results):
    """Sampling never hides failures: an errored round trip emits all its
    spans, each with status=error, in one trace, even at rate 0."""
    err, both, handle_status, replica_status, same_trace = same_result(
        results, "errored_serve_round_trip_keeps_all_spans")
    assert err[1] and err[2], err   # ValueError matching "boom"
    assert both
    assert handle_status == "error" and replica_status == "error"
    assert same_trace


def test_sampled_in_serve_round_trip_keeps_spans(results):
    """Rate 1.0 (default): the ok round trip emits its spans."""
    assert same_result(results, "sampled_in_serve_round_trip_keeps_spans") \
        == (1, True, "ok")


def test_mirrors_every_reference_test():
    assert_mirrored("tracing")
