"""``tests/test_log_streaming.py`` on the port's runtime, test by test.

The three tests that read what reaches the driver's own stdout and
stderr (``capfd``) run on the port alone, in this process, and hold the
lines the reference asserts: the worker's prefix with its pid, stderr on
stderr, silence with ``log_to_driver=False``. The follow stream and the
cursor read return values: each runs as a program of
``torch_obs_programs``' "logs" group on both runtimes, and the results
must be equal and pass the reference's assertions.
"""

import os
import sys
import time

import pytest

import torch_obs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import deadline, group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "logs", tmp_path_factory)


def _drain_until(capfd, markers, timeout=15.0):
    """Accumulate captured driver output until every marker appeared."""
    if isinstance(markers, str):
        markers = [markers]
    buf_out, buf_err = "", ""
    end = time.time() + timeout
    while time.time() < end:
        out, err = capfd.readouterr()
        buf_out += out
        buf_err += err
        if all(m in buf_out or m in buf_err for m in markers):
            return buf_out, buf_err
        time.sleep(0.2)
    raise AssertionError(
        f"markers {markers!r} never reached the driver; "
        f"stdout={buf_out[-500:]!r} stderr={buf_err[-500:]!r}")


@pytest.fixture
def port_rt(monkeypatch):
    import ray_tpu_torch

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with deadline(120, what="a log-streaming test on the port"):
        yield ray_tpu_torch


def test_print_in_task_reaches_driver(port_rt, capfd):
    rt = port_rt
    rt.init(num_cpus=2, log_to_driver=True)
    try:
        @rt.remote
        def chatty():
            print("stream-me-MARKER-out")
            print("stream-me-MARKER-err", file=sys.stderr)
            return os.getpid()

        pid = rt.get(chatty.remote(), timeout=60)
        out, err = _drain_until(
            capfd, ["stream-me-MARKER-out", "stream-me-MARKER-err"])
        line = next(ln for ln in out.splitlines()
                    if "stream-me-MARKER-out" in ln)
        # Prefixed with the producing worker's identity.
        assert f"pid={pid}" in line and line.startswith("(")
        # stderr lines land on the driver's stderr.
        assert "stream-me-MARKER-err" in err
    finally:
        rt.shutdown()


def test_log_to_driver_false_stays_quiet(port_rt, capfd):
    rt = port_rt
    rt.init(num_cpus=2, log_to_driver=False)
    try:
        @rt.remote
        def chatty():
            print("should-not-appear-MARKER")
            return 1

        assert rt.get(chatty.remote(), timeout=60) == 1
        time.sleep(1.5)
        out, err = capfd.readouterr()
        assert "should-not-appear-MARKER" not in out + err
    finally:
        rt.shutdown()


def test_actor_prints_reach_driver(port_rt, capfd):
    rt = port_rt
    rt.init(num_cpus=2, log_to_driver=True)
    try:
        @rt.remote
        class Talker:
            def say(self, msg):
                print(f"actor-says-{msg}")
                return True

        t = Talker.remote()
        assert rt.get(t.say.remote("MARKER42"), timeout=60)
        _drain_until(capfd, "actor-says-MARKER42")
    finally:
        rt.shutdown()


def test_get_log_follow_streams_new_lines_in_order(results):
    """get_log(follow=True): the initial tail, then only new lines, in
    order, no duplicates; close() stops it."""
    pinged, shaped, ten, ordered, unique, stopped = same_result(
        results, "get_log_follow_streams_new_lines_in_order")
    assert pinged == 1 and shaped
    assert ten
    assert ordered, "lines reordered"
    assert unique, "duplicate lines"
    assert stopped


def test_follow_cursor_reads_only_complete_lines(results):
    """The agent's cursor read never splits a line; truncation restarts
    it from 0."""
    first, held, landed, fresh = same_result(
        results, "follow_cursor_reads_only_complete_lines")
    assert first == (["one", "two"], len(b"one\ntwo\n"))
    assert held == ([], first[1])
    assert landed[0] == ["partial", "three"]
    assert fresh == (["fresh"], len(b"fresh\n"))


def test_mirrors_every_reference_test():
    assert_mirrored("log_streaming")
