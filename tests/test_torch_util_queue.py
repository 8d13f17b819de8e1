"""``tests/test_util_queue.py`` on the port's runtime, test by test.

Each test's body runs as a program of ``torch_libs_programs``' "util_queue"
group on both runtimes, on one cluster of the reference fixture's size (2
CPUs, a 64 MiB store); the results must be equal and pass the reference's
assertions. ``Empty`` and ``Full`` come back by name.
"""

import pytest

import torch_libs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "util_queue", tmp_path_factory)


def test_fifo_roundtrip(results):
    assert same_result(results, "fifo_roundtrip") == \
        [5, list(range(5)), True, "Empty"]


def test_maxsize_blocks_and_full(results):
    """Full at maxsize, both without waiting and at a put's timeout; a
    blocked put returns once another thread makes room."""
    assert same_result(results, "maxsize_blocks_and_full") == \
        [True, "Full", "Full", False, 2]


def test_queue_across_tasks(results):
    assert same_result(results, "queue_across_tasks") == \
        ([0, 10, 20, 30], True)


def test_batch_ops(results):
    assert same_result(results, "batch_ops") == [[1, 2, 3], "Empty"]


def test_mirrors_every_reference_test():
    assert_mirrored("util_queue")
