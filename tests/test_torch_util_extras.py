"""``tests/test_util_extras.py`` on the port's runtime, test by test:
the multiprocessing ``Pool`` shim, ``check_serialize`` and usage stats.

Each test's body runs as a program of ``torch_libs_programs``'
"util_extras" group on both runtimes, on one cluster of the reference
fixture's size (4 CPUs, a 256 MiB store); the results must be equal and
pass the reference's assertions. The opt-out program sets each runtime's
own variable (``RAY_TPU_USAGE_STATS_ENABLED``,
``RAY_TPU_TORCH_USAGE_STATS_ENABLED``).
"""

import pytest

import torch_libs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "util_extras", tmp_path_factory)


def test_pool_map(results):
    assert same_result(results, "pool_map") == [x * x for x in range(10)]


def test_pool_apply_and_async(results):
    assert same_result(results, "pool_apply_and_async") == \
        [49, 64, True, True]


def test_pool_starmap_imap(results):
    assert same_result(results, "pool_starmap_imap") == (
        [8, 9], [x * x for x in range(6)], sorted(x * x for x in range(6)))


def test_pool_error_and_callbacks(results):
    """A raising task fails its result; ``map_async``'s callback gets the
    whole list once."""
    assert same_result(results, "pool_error_and_callbacks") == \
        [True, False, [1, 4, 9], True, [[1, 4, 9]]]


def test_pool_initializer(results):
    assert same_result(results, "pool_initializer") == ["42"] * 4


def test_pool_lifecycle(results):
    assert same_result(results, "pool_lifecycle") == \
        ["ValueError", "ValueError"]


def test_pool_join_waits_for_outstanding(results):
    """``join`` after ``close`` waits for submitted work; a finished result
    is untracked; ``imap`` submits at once; ``terminate`` drops the
    rest."""
    (tracked, waited, first, second, untracked, imap_tracked, imap_out,
     dropped) = same_result(results, "pool_join_waits_for_outstanding")
    assert tracked and waited and first == 1
    assert second == 2 and untracked
    assert imap_tracked and imap_out == [1, 2] and dropped


def test_check_serialize_ok(results):
    assert same_result(results, "check_serialize_ok") == (True, 0)


def test_check_serialize_finds_capture(results):
    assert same_result(results, "check_serialize_finds_capture") == \
        (False, True)


def test_usage_stats(results):
    """The library and the tag reach the snapshot, and the report written
    carries the version."""
    assert same_result(results, "usage_stats") == \
        (True, True, "on", True, True)


def test_usage_stats_opt_out(results):
    assert same_result(results, "usage_stats_opt_out") == \
        ((False, None), True)


def test_mirrors_every_reference_test():
    assert_mirrored("util_extras")
