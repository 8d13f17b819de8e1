"""``tests/test_generators.py`` on the port's runtime, test by test.

Every test's result is a value: each runs as a program of
``torch_api_programs``' "generators" group on both runtimes (``ray_tpu``
in a fresh interpreter, then ``ray_tpu_torch`` here, each program on its
own cluster: 4 CPUs, or the reference's two 2-CPU nodes for the lost
yield). The two results must be equal, and the port's must pass the
reference test's own assertions. The kill mid-yield goes through each
runtime's ``test_utils.kill_any_busy_worker``; the data test through each
runtime's ``data`` package.
"""

import pytest

import torch_api_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "generators", tmp_path_factory)


def test_dynamic_generator_basic(results):
    assert same_result(results, "dynamic_generator_basic") == \
        (True, 5, True, [i * i for i in range(5)])


def test_dynamic_generator_variable_counts(results):
    assert same_result(results, "dynamic_generator_variable_counts") == [
        (n, list(range(n))) for n in (0, 1, 7)]


def test_dynamic_generator_refs_usable_as_args(results):
    assert same_result(results,
                       "dynamic_generator_refs_usable_as_args") == [11, 21]


def test_dynamic_generator_exception(results):
    err = same_result(results, "dynamic_generator_exception")
    assert err is not None and err[1] and err[2], err


def test_dynamic_generator_non_generator_return_errors(results):
    assert same_result(
        results, "dynamic_generator_non_generator_return_errors") is not None


def test_dynamic_generator_retry_after_kill_mid_yield(results):
    assert same_result(
        results, "dynamic_generator_retry_after_kill_mid_yield") == \
        (True, 6, list(range(6)))


def test_dynamic_generator_lost_yield_reconstructs(results):
    assert same_result(results,
                       "dynamic_generator_lost_yield_reconstructs") == \
        [0, 1, 2]


def test_data_dynamic_block_splitting(results):
    assert same_result(results, "data_dynamic_block_splitting") == \
        (True, list(range(1, 96)), 4, list(range(37)))


def test_mirrors_every_reference_test():
    assert_mirrored("generators")
