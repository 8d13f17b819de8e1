"""``tests/test_actors.py`` on the port's runtime, test by test.

Every test's result is a value: each runs as a program of
``torch_api_programs``' "actors" group on both runtimes (``ray_tpu`` in a
fresh interpreter, then ``ray_tpu_torch`` here, each program on its own
4-CPU cluster). The two results must be equal, and the port's must pass
the reference test's own assertions, its time bounds included.
"""

import pytest

import torch_api_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "actors", tmp_path_factory)


def test_basic_actor(results):
    assert same_result(results, "basic_actor") == [1, 2]


def test_actor_constructor_args(results):
    assert same_result(results, "actor_constructor_args") == (11, 3)


def test_actor_ordering(results):
    assert same_result(results, "actor_ordering") == list(range(20))


def test_actor_state_isolated(results):
    assert same_result(results, "actor_state_isolated") == 1


def test_actor_error(results):
    (_, is_runtime_error, matched), ok = same_result(results, "actor_error")
    assert is_runtime_error and matched
    assert ok == "fine"


def test_actor_creation_error(results):
    assert same_result(results, "actor_creation_error") is not None


def test_named_actor(results):
    got, err = same_result(results, "named_actor")
    assert got == 1
    assert err is not None and err[1], err


def test_duplicate_named_actor(results):
    assert same_result(results, "duplicate_named_actor") is not None


def test_pass_handle_to_task(results):
    assert same_result(results, "pass_handle_to_task") == (1, 2)


def test_kill_actor(results):
    first, err = same_result(results, "kill_actor")
    assert first == 1
    assert err is not None and err[1], err


def test_actor_restart(results):
    assert same_result(results, "actor_restart") == (1, 1)


def test_async_actor(results):
    assert same_result(results, "async_actor") == ([0.3] * 5, True)


def test_threaded_actor(results):
    assert same_result(results, "threaded_actor") == ([0.4] * 4, True)


def test_exit_actor(results):
    first, err = same_result(results, "exit_actor")
    assert first == 1
    assert err is not None and err[1], err


def test_actor_method_num_returns(results):
    assert same_result(results, "actor_method_num_returns") == [1, 2]


def test_actor_pool(results):
    assert same_result(results, "actor_pool") == [0, 2, 4, 6, 8, 10]


def test_mirrors_every_reference_test():
    assert_mirrored("actors")
