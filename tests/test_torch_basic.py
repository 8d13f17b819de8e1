"""``tests/test_basic.py`` on the port's runtime, test by test.

Each test whose result is a value runs as a program of
``torch_api_programs``' "basic" group on both runtimes (``ray_tpu`` in a
fresh interpreter, then ``ray_tpu_torch`` here, each program on its own
cluster): the two results must be equal, and the port's must pass the
reference test's own assertions. ``test_free_objects`` reads the driver's
store, and runs on the port alone.
"""

import time

import pytest

import torch_api_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, ports_runtime, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "basic", tmp_path_factory)


def test_simple_task(results):
    assert same_result(results, "simple_task") == 2


def test_task_args_kwargs(results):
    assert same_result(results, "task_args_kwargs") == (6, 16)


def test_put_get(results):
    assert same_result(results, "put_get") == \
        [1, "hello", {"a": [1, 2]}, None, (1, 2)]


def test_put_get_numpy(results):
    assert same_result(results, "put_get_numpy") == \
        ((1000, 100), "float64", True)


def test_object_ref_as_arg(results):
    assert same_result(results, "object_ref_as_arg") == 11


def test_task_chain(results):
    assert same_result(results, "task_chain") == 11


def test_nested_refs_not_resolved(results):
    assert same_result(results, "nested_refs_not_resolved") == [0, 1, 2]


def test_multiple_returns(results):
    assert same_result(results, "multiple_returns") == [1, 2, 3]


def test_num_returns_zero(results):
    assert same_result(results, "num_returns_zero") is True


def test_error_propagation(results):
    _, is_value_error, matched = same_result(results, "error_propagation")
    assert is_value_error and matched


def test_error_through_dependency(results):
    assert same_result(results, "error_through_dependency") is not None


def test_nested_tasks(results):
    assert same_result(results, "nested_tasks") == 11


def test_wait(results):
    assert same_result(results, "wait") == (True, True)


def test_wait_timeout(results):
    assert same_result(results, "wait_timeout") == ([], 1)


def test_get_timeout(results):
    err = same_result(results, "get_timeout")
    assert err is not None and err[1], err


def test_large_object(results):
    assert same_result(results, "large_object") == 4 << 20


def test_large_task_arg(results):
    assert same_result(results, "large_task_arg") == 2 << 20


def test_many_parallel_tasks(results):
    assert same_result(results, "many_parallel_tasks") == \
        [i * i for i in range(100)]


def test_options_override(results):
    assert same_result(results, "options_override") == (1, 2)


def test_cluster_resources(results):
    assert same_result(results, "cluster_resources") == (4.0, 1, True)


def test_runtime_context(results):
    assert same_result(results, "runtime_context") == (True, True)


def test_cancel(results):
    err = same_result(results, "cancel")
    assert err is not None and err[1], err


def test_free_objects():
    with ports_runtime(num_cpus=4, object_store_memory=256 * 1024 * 1024) \
            as rt:
        from ray_tpu_torch._private import worker as worker_mod

        ref = rt.put("gone")
        core = worker_mod.require_worker()
        core.free([ref])
        time.sleep(0.2)
        assert not core.store.contains(ref.binary())


def test_mirrors_every_reference_test():
    assert_mirrored("basic")
