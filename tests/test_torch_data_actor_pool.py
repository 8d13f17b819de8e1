"""``tests/test_data_actor_pool.py`` on the port's runtime, test by test:
``map_batches(compute=ActorPoolStrategy)``, stateful UDFs on a pool of
long-lived actors.

Each test's body runs as a program of ``torch_libs_programs``'
"data_actor_pool" group on both runtimes, on one cluster of the reference
fixture's size (4 CPUs, a 128 MiB store); the results must be equal and
pass the reference's assertions. The reference's JAX model UDF is a torch
one on the port (``ModelPredictor``).
"""

import pytest

import torch_libs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "data_actor_pool", tmp_path_factory)


def test_actor_pool_init_once_per_actor(results):
    """The model UDF's constructor runs once per pool actor, at most
    ``max_size`` (2) times, in distinct processes."""
    n, shapes_ok, inits_in_range, distinct = same_result(
        results, "actor_pool_init_once_per_actor")
    assert n == 32 and shapes_ok
    assert inits_in_range and distinct


def test_actor_pool_respects_max_size(results):
    assert same_result(results, "actor_pool_respects_max_size") is True


def test_actor_pool_composes_with_task_stages(results):
    assert same_result(results, "actor_pool_composes_with_task_stages") == \
        [v + 10 for v in range(20) if (v + 10) % 2 == 0]


def test_actor_pool_explain_and_plain_callable(results):
    named, values = same_result(results,
                                "actor_pool_explain_and_plain_callable")
    assert named
    assert values == [2 * v for v in range(8)]


def test_actor_pool_streaming_iter_batches(results):
    assert same_result(results, "actor_pool_streaming_iter_batches") == \
        list(range(24))


def test_mirrors_every_reference_test():
    assert_mirrored("data_actor_pool")
