"""``tests/test_apex.py`` on the port's runtime, test by test: Ape-X DQN,
sharded prioritized replay with priority feedback.

Each test's body runs as a program of ``torch_libs_programs``' "apex"
group on both runtimes, on one cluster of the reference fixture's size (4
CPUs, a 128 MiB store); the results must be equal and pass the
reference's assertions. On the port the learner and the rollout workers
run on the CPU (``device="cpu"``); ``chip_smoke.py`` phase 25 runs the
learner on the card.
"""

import pytest

import torch_libs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "apex", tmp_path_factory)


def test_prioritized_shard_math(results):
    """Sampling concentrates on the dominant entry, its importance weight
    is the smallest, and flattened priorities spread sampling back out."""
    assert same_result(results, "prioritized_shard_math") == \
        (True, True, True)


def test_apex_end_to_end(results):
    """Experience reaches both shards, the learner updates, priorities
    come back non-uniform, and the internal key is stripped."""
    (enough, n_shards, updated, stripped, both_fed,
     nonuniform) = same_result(results, "apex_end_to_end")
    assert enough and n_shards == 2 and updated and stripped
    assert both_fed and nonuniform


def test_mirrors_every_reference_test():
    assert_mirrored("apex")
