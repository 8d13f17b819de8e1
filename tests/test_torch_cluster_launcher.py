"""``tests/test_cluster_launcher.py`` on the port's runtime, test by test:
the cluster YAML launcher and its process-backed node provider.

Each test's body runs as a program of ``torch_libs_programs``'
"cluster_launcher" group on both runtimes; each starts its own cluster,
as the reference's do. The results must be equal and pass the
reference's assertions.
"""

import pytest

import torch_libs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "cluster_launcher", tmp_path_factory)


def test_yaml_launch_min_workers_and_autoscale(results):
    """``min_workers`` starts a node process at once; four 2-CPU tasks
    scale up within ``max_workers`` and all return."""
    alive, out, scaled = same_result(
        results, "yaml_launch_min_workers_and_autoscale")
    assert alive
    assert out == [1] * 4
    assert scaled


def test_bad_yaml_rejected(results):
    assert same_result(results, "bad_yaml_rejected") == "ValueError"


def test_mirrors_every_reference_test():
    assert_mirrored("cluster_launcher")
