"""``tests/test_collective_dist.py`` on the port's runtime, test by test:
a collective group whose ranks are separate worker processes.

Each test's body runs as a program of ``torch_libs_programs``'
"collective_dist" group on both runtimes, on one cluster of the reference
fixture's size (4 CPUs, a 128 MiB store); the results must be equal and
pass the reference's assertions. The reference's ``xla_dist`` group (one
``jax.distributed`` world) is the port's ``torch_dist`` group (one
``torch.distributed`` world on gloo, a rank a process), and its
``JaxTrainer`` the port's ``TorchDistTrainer`` on that backend.
"""

import pytest

import torch_libs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "collective_dist", tmp_path_factory)


def test_xla_dist_group(results):
    """Two worker processes form one world, and every dense collective
    and the mailbox's send/recv span both."""
    out = same_result(results, "xla_dist_group")
    assert out["join"] == [True, True]
    assert out["process_count"] == [2, 2]
    assert out["process_index"] == [0, 1]
    assert out["mesh_devices"] == [2, 2]
    assert out["allreduce"] == [[3.0] * 8] * 2
    assert out["allgather"] == [[[0.0, 0.0], [1.0, 1.0]]] * 2
    assert out["broadcast"] == [[0.0, 1.0, 2.0, 3.0]] * 2
    for o in out["reducescatter"]:
        assert o == [[3.0] * 3] * 2
    assert out["p2p"] == [7.0] * 4
    assert out["barrier"] == [True, True]


def test_jax_trainer_uses_xla_dist(results):
    """The trainer's gradient allreduce runs on the cross-process group
    (``XlaDistributedGroup`` on ``ray_tpu``, ``TorchDistGroup`` on the
    port), whose world spans the gang, and the loss falls."""
    assert same_result(results, "jax_trainer_uses_xla_dist") == \
        (True, True, True)


def test_mirrors_every_reference_test():
    assert_mirrored("collective_dist")
