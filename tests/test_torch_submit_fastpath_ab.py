"""The reference's submit-side fast paths turned off one at a time on both
runtimes (``torch_fastpath_programs``'s "submit" group): each program
runs its workload on a fresh cluster with one toggle off, and its results
and probes must be the reference's with the same toggle off. The workload
gives the same results with every fast path on and with each one off."""

import pytest

import torch_fastpath_programs as progs
from torch_runtimes import group_results

NAMES = [p.__name__ for p in progs.PROGRAMS["submit"]]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "submit", tmp_path_factory)


@pytest.mark.parametrize("program", NAMES)
def test_same_results_on_both_runtimes(results, program):
    ref = results["ray_tpu"][program]
    port = results["ray_tpu_torch"][program]
    assert ref[0] == "ok", ref
    assert port == ref


@pytest.mark.parametrize("program", NAMES)
def test_fast_path_off_gives_the_workloads_results(results, program):
    status, (out, _probe) = results["ray_tpu_torch"][program]
    assert status == "ok"
    assert out == progs.WORKLOAD_RESULT
