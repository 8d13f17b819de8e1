"""``tests/test_dag_workflow.py`` on the port's runtime, test by test:
the DAG API and durable workflows.

Each test's body runs as a program of ``torch_libs_programs``'
"dag_workflow" group on both runtimes, on one cluster as the reference's
module fixture starts it (4 CPUs, a 128 MiB store); the results must be
equal and pass the reference's assertions.
"""

import pytest

import torch_libs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "dag_workflow", tmp_path_factory)


def test_dag_basic(results):
    assert same_result(results, "dag_basic") == 25  # 5*2 + 5*3


def test_dag_diamond_single_execution(results):
    """A shared upstream node submits exactly once."""
    assert same_result(results, "dag_diamond_single_execution") == (2, 1)


def test_actor_method_bind(results):
    assert same_result(results, "actor_method_bind") == 5


def test_workflow_run_and_output(results):
    assert same_result(results, "workflow_run_and_output") == \
        (24, "SUCCESSFUL", 24, True)


def test_workflow_resume_skips_completed_steps(results):
    """The first run fails, the resume finishes, and the completed step
    ran once (its checkpoint is reused)."""
    assert same_result(results, "workflow_resume_skips_completed_steps") \
        == (True, "FAILED", 15, "SUCCESSFUL", 1)


def test_mirrors_every_reference_test():
    assert_mirrored("dag_workflow")
