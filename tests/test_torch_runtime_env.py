"""``tests/test_runtime_env.py`` on the port's runtime, test by test.

Every test's result is a value: each runs as a program of
``torch_obs_programs``' "runtime_env" group on both runtimes, each on the
reference fixture's cluster (2 CPUs, a 128 MiB store); the results must be
equal and pass the reference's assertions. The pip programs install
wheels they build in their own directory, as the reference's
``_make_wheel`` does: nothing is downloaded. ``KV_NAMESPACE`` is each
runtime's own.
"""

import pytest

import torch_obs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "runtime_env", tmp_path_factory)


def test_py_modules_importable_in_task(results):
    assert same_result(results, "py_modules_importable_in_task") == \
        (1234, 42)


def test_working_dir_sets_cwd(results):
    assert same_result(results, "working_dir_sets_cwd") == "payload-7"


def test_actor_runtime_env(results):
    assert same_result(results, "actor_runtime_env") == "hi cfgval"


def test_uri_cache_deduplicates(results):
    """The same content uploads once (content-addressed KV key) and the
    node extracts it once."""
    first, second, n_keys, one_entry = same_result(
        results, "uri_cache_deduplicates")
    assert first == second == ["f.txt"]
    assert n_keys == 1   # one content hash, uploaded once
    assert one_entry     # the node's URI cache holds that one extraction


def test_env_vars_still_honored_with_working_dir(results):
    assert same_result(results,
                       "env_vars_still_honored_with_working_dir") == \
        ("on", True)


def test_runtime_env_plugin_api(results):
    """A custom key is packaged driver-side and materialized node-side
    into worker env vars + sys.path; explicit env_vars beat the
    plugin's."""
    (tag, on_path), explicit = same_result(results,
                                           "runtime_env_plugin_api")
    assert tag == "hello-plugin"
    assert on_path
    assert explicit == "explicit"


def test_pip_env_version_isolation(results):
    """Two concurrent tasks with different pip envs import different
    versions of one package; a task without the env sees none."""
    assert same_result(results, "pip_env_version_isolation") == \
        ("1.0", "2.0", "clean")


def test_pip_env_venv_cached(results):
    """The same pip spec reuses its cached venv (one venv dir per hash)."""
    assert same_result(results, "pip_env_venv_cached") == ("3.1", "3.1", 1)


def test_mirrors_every_reference_test():
    assert_mirrored("runtime_env")
