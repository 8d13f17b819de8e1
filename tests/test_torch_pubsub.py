"""``tests/test_pubsub.py`` on the port's runtime, test by test.

Every test's result is a value: each runs as a program of
``torch_obs_programs``' "pubsub" group on both runtimes, each on the
reference fixture's cluster (2 CPUs, a 64 MiB store); the results must be
equal and pass the reference's assertions. The actor-state channel is the
one the port's gang supervisor reads for its death push.
"""

import pytest

import torch_obs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "pubsub", tmp_path_factory)


def test_publish_subscribe_roundtrip(results):
    assert same_result(results, "publish_subscribe_roundtrip") == \
        {"sev": 1, "msg": "hi"}


def test_publish_from_worker_reaches_driver(results):
    assert same_result(results, "publish_from_worker_reaches_driver") == \
        (7, {"i": 7})


def test_actor_state_channel(results):
    """The GCS publishes actor lifecycle transitions on actor_state."""
    ping, alive, saw_dead = same_result(results, "actor_state_channel")
    assert ping
    assert alive == ("ALIVE", "Blip")
    assert saw_dead, "never saw the DEAD transition"


def test_unsubscribed_channel_silent(results):
    got, empty = same_result(results, "unsubscribed_channel_silent")
    assert got == "yes"
    assert empty[1], empty   # get_nowait raised queue.Empty


def test_mirrors_every_reference_test():
    assert_mirrored("pubsub")
