"""``tests/torch_spmd.World`` fails fast: after a call some of its ranks
failed, it kills its ranks and refuses every later call at once with the
first error; the same error from every rank leaves it usable.

The two tests share one world, in this order: the second leaves it dead."""

import time

import pytest

import torch_spmd


@pytest.fixture(scope="module")
def world():
    w = torch_spmd.World(2)
    try:
        yield w
    finally:
        w.close()


def test_world_stays_usable_after_the_same_error_on_every_rank(world):
    with pytest.raises(RuntimeError, match="every rank fails alike"):
        world.run(torch_spmd.same_error)
    assert world.error is None
    assert world.run(torch_spmd.whoami) == [0, 1]


def test_world_refuses_calls_after_a_rank_error(world):
    assert world.run(torch_spmd.whoami) == [0, 1]
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        world.run(torch_spmd.fail_on, 1)
    assert not any(p.is_alive() for p in world.procs)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="failed before") as exc:
        world.run(torch_spmd.whoami)
    assert time.perf_counter() - t0 < 1.0
    assert "rank 1 fails" in str(exc.value)
