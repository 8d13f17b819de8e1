"""The port's ``LearnerGroup`` and Tune adapter (ray_tpu_torch.rllib), run
on the JAX package's ``ray_tpu`` runtime with learners on the CPU: torch
twins of the ``ray_cluster`` tests of tests/test_rllib.py and
tests/test_rllib_algorithms.py on the group (replicas bit-identical, the
group within 5e-3 of one learner), PPO with two learners, and
``as_trainable`` driven by a ``ray_tpu.tune.Tuner``."""

import gymnasium as gym
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu_torch import rllib as tr
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, ADVANTAGES, LOGPS, OBS, RETURNS, SampleBatch,
)

CPU = dict(runtime=ray_tpu, device="cpu", worker_device="cpu")


def _cartpole():
    return gym.make("CartPole-v1")


@pytest.fixture(scope="module")
def ray_cluster():
    """A 4-CPU cluster whose processes, and this one, run torch on one
    thread each: a process that imports torch starts one intra-op thread
    per core, and the test workers run side by side. The cluster's worker
    processes take the variable from this environment at init."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ctx = ray_tpu.init(num_cpus=4,
                           object_store_memory=128 * 1024 * 1024)
    yield ctx
    ray_tpu.shutdown()
    torch.set_num_threads(threads)


def _assert_weights(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


def _assert_equal_weights(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------- learner group


def _random_ppo_batch(n=256):
    rng = np.random.default_rng(0)
    return SampleBatch({
        OBS: rng.normal(size=(n, 4)).astype(np.float32),
        ACTIONS: rng.integers(0, 2, n).astype(np.int32),
        LOGPS: np.full(n, -0.69, np.float32),
        ADVANTAGES: rng.normal(size=n).astype(np.float32),
        RETURNS: rng.normal(size=n).astype(np.float32),
    })


def _cpu_ppo_learner(spec, cfg):
    return tr.PPOLearner(spec, cfg, device="cpu")


def test_learner_group_checkpoint_state(ray_cluster):
    """get_state/set_state, so Algorithm.save/restore_checkpoint works with
    num_learners > 1."""
    spec, cfg = tr.PolicySpec(obs_dim=4, num_actions=2), tr.PPOConfig()
    group = tr.LearnerGroup(lambda: _cpu_ppo_learner(spec, cfg),
                            num_learners=2, runtime=ray_tpu)
    try:
        state = group.get_state()
        assert "params" in state and "opt_state" in state
        group.set_state(state)   # broadcast restores every shard
        _assert_equal_weights(group.get_weights(), state["params"])
    finally:
        group.stop()


def test_learner_group_matches_single_learner(ray_cluster):
    """DP invariants: (a) the learner replicas stay bit-identical after
    updates (the DDP replication invariant, exact); (b) the group tracks a
    single learner on the same batch closely, not exactly: PPO normalizes
    advantages within each learner's shard."""
    spec, cfg = tr.PolicySpec(obs_dim=4, num_actions=2), tr.PPOConfig(seed=3)
    batch = _random_ppo_batch(128)
    rng1, rng2 = np.random.default_rng(1), np.random.default_rng(1)
    single = _cpu_ppo_learner(spec, cfg)
    group = tr.LearnerGroup(lambda: _cpu_ppo_learner(spec, cfg),
                            num_learners=2, runtime=ray_tpu)
    try:
        m_single = single.update_from_batch(batch, num_epochs=2,
                                            minibatch_size=128, rng=rng1)
        m_group = group.update_from_batch(batch, num_epochs=2,
                                          minibatch_size=128, rng=rng2)
        assert m_single.keys() == m_group.keys()
        w0, w1 = ray_tpu.get([s.get_weights.remote()
                              for s in group._shards])
        _assert_equal_weights(w0, w1)
        _assert_weights(group.get_weights(), single.get_weights(),
                        atol=5e-3)
        assert not torch.equal(w0["pi.w"], _cpu_ppo_learner(
            spec, cfg).get_weights()["pi.w"])   # it did train
    finally:
        group.stop()


def test_learner_group_average_is_the_example_weighted_mean():
    """The reference's order of summation: (0 + 3 g0 + 5 g1) / 8."""
    g0 = {"w": torch.tensor([1.0, 2.0]), "b": torch.tensor([0.5])}
    g1 = {"w": torch.tensor([3.0, -1.0]), "b": torch.tensor([1.5])}
    avg = tr.LearnerGroup._average([g0, g1], [3, 5])
    assert torch.equal(avg["w"], (3 * g0["w"] + 5 * g1["w"]) / 8)
    assert torch.equal(avg["b"], torch.tensor([1.125]))


def test_ppo_with_learner_group(ray_cluster):
    algo = (tr.PPOConfig()
            .environment(_cartpole)
            .rollouts(num_rollout_workers=2, rollout_fragment_length=128)
            .training(num_sgd_epochs=2, sgd_minibatch_size=128,
                      num_learners=2)
            .build(**CPU))
    m = algo.train()
    assert m["timesteps_this_iter"] == 256
    assert "total_loss" in m
    assert isinstance(algo.learner, tr.LearnerGroup)
    algo.stop()


# ---------------------------------------------------------------- tune


def test_tuner_runs_the_trainable(ray_cluster):
    """A Tuner trial builds the port's PPO from the trial's config (lr) on
    the in-process runtime inside its worker, and reports each
    iteration through the session."""
    from ray_tpu.train import session
    from ray_tpu.tune import Tuner

    base = (tr.PPOConfig()
            .environment(_cartpole)
            .rollouts(num_rollout_workers=1, rollout_fragment_length=64)
            .training(num_sgd_epochs=1, sgd_minibatch_size=64))
    trainable = tr.PPO.as_trainable(base, stop_iters=2,
                                    report=session.report, device="cpu")
    grid = Tuner(trainable, param_space={"lr": 1e-3}).fit()
    assert not grid.errors, grid.errors
    history = grid[0].metrics_history
    assert [m["training_iteration"] for m in history] == [1, 2]
    assert [m["timesteps_total"] for m in history] == [64, 128]
    assert all(np.isfinite(m["total_loss"]) for m in history)


def test_as_trainable_reports_every_iteration():
    reports = []
    base = (tr.A2CConfig()
            .environment(_cartpole)
            .rollouts(num_rollout_workers=1, rollout_fragment_length=32))
    tr.A2C.as_trainable(base, stop_iters=3, report=reports.append,
                        device="cpu")({"lr": 5e-4})
    assert [r["training_iteration"] for r in reports] == [1, 2, 3]
    assert base.lr == tr.A2CConfig().lr     # the trial's copy took the lr


def test_learner_group_with_a_remote_learner_on_the_ports_runtime(
        ray_cluster):
    """``runtime=ray_tpu_torch``: one learner in a worker process of the
    port's own runtime takes the same update, bit for bit, as the same
    group on ``ray_tpu``, run first, and as a learner in this process."""
    import functools

    from torch_runtimes import ports_runtime

    spec, cfg = tr.PolicySpec(obs_dim=4, num_actions=2), tr.PPOConfig(seed=3)
    factory = functools.partial(tr.PPOLearner, spec, cfg, device="cpu")
    batch = _random_ppo_batch(128)

    def run(runtime):
        group = tr.LearnerGroup(factory, num_learners=1, runtime=runtime)
        try:
            m = group.update_from_batch(batch, num_epochs=2,
                                        minibatch_size=64,
                                        rng=np.random.default_rng(1))
            return m, group.get_weights()
        finally:
            group.stop()

    m_ref, w_ref = run(ray_tpu)
    with ports_runtime(restore=dict(num_cpus=4,
                                    object_store_memory=128 * 1024 * 1024),
                       num_cpus=2) as rt:
        m_port, w_port = run(rt)
    single = factory()
    m_single = single.update_from_batch(batch, num_epochs=2,
                                        minibatch_size=64,
                                        rng=np.random.default_rng(1))
    assert m_port == m_ref == m_single
    _assert_equal_weights(w_port, w_ref)
    _assert_equal_weights(w_port, single.get_weights())
