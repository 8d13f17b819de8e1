"""The port's RLlib algorithms, on-policy side (ray_tpu_torch.rllib: PPO,
A2C, IMPALA, checkpoints, connectors in a rollout actor), run on the JAX
package's ``ray_tpu`` runtime with learners and rollout actors on the CPU:
torch twins of the ``ray_cluster`` tests of tests/test_rllib.py and
tests/test_rllib_algorithms.py, with their configurations and thresholds
(learning needs statistical parity only); one iteration of PPO and of A2C
against the JAX algorithms from one config, seed and converted state; a
JAX checkpoint restored into the port.

Tolerances of the one-iteration parity are tests/test_torch_rllib.py's
(float32 on both sides, other summation orders): metrics to 1e-6 + 1e-5
relative, params to 1e-6 + 1e-4 relative."""

import pickle

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu import rllib as jr
from ray_tpu_torch import rllib as tr
from ray_tpu_torch.rllib import convert
from ray_tpu_torch.rllib.sample_batch import OBS

LOSS_TOL = dict(atol=1e-6, rtol=1e-5)
PARAM_TOL = dict(atol=1e-6, rtol=1e-4)
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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_weights(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


def _assert_equal_weights(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------------- learning


def test_ppo_cartpole_learns(ray_cluster):
    algo = (tr.PPOConfig()
            .environment(_cartpole)
            .rollouts(num_rollout_workers=2, rollout_fragment_length=256)
            .training(num_sgd_epochs=4, sgd_minibatch_size=128, lr=1e-3)
            .build(**CPU))
    first = algo.train()
    assert first["timesteps_this_iter"] == 512
    assert first["env_steps_per_sec"] > 0
    returns = []
    for _ in range(12):
        m = algo.train()
        if m["episode_return_mean"] is not None:
            returns.append(m["episode_return_mean"])
    algo.stop()
    # CartPole returns should clearly improve over ~13 iterations
    assert max(returns[-3:]) > returns[0] + 20, returns


def test_impala_cartpole_learns(ray_cluster):
    algo = (tr.IMPALAConfig()
            .environment(_cartpole)
            .rollouts(num_rollout_workers=2, rollout_fragment_length=256)
            .training(lr=2e-3, entropy_coeff=0.02)
            .build(**CPU))
    returns = []
    for _ in range(20):
        m = algo.train()
        assert m["fragments_this_iter"] >= 1
        if m["episode_return_mean"] is not None:
            returns.append(m["episode_return_mean"])
    algo.stop()
    assert m["timesteps_total"] > 2000
    assert max(returns[-4:]) > returns[0] + 15, returns


def test_a2c_cartpole_learns(ray_cluster):
    algo = (tr.A2CConfig()
            .environment(_cartpole)
            .rollouts(num_rollout_workers=2, rollout_fragment_length=256)
            .training(lr=2e-3)
            .build(**CPU))
    returns = []
    for _ in range(15):
        m = algo.train()
        if m["episode_return_mean"] is not None:
            returns.append(m["episode_return_mean"])
    algo.stop()
    assert max(returns[-4:]) > returns[0] + 15, returns


# --------------------------------------------------------- checkpoints


def test_algorithm_checkpoint_roundtrip(ray_cluster, tmp_path):
    def build():
        return (tr.A2CConfig()
                .environment(_cartpole)
                .rollouts(num_rollout_workers=1, rollout_fragment_length=64)
                .build(**CPU))

    algo = build()
    algo.train()
    algo.train()
    path = algo.save_checkpoint(str(tmp_path / "ckpt"))
    assert path.endswith("algorithm_state.pkl")
    with open(path, "rb") as f:      # plain pickle, tensors on the CPU
        state = pickle.load(f)
    assert state["config"]["env_creator"] is None
    algo2 = build()
    algo2.restore_checkpoint(str(tmp_path / "ckpt"))
    assert algo2.iteration == 2
    assert algo2.timesteps_total == algo.timesteps_total
    _assert_equal_weights(algo2.get_weights(), algo.get_weights())
    algo.stop()
    algo2.stop()


def test_restores_a_jax_checkpoint(ray_cluster, tmp_path):
    """A JAX ``algorithm_state.pkl``, read with jax, converted and set on
    the port's learner: the port's weights equal the reference's."""
    jalgo = (jr.A2CConfig()
             .environment(_cartpole)
             .rollouts(num_rollout_workers=1, rollout_fragment_length=64)
             .build())
    jalgo.train()
    path = jalgo.save_checkpoint(str(tmp_path / "jax"))
    with open(path, "rb") as f:
        state = pickle.load(f)
    talgo = (tr.A2CConfig()
             .environment(_cartpole)
             .rollouts(num_rollout_workers=1, rollout_fragment_length=64)
             .build(**CPU))
    talgo.learner.set_state(convert.learner_state(
        _np(state["learner_state"])))
    _assert_equal_weights(talgo.get_weights(),
                          convert.params(_np(jalgo.get_weights())))
    got = talgo.learner.get_state()["opt_state"]
    want = convert.adam(_np(state["learner_state"]["opt_state"]))
    assert {k: v["step"] for k, v in got.items()} == \
        {k: v["step"] for k, v in want.items()} == {k: 1.0 for k in want}
    jalgo.stop()
    talgo.stop()


# ---------------------------------------------- parity with the reference


@pytest.mark.parametrize("name", ["ppo", "a2c"])
def test_one_iteration_matches_jax(ray_cluster, name):
    """The JAX algorithm and the port's on one runtime, config and seed,
    the port's learner loaded with the reference's state: one ``train()``
    each samples the same episodes and lands on the same metrics and
    params."""
    jcls, tcls, train = {
        "ppo": (jr.PPOConfig, tr.PPOConfig,
                dict(num_sgd_epochs=2, sgd_minibatch_size=64, seed=7)),
        "a2c": (jr.A2CConfig, tr.A2CConfig, dict(seed=7)),
    }[name]
    rollouts = dict(num_rollout_workers=2, rollout_fragment_length=100)
    jalgo = (jcls().environment(_cartpole).rollouts(**rollouts)
             .training(**train).build())
    talgo = (tcls().environment(_cartpole).rollouts(**rollouts)
             .training(**train).build(**CPU))
    talgo.learner.set_state(convert.learner_state(
        _np(jalgo.learner.get_state())))
    want, got = jalgo.train(), talgo.train()
    jalgo.stop()
    talgo.stop()
    assert got["timesteps_this_iter"] == want["timesteps_this_iter"] == 200
    assert got["episode_return_mean"] == want["episode_return_mean"]
    assert set(got) == set(want)
    for k in set(want) - {"env_steps_per_sec", "episode_return_mean"}:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LOSS_TOL)
    _assert_weights(talgo.get_weights(),
                    convert.params(_np(jalgo.get_weights())), **PARAM_TOL)


# ---------------------------------------------------------- connectors


def test_connectors_in_rollout(ray_cluster):
    """A rollout actor with a connector pipeline samples with the PPO
    learner's weights (obs normalized before the policy on every step)."""
    spec = tr.PolicySpec(obs_dim=4, num_actions=2)
    worker = ray_tpu.remote(tr.RolloutWorker).remote(
        _cartpole, spec, rollout_fragment_length=64, seed=0,
        connectors=tr.ConnectorPipeline([tr.MeanStdFilter()]), device="cpu")
    learner = tr.PPOLearner(spec, tr.PPOConfig(), device="cpu")
    batch = ray_tpu.get(worker.sample.remote(learner.get_weights()))
    ray_tpu.kill(worker)
    assert batch.count == 64
    # Stored observations are the TRANSFORMED ones the policy saw.
    assert abs(float(np.asarray(batch[OBS]).mean())) < 5.0
