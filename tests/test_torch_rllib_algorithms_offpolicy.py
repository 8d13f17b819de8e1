"""The port's RLlib algorithms, off-policy, offline and multi-agent side
(ray_tpu_torch.rllib: DQN, Ape-X, SAC, BC, multi-agent PPO), run on the JAX
package's ``ray_tpu`` runtime with learners and rollout actors on the CPU:
torch twins of the ``ray_cluster`` tests of tests/test_rllib.py,
tests/test_rllib_algorithms.py and tests/test_apex.py, with their
configurations and thresholds (learning needs statistical parity only).
Then every algorithm on the in-process runtime: two builds from one seed
give bit-identical weights after 2 iterations."""

import gymnasium as gym
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu_torch import rllib as tr
from ray_tpu_torch.rllib.sample_batch import ACTIONS, OBS, SampleBatch

CPU = dict(runtime=ray_tpu, device="cpu", worker_device="cpu")


def _cartpole():
    return gym.make("CartPole-v1")


def _pendulum():
    return gym.make("Pendulum-v1")


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


def test_dqn_cartpole_improves(ray_cluster):
    """End-to-end DQN: epsilon-greedy rollout actors feeding the replay
    learner; the return trend must beat the random baseline."""
    algo = (tr.DQNConfig()
            .environment(_cartpole)
            .rollouts(num_rollout_workers=2, rollout_fragment_length=200)
            .training(lr=1e-3, learning_starts=400, num_sgd_iters=48,
                      train_batch_size=64, target_update_freq=100,
                      epsilon_decay_steps=3000, seed=0)
            .build(**CPU))
    try:
        first = None
        for _ in range(12):
            res = algo.train()
            if res["episode_return_mean"] is not None and first is None:
                first = res["episode_return_mean"]
        last = res["episode_return_mean"]
        assert res["timesteps_total"] >= 4000
        assert res["buffer_size"] > 1000
        assert res["epsilon"] < 0.5  # schedule advanced
        # CartPole random play scores ~20; learning should clearly beat it.
        assert last is not None and last > 40, (first, last)
    finally:
        algo.stop()


def test_apex_end_to_end(ray_cluster):
    """Full Ape-X loop on CartPole: experience flows worker -> shard
    without a driver hop, the learner trains from shards and feeds
    priorities back, weights refresh, iterations overlap."""
    algo = (tr.ApexDQNConfig(
                buffer_size=8000, learning_starts=200,
                train_batch_size=32, num_sgd_iters=8,
                num_replay_shards=2, rollout_fragment_length=100)
            .environment(_cartpole)
            .rollouts(num_rollout_workers=2)
            .build(**CPU))
    try:
        total_updates = 0
        for _ in range(4):
            m = algo.train()
            total_updates += m.get("learner_updates_this_iter", 0)
        assert m["replay_total"] >= 200
        assert m["replay_shards"] == 2
        assert total_updates > 0
        assert "_td_abs" not in m        # internal key stripped
        # Both shards received experience (round-robin pushes).
        sizes = ray_tpu.get(
            [s.stats.remote() for s in algo.replay_shards])
        assert all(s["size"] > 0 for s in sizes), sizes
        # Priorities are non-uniform after feedback.
        assert any(s["prio_max"] > s["prio_mean"] for s in sizes), sizes
    finally:
        algo.stop()


def test_sac_pendulum_end_to_end(ray_cluster):
    """SAC plumbing on a real continuous env: rollout actors sample
    tanh-Gaussian actions within bounds, the buffer fills, and updates
    run (full convergence needs ~10k+ steps, out of CI budget)."""
    algo = (tr.SACConfig()
            .environment(_pendulum)
            .rollouts(num_rollout_workers=1, rollout_fragment_length=200)
            .training(lr=3e-3, learning_starts=200, num_sgd_iters=8,
                      train_batch_size=64, seed=0)
            .build(**CPU))
    try:
        for _ in range(4):
            m = algo.train()
        assert m["timesteps_total"] == 800
        assert m["buffer_size"] == 800
        assert np.isfinite(m["critic_loss"])
        assert m["alpha"] > 0
        # Actions respected the Box bounds.
        a = algo.buffer.actions[:algo.buffer.size]
        assert a.min() >= -2.0 - 1e-5 and a.max() <= 2.0 + 1e-5
    finally:
        algo.stop()


def _write_expert(path, rng):
    """Expert: action = 1 iff obs[0] > 0 (a learnable deterministic
    rule); 6 batches of 128 to JSONL shards."""
    writer = tr.JsonWriter(path)
    for _ in range(6):
        obs = rng.normal(size=(128, 4)).astype(np.float32)
        writer.write(SampleBatch({OBS: obs,
                                  ACTIONS: (obs[:, 0] > 0).astype(np.int32)}))
    writer.close()


def test_offline_json_roundtrip_and_bc(tmp_path, ray_cluster):
    """Offline RL: record experiences with JsonWriter, read them back, and
    behavior-clone a policy that matches the (deterministic) expert on its
    states; the greedy evaluation rolls out on the learner's device."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "exp")
    _write_expert(path, rng)
    assert tr.JsonReader(path).read_all().count == 6 * 128
    algo = (tr.BCConfig(input_path=path)
            .environment(_cartpole)
            .training(lr=3e-3, sgd_iters_per_step=40,
                      train_batch_size=256, seed=0)
            .build(**CPU))
    try:
        m1 = algo.train()
        for _ in range(4):
            m2 = algo.train()
        assert m2["bc_loss"] < m1["bc_loss"]
        # Cloned policy reproduces the expert rule.
        test_obs = rng.normal(size=(256, 4)).astype(np.float32)
        with torch.no_grad():
            logits, _ = algo.learner.policy(torch.from_numpy(test_obs))
        pred = torch.argmax(logits, dim=1).numpy()
        agree = (pred == (test_obs[:, 0] > 0)).mean()
        assert agree > 0.9, agree
        ret = algo.evaluate(2)
        assert 1.0 <= ret <= 500.0
    finally:
        algo.stop()


class _TagTeamEnv:
    """Toy 2-agent env: each agent sees a +/-1 cue and must answer with
    the matching action; one agent's cue is INVERTED so the two agents
    need different policies: a policy-map test, not a broadcast test."""

    def __init__(self):
        self._rng = np.random.default_rng(0)
        self._t = 0

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._draw(), {}

    def _draw(self):
        self._cue = int(self._rng.integers(0, 2))
        obs = np.asarray([2.0 * self._cue - 1.0], np.float32)
        return {"a0": obs, "a1": -obs}

    def step(self, actions):
        rew = {"a0": float(actions["a0"] == self._cue),
               "a1": float(actions["a1"] == self._cue)}
        self._t += 1
        done = self._t >= 16
        obs = self._draw()
        term = {"a0": done, "a1": done, "__all__": done}
        trunc = {"__all__": False}
        return obs, rew, term, trunc, {}


def _ma_config(spec, fragment=256):
    return (tr.MultiAgentPPOConfig()
            .environment(_TagTeamEnv)
            .rollouts(num_rollout_workers=1,
                      rollout_fragment_length=fragment)
            .training(lr=3e-3, num_sgd_epochs=4, sgd_minibatch_size=64,
                      seed=0)
            .multi_agent(policies={"even": spec, "odd": spec},
                         policy_mapping_fn=lambda agent:
                         "even" if agent == "a0" else "odd"))


def test_multi_agent_policy_map_learns(ray_cluster, tmp_path):
    """Two agents with OPPOSITE observation conventions learn under two
    mapped policies; the rollout actor takes the mapping function through
    the runtime's serializer. The multi-policy checkpoint restores every
    policy."""
    spec = tr.PolicySpec(obs_dim=1, num_actions=2, hidden=(16,))
    algo = _ma_config(spec).build(**CPU)
    try:
        returns = []
        for _ in range(14):
            m = algo.train()
            if m["episode_return_mean"] is not None:
                returns.append(m["episode_return_mean"])
        # 16 steps x 2 agents x ~1.0 reward when solved = ~32; random ~16.
        assert returns[-1] > returns[0] + 4, returns
        assert any(k.startswith("even/") for k in m)
        assert any(k.startswith("odd/") for k in m)
        algo.save_checkpoint(str(tmp_path / "ma"))
        other = _ma_config(spec).build(device="cpu")
        other.restore_checkpoint(str(tmp_path / "ma"))
        assert other.iteration == 14
        for name, learner in algo.learners.items():
            got = other.learners[name].get_weights()
            for k, v in learner.get_weights().items():
                assert torch.equal(got[k], v), (name, k)
        other.stop()
    finally:
        algo.stop()


# ----------------------------------------- in-process runtime, determinism


def _configs(tmp_path):
    small = dict(num_rollout_workers=2, rollout_fragment_length=64)
    offpolicy = dict(learning_starts=64, num_sgd_iters=4,
                     train_batch_size=32)
    path = str(tmp_path / "exp")
    _write_expert(path, np.random.default_rng(1))
    spec = tr.PolicySpec(obs_dim=1, num_actions=2, hidden=(16,))
    return {
        "ppo": tr.PPOConfig(num_sgd_epochs=2, sgd_minibatch_size=64)
        .environment(_cartpole).rollouts(**small),
        "ppo-group": tr.PPOConfig(num_sgd_epochs=2, sgd_minibatch_size=64,
                                  num_learners=2)
        .environment(_cartpole).rollouts(**small),
        "a2c": tr.A2CConfig(microbatch_size=48).environment(_cartpole)
        .rollouts(**small),
        "impala": tr.IMPALAConfig(max_fragments_per_step=3)
        .environment(_cartpole).rollouts(**small),
        "dqn": tr.DQNConfig(**offpolicy).environment(_cartpole)
        .rollouts(**small),
        "apex": tr.ApexDQNConfig(**offpolicy).environment(_cartpole)
        .rollouts(**small),
        "sac": tr.SACConfig(**offpolicy, hidden=(32, 32))
        .environment(_pendulum).rollouts(**small),
        "multi-agent": _ma_config(spec, fragment=64),
        "bc": tr.BCConfig(input_path=path, sgd_iters_per_step=4,
                          train_batch_size=64).environment(_cartpole),
    }


@pytest.mark.parametrize("name", ["ppo", "ppo-group", "a2c", "impala",
                                  "dqn", "apex", "sac", "multi-agent",
                                  "bc"])
def test_two_builds_from_one_seed_are_bit_identical(tmp_path, name):
    """In-process, on the CPU: the same seed gives the same weights, bit
    for bit, after 2 iterations, and the iterations did train."""
    cfg = _configs(tmp_path)[name]
    runs = []
    for _ in range(2):
        algo = cfg.build(device="cpu")
        start = algo.get_weights()
        metrics = [algo.train() for _ in range(2)]
        runs.append((start, algo.get_weights(), metrics))
        algo.stop()
    (start, a, ma), (_, b, mb) = runs
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert any(not torch.equal(a[k], start[k]) for k in a)
    for x, y in zip(ma, mb):
        assert {k: v for k, v in x.items() if k != "env_steps_per_sec"} == \
            {k: v for k, v in y.items() if k != "env_steps_per_sec"}
