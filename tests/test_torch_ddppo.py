"""The port's DD-PPO (ray_tpu_torch.rllib.ddppo) on the ``ray_tpu`` runtime
with its gang on the CPU, over the ``store`` and ``torch_dist`` (gloo)
collectives: twins of tests/test_ddppo.py's ``ray_cluster`` tests.

Gradient equivalence: a 2-rank gang, both ranks holding the JAX learner's
converted state, takes one decentralized update on two batches; the
averaged gradient it applied (read from Adam's first moment after that
step from fresh moments, which is 0.1 x the gradient) equals the JAX
DD-PPO's average (``ravel_pytree`` of each rank's gradient, then the
mean), reordered by ``rllib.convert.flat_to_port``. Tolerance: the learner
tolerances of tests/test_torch_rllib.py (float32, other summation orders;
the gang also shuffles each batch before its one minibatch).
"""

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import ray_tpu
from ray_tpu import rllib as jr
from ray_tpu.rllib.ppo import PPOLearner as JaxPPOLearner
from ray_tpu_torch.rllib import DDPPOConfig, convert
from ray_tpu_torch.rllib.ddppo import _DDPPOWorker
from ray_tpu_torch.rllib.policy import PolicySpec
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, ADVANTAGES, LOGPS, OBS, RETURNS, SampleBatch,
)

BACKENDS = ["store", "torch_dist"]
GRAD_TOL = dict(atol=1e-7, rtol=1e-4)


def _cartpole():
    return gym.make("CartPole-v1")


@pytest.fixture(scope="module")
def ray_cluster():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ctx = ray_tpu.init(num_cpus=4,
                           object_store_memory=128 * 1024 * 1024)
    yield ctx
    ray_tpu.shutdown()
    torch.set_num_threads(threads)


def _synthetic_batch(seed, n=32, obs_dim=4, num_actions=2):
    rng = np.random.default_rng(seed)
    return {
        OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        ACTIONS: rng.integers(0, num_actions, n).astype(np.int32),
        LOGPS: rng.normal(scale=0.1, size=n).astype(np.float32),
        ADVANTAGES: rng.normal(size=n).astype(np.float32),
        RETURNS: rng.normal(size=n).astype(np.float32),
    }


@pytest.mark.parametrize("backend", BACKENDS)
def test_ddppo_gradient_equivalence_with_jax(ray_cluster, backend):
    kw = dict(num_rollout_workers=2, rollout_fragment_length=16, obs_dim=4,
              num_actions=2, seed=5)
    b0, b1 = _synthetic_batch(1), _synthetic_batch(2)

    # The JAX DD-PPO's average: each rank's gradient raveled, then the mean.
    jcfg = jr.DDPPOConfig(**kw)
    central = JaxPPOLearner(jr.PolicySpec(4, 2), jcfg)
    state = jax.tree.map(np.asarray, central.get_state())
    flats = [np.asarray(ravel_pytree(central.compute_grads(dict(b))[0])[0])
             for b in (b0, b1)]
    jax_avg = np.stack(flats).mean(axis=0)

    cfg = DDPPOConfig(collective_backend=backend, **kw)
    cfg.environment(_cartpole)
    worker_cls = ray_tpu.remote(_DDPPOWorker)
    gang = [worker_cls.remote(_cartpole, PolicySpec(4, 2), cfg, 2, r,
                              f"eq_{backend}", device="cpu",
                              runtime=ray_tpu)
            for r in range(2)]
    try:
        ray_tpu.get([w.join.remote() for w in gang], timeout=120)
        ray_tpu.get([w.set_state.remote(convert.learner_state(state))
                     for w in gang])
        ray_tpu.get([w.train_iteration.remote(1, 10_000, SampleBatch(b))
                     for w, b in zip(gang, (b0, b1))], timeout=120)
        s0, s1 = ray_tpu.get([w.get_state.remote() for w in gang])
    finally:
        ray_tpu.get([w.leave.remote() for w in gang], timeout=60)
        for w in gang:
            ray_tpu.kill(w)
    # Ranks bit-identical after the update (replication invariant).
    for name, p in s0["params"].items():
        assert torch.equal(p, s1["params"][name]), name
    names = list(s0["params"])
    moment = np.concatenate([s0["opt_state"][n]["exp_avg"].reshape(-1)
                             .numpy() for n in names])
    want = convert.flat_to_port(jax_avg, state["params"], names)
    np.testing.assert_allclose(moment, np.float32(0.1) * want, **GRAD_TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_ddppo_end_to_end_stays_in_sync(ray_cluster, backend):
    """The DDPPO Algorithm on CartPole with no central learner: ranks stay
    bit-identical across their different sampled data, and metrics flow."""
    algo = (DDPPOConfig(num_sgd_epochs=2, sgd_minibatch_size=64,
                        collective_backend=backend)
            .environment(_cartpole)
            .rollouts(num_rollout_workers=2, rollout_fragment_length=64)
            .build(runtime=ray_tpu, device="cpu"))
    try:
        for _ in range(2):
            metrics = algo.train()
        assert metrics["timesteps_this_iter"] == 2 * 64
        assert "total_loss" in metrics
        w0, w1 = [ray_tpu.get(a.get_weights.remote()) for a in algo.workers]
        for name, p in w0.items():
            assert torch.equal(p, w1[name]), name
        # The state round-trips through the gang facade.
        state = algo.learner.get_state()
        algo.learner.set_state(state)
    finally:
        algo.stop()


def test_flat_to_port_reorders_jax_leaves():
    """jax flattens dict keys sorted; the port's parameter order is the
    module's own. A vector of leaf ids comes back in the port's order."""
    tree = {"trunk": [{"w": np.zeros((2, 3)), "b": np.zeros(3)}],
            "pi": {"w": np.zeros((3, 2)), "b": np.zeros(2)}}
    flat, _ = ravel_pytree(jax.tree.map(
        lambda x: np.full(x.shape, float(x.size), np.float32), tree))
    names = ["trunk.0.w", "trunk.0.b", "pi.w", "pi.b"]
    out = convert.flat_to_port(np.asarray(flat), tree, names)
    np.testing.assert_array_equal(out, [6] * 6 + [3] * 3 + [6] * 6 + [2] * 2)
    with pytest.raises(ValueError, match="values"):
        convert.flat_to_port(np.zeros(3), tree, names)
