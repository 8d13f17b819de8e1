"""The port's RLlib core, off-policy and multi-agent side
(ray_tpu_torch.rllib, torch on the CPU) against the JAX package's on the
same numpy inputs and converted state: the DQN learner across a target
sync, Ape-X's prioritized shard (numpy, exact) and weighted update, the SAC
learner (critics, actor, alpha, polyak target), and the DQN, Ape-X, SAC and
multi-agent workers. Also torch twins of the JAX package's in-process
tests of these parts.

The reference's DQN, Ape-X and SAC updates are single jitted programs that
expose no gradients, so each parity test starts from a fresh Adam state:
after one step Adam's first moment is exactly 0.1 x the gradient, in both
packages, and the moments are compared. Tolerances are those of
tests/test_torch_rllib.py (float32, other summation orders): metrics to
1e-6 + 1e-5 relative, moments and params to 1e-6 + 1e-4 relative. SAC also
draws its noise through ``random.normal``, a few ulp from jax's
(tests/test_torch_random.py)."""

import cloudpickle
import jax
import numpy as np
import pytest
import torch

from ray_tpu import rllib as jr
from ray_tpu.rllib import apex as japex
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import multi_agent as jma
from ray_tpu.rllib import sac as jsac
from ray_tpu_torch import rllib as tr
from ray_tpu_torch.rllib import apex as tapex
from ray_tpu_torch.rllib import convert
from ray_tpu_torch.rllib import dqn as tdqn
from ray_tpu_torch.rllib import multi_agent as tma
from ray_tpu_torch.rllib import sac as tsac
from ray_tpu_torch.rllib.sample_batch import ACTIONS, OBS
from ray_tpu_torch.runtime import LocalRuntime

METRIC_TOL = dict(atol=1e-6, rtol=1e-5)
PARAM_TOL = dict(atol=1e-6, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_trees(port, jax_tree, prefix="", **tol):
    want = convert.params(_np(jax_tree), prefix)
    assert set(port) == set(want)
    for k in want:
        np.testing.assert_allclose(port[k].numpy(), want[k].numpy(),
                                   err_msg=k, **(tol or PARAM_TOL))


def _close_metrics(port, ref):
    assert set(port) == set(ref), (port, ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], err_msg=k, **METRIC_TOL)


def _close_adam(port_state, jax_opt_state, prefix=""):
    want = convert.adam(_np(jax_opt_state), prefix)
    assert set(port_state) == set(want)
    for k, st in want.items():
        assert port_state[k]["step"] == st["step"]
        for m in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(port_state[k][m].numpy(),
                                       st[m].numpy(), err_msg=f"{k} {m}",
                                       **PARAM_TOL)


def _transitions(n, seed, obs_dim=4, num_actions=2):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, obs_dim)).astype(np.float32)
    return {"obs": obs,
            "actions": rng.integers(0, num_actions, n).astype(np.int32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "next_obs": (obs + 0.1 * rng.normal(size=obs.shape)).astype(
                np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32)}


# --------------------------------------------------------------------- DQN


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_learner_matches_jax_across_target_sync(double_q):
    """One update from a fresh Adam state (moments = the gradient), then
    two more: the target net syncs after the second, so the third update's
    TD targets come from the synced net on both sides."""
    spec = dict(obs_dim=4, num_actions=2, hidden=(32, 32))
    cfg = dict(seed=3, target_update_freq=2, double_q=double_q, gamma=0.9)
    jl = jr.DQNLearner(jr.PolicySpec(**spec), jr.DQNConfig(**cfg))
    tl = tr.DQNLearner(tr.PolicySpec(**spec), tr.DQNConfig(**cfg),
                       device="cpu")
    tl.set_state(convert.learner_state(_np(jl.get_state())))
    tb, jb = tr.ReplayBuffer(500, 4), jr.ReplayBuffer(500, 4)
    t = _transitions(300, 0)
    for b in (tb, jb):
        b.add_batch(t["obs"], t["actions"], t["rewards"], t["next_obs"],
                    t["dones"])
    trng, jrng = np.random.default_rng(1), np.random.default_rng(1)
    for it in range(3):
        kw = dict(iters=1, batch_size=64)
        _close_metrics(tl.update_from_buffer(tb, rng=trng, **kw),
                       jl.update_from_buffer(jb, rng=jrng, **kw))
        if it == 0:
            _close_adam(tl.get_state()["opt_state"],
                        jl.get_state()["opt_state"])
    state = tl.get_state()
    assert state["num_updates"] == jl.num_updates == 3
    _close_trees(tl.get_weights(), jl.params)
    _close_trees(state["target_params"], jl.target_params)
    # synced at update 2, not at 3
    assert not np.allclose(_np(jl.target_params)["pi"]["w"],
                           _np(jl.params)["pi"]["w"])


def test_dqn_learner_reduces_td_error():
    rng = np.random.default_rng(0)
    spec = tr.PolicySpec(obs_dim=4, num_actions=2)
    learner = tr.DQNLearner(spec, tr.DQNConfig(lr=3e-3, gamma=0.0,
                                               target_update_freq=20),
                            device="cpu")
    buf = tr.ReplayBuffer(1024, 4)
    obs = rng.normal(size=(512, 4)).astype(np.float32)
    acts = rng.integers(0, 2, 512)
    rews = (obs[np.arange(512), acts % 4] > 0).astype(np.float32)
    buf.add_batch(obs, acts, rews, obs, np.zeros(512, np.float32))
    m1 = learner.update_from_buffer(buf, iters=5, batch_size=128, rng=rng)
    for _ in range(20):
        m2 = learner.update_from_buffer(buf, iters=5, batch_size=128,
                                        rng=rng)
    assert m2["loss"] < m1["loss"]


class _ToyEnv:
    """CartPole's sizes without gymnasium: 4 floats in, 2 actions; ends
    every 13 steps, truncates every 9."""

    def __init__(self):
        self._rng = np.random.default_rng(0)

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._rng.normal(size=4).astype(np.float32), {}

    def step(self, a):
        self._t += 1
        obs = self._rng.normal(size=4).astype(np.float32) + a
        return obs, float(a), self._t % 13 == 0, self._t % 9 == 0, {}


def _dqn_weights(seed=5):
    jp = jr.MLPPolicy(jr.PolicySpec(4, 2)).init(jax.random.key(seed))
    return jp, convert.params(_np(jp))


def test_dqn_worker_matches_jax():
    """Epsilon-greedy from the same numpy seed: the greedy argmax on the
    converted weights picks the reference's action at every step."""
    jp, tp = _dqn_weights()
    jw = jdqn._DQNRolloutWorker(_ToyEnv, jr.PolicySpec(4, 2),
                                rollout_fragment_length=80, seed=2)
    tw = tdqn._DQNRolloutWorker(_ToyEnv, tr.PolicySpec(4, 2),
                                rollout_fragment_length=80, seed=2,
                                device="cpu")
    for eps in (0.3, 0.0):
        want, got = jw.sample(jp, eps), tw.sample(tp, eps)
        assert got["completed_returns"] == want["completed_returns"]
        for k in ("obs", "actions", "rewards", "next_obs", "dones"):
            assert (got[k] == want[k]).all(), k


# ------------------------------------------------------------------- Ape-X


def _shards(capacity=64, obs_dim=2, alpha=1.0, seed=0):
    return (tapex._ReplayShard(capacity, obs_dim, alpha, 1e-6, seed),
            japex._ReplayShard(capacity, obs_dim, alpha, 1e-6, seed))


def test_prioritized_shard_math():
    """Sampling concentrates on high-priority entries; importance weights
    correct for the bias; priority updates take effect."""
    shard, _ = _shards()
    batch = {"obs": np.zeros((10, 2), np.float32),
             "actions": np.arange(10, dtype=np.int32),
             "rewards": np.zeros(10, np.float32),
             "next_obs": np.zeros((10, 2), np.float32),
             "dones": np.zeros(10, np.float32)}
    prios = np.ones(10)
    prios[3] = 100.0
    shard.add_batch(batch, prios)
    out, idx = shard.sample(512, beta=1.0)
    assert float(np.mean(out["actions"] == 3)) > 0.7
    w3 = out["weights"][out["actions"] == 3]
    w_other = out["weights"][out["actions"] != 3]
    assert w3.max() < w_other.min()
    shard.update_priorities(np.arange(10), np.ones(10))
    out2, _ = shard.sample(512, beta=1.0)
    assert float(np.mean(out2["actions"] == 3)) < 0.3


def test_prioritized_shard_equals_jax():
    """The numpy copy, call for call: adds with and without priorities
    (wrapping the ring), samples, priority updates and stats, exactly."""
    ts, js = _shards(capacity=48, obs_dim=4, alpha=0.6, seed=7)
    rng = np.random.default_rng(0)
    for i in range(5):
        b = _transitions(20, i)
        p = None if i % 2 else rng.random(20) * 3
        assert ts.add_batch(b, p) == js.add_batch(b, p)
        (tb, tidx), (jb, jidx) = ts.sample(32, 0.4), js.sample(32, 0.4)
        assert (tidx == jidx).all()
        assert all((tb[k] == jb[k]).all() for k in jb)
        new = rng.normal(size=len(tidx))
        ts.update_priorities(tidx, new)
        js.update_priorities(jidx, new)
        assert ts.stats() == js.stats()
    assert (ts.prios == js.prios).all()


def _jax_weighted(cfg, learner):
    """The reference's weighted update lives on ApexDQN, which needs the
    runtime to build; bind it to a bare instance holding only what it
    reads (config and learner)."""
    algo = japex.ApexDQN.__new__(japex.ApexDQN)
    algo.config, algo.learner = cfg, learner
    return algo._weighted_update


def test_apex_weighted_update_matches_jax():
    """Three importance-weighted updates from batches a prioritized shard
    draws (the same draws on both sides), the reference's |TD| fed back as
    both shards' priorities: loss, |TD|, the first update's moments, the
    params and the target sync after update 2."""
    spec = dict(obs_dim=4, num_actions=2, hidden=(32, 32))
    cfg = dict(seed=4, target_update_freq=2, gamma=0.95)
    jcfg = jr.ApexDQNConfig(**cfg)
    jl = jr.DQNLearner(jr.PolicySpec(**spec), jcfg)
    tl = tapex.ApexDQNLearner(tr.PolicySpec(**spec),
                              tr.ApexDQNConfig(**cfg), device="cpu")
    tl.set_state(convert.learner_state(_np(jl.get_state())))
    jupdate = _jax_weighted(jcfg, jl)
    ts, js = _shards(capacity=256, obs_dim=4, alpha=0.6, seed=1)
    b = _transitions(200, 9)
    ts.add_batch(b), js.add_batch(b)
    for it in range(3):
        (tbatch, tidx), (jbatch, jidx) = ts.sample(64, 0.4), js.sample(64,
                                                                       0.4)
        got, want = tl.weighted_update(tbatch), jupdate(jbatch)
        np.testing.assert_allclose(got.pop("_td_abs"), want["_td_abs"],
                                   **PARAM_TOL)
        _close_metrics(got, {k: v for k, v in want.items() if k != "_td_abs"})
        if it == 0:
            _close_adam(tl.get_state()["opt_state"], jl.opt_state)
        ts.update_priorities(tidx, want["_td_abs"])
        js.update_priorities(jidx, want["_td_abs"])
    assert tl.num_updates == jl.num_updates == 3
    _close_trees(tl.get_weights(), jl.params)
    _close_trees(tl.get_state()["target_params"], jl.target_params)


class _ReadableShard(tapex._ReplayShard):
    def columns(self, n):
        return self.size, self.obs[:n], self.actions[:n], self.prios[:n]


def test_apex_worker_priorities_match_jax():
    """The worker's TD-error priorities (online net as its own target) on
    its fragment, stored into a shard actor of the in-process runtime."""
    jp, tp = _dqn_weights(8)
    rt = LocalRuntime()
    shard = rt.remote(_ReadableShard).remote(128, 4, 1.0, 1e-6, 0)
    tw = tapex._ApexWorker(_ToyEnv, tr.PolicySpec(4, 2), [shard],
                           gamma=0.97, rollout_fragment_length=50, seed=1,
                           device="cpu")
    jw = japex._ApexWorker(_ToyEnv, jr.PolicySpec(4, 2), [], gamma=0.97,
                           rollout_fragment_length=50, seed=1)
    out = tw.sample_and_store(tp, 0.2)
    want = jw.sample(jp, 0.2)
    want.pop("completed_returns")
    prios = np.asarray(jw._td(jp, want["obs"], want["actions"],
                              want["rewards"], want["next_obs"],
                              want["dones"]))
    size, obs, actions, stored = rt.get(shard.columns.remote(50))
    assert out["steps"] == size == 50
    assert (obs == want["obs"]).all()
    assert (actions == want["actions"]).all()
    np.testing.assert_allclose(stored, np.maximum(prios, 1e-6), **PARAM_TOL)


# --------------------------------------------------------------------- SAC

SAC_SPEC = dict(obs_dim=3, action_dim=1, action_low=-2.0, action_high=2.0,
                hidden=(32, 32))


def _sac_pair(seed=0, **cfg):
    jl = jr.SACLearner(jr.ContinuousPolicySpec(**SAC_SPEC),
                       jr.SACConfig(seed=seed, **cfg))
    tl = tr.SACLearner(tr.ContinuousPolicySpec(**SAC_SPEC),
                       tr.SACConfig(seed=seed, **cfg), device="cpu")
    tl.set_state(convert.sac_state(_np(jl.get_state())))
    return jl, tl


def _sac_buffers(n=400, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, 3)).astype(np.float32)
    act = rng.uniform(-2, 2, size=(n, 1)).astype(np.float32)
    rew = (-(obs[:, 0] ** 2) - 0.1 * act[:, 0] ** 2).astype(np.float32)
    nxt = (obs + 0.05 * rng.normal(size=obs.shape)).astype(np.float32)
    done = (rng.random(n) < 0.05).astype(np.float32)
    bufs = (tr.ContinuousReplayBuffer(1000, 3, 1),
            jr.ContinuousReplayBuffer(1000, 3, 1))
    for b in bufs:
        b.add_batch(obs, act, rew, nxt, done)
    return bufs


@pytest.mark.parametrize("autotune", [True, False])
def test_sac_learner_matches_jax(autotune):
    """Critic, actor and alpha from the reference's converted state: each
    update's losses, alpha and entropy; after the first, both Adam states'
    moments (the critic and actor gradients, and alpha's); after three, the
    params, the polyak target, log_alpha and both Adam states."""
    jl, tl = _sac_pair(seed=2, autotune_alpha=autotune, lr=1e-3)
    tb, jb = _sac_buffers()
    trng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for it in range(3):
        _close_metrics(tl.update_from_buffer(tb, 1, 64, trng),
                       jl.update_from_buffer(jb, 1, 64, jrng))
        if it == 0:
            st = tl.get_state()
            _close_adam(st["opt_state"], jl.opt_state)
            if autotune:
                _close_adam(st["alpha_opt_state"], jl.alpha_opt_state,
                            "log_alpha")
    st = tl.get_state()
    _close_trees(st["params"], jl.params)
    _close_trees(st["target"], jl.target)
    _close_adam(st["opt_state"], jl.opt_state)
    np.testing.assert_allclose(float(st["log_alpha"]), float(jl.log_alpha),
                               **PARAM_TOL)
    _close_adam(st["alpha_opt_state"], jl.alpha_opt_state, "log_alpha")
    if not autotune:
        assert st["alpha_opt_state"]["log_alpha"]["step"] == 0
        assert float(st["log_alpha"]) == np.float32(np.log(0.1))


def test_sac_policy_init_and_draws_match_jax():
    """GaussianPolicy.init from one key (the few ulp of random.normal), and
    sample_action on the reference's params: actions and log-densities
    with the tanh squash and the Box rescaling."""
    jspec = jr.ContinuousPolicySpec(**SAC_SPEC)
    jp = jr.GaussianPolicy.init(jax.random.key(4), jspec)
    from ray_tpu_torch import random as trnd
    tp = tsac.GaussianPolicy(tr.ContinuousPolicySpec(**SAC_SPEC),
                             trnd.key(4, device="cpu"), device="cpu")
    _close_trees(tp.state_dict(), jp, atol=0, rtol=1e-6)
    tp.load_state_dict(convert.params(_np(jp)))
    obs = np.random.default_rng(1).normal(size=(256, 3)).astype(np.float32)
    with torch.no_grad():
        a, logp = tp.sample_action(torch.from_numpy(obs),
                                   trnd.key(9, device="cpu"))
    ja, jlogp = jr.GaussianPolicy.sample_action(jp, obs, jax.random.key(9),
                                                jspec)
    np.testing.assert_allclose(a.numpy(), ja, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(logp.numpy(), jlogp, atol=1e-5, rtol=1e-5)
    assert np.abs(a.numpy()).max() <= 2.0


def test_sac_learner_fits_critic():
    rng = np.random.default_rng(0)
    spec = tr.ContinuousPolicySpec(obs_dim=3, action_dim=1, action_low=-2.0,
                                   action_high=2.0, hidden=(32, 32))
    learner = tr.SACLearner(spec, tr.SACConfig(seed=0, lr=3e-3),
                            device="cpu")
    buf, _ = _sac_buffers(1000)
    m1 = learner.update_from_buffer(buf, 5, 128, rng)
    for _ in range(20):
        m2 = learner.update_from_buffer(buf, 5, 128, rng)
    assert m2["critic_loss"] < m1["critic_loss"]
    assert m2["alpha"] > 0
    assert np.isfinite(m2["entropy"])
    learner2 = tr.SACLearner(spec, tr.SACConfig(seed=1), device="cpu")
    learner2.set_state(learner.get_state())
    for k, v in learner.get_weights().items():
        assert torch.equal(v, learner2.get_weights()[k])
    assert torch.equal(learner2.log_alpha, learner.log_alpha)


class _PendulumLike:
    """Pendulum's sizes without gymnasium: 3 floats, 1 action in [-2, 2]."""

    def reset(self, seed=None):
        self._t, self._x = 0, np.float32(0.5)
        return np.asarray([1.0, 0.0, 0.5], np.float32), {}

    def step(self, a):
        self._t += 1
        self._x = np.float32(0.9 * self._x + 0.1 * float(a[0]))
        obs = np.asarray([np.cos(self._x), np.sin(self._x), self._x],
                         np.float32)
        return obs, -float(self._x) ** 2, False, self._t % 25 == 0, {}


@pytest.mark.parametrize("env", ["numpy", "pendulum"])
def test_sac_worker_matches_jax(env):
    """A fragment from the same key and converted weights: actions to the
    few ulp that random.normal and the squash leave, and the env's replies
    to them."""
    if env == "pendulum":
        gym = pytest.importorskip("gymnasium")
        creator = lambda: gym.make("Pendulum-v1")  # noqa: E731
    else:
        creator = _PendulumLike
    jspec = jr.ContinuousPolicySpec(**SAC_SPEC)
    jp = jr.GaussianPolicy.init(jax.random.key(6), jspec)
    jw = jsac._SACRolloutWorker(creator, jspec, 60, 3)
    tw = tsac._SACRolloutWorker(creator, tr.ContinuousPolicySpec(**SAC_SPEC),
                                60, 3, device="cpu")
    want, got = jw.sample(jp), tw.sample(convert.params(_np(jp)))
    assert got["episode_returns"] == pytest.approx(want["episode_returns"],
                                                   rel=1e-4)
    for k in ("obs", "actions", "rewards", "next_obs", "dones"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)


# ------------------------------------------------------------- multi-agent


class _TagTeamEnv:
    """Two agents see a +/-1 cue, one of them inverted, and are rewarded
    for answering with the cue; episodes of 16 steps."""

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
        return obs, rew, term, {"__all__": False}, {}


def _mapping(agent):
    return "p0" if agent == "a0" else "p1"


def test_multi_agent_worker_and_learners_match_jax():
    """Per-policy batches from one shared env (whole episodes and a
    bootstrapped tail), then one PPO update per policy: the port's
    ``policy_learners`` on its batches against the reference's learners on
    theirs."""
    policies = {"p0": (1, 2), "p1": (1, 2)}
    cfg = dict(lr=1e-3, seed=5, num_sgd_epochs=2, sgd_minibatch_size=32)
    jcfg = jr.MultiAgentPPOConfig(**cfg).multi_agent(
        policies={n: jr.PolicySpec(*s) for n, s in policies.items()},
        policy_mapping_fn=_mapping)
    tcfg = tr.MultiAgentPPOConfig(**cfg).multi_agent(
        policies={n: tr.PolicySpec(*s) for n, s in policies.items()},
        policy_mapping_fn=_mapping)
    ppo = jr.PPOConfig(lr=jcfg.lr, seed=jcfg.seed)
    jlearners = {n: jr.PPOLearner(s, ppo) for n, s in jcfg.policies.items()}
    tlearners = tma.policy_learners(tcfg, device="cpu")
    for n in policies:
        tlearners[n].set_state(convert.learner_state(
            _np(jlearners[n].get_state())))
    jweights = {n: lr.get_weights() for n, lr in jlearners.items()}
    jw = jma._MultiAgentRolloutWorker(
        _TagTeamEnv, jcfg.policies, cloudpickle.dumps(_mapping), 0.99, 0.95,
        70, 2)
    tw = tma._MultiAgentRolloutWorker(
        _TagTeamEnv, tcfg.policies, _mapping, 0.99, 0.95, 70, 2,
        device="cpu")
    want = jw.sample(jweights)
    got = tw.sample({n: lr.get_weights() for n, lr in tlearners.items()})
    assert got["steps"] == want["steps"] == 70
    assert got["episode_returns"] == want["episode_returns"]
    for n in policies:
        g, w = got["batches"][n], want["batches"][n]
        assert set(g) == set(w) and len(g[ACTIONS]) == 35
        for k in (OBS, ACTIONS):
            assert (g[k] == w[k]).all(), (n, k)
        for k in set(w) - {OBS, ACTIONS}:
            np.testing.assert_allclose(g[k], w[k], atol=1e-5, rtol=1e-5,
                                       err_msg=f"{n} {k}")
        kw = dict(num_epochs=2, minibatch_size=32)
        _close_metrics(
            tlearners[n].update_from_batch(
                tr.SampleBatch(g), rng=np.random.default_rng(0), **kw),
            jlearners[n].update_from_batch(
                jr.SampleBatch(w), rng=np.random.default_rng(0), **kw))
        _close_trees(tlearners[n].get_weights(), jlearners[n].params)
