"""The port's RLlib core, on-policy side (ray_tpu_torch.rllib, torch on the
CPU) against the JAX package's on the same numpy inputs and converted
state: sample batches, GAE and connectors (numpy copies, exact), the MLP
policy, V-trace, the PPO, A2C, IMPALA and BC learners (loss, every
gradient, params after 3 steps), offline JSON IO, and a CartPole-v1 rollout
fragment. Also torch twins of the JAX package's in-process RLlib tests.

Tolerances, float32 on both sides with other summation orders (XLA's
fused programs against eager torch on the CPU): losses and metrics to
1e-6 + 1e-5 relative; gradients to 1e-6 + 1e-4 relative; params and Adam
moments after 3 steps to 1e-6 + 1e-4 relative. Measured on this suite's
inputs: metrics within 5.2e-6 relative, gradients within 7.2e-7, params
within 1.2e-7 after 3 steps."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu import rllib as jr
from ray_tpu.rllib import connectors as jc
from ray_tpu.rllib import offline as joff
from ray_tpu.rllib import rollout_worker as jrw
from ray_tpu.rllib import sample_batch as jsb
from ray_tpu.rllib import vtrace as jvt
from ray_tpu_torch import random as trnd
from ray_tpu_torch import rllib as tr
from ray_tpu_torch.rllib import connectors as tc
from ray_tpu_torch.rllib import convert
from ray_tpu_torch.rllib import offline as toff
from ray_tpu_torch.rllib import sample_batch as tsb
from ray_tpu_torch.rllib import vtrace as tvt
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, ADVANTAGES, DONES, LOGPS, NEXT_VALUES, OBS, RETURNS, REWARDS,
    VALUES, SampleBatch,
)

LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
PARAM_TOL = dict(atol=1e-6, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_params(port, jax_params, **tol):
    want = convert.params(_np(jax_params))
    assert set(port) == set(want)
    for k in want:
        np.testing.assert_allclose(port[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


def _assert_metrics(port, ref):
    assert set(port) == set(ref), (port, ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)


# ----------------------------------------------------------- numpy copies


def test_gae_simple():
    rewards = np.array([1.0, 1.0, 1.0], np.float32)
    values = np.zeros(3, np.float32)
    dones = np.array([False, False, True])
    _, rets = tsb.compute_gae(rewards, values, dones, last_value=5.0,
                              gamma=1.0, lam=1.0)
    # terminal: no bootstrap; returns are reward-to-go
    np.testing.assert_allclose(rets, [3.0, 2.0, 1.0])
    _, rets2 = tsb.compute_gae(rewards, values,
                               np.array([False, False, False]),
                               last_value=5.0, gamma=1.0, lam=1.0)
    np.testing.assert_allclose(rets2, [8.0, 7.0, 6.0])  # bootstrapped


def test_batch_ops():
    a = SampleBatch({"x": np.arange(4)})
    b = SampleBatch({"x": np.arange(4, 6)})
    c = tr.concat_batches([a, b])
    assert c.count == 6
    mbs = list(c.minibatches(3))
    assert len(mbs) == 2 and mbs[0].count == 3
    sh = c.shuffle(np.random.default_rng(0))
    assert sorted(sh["x"]) == list(range(6))


def test_gae_and_batch_ops_equal_jax():
    rng = np.random.default_rng(3)
    r = rng.normal(size=50).astype(np.float32)
    v = rng.normal(size=50).astype(np.float32)
    d = rng.random(50) < 0.1
    for got, want in zip(tsb.compute_gae(r, v, d, 0.7, 0.99, 0.95),
                         jsb.compute_gae(r, v, d, 0.7, 0.99, 0.95)):
        assert got.dtype == want.dtype and (got == want).all()
    cols = {"x": rng.normal(size=(20, 3)), "y": np.arange(20)}
    tb = tsb.concat_batches([tsb.SampleBatch(cols)] * 2)
    jb = jsb.concat_batches([jsb.SampleBatch(cols)] * 2)
    ts = tb.shuffle(np.random.default_rng(1))
    js = jb.shuffle(np.random.default_rng(1))
    for t, j in zip(ts.minibatches(7), js.minibatches(7)):
        assert all((t[k] == j[k]).all() for k in cols)


def test_connector_pipeline_units():
    pipe = tc.ConnectorPipeline([tc.FlattenObs(), tc.ClipObs(-2, 2),
                                 tc.MeanStdFilter()])
    rng = np.random.default_rng(0)
    for _ in range(200):
        out = pipe.transform_obs(rng.normal(3.0, 2.0, size=(2, 2)))
    assert out.shape == (4,)
    assert abs(float(out.mean())) < 3.0
    pipe2 = tc.ConnectorPipeline([tc.FlattenObs(), tc.ClipObs(-2, 2),
                                  tc.MeanStdFilter()])
    pipe2.set_state(pipe.get_state())
    x = np.full((2, 2), 1.5)
    np.testing.assert_allclose(pipe.transform_obs(x.copy()),
                               pipe2.transform_obs(x.copy()), rtol=1e-5)
    ca = tc.ClipAction([-1.0, -0.5], [1.0, 0.5])
    np.testing.assert_allclose(ca.transform_action([3.0, -3.0]),
                               [1.0, -0.5])


def test_connectors_equal_jax():
    def pipe(m):
        return m.ConnectorPipeline([m.FlattenObs(), m.ClipObs(-2, 2),
                                    m.MeanStdFilter()])
    tp, jp = pipe(tc), pipe(jc)
    rng = np.random.default_rng(4)
    for _ in range(30):
        x = rng.normal(1.0, 2.0, size=(2, 3))
        assert (tp.transform_obs(x) == jp.transform_obs(x)).all()
    state = tp.get_state()
    assert state[2]["n"] == jp.get_state()[2]["n"] == 30
    assert (state[2]["m2"] == jp.get_state()[2]["m2"]).all()


# ----------------------------------------------------------------- policy


def test_policy_init_and_forward_match_jax():
    """init from one key: the reference's params to the few ulp of
    random.normal (tests/test_torch_random.py); forward, log-probs and
    sampled actions from the reference's own params."""
    for hidden in [(64, 64), (16,)]:
        jspec, tspec = jr.PolicySpec(5, 3, hidden), tr.PolicySpec(5, 3,
                                                                  hidden)
        jp = jr.MLPPolicy(jspec).init(jax.random.key(7))
        tp = tr.MLPPolicy(tspec, trnd.key(7, device="cpu"), device="cpu")
        _assert_params(tp.state_dict(), jp, atol=0, rtol=1e-6)
        tp.load_state_dict(convert.params(_np(jp)))
        obs = np.random.default_rng(0).normal(size=(32, 5)).astype(
            np.float32)
        with torch.no_grad():
            logits, values = tp(torch.from_numpy(obs))
            a, logp, v = tp.sample_action(
                torch.from_numpy(obs), trnd.fold_in(trnd.key(3,
                                                             device="cpu"), 1))
        jlogits, jvalues = jr.MLPPolicy.forward(jp, obs)
        np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(values.numpy(), jvalues, atol=1e-6,
                                   rtol=1e-6)
        ja, jlogp, _ = jr.MLPPolicy.sample_action(
            jp, obs, jax.random.fold_in(jax.random.key(3), 1))
        assert (a.numpy() == np.asarray(ja)).all()
        np.testing.assert_allclose(logp.numpy(), jlogp, atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(v.numpy(), values.numpy(), atol=0)


# ----------------------------------------------------------------- V-trace


def _vtrace_inputs(shape, seed, ratio_scale):
    rng = np.random.default_rng(seed)
    f = lambda s=1.0: (rng.normal(size=shape) * s).astype(np.float32)  # noqa
    behavior = f()
    target = behavior + f(ratio_scale)
    values = f()
    next_values = np.concatenate([values[1:], f()[:1]])
    discounts = (0.97 * (rng.random(shape) > 0.1)).astype(np.float32)
    return behavior, target, f(), values, next_values, discounts


@pytest.mark.parametrize("shape", [(40,), (25, 6)])
@pytest.mark.parametrize("clips", [(1.0, 1.0), (2.0, 0.5)])
def test_vtrace_matches_jax(shape, clips):
    """Off-policy ratios on both sides of each threshold, terminal steps
    inside the sequence: the same targets to 1e-6."""
    args = _vtrace_inputs(shape, sum(shape), 0.8)
    got = tvt.vtrace(*map(torch.from_numpy, args), *clips)
    want = jvt.vtrace(*args, *clips)
    for g, w in zip(got, want):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


def test_vtrace_on_policy_reduces_to_nstep():
    T, gamma = 5, 0.9
    rng = np.random.default_rng(0)
    rewards = rng.normal(size=T).astype(np.float32)
    values = rng.normal(size=T).astype(np.float32)
    bootstrap = 0.7
    next_values = np.append(values[1:], np.float32(bootstrap))
    logp = rng.normal(size=T).astype(np.float32)
    discounts = np.full(T, gamma, np.float32)
    t = torch.from_numpy
    out = tvt.vtrace(t(logp), t(logp), t(rewards), t(values),
                     t(next_values), t(discounts))
    expected = np.zeros(T, np.float32)
    acc = bootstrap
    for i in range(T - 1, -1, -1):
        acc = rewards[i] + gamma * acc
        expected[i] = acc
    np.testing.assert_allclose(out.vs.numpy(), expected, rtol=1e-5)


def test_vtrace_clipping_bounds_correction():
    T = 4
    behavior = np.zeros(T, np.float32)
    target = np.full(T, 5.0, np.float32)  # ratio e^5 ~ 148, clipped to 1
    rewards = np.ones(T, np.float32)
    values = np.zeros(T, np.float32)
    next_values = np.append(values[1:], np.float32(0.0))
    discounts = np.full(T, 0.9, np.float32)
    t = torch.from_numpy
    out = tvt.vtrace(t(behavior), t(target), t(rewards), t(values),
                     t(next_values), t(discounts))
    clipped = tvt.vtrace(t(behavior), t(behavior), t(rewards), t(values),
                         t(next_values), t(discounts))
    np.testing.assert_allclose(out.vs.numpy(), clipped.vs.numpy(),
                               rtol=1e-5)


# ---------------------------------------------------------------- learners


def _batch(n, seed, obs_dim=4, num_actions=2):
    """Every column a learner here reads; dones inside the batch."""
    rng = np.random.default_rng(seed)
    values = rng.normal(size=n).astype(np.float32)
    return SampleBatch({
        OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        ACTIONS: rng.integers(0, num_actions, n).astype(np.int32),
        LOGPS: rng.uniform(-1.2, -0.3, n).astype(np.float32),
        ADVANTAGES: rng.normal(size=n).astype(np.float32),
        RETURNS: rng.normal(size=n).astype(np.float32),
        REWARDS: rng.normal(size=n).astype(np.float32),
        DONES: rng.random(n) < 0.05,
        NEXT_VALUES: np.append(values[1:], np.float32(0.3)),
    })


LEARNERS = {
    "ppo": (lambda m: (m.PPOLearner, m.PPOConfig(seed=1))),
    "a2c": (lambda m: (m.A2CLearner, m.A2CConfig(seed=2))),
    "a2c-micro": (lambda m: (m.A2CLearner, m.A2CConfig(seed=2))),
    "impala": (lambda m: (m.IMPALALearner, m.IMPALAConfig(seed=3))),
    "bc": (lambda m: (m.BCLearner, m.BCConfig(seed=4))),
}


def _pair(name, obs_dim=4, num_actions=2, hidden=(32, 32)):
    """(JAX learner, port learner on the CPU holding its converted
    state)."""
    (jcls, jcfg), (tcls, tcfg) = LEARNERS[name](jr), LEARNERS[name](tr)
    jcfg.hidden = tcfg.hidden = hidden
    jl = jcls(jr.PolicySpec(obs_dim, num_actions, hidden), jcfg)
    tl = tcls(tr.PolicySpec(obs_dim, num_actions, hidden), tcfg,
              device="cpu")
    tl.set_state(convert.learner_state(_np(jl.get_state())))
    return jl, tl


def _update(name, learner, batch, rng):
    """One update as each learner's caller makes it."""
    if name == "ppo":
        return learner.update_from_batch(batch, num_epochs=1,
                                         minibatch_size=batch.count, rng=rng)
    if name.startswith("a2c"):
        return learner.update_from_batch(
            batch, microbatch_size=24 if name == "a2c-micro" else 0)
    if name == "impala":
        return learner.update_from_fragment(batch)
    return learner.step(batch)


@pytest.mark.parametrize("name", list(LEARNERS))
def test_learner_loss_grads_and_steps_match_jax(name):
    """From the reference learner's converted state: the loss and every
    gradient on one batch, then 3 updates on 3 batches (A2C: one
    optimizer step each, over 3 microbatches of 24, 24 and 16 rows for
    "a2c-micro"), each update's metrics, and the params and Adam moments
    after them."""
    jl, tl = _pair(name)
    b0 = _batch(64, 0)
    jgrads, jm = jl.compute_grads(dict(b0))
    tgrads, tm = tl.compute_grads(b0)
    _assert_metrics(tm, jm)
    _assert_params(tgrads, jgrads, **GRAD_TOL)
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(1, 4):
        b = _batch(64, i)
        _assert_metrics(_update(name, tl, b, trng), _update(name, jl, b, jrng))
    _assert_params(tl.get_weights(), jl.get_weights(), **PARAM_TOL)
    state = convert.adam(_np(jl.get_state()["opt_state"]))
    got = tl.get_state()["opt_state"]
    for k, st in state.items():
        assert got[k]["step"] == st["step"] == 3
        for m in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(got[k][m].numpy(), st[m].numpy(),
                                       err_msg=f"{k} {m}", **PARAM_TOL)


def test_learner_reduces_loss():
    learner = tr.PPOLearner(tr.PolicySpec(obs_dim=4, num_actions=2),
                            tr.PPOConfig(), device="cpu")
    rng = np.random.default_rng(0)
    batch = _batch(256, 0)
    m1 = learner.update_from_batch(batch, num_epochs=1, minibatch_size=128,
                                   rng=rng)
    for _ in range(5):
        m2 = learner.update_from_batch(batch, num_epochs=1,
                                       minibatch_size=128, rng=rng)
    assert m2["vf_loss"] < m1["vf_loss"]


def test_a2c_microbatch_single_optimizer_step():
    """Microbatched A2C accumulates gradients and takes ONE optimizer step
    per train batch: the Adam step count advances by exactly 1 and params
    match the full-batch update to accumulation-order tolerance."""
    spec, cfg = tr.PolicySpec(obs_dim=4, num_actions=2), tr.A2CConfig(seed=0)
    batch = _batch(96, 0)
    full = tr.A2CLearner(spec, cfg, device="cpu")
    micro = tr.A2CLearner(spec, cfg, device="cpu")
    micro.set_state(full.get_state())
    full.update_from_batch(batch, microbatch_size=0)
    m = micro.update_from_batch(batch, microbatch_size=32)
    assert isinstance(m, dict) and "policy_loss" in m
    steps = [st["step"] for st in micro.get_state()["opt_state"].values()]
    assert steps and all(s == 1 for s in steps), steps
    fw, mw = full.get_weights(), micro.get_weights()
    assert max(float((fw[k] - mw[k]).abs().max()) for k in fw) < 1e-4


def test_learner_state_roundtrip_and_weights_are_copies():
    learner = tr.PPOLearner(tr.PolicySpec(4, 2), tr.PPOConfig(),
                            device="cpu")
    w = learner.get_weights()
    state = learner.get_state()
    learner.step(_batch(32, 0))
    assert not torch.equal(w["pi.w"], learner.get_weights()["pi.w"])
    other = tr.PPOLearner(tr.PolicySpec(4, 2), tr.PPOConfig(seed=9),
                          device="cpu")
    other.set_state(learner.get_state())
    m1, m2 = learner.step(_batch(32, 1)), other.step(_batch(32, 1))
    assert m1 == m2
    learner.set_state(state)
    assert torch.equal(learner.get_weights()["pi.w"], w["pi.w"])


def test_learners_and_workers_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.PPOLearner(tr.PolicySpec(4, 2), tr.PPOConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.SACLearner(tr.ContinuousPolicySpec(3, 1), tr.SACConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.RolloutWorker(_CountEnv, tr.PolicySpec(4, 2))


# ----------------------------------------------------------------- offline


def test_offline_json_roundtrip_and_bc(tmp_path):
    """The port's writer and the reference's reader (and back) agree on the
    shards; BC trained from them fits the dataset's actions."""
    rng = np.random.default_rng(0)
    tw = toff.JsonWriter(str(tmp_path / "t"), max_shard_bytes=4000)
    batches = []
    for _ in range(6):
        obs = rng.normal(size=(40, 4)).astype(np.float32)
        b = {OBS: obs, ACTIONS: (obs[:, 0] > 0).astype(np.int32)}
        batches.append(b)
        tw.write(b)
    tw.close()
    assert len(toff.JsonReader(str(tmp_path / "t")).files) > 1
    mine = toff.JsonReader(str(tmp_path / "t")).read_all()
    theirs = joff.JsonReader(str(tmp_path / "t")).read_all()
    for k in (OBS, ACTIONS):
        assert (mine[k] == theirs[k]).all()
        assert (mine[k] == np.concatenate([b[k] for b in batches])).all()
    learner = tr.BCLearner(tr.PolicySpec(4, 2), tr.BCConfig(lr=3e-3),
                           device="cpu")
    first = learner.step(mine)["bc_loss"]
    for _ in range(60):
        last = learner.step(mine)["bc_loss"]
    assert last < 0.5 * first


# ----------------------------------------------------------------- workers


class _CountEnv:
    """A tiny deterministic env of CartPole's sizes (no gymnasium)."""

    class _Space:
        shape = (4,)

    observation_space = _Space()

    def reset(self, seed=None):
        self._t = 0
        return np.zeros(4, np.float32), {}

    def step(self, a):
        self._t += 1
        obs = np.full(4, 0.1 * self._t, np.float32)
        obs[0] = a
        return obs, 1.0, self._t % 11 == 0, self._t % 7 == 0, {}


def _gumbel_margin(key, logits):
    """Gap between the best and second-best gumbel + logits score of the
    reference's categorical draw."""
    g = np.sort(np.asarray(jax.random.gumbel(key, logits.shape)) + logits)
    return float(g[..., -1] - g[..., -2])


def _compare_fragments(got, want, stop):
    """Columns equal up to step ``stop`` (exclusive)."""
    for k in (OBS, ACTIONS, DONES):
        assert (got[k][:stop] == want[k][:stop]).all(), k
    for k in (LOGPS, VALUES, REWARDS, ADVANTAGES, RETURNS, NEXT_VALUES):
        np.testing.assert_allclose(got[k][:stop], want[k][:stop], atol=1e-5,
                                   rtol=1e-5, err_msg=k)



def _worker_parity(env_creator, gamma=0.99, lam=0.95, n=200, seed=3):
    """A port worker and the reference's, same converted weights and seed:
    actions, log-probs, values and GAE equal. Sampling through the gumbel
    trick can pick the other action only where the reference's top two
    scores are closer than the logits' rounding difference (1e-5 here);
    the episodes part there, so the comparison stops at such a draw."""
    jspec, tspec = jr.PolicySpec(4, 2), tr.PolicySpec(4, 2)
    jp = jr.MLPPolicy(jspec).init(jax.random.key(11))
    # scale the head up so the draws are not coin flips
    jp["pi"]["w"] = jp["pi"]["w"] * 300.0
    jw = jrw.RolloutWorker(env_creator, jspec, gamma=gamma, lam=lam,
                           rollout_fragment_length=n, seed=seed)
    tw = tr.RolloutWorker(env_creator, tspec, gamma=gamma, lam=lam,
                          rollout_fragment_length=n, seed=seed, device="cpu")
    want = jw.sample(jp)
    got = tw.sample(convert.params(_np(jp)))
    stop = n
    key = jax.random.key(seed)
    for t in range(n):
        key, sub = jax.random.split(key)
        if got[ACTIONS][t] != want[ACTIONS][t]:
            logits, _ = jr.MLPPolicy.forward(jp, want[OBS][t][None])
            assert _gumbel_margin(sub, np.asarray(logits)) < 1e-5, t
            stop = t
            break
    _compare_fragments(got, want, stop)
    if stop == n:
        assert got.completed_returns == want.completed_returns
    return got, want


def test_rollout_worker_matches_jax_on_a_numpy_env():
    """Terminations and time-limit truncations (bootstrapped with V(s'))
    inside the fragment."""
    got, _ = _worker_parity(_CountEnv, n=60)
    assert got[DONES].sum() >= 5 and len(got.completed_returns) >= 5


def test_rollout_worker_cartpole_matches_jax():
    gym = pytest.importorskip("gymnasium")
    got, want = _worker_parity(lambda: gym.make("CartPole-v1"))
    assert got.count == want.count == 200
