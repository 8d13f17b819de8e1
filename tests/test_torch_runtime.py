"""The port's in-process runtime (ray_tpu_torch/runtime.py): the runtime
seam's contract as the port's algorithms rely on it, its signatures
against the JAX package's ``ray_tpu`` API, and its value semantics; and the
entry points that run actors on it default to CUDA."""

import inspect

import gymnasium as gym
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu_torch import rllib as tr
from ray_tpu_torch.runtime import ActorDiedError, LocalRuntime, ObjectRef


class _Counter:
    def __init__(self, start=0):
        self.n = start

    def add(self, k=1):
        self.n += k
        return self.n

    def fail(self):
        raise KeyError("boom")


class _Keeper:
    """Keeps what it is given, as a replay shard or a worker's weights."""

    def __init__(self, init):
        self.kept = init

    def keep(self, value):
        self.kept = value
        return value

    def read(self):
        return self.kept

    def call(self, other, k):
        return self.kept, other.add.remote(k)


@pytest.fixture
def rt():
    return LocalRuntime()


def test_signatures_match_the_ray_tpu_api():
    """The calls the port makes run on either runtime: the same names,
    parameters, kinds and defaults as ``ray_tpu/api.py``."""
    for name in ("remote", "get", "put", "wait", "kill", "get_actor",
                 "get_runtime_context"):
        mine = inspect.signature(getattr(LocalRuntime(), name))
        theirs = inspect.signature(getattr(ray_tpu, name))
        if name == "remote":   # ray_tpu's is a decorator: (*args, **kw)
            assert list(mine.parameters) == ["cls_or_fn"]
            continue
        assert [(p.name, p.kind, p.default)
                for p in mine.parameters.values()] == \
            [(p.name, p.kind, p.default)
             for p in theirs.parameters.values()], name


def test_actor_state_persists_across_calls(rt):
    c = rt.remote(_Counter).remote(5)
    refs = [c.add.remote() for _ in range(3)]
    assert all(isinstance(r, ObjectRef) for r in refs)
    assert rt.get(refs) == [6, 7, 8]
    assert rt.get(c.add.remote(k=10)) == 18


def test_options_and_named_actors(rt):
    cls = rt.remote(_Counter)
    c = cls.options(num_cpus=1, num_gpus=0, num_tpus=0,
                    name="counter").remote()
    rt.get(c.add.remote(3))
    found = rt.get_actor("counter")
    assert found is c and rt.get(found.add.remote()) == 4
    with pytest.raises(ValueError, match="exists"):
        cls.options(name="counter").remote()
    with pytest.raises(ValueError, match="Failed to look up"):
        rt.get_actor("missing")
    with pytest.raises(TypeError, match="unsupported options"):
        cls.options(max_restarts=3)
    fn = rt.remote(lambda x: 2 * x)
    assert rt.get(fn.options(num_cpus=2).remote(21)) == 42


def test_get_keeps_order_and_put_round_trips(rt):
    fn = rt.remote(lambda i: i * i)
    refs = [fn.remote(i) for i in range(6)]
    assert rt.get(refs[::-1]) == [25, 16, 9, 4, 1, 0]
    value = {"a": np.arange(4), "b": [1, 2]}
    ref = rt.put(value)
    got = rt.get(ref)
    assert got is not value and (got["a"] == value["a"]).all()
    assert got["b"] == value["b"]
    with pytest.raises(TypeError):
        rt.get(3)


def test_wait_returns_ready_refs_in_input_order(rt):
    fn = rt.remote(lambda i: i)
    refs = [fn.remote(i) for i in range(5)]
    ready, rest = rt.wait(refs)
    assert ready == refs[:1] and rest == refs[1:]
    ready, rest = rt.wait(refs[::-1], num_returns=3, timeout=0)
    assert ready == refs[::-1][:3] and rest == refs[::-1][3:]
    assert rt.wait(refs, num_returns=5) == (refs, [])
    with pytest.raises(ValueError):
        rt.wait(refs, num_returns=6)
    with pytest.raises(ValueError):
        rt.wait([refs[0], refs[0]])
    with pytest.raises(TypeError):
        rt.wait(refs[0])


def test_exceptions_raise_at_get_not_at_remote(rt):
    c = rt.remote(_Counter).remote()
    ref = c.fail.remote()            # no raise here
    with pytest.raises(KeyError, match="boom"):
        rt.get(ref)
    with pytest.raises(KeyError):
        rt.get([c.add.remote(), ref])
    task = rt.remote(lambda: 1 / 0).remote()
    with pytest.raises(ZeroDivisionError):
        rt.get(task)
    # a constructor's error surfaces at get() of each call
    bad = rt.remote(_Counter).remote(start=None)
    with pytest.raises(TypeError):
        rt.get(bad.add.remote())
    assert rt.get(c.add.remote()) == 2   # the actor survives its errors


def test_call_on_a_killed_actor_raises(rt):
    c = rt.remote(_Counter).options(name="c").remote()
    rt.get(c.add.remote())
    rt.kill(c)
    rt.kill(c)                      # killing twice is harmless
    with pytest.raises(ActorDiedError):
        rt.get(c.add.remote())
    with pytest.raises(ValueError):
        rt.get_actor("c")
    with pytest.raises(TypeError):
        rt.kill(object())


def test_arguments_and_results_pass_by_value(rt):
    """An actor never sees its caller's later in-place writes, nor the
    caller the actor's, as between the real runtime's processes; handles
    pass as themselves."""
    arr = np.zeros(3, np.float32)
    weights = {"w": torch.zeros(2)}
    k = rt.remote(_Keeper).remote(weights)
    weights["w"] += 1.0              # after the constructor
    assert float(rt.get(k.read.remote())["w"].sum()) == 0.0
    out = rt.get(k.keep.remote(arr))
    arr[:] = 7.0                     # after the call
    assert (rt.get(k.read.remote()) == 0.0).all()
    out[:] = 5.0                     # the result is the caller's own
    assert (rt.get(k.read.remote()) == 0.0).all()
    counter = rt.remote(_Counter).remote()
    kept, ref = rt.get(k.call.remote(counter, 4))
    assert rt.get(ref) == 4 and rt.get(counter.add.remote()) == 5


def test_runtime_context_names_the_running_actor(rt):
    assert rt.get_runtime_context().get_actor_id() is None

    class Who:
        def __init__(self, runtime):
            self.rt = runtime

        def me(self):
            return self.rt.get_runtime_context().get_actor_id()

    w = rt.remote(Who).remote(rt)
    assert rt.get(w.me.remote()).startswith("Who-")


def _cartpole():
    return gym.make("CartPole-v1")


def test_algorithm_learner_group_and_build_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tr.PPOConfig().environment(_cartpole)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cfg.build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.PPO(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.PPOConfig().environment(_cartpole).build(worker_device="cuda",
                                                    device="cpu")
    spec = tr.PolicySpec(4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.LearnerGroup(lambda: tr.PPOLearner(spec, tr.PPOConfig()), 2)
    algo = cfg.build(device="cpu")  # the CPU when asked for
    assert algo.device.type == algo.worker_device.type == "cpu"
    algo.stop()
