"""The port's gang trainer (ray_tpu_torch.train) on the ``ray_tpu`` runtime
with its ranks on the CPU: twins of tests/test_train.py and of
tests/test_collective_dist.py::test_jax_trainer_uses_xla_dist, and the
slice as a whole: a 2-rank ``TorchDistTrainer`` (gloo) training the tiny
GPT on the two halves of a batch against the JAX package's
``make_train_step`` on the whole batch, from the same converted params.

The slice's tolerance: losses and params to 1e-5 (float32 on both sides;
the averaged half-batch gradients and the full-batch one differ by
rounding, about 1e-7 relative, which SGD moves a param by lr times that).
SGD with decoupled weight decay set explicitly has one form in both
packages (``optax.chain(add_decayed_weights(wd), sgd(lr))`` and
``torch.optim.SGD(lr, weight_decay=wd)``); Adam's first step,
lr * g / (|g| + eps), would magnify rounding where |g| is near zero.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu
from ray_tpu import models as jm
from ray_tpu_torch._private.config import config
from ray_tpu_torch.runtime import LocalRuntime
from ray_tpu_torch.train import (
    Checkpoint, CheckpointConfig, DataParallelTrainer, FailureConfig,
    RunConfig, ScalingConfig, TorchDistTrainer,
)
from ray_tpu_torch.train.worker_group import WorkerGroup

CPU = dict(runtime=ray_tpu, device="cpu")
GPT_LR, GPT_WD, GPT_STEPS = 0.1, 0.01, 3
GPT_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def ray_4cpu():
    """A 4-CPU cluster whose processes, and this one, run torch on one
    thread each; gang restarts back off 0.1 s."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    backoff = config.get("gang_restart_backoff_s")
    config.set("gang_restart_backoff_s", 0.1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ctx = ray_tpu.init(num_cpus=4,
                           object_store_memory=128 * 1024 * 1024)
    yield ctx
    ray_tpu.shutdown()
    config.set("gang_restart_backoff_s", backoff)
    torch.set_num_threads(threads)


def _dp_mlp_loop(config):
    """2-worker data-parallel MLP: grads allreduced through the session's
    collective group; rank 0 reports + checkpoints."""
    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import MLPConfig, mlp_forward, mlp_init
    from ray_tpu_torch.train import Checkpoint

    rank, ws = train.get_world_rank(), train.get_world_size()
    dev = train.get_device()
    cfg = MLPConfig(in_dim=8, hidden=(16,), out_dim=2)
    params = mlp_init(cfg, generator=torch.Generator().manual_seed(0),
                      device=dev)
    leaves = [t for lyr in params["layers"] for t in (lyr["w"], lyr["b"])]

    rng = np.random.default_rng(100 + rank)  # per-rank data shard
    x = torch.as_tensor(rng.normal(size=(16, 8)), dtype=torch.float32)
    y = torch.as_tensor(rng.integers(0, 2, size=(16,)))
    lr = config["lr"]
    for step in range(config["steps"]):
        loss = torch.nn.functional.cross_entropy(mlp_forward(params, x), y)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                avg = np.asarray(train.session.allreduce(g.numpy())) / ws
                p -= lr * torch.from_numpy(avg)
        if rank == 0:
            ckpt = None
            if step == config["steps"] - 1:
                ckpt = Checkpoint.from_pytree(params, extra={"step": step})
            train.report({"loss": float(loss), "step": step},
                         checkpoint=ckpt)


def test_data_parallel_training(ray_4cpu, tmp_path):
    trainer = DataParallelTrainer(
        _dp_mlp_loop,
        train_loop_config={"steps": 4, "lr": 0.5},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="dp_mlp", storage_path=str(tmp_path)),
        **CPU)
    result = trainer.fit()
    assert result.ok, result.error
    assert len(result.metrics_history) == 4
    losses = [m["loss"] for m in result.metrics_history]
    assert losses[-1] < losses[0]
    # checkpoint persisted under the run dir and restorable
    assert result.checkpoint is not None
    assert result.checkpoint.path.startswith(str(tmp_path))
    restored = result.checkpoint.to_pytree(device="cpu")
    assert "layers" in restored
    assert result.checkpoint.to_dict()["step"] == 3


def _flaky_loop(config):
    import os

    from ray_tpu_torch import train
    from ray_tpu_torch.train import Checkpoint

    marker = config["marker"]
    start_step = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        start_step = ckpt.to_dict()["step"] + 1
    for step in range(start_step, config["steps"]):
        if step == 2 and not os.path.exists(marker):
            open(marker, "w").write("crashed")
            raise RuntimeError("injected failure at step 2")
        train.report({"step": step},
                     checkpoint=Checkpoint.from_dict({"step": step}))


def test_failure_restart_from_checkpoint(ray_4cpu, tmp_path):
    marker = str(tmp_path / "crash_marker")
    trainer = DataParallelTrainer(
        _flaky_loop,
        train_loop_config={"steps": 5, "marker": marker},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="flaky", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1)),
        **CPU)
    result = trainer.fit()
    assert result.ok, result.error
    assert os.path.exists(marker)  # it did crash once
    steps = [m["step"] for m in result.metrics_history]
    # steps 0,1 from attempt 1, then resumed at 2 (not 0) after restart
    assert steps == [0, 1, 2, 3, 4]


def test_num_to_keep_pruning_survives_restart(ray_4cpu, tmp_path):
    """Retention counts earlier attempts' checkpoints too."""
    marker = str(tmp_path / "crash_marker2")
    trainer = DataParallelTrainer(
        _flaky_loop,
        train_loop_config={"steps": 6, "marker": marker},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="prune", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1),
            checkpoint_config=CheckpointConfig(num_to_keep=2)),
        **CPU)
    result = trainer.fit()
    assert result.ok, result.error
    run_dir = str(tmp_path / "prune")
    ckpts = [d for d in os.listdir(run_dir) if d.startswith("checkpoint_")]
    assert len(ckpts) <= 2, ckpts


def test_failure_exhausts_retries(ray_4cpu, tmp_path):
    def always_fails(config):
        raise ValueError("boom")

    trainer = DataParallelTrainer(
        always_fails, train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="fails", storage_path=str(tmp_path)),
        **CPU)
    result = trainer.fit()
    assert not result.ok
    assert "boom" in str(result.error)


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpoint.from_dict({"a": 1}, path=str(tmp_path / "c1"))
    assert ck.to_dict() == {"a": 1}

    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": [torch.zeros(3)]}
    ck2 = Checkpoint.from_pytree(tree, path=str(tmp_path / "c2"),
                                 extra={"step": 7})
    out = ck2.to_pytree(device="cpu")
    assert torch.equal(out["w"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(out["b"][0], torch.zeros(3))
    assert ck2.to_dict()["step"] == 7
    moved = ck2.move_to(str(tmp_path / "c3"))
    assert moved.to_dict()["step"] == 7 and moved.has_pytree()


def _torch_ddp_loop(config):
    """2-worker torch DP: bucketed backward_allreduce must give every
    parameter the average of the ranks' gradients (one collective per
    bucket, not per parameter)."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.train import torch as rt_torch

    rank = train.get_world_rank()
    torch.manual_seed(rank)      # prepare_model makes the ranks agree
    model = torch.nn.Sequential(
        torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 2))
    model = rt_torch.prepare_model(model)

    x = torch.full((4, 8), float(rank + 1))
    loss = model(x).sum()
    loss.backward()
    expected = {}
    ref = torch.nn.Sequential(
        torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 2))
    ref.load_state_dict(model.state_dict())
    for other in (1.0, 2.0):
        ref.zero_grad()
        ref(torch.full((4, 8), other)).sum().backward()
        for n, p in ref.named_parameters():
            expected[n] = expected.get(n, 0) + p.grad.detach().clone() / 2

    rt_torch.backward_allreduce(model, bucket_cap_bytes=256)  # many buckets
    for n, p in model.named_parameters():
        assert torch.allclose(p.grad, expected[n], atol=1e-5), n
    train.report({"ok": 1.0, "rank": rank})


@pytest.mark.parametrize("backend", ["store", "torch_dist"])
def test_torch_bucketed_allreduce(ray_4cpu, tmp_path, backend):
    from ray_tpu_torch.train.torch import TorchTrainer

    trainer = TorchTrainer(
        _torch_ddp_loop,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path)),
        backend=backend, **CPU)
    result = trainer.fit()
    assert result.error is None, result.error
    assert result.metrics["ok"] == 1.0


_ADDRESS_RANK_SRC = """
import sys
import torch
from ray_tpu_torch.parallel import collective
from ray_tpu_torch.train import torch as rt_torch
rank, addr, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
g = collective.TorchDistGroup(2, rank, "at_addr", device="cpu", address=addr)
torch.manual_seed(0)
model = torch.nn.Sequential(
    torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 2))
model(torch.full((4, 8), float(rank + 1))).sum().backward()
rt_torch.backward_allreduce(model, bucket_cap_bytes=256, group=g)
try:
    g.send(torch.zeros(1).numpy(), 1 - rank)
    sent = "sent"
except RuntimeError as e:
    sent = str(e)
torch.save({"grads": [p.grad for p in model.parameters()], "send": sent},
           f"{out}/rank{rank}.pt")
g.destroy()
"""


def test_ranks_met_at_an_address_average_their_buckets(tmp_path):
    """Two processes started outside any runtime meet at a given address
    (a ``TorchDistGroup`` with no coordinator) and average their gradients
    through ``backward_allreduce(group=...)`` in many buckets; with no
    coordinator, send/recv raise."""
    import subprocess
    import sys

    from ray_tpu_torch.parallel.collective import _free_port

    torch.manual_seed(0)
    ref = torch.nn.Sequential(
        torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 2))
    want = [torch.zeros_like(p) for p in ref.parameters()]
    for x in (1.0, 2.0):
        ref.zero_grad()
        ref(torch.full((4, 8), x)).sum().backward()
        for w, p in zip(want, ref.parameters()):
            w += p.grad / 2
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _ADDRESS_RANK_SRC,
                               str(r), addr, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode()[-2000:]
                for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
        assert "no coordinator" in got["send"], got["send"]
        for g, w in zip(got["grads"], want):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


def test_ranks_pin_the_gpu_of_their_local_rank(monkeypatch):
    """A CUDA rank sees the GPU of its local rank on its node (counted from
    the placement group's bundle nodes), picked from the user's
    CUDA_VISIBLE_DEVICES where one is set."""
    from types import SimpleNamespace

    from ray_tpu_torch.train.worker_group import (
        gang_local_ranks, rank_runtime_env, runtime_assigns_gpus,
    )

    table = {"bundles": [{"index": i, "node_id": n}
                         for i, n in enumerate("ababc")]}
    rt = SimpleNamespace(util=SimpleNamespace(
        placement_group_table=lambda pg: table))
    assert gang_local_ranks(rt, object(), 4) == [0, 0, 1, 1]
    assert gang_local_ranks(rt, object(), 3, bundle_offset=2) == [0, 0, 0]
    assert gang_local_ranks(rt, None, 3) == [0, 1, 2]
    assert gang_local_ranks(LocalRuntime(), None, 2) == [0, 1]

    cuda = torch.device("cuda")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert rank_runtime_env(None, 1, cuda) == {
        "env_vars": {"CUDA_VISIBLE_DEVICES": "1"}}
    user = {"env_vars": {"CUDA_VISIBLE_DEVICES": "3, 5", "X": "1"}}
    assert rank_runtime_env(user, 1, cuda)["env_vars"] == {
        "CUDA_VISIBLE_DEVICES": "5", "X": "1"}
    assert user["env_vars"]["CUDA_VISIBLE_DEVICES"] == "3, 5"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,7")
    assert rank_runtime_env(None, 1, cuda)["env_vars"][
        "CUDA_VISIBLE_DEVICES"] == "7"
    with pytest.raises(ValueError, match="lists 2"):
        rank_runtime_env(None, 2, cuda)
    assert rank_runtime_env({"pip": []}, 0, torch.device("cpu")) == {
        "pip": []}
    # The port's own runtime assigns GPUs itself: its ranks are not pinned.
    import ray_tpu_torch

    assert runtime_assigns_gpus(ray_tpu_torch)
    assert not runtime_assigns_gpus(LocalRuntime())


def _dist_train_loop(config):
    """TorchDistTrainer loop whose gradient allreduce goes through the
    gang's torch.distributed world (the trainer's default backend)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.parallel import collective

    g = collective.get_group(train.session._get_session()
                             .collective_group_name)
    assert type(g).__name__ == "TorchDistGroup"
    assert dist.get_world_size() == train.get_world_size()
    assert dist.get_backend() == "gloo"

    rank, ws = train.get_world_rank(), train.get_world_size()
    w = torch.zeros(4, requires_grad=True)
    rng = np.random.default_rng(rank)
    x = torch.as_tensor(rng.normal(size=(8, 4)), dtype=torch.float32)
    for step in range(config["steps"]):
        (grad,) = torch.autograd.grad(((x @ w - 1.0) ** 2).mean(), w)
        grad = g.allreduce(grad) / ws
        with torch.no_grad():
            w -= 0.1 * grad
        if rank == 0:
            train.report({"step": step, "loss": float(
                ((x @ w.detach() - 1.0) ** 2).mean())})


def test_torch_dist_trainer_uses_torch_dist(ray_4cpu, tmp_path):
    trainer = TorchDistTrainer(
        _dist_train_loop,
        train_loop_config={"steps": 3},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="td", storage_path=str(tmp_path)),
        **CPU)
    result = trainer.fit()
    assert result.ok, result.error
    losses = [m["loss"] for m in result.metrics_history]
    assert losses[-1] < losses[0]


# ------------------------------------------------------ the slice as a whole


def _gpt_loop(config):
    """The tiny GPT on this rank's half of the batch: loss, backward,
    ``backward_allreduce`` over the gang's gloo world, SGD. Rank 0 reports
    the gang's mean loss each step and checkpoints the final params."""
    import torch

    from ray_tpu_torch import models as tm
    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.parallel import collective
    from ray_tpu_torch.train import Checkpoint
    from ray_tpu_torch.train import torch as rt_torch

    rank, ws, dev = (train.get_world_rank(), train.get_world_size(),
                     train.get_device())
    g = collective.get_group(train.session._get_session()
                             .collective_group_name)
    cfg = tm.GPTConfig.preset("tiny", dtype=torch.float32)
    params = tm.params_from_numpy(config["params"], cfg, device=dev)
    leaves = tt.tree_leaves(params)
    opt = torch.optim.SGD(leaves, lr=config["lr"],
                          weight_decay=config["wd"])
    toks = torch.tensor(config["tokens"]).chunk(ws)[rank].to(dev)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    for step in range(config["steps"]):
        opt.zero_grad(set_to_none=True)
        loss = tm.loss_fn(params, batch, cfg)
        loss.backward()
        rt_torch.backward_allreduce(leaves)
        opt.step()
        mean = g.allreduce(loss.detach().reshape(1),
                           op=collective.ReduceOp.AVG)
        if rank == 0:
            last = step == config["steps"] - 1
            train.report({"step": step, "loss": float(mean)},
                         checkpoint=Checkpoint.from_pytree(params)
                         if last else None)


def _jax_gpt_run(tokens):
    """The JAX package's params, then its losses and params after
    GPT_STEPS steps of ``make_train_step`` on the whole batch."""
    cfg = jm.GPTConfig.preset("tiny", dtype=jnp.float32)
    opt = optax.chain(optax.add_decayed_weights(GPT_WD), optax.sgd(GPT_LR))
    state = jm.make_train_state(jax.random.key(0), cfg, opt)
    params0 = jax.tree.map(np.asarray, state.params)
    step = jax.jit(jm.make_train_step(cfg, opt))
    batch = {"inputs": jnp.asarray(tokens[:, :-1], jnp.int32),
             "targets": jnp.asarray(tokens[:, 1:], jnp.int32)}
    losses = []
    for _ in range(GPT_STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return params0, losses, jax.tree.map(np.asarray, state.params)


def test_two_rank_gang_trains_gpt_as_jax_on_the_whole_batch(ray_4cpu,
                                                             tmp_path):
    from ray_tpu_torch.models import transformer as tt

    tokens = np.random.default_rng(3).integers(0, 256, (4, 33))
    params0, want_losses, want_params = _jax_gpt_run(tokens)
    trainer = TorchDistTrainer(
        _gpt_loop,
        train_loop_config={"params": params0, "tokens": tokens,
                           "lr": GPT_LR, "wd": GPT_WD, "steps": GPT_STEPS},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="gpt", storage_path=str(tmp_path)),
        **CPU)
    result = trainer.fit()
    assert result.ok, result.error
    losses = [m["loss"] for m in result.metrics_history]
    np.testing.assert_allclose(losses, want_losses, **GPT_TOL)
    got = tt.tree_leaves(result.checkpoint.to_pytree(device="cpu"))
    want = jax.tree.leaves(want_params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b, **GPT_TOL)


def test_in_process_runtime_refuses_a_multi_rank_gang():
    """The in-process runtime runs one rank: a 2-rank gang raises at once,
    it does not hang in the world's rendezvous."""
    with pytest.raises(ValueError, match="runs one rank"):
        TorchDistTrainer(_dist_train_loop,
                         scaling_config=ScalingConfig(num_workers=2),
                         runtime=LocalRuntime(), device="cpu")
    with pytest.raises(ValueError, match="runs one rank"):
        WorkerGroup(2, {"CPU": 1}, backend="torch_dist",
                    runtime=LocalRuntime(), device="cpu")


def test_in_process_gang_of_one(tmp_path):
    """One torch_dist rank on the in-process runtime joins a gloo world of
    one; the world is gone when fit() returns."""
    import torch.distributed as dist

    trainer = TorchDistTrainer(
        _dist_train_loop, train_loop_config={"steps": 3},
        run_config=RunConfig(name="one", storage_path=str(tmp_path)),
        device="cpu")
    result = trainer.fit()
    assert result.ok, result.error
    assert [m["step"] for m in result.metrics_history] == [0, 1, 2]
    assert not dist.is_initialized()


def test_two_rank_gang_on_the_ports_runtime_gives_ray_tpus_losses(ray_4cpu,
                                                                  tmp_path):
    """``runtime=ray_tpu_torch``: the same 2-rank gloo gang, run first on
    ``ray_tpu`` and then on the port's own runtime (the two never at
    once), gives the same losses and params, and both stay at JAX's."""
    from torch_runtimes import ports_runtime

    from ray_tpu_torch.models import transformer as tt

    tokens = np.random.default_rng(3).integers(0, 256, (4, 33))
    params0, want_losses, _ = _jax_gpt_run(tokens)

    def fit(runtime, name):
        trainer = TorchDistTrainer(
            _gpt_loop,
            train_loop_config={"params": params0, "tokens": tokens,
                               "lr": GPT_LR, "wd": GPT_WD,
                               "steps": GPT_STEPS},
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(name=name, storage_path=str(tmp_path)),
            runtime=runtime, device="cpu")
        result = trainer.fit()
        assert result.ok, result.error
        return ([m["loss"] for m in result.metrics_history],
                tt.tree_leaves(result.checkpoint.to_pytree(device="cpu")))

    ref_losses, ref_params = fit(ray_tpu, "gpt-ray-tpu")
    with ports_runtime(restore=dict(num_cpus=4,
                                    object_store_memory=128 * 1024 * 1024),
                       num_cpus=4, object_store_memory=128 * 1024 * 1024
                       ) as rt:
        losses, params = fit(rt, "gpt-port")
    assert losses == ref_losses
    for a, b in zip(params, ref_params):
        assert torch.equal(a, b)
    np.testing.assert_allclose(losses, want_losses, **GPT_TOL)


def test_scaling_config_bundles_match_jax():
    """``ScalingConfig.bundles()``: one bundle of ``worker_resources()`` a
    worker, as the reference's; ``use_gpu`` stands for ``use_tpu``."""
    from ray_tpu.train import ScalingConfig as JaxScalingConfig

    for kw, jkw in [({}, {}), ({"num_workers": 3}, {"num_workers": 3}),
                    ({"num_workers": 2, "use_gpu": True},
                     {"num_workers": 2, "use_tpu": True}),
                    ({"num_workers": 2,
                      "resources_per_worker": {"CPU": 2, "mem": 1}},
                     {"num_workers": 2,
                      "resources_per_worker": {"CPU": 2, "mem": 1}})]:
        want = [{("GPU" if k == "TPU" else k): v for k, v in b.items()}
                for b in JaxScalingConfig(**jkw).bundles()]
        assert ScalingConfig(**kw).bundles() == want
