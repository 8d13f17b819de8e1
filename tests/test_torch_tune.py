"""The port's tuning library (``ray_tpu_torch.tune``) against the JAX
package's (``ray_tpu.tune``), and the slice as a whole.

1. Search and schedulers are pure Python: the same space and seed give the
   same variants and TPE suggestions, and the same scripted reports give
   the same ASHA, HyperBand and PBT decisions, in both packages.
2. The Tuner programs of ``torch_cluster_programs`` (those of
   tests/test_tune.py: grid, ASHA, retry, PBT, a trial that is a 2-rank
   gang) run on a 4-CPU ``ray_tpu`` cluster in a fresh interpreter, which
   exits, and then on a 4-CPU ``ray_tpu_torch`` cluster here; each
   program's results must be equal.
3. Default concurrency counts every resource a trial asks for: on 4 CPUs
   and 1 declared GPU, three GPU trials run one at a time and all finish
   (the reference counts CPUs only and would launch two; the second's
   group would wait out its 120 s and fail).
4. The slice as a whole, on the CPU: a cluster launched with
   ``launch_cluster`` (a head with no GPU, a ``gpu_host`` node type of
   one declared GPU), a Tune sweep of two learning rates over a
   ``TorchDistTrainer`` on the tiny GPT (``flash_attention=True``, the
   kernels' plain path on the CPU) fed by ``ray_tpu_torch.data``. The
   autoscaler launches one node for it and removes it when idle; each
   trial's losses equal the JAX package's ``make_train_step`` on the same
   converted params and the same numpy batch. Tolerance: ``GPT_TOL`` of
   tests/test_torch_train.py (atol 1e-5, rtol 1e-5), float32 on both
   sides, SGD with decoupled weight decay (one form in both packages).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_tpu import models as jm
from ray_tpu import tune as jtune
from ray_tpu_torch import tune as ttune

import torch_cluster_programs as progs
from torch_runtimes import deadline, reference_results

NAMES = [p.__name__ for p in progs.PROGRAMS["tune"]]
GPT_TOL = dict(atol=1e-5, rtol=1e-5)
SWEEP_LRS, SWEEP_WD, SWEEP_STEPS = (0.1, 0.05), 0.01, 3
SWEEP_B, SWEEP_L = 4, 32


# ------------------------------------------------------- pure Python parity


def _spaces(tune):
    return [
        ({"a": tune.grid_search([1, 2, 3]), "b": tune.grid_search(["x", "y"]),
          "c": 42, "d": tune.uniform(0.0, 1.0)}, 2, 0),
        ({"opt": {"lr": tune.loguniform(1e-4, 1e-1),
                  "wd": tune.choice([0.0, 0.1])},
          "n": tune.randint(1, 5)}, 5, 1),
        ({"train_loop_config": {"lr": tune.grid_search([3e-4, 1e-3])}}, 1,
         None),
        ({"k": tune.sample_from(lambda _: 7), "u": tune.uniform(-1, 1)}, 3,
         11),
    ]


@pytest.mark.parametrize("case", range(4))
def test_variants_equal_the_references(case):
    space, n, seed = _spaces(ttune)[case]
    jspace, jn, jseed = _spaces(jtune)[case]
    got = ttune.BasicVariantGenerator(space, n, seed=seed).variants()
    want = jtune.BasicVariantGenerator(jspace, jn, seed=jseed).variants()
    assert got == want and len(got) > 0


def _tpe(tune, n_initial):
    import random

    s = tune.TPESearcher(metric="loss", mode="min", n_initial=n_initial,
                         seed=7)
    s.set_search_properties("loss", "min",
                            {"x": tune.uniform(0.0, 1.0),
                             "lr": tune.loguniform(1e-4, 1e-1),
                             "c": tune.choice(["a", "b", "c"]),
                             "n": tune.randint(1, 9)})
    rng = random.Random(0)
    out = []
    for i in range(20):
        cfg = s.suggest(f"s{i}")
        out.append(cfg)
        loss = (cfg["x"] - 0.8) ** 2 + (0.0 if cfg["c"] == "b" else 0.3) \
            + rng.random() * 0.01
        s.on_trial_complete(f"s{i}", {"loss": loss})
    return out


@pytest.mark.parametrize("n_initial", [0, 5])
def test_tpe_suggestions_equal_the_references(n_initial):
    assert _tpe(ttune, n_initial) == _tpe(jtune, n_initial)


def _reports(seed, trials=6, iters=9):
    rng = np.random.default_rng(seed)
    quality = rng.uniform(0.5, 2.0, trials)
    order = [(t, i) for i in range(1, iters + 1) for t in range(trials)]
    rng.shuffle(order[trials:])
    return [(f"t{t}", {"training_iteration": i,
                       "loss": float(quality[t] / i),
                       "score": float(quality[t] * i)})
            for t, i in order]


def _decisions(sched, seed):
    out = []
    for tid, result in _reports(seed):
        if hasattr(sched, "on_trial_add") and tid not in getattr(
                sched, "_assignment", getattr(sched, "_configs", {})):
            sched.on_trial_add(tid, {"lr": 0.1})
        d = sched.on_result(tid, result)
        out.append(d if isinstance(d, str) else (d.donor, d.config))
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("which", ["asha", "hyperband", "pbt"])
def test_scheduler_decisions_equal_the_references(which, seed):
    def make(tune):
        if which == "asha":
            return tune.ASHAScheduler(metric="loss", mode="min", max_t=9,
                                      grace_period=1, reduction_factor=2)
        if which == "hyperband":
            return tune.HyperBandScheduler(metric="score", mode="max",
                                           max_t=9, reduction_factor=3)
        return tune.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=2,
            hyperparam_mutations={"lr": [0.01, 0.1, 1.0]},
            quantile_fraction=0.34, seed=seed)

    got, want = make(ttune), make(jtune)
    assert _decisions(got, seed) == _decisions(want, seed)
    assert getattr(got, "num_exploits", 0) == getattr(want, "num_exploits",
                                                      0)


def test_placement_group_factory_equals_the_references():
    bundles = [{"CPU": 1}, {"CPU": 1, "GPU": 1}]
    got = ttune.PlacementGroupFactory(bundles, strategy="SPREAD")
    want = jtune.PlacementGroupFactory(bundles, strategy="SPREAD")
    assert (got.bundles, got.strategy, got.head_bundle, repr(got)) == (
        want.bundles, want.strategy, want.head_bundle, repr(want))
    with pytest.raises(ValueError):
        ttune.PlacementGroupFactory([])


# ------------------------------------------------------------ Tuner parity


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ref = reference_results("torch_cluster_programs.py",
                            ["tune", tmp_path_factory.mktemp("ref")],
                            tmp_path_factory.mktemp("ref_out"))
    import ray_tpu_torch

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        with deadline(what="the tune programs on the port's runtime"):
            port = progs.run_group(ray_tpu_torch, "GPU", "tune",
                                   str(tmp_path_factory.mktemp("port")))
    return {"ray_tpu": ref, "ray_tpu_torch": port}


@pytest.mark.parametrize("program", NAMES)
def test_same_results_on_both_runtimes(results, program):
    ref = results["ray_tpu"][program]
    port = results["ray_tpu_torch"][program]
    assert ref[0] == "ok", ref
    assert port == ref


# ------------------------------------------------------ GPU concurrency


def test_default_concurrency_counts_every_resource(tmp_path):
    """4 CPUs and 1 declared GPU: a trial of [{CPU 1}, {CPU 1, GPU 1}]
    allows one at a time (CPUs alone would allow two), a CPU-only trial of
    the same CPUs two. Three such GPU trials, each a one-rank trainer on
    the GPU bundle, run one after another and all finish."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.tune.tuner import _default_concurrency

    gpu_trial = [{"CPU": 1}, {"CPU": 1, "GPU": 1}]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        with deadline(what="three GPU trials"):
            rt.init(num_cpus=4, num_gpus=1)
            try:
                assert _default_concurrency(gpu_trial, 3) == 1
                assert _default_concurrency([{"CPU": 1}, {"CPU": 1}],
                                            3) == 2
                assert _default_concurrency([{"CPU": 1, "TPU": 1}], 3) == 1
                trainer = train.TorchDistTrainer(
                    progs.gpu_trial_loop,
                    train_loop_config={"hold_s": 0.5},
                    scaling_config=train.ScalingConfig(num_workers=1,
                                                       use_gpu=True),
                    run_config=train.RunConfig(
                        storage_path=str(tmp_path / "inner")),
                    backend="torch_dist", runtime=rt, device="cpu")
                t0 = time.time()
                grid = ttune.Tuner(
                    trainer,
                    param_space={"train_loop_config": {
                        "lr": ttune.grid_search([0.1, 0.2, 0.3])}},
                    tune_config=ttune.TuneConfig(
                        metric="lr", mode="max",
                        resources_per_trial=ttune.PlacementGroupFactory(
                            gpu_trial)),
                    run_config=train.RunConfig(
                        storage_path=str(tmp_path))).fit()
                fit_s = time.time() - t0
                avail = rt.available_resources()
            finally:
                rt.shutdown()
    assert len(grid) == 3 and not grid.errors
    spans = sorted((r.metrics["start"], r.metrics["end"]) for r in grid)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])), spans
    assert sorted(r.metrics["lr"] for r in grid) == [0.1, 0.2, 0.3]
    assert {r.metrics["cuda_visible_devices"] for r in grid} == {"0"}
    assert fit_s < 120, fit_s
    assert avail.get("GPU") == 1.0


# --------------------------------------------------- the slice as a whole


def _jax_losses(tokens, lr):
    """The JAX package's params, and its losses over SWEEP_STEPS steps of
    ``make_train_step`` on the whole batch, at ``lr``."""
    cfg = jm.GPTConfig.preset("tiny", dtype=jnp.float32, flash_attention=True)
    opt = optax.chain(optax.add_decayed_weights(SWEEP_WD), optax.sgd(lr))
    state = jm.make_train_state(jax.random.key(0), cfg, opt)
    params0 = jax.tree.map(np.asarray, state.params)
    step = jax.jit(jm.make_train_step(cfg, opt))
    batch = {"inputs": jnp.asarray(tokens[:, :-1], jnp.int32),
             "targets": jnp.asarray(tokens[:, 1:], jnp.int32)}
    losses = []
    for _ in range(SWEEP_STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return params0, losses


def test_autoscaled_two_lr_sweep_trains_the_gpt_as_jax(tmp_path):
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch import train
    from ray_tpu_torch.autoscaler.cluster_launcher import launch_cluster

    tokens = np.random.default_rng(0).integers(0, 256,
                                               (SWEEP_B, SWEEP_L + 1))
    runs = {lr: _jax_losses(tokens, lr) for lr in SWEEP_LRS}
    params0 = runs[SWEEP_LRS[0]][0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        with deadline(what="the autoscaled sweep"):
            launched = launch_cluster({
                "max_workers": 1, "idle_timeout_s": 5,
                "update_interval_s": 0.5,
                "provider": {"type": "local_process",
                             "object_store_memory": 64 << 20},
                "head_node_type": {"CPU": 4, "GPU": 0},
                "available_node_types": {"gpu_host": {
                    "resources": {"CPU": 2, "GPU": 1},
                    "min_workers": 0, "max_workers": 1}}})
            try:
                rt.init(address=launched.address)
                head = rt.get_runtime_context().get_node_id()
                assert rt.cluster_resources().get("GPU", 0) == 0
                ds = rd.from_numpy(np.tile(tokens, (SWEEP_STEPS, 1))
                                   ).map_batches(
                    lambda b: {"inputs": b["data"][:, :-1],
                               "targets": b["data"][:, 1:]})
                trainer = train.TorchDistTrainer(
                    progs.gpt_trial_loop,
                    train_loop_config={"params": params0, "wd": SWEEP_WD,
                                       "batch": SWEEP_B},
                    scaling_config=train.ScalingConfig(num_workers=1,
                                                       use_gpu=True),
                    run_config=train.RunConfig(
                        storage_path=str(tmp_path / "inner")),
                    datasets={"train": ds}, backend="torch_dist",
                    runtime=rt, device="cpu")
                grid = ttune.Tuner(
                    trainer,
                    param_space={"train_loop_config": {
                        "lr": ttune.grid_search(list(SWEEP_LRS))}},
                    tune_config=ttune.TuneConfig(
                        metric="loss", mode="min",
                        resources_per_trial=ttune.PlacementGroupFactory(
                            [{"CPU": 1}, {"CPU": 1, "GPU": 1}])),
                    run_config=train.RunConfig(
                        storage_path=str(tmp_path))).fit()
                deadline_s = time.time() + 30
                while time.time() < deadline_s and (
                        rt.cluster_resources().get("GPU", 0)
                        or launched.provider.non_terminated_nodes()):
                    time.sleep(0.2)
                gpus_after = rt.cluster_resources().get("GPU", 0)
                nodes = {n["NodeID"]: n["Alive"] for n in rt.nodes()}
            finally:
                rt.shutdown()
                launched.shutdown()
    assert len(grid) == 2 and not grid.errors
    assert grid.get_best_result("loss", "min").metrics["loss"] == min(
        r.metrics["loss"] for r in grid)
    for r, lr in zip(grid, SWEEP_LRS):
        hist = r.metrics_history
        assert [m["step"] for m in hist] == list(range(SWEEP_STEPS))
        for m in hist:
            assert m["batch"] == tokens[:, :-1].tolist()
            assert m["node"] != head and m["cuda_visible_devices"] == "0"
        np.testing.assert_allclose([m["loss"] for m in hist], runs[lr][1],
                                   **GPT_TOL)
    # One GPU node was launched, both trials ran on it, and it is gone.
    gpu_nodes = {m["node"] for r in grid for m in r.metrics_history}
    assert set(nodes) == {head} | gpu_nodes and len(gpu_nodes) == 1
    assert nodes == {head: True, **{n: False for n in gpu_nodes}}
    assert gpus_after == 0


def test_a_cpu_process_forms_a_gpu_gang():
    """A Tune trial's actor holds a CPU bundle and no GPU, yet forms a
    ``TorchDistTrainer``'s CUDA gang: a runtime with processes leaves each
    rank to resolve its own device, and only the in-process runtime, whose
    rank is this process, needs the device here."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.runtime import LocalRuntime
    from ray_tpu_torch.train.worker_group import gang_device

    assert gang_device(ray_tpu_torch, None) == torch.device("cuda")
    assert gang_device(ray_tpu_torch, "cuda") == torch.device("cuda")
    assert gang_device(ray_tpu_torch, "cpu") == torch.device("cpu")
    assert gang_device(LocalRuntime(), "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gang_device(LocalRuntime(), None)
