"""The port stands alone: no module of ray_tpu_torch, nor chip_smoke.py,
imports jax, optax, cloudpickle, msgpack or anything of the JAX package
ray_tpu (the card's machine has none of them), its entry points do not
drift to the CPU without a GPU, and its own runtime (driver and workers)
loads none of them and keeps its own store library and session root.
Importing the port loads no yaml, pandas or pyarrow either: the cluster
launcher and the datasets import them only where a call needs them."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from ray_tpu_torch._private import device_objects
from ray_tpu_torch.parallel import collective
from ray_tpu_torch.rllib import DDPPOConfig
from ray_tpu_torch.runtime import LocalRuntime
from ray_tpu_torch.serve.llm import (
    DecodeReplica, LLMReplica, PrefillReplica, build_llm_app,
)
from ray_tpu_torch.serve.llm.engine import (
    EngineConfig, InflightBatchEngine, _build_model,
)
from ray_tpu_torch.train import Checkpoint, TorchDistTrainer
from ray_tpu_torch.train.worker_group import WorkerGroup

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "optax", "ray_tpu", "cloudpickle",
                   "msgpack", "aiohttp")


# Imported lazily by the calls that need them, never at import time.
NOT_AT_IMPORT = ("yaml", "pandas", "pyarrow")


def _imports(path: pathlib.Path):
    """(line, module) of every import in ``path``, at any depth."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_sources_found():
    names = {p.name for p in SOURCES}
    assert {"engine.py", "generate.py", "random.py", "paged.py",
            "chip_smoke.py", "sac.py", "convert.py", "runtime.py",
            "learner_group.py", "device_objects.py", "config.py",
            "migration.py", "kv_transfer.py", "replicas.py",
            "router.py", "collective.py", "data_parallel.py",
            "worker_group.py", "session.py", "checkpoint.py",
            "ddppo.py", "mesh.py", "sharding.py", "pipeline.py",
            "attention.py", "graft_entry.py", "api.py", "actor.py",
            "remote_function.py", "node_manager.py", "gcs.py",
            "worker.py", "worker_main.py", "worker_zygote.py",
            "plasma.py", "pickler.py", "serialization.py", "lease.py",
            "protocol.py", "placement_group.py", "lockdep.py",
            "pubsub.py", "controller.py", "handle.py", "replica.py",
            "admission.py", "server.py", "cluster_utils.py",
            "node_daemon.py", "node_provider.py", "autoscaler.py",
            "fake_provider.py", "local_provider.py", "cluster_launcher.py",
            "gpu_pool_provider.py", "logical.py", "dataset.py", "search.py",
            "schedulers.py", "placement_groups.py", "tuner.py"} <= names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_reference_import(path):
    bad = [f"{path.relative_to(ROOT)}:{line} imports {mod}"
           for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, bad


def test_importing_every_module_loads_none_of_them():
    """Imports done at run time too: a fresh interpreter imports every
    module of the port (the collectives, the trainer and DD-PPO among
    them) and loads none of the forbidden packages beyond what the
    interpreter had loaded at start."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in SOURCES if p.parent != ROOT]
    assert {"ray_tpu_torch.parallel.collective", "ray_tpu_torch.train",
            "ray_tpu_torch.train.torch", "ray_tpu_torch.rllib.ddppo",
            "ray_tpu_torch.parallel.mesh", "ray_tpu_torch.parallel.sharding",
            "ray_tpu_torch.parallel.pipeline",
            "ray_tpu_torch.graft_entry", "ray_tpu_torch.api",
            "ray_tpu_torch._private.node_manager",
            "ray_tpu_torch._private.gcs",
            "ray_tpu_torch._private.worker_main",
            "ray_tpu_torch._private.worker_zygote",
            "ray_tpu_torch.object_store.plasma",
            "ray_tpu_torch._private.lockdep",
            "ray_tpu_torch.experimental.pubsub",
            "ray_tpu_torch.serve.controller",
            "ray_tpu_torch.serve.ingress.server",
            "ray_tpu_torch.cluster_utils",
            "ray_tpu_torch.scripts.node_daemon",
            "ray_tpu_torch.autoscaler",
            "ray_tpu_torch.autoscaler.cluster_launcher",
            "ray_tpu_torch.autoscaler.local_provider",
            "ray_tpu_torch.autoscaler.gpu_pool_provider",
            "ray_tpu_torch.data", "ray_tpu_torch.data.dataset",
            "ray_tpu_torch.tune", "ray_tpu_torch.tune.tuner"} \
        <= {m.removesuffix(".__init__") for m in mods}
    code = ("import sys\nbefore = set(sys.modules)\n" +
            "".join(f"import {m}\n" for m in mods) +
            "print(sorted({m.split('.')[0] for m in sys.modules} - "
            "{m.split('.')[0] for m in before}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    loaded = ast.literal_eval(out.strip().splitlines()[-1])
    assert "ray_tpu_torch" in loaded
    assert not [m for m in loaded if _forbidden(m)], loaded
    assert not [m for m in loaded if m in NOT_AT_IMPORT], loaded


def test_scan_catches_forbidden_imports(tmp_path):
    """The scan itself: each forbidden form is caught, the port's own
    package name is not."""
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom ray_tpu.models import x\n"
                   "import ray_tpu\nfrom ray_tpu_torch import models\n"
                   "def f():\n    from jax import lax\n    import optax\n"
                   "    import cloudpickle\n    import msgpack\n"
                   "    from aiohttp import web\n")
    found = [mod for _, mod in _imports(src) if _forbidden(mod)]
    assert found == ["jax.numpy", "ray_tpu.models", "ray_tpu", "jax", "optax",
                     "cloudpickle", "msgpack", "aiohttp"]


def test_engine_and_build_model_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ec = EngineConfig(preset="tiny",
                      model_overrides=(("dtype", "float32"),))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _build_model(ec)
    cfg, params = _build_model(ec, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InflightBatchEngine(params, cfg, ec)


def test_serving_tier_raises_without_cuda(monkeypatch):
    """The replicas, and an app built by ``build_llm_app``, default to CUDA
    and raise without it; ``device="cpu"`` runs them on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ec = dict(preset="tiny", model_overrides={"dtype": "float32"},
              max_slots=2, max_len=32, prompt_buckets=(16,))
    for cls in (LLMReplica, PrefillReplica, DecodeReplica):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(ec)
    rt = LocalRuntime()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.serve.run(build_llm_app(ec, runtime=rt, mode="combined"))
    handle = rt.serve.run(build_llm_app(ec, runtime=rt, device="cpu",
                                        mode="combined"))
    assert len(handle.remote({"prompt": [1, 2], "n": 2}).result()
               ["tokens"]) == 2
    rt.serve.delete("llm-engine")


def test_rebuild_goes_back_to_cuda_when_the_process_has_it(monkeypatch):
    """``rebuild_tensor`` puts a tensor from ``cuda:i`` back on ``cuda:i``
    when this process has that device; on the CPU only when it has not. A
    CPU tensor comes back on the CPU."""
    pick = device_objects._pick_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pick({"device": "cuda:0"}) == torch.device("cuda", 0)
    assert pick({"device": "cuda:1"}) == torch.device("cpu")
    assert pick({"device": "cpu"}) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pick({"device": "cuda:0"}) == torch.device("cpu")


def test_trainer_and_ddppo_raise_without_cuda(monkeypatch, tmp_path):
    """The gang trainer, its worker group, a torch_dist group, a
    checkpoint's load and DD-PPO default to CUDA and raise without it;
    ``device="cpu"`` builds them on the CPU."""
    import gymnasium as gym

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchDistTrainer(lambda: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WorkerGroup(1, {"CPU": 1}, backend="store")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collective.TorchDistGroup(1, 0, "nocuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collective.LocalGroup(1, 0, "nocuda")
    ckpt = Checkpoint.from_pytree({"w": torch.ones(2)},
                                  path=str(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.to_pytree()
    assert torch.equal(ckpt.to_pytree(device="cpu")["w"], torch.ones(2))
    cfg = DDPPOConfig(num_rollout_workers=1).environment(
        lambda: gym.make("CartPole-v1"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cfg.build()
    algo = cfg.build(device="cpu")
    assert algo.train()["timesteps_this_iter"] == 200
    algo.stop()
    TorchDistTrainer(lambda: None, device="cpu")


_RUNTIME_PROBE = """
import json, os, sys, tempfile
sys.path.insert(0, {tests!r})
before = set(sys.modules)
import ray_tpu_torch as rt
import torch_core_programs as progs
from ray_tpu_torch._private import worker
from ray_tpu_torch.object_store import plasma
rt.init(num_cpus=1)
try:
    cluster = worker._global_cluster
    facts = rt.get(rt.remote(progs.process_facts).remote(), timeout=60)
    driver = sorted({{m.split(".")[0] for m in sys.modules}} - {{
        m.split(".")[0] for m in before}})
    print(json.dumps({{"driver": driver, "worker": facts["loaded"],
                      "session": cluster.session_dir,
                      "store_so": plasma._ensure_built(),
                      "tmp": tempfile.gettempdir()}}))
finally:
    rt.shutdown()
"""


def test_ports_runtime_loads_no_reference_in_driver_or_worker():
    """After ``ray_tpu_torch.init()``, neither ``ray_tpu`` nor jax (nor
    cloudpickle or msgpack) is loaded, in a fresh driver and, through a
    task, in a worker. The store library is the port's own build, under
    ``ray_tpu_torch/_build``, and the session lives under the port's own
    root."""
    import json
    import os

    code = _RUNTIME_PROBE.format(tests=str(ROOT / "tests"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert "ray_tpu_torch" in got["driver"]
    assert not [m for m in got["driver"] if _forbidden(m)], got["driver"]
    assert got["worker"] == []
    build = ROOT / "ray_tpu_torch" / "_build"
    assert pathlib.Path(got["store_so"]).parent == build
    from ray_tpu.object_store import plasma as jax_plasma

    assert pathlib.Path(jax_plasma._SO_PATH).parent != build
    assert got["session"].startswith(
        os.path.join(got["tmp"], "ray_tpu_torch") + os.sep)
    assert not got["session"].startswith("/tmp/ray_tpu" + os.sep)
