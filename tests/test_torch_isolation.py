"""The port stands alone: no module of ray_tpu_torch, nor chip_smoke.py,
imports jax, optax, cloudpickle, msgpack or anything of the JAX package
ray_tpu (the card's machine has none of them), and its entry points do not
drift to the CPU without a GPU."""

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
                   "msgpack")


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
            "ddppo.py"} <= names


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
            "ray_tpu_torch.train.torch", "ray_tpu_torch.rllib.ddppo"} \
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


def test_scan_catches_forbidden_imports(tmp_path):
    """The scan itself: each forbidden form is caught, the port's own
    package name is not."""
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom ray_tpu.models import x\n"
                   "import ray_tpu\nfrom ray_tpu_torch import models\n"
                   "def f():\n    from jax import lax\n    import optax\n"
                   "    import cloudpickle\n    import msgpack\n")
    found = [mod for _, mod in _imports(src) if _forbidden(mod)]
    assert found == ["jax.numpy", "ray_tpu.models", "ray_tpu", "jax", "optax",
                     "cloudpickle", "msgpack"]


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
