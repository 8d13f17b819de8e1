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
            "schedulers.py", "placement_groups.py", "tuner.py",
            "dag_node.py", "execution.py", "client.py", "head.py",
            "cli.py", "__main__.py", "queue.py", "multiprocessing.py",
            "check_serialize.py", "test_utils.py", "http.py"} <= names


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
            "ray_tpu_torch.tune", "ray_tpu_torch.tune.tuner",
            "ray_tpu_torch.dag", "ray_tpu_torch.dag.dag_node",
            "ray_tpu_torch.workflow", "ray_tpu_torch.workflow.execution",
            "ray_tpu_torch.job_submission",
            "ray_tpu_torch.job_submission.client",
            "ray_tpu_torch.util.client",
            "ray_tpu_torch.experimental.state",
            "ray_tpu_torch.experimental.state.api",
            "ray_tpu_torch.dashboard.head", "ray_tpu_torch.scripts.cli",
            "ray_tpu_torch.__main__", "ray_tpu_torch.util.queue",
            "ray_tpu_torch.util.multiprocessing",
            "ray_tpu_torch.util.check_serialize",
            "ray_tpu_torch._private.test_utils",
            "ray_tpu_torch._private.http"} \
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


_CLI_PROBE = """
import runpy, sys
before = set(sys.modules)
sys.argv = ["ray_tpu_torch"] + {argv!r}
try:
    runpy.run_module("ray_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code
print(repr((code, sorted({{m.split(".")[0] for m in sys.modules}} - {{
    m.split(".")[0] for m in before}}))))
"""


@pytest.mark.parametrize("argv", [["--help"], ["up", "--help"],
                                  ["list", "nodes"]],
                         ids=["help", "up-help", "list-no-cluster"])
def test_cli_process_loads_none_of_them(argv, tmp_path):
    """``python -m ray_tpu_torch`` loads none of the forbidden packages,
    no torch, and no yaml until ``up`` reads a file: asking for help, and
    ``list`` with no cluster to connect to (it exits naming the ways to
    give one)."""
    import os

    env = {k: v for k, v in os.environ.items()
           if k != "RAY_TPU_TORCH_ADDRESS"}
    env["TMPDIR"] = str(tmp_path)       # no head's address file there
    out = subprocess.run(
        [sys.executable, "-c", _CLI_PROBE.format(argv=argv)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120).stdout
    code, loaded = ast.literal_eval(out.strip().splitlines()[-1])
    assert "ray_tpu_torch" in loaded
    assert not [m for m in loaded if _forbidden(m)], loaded
    assert not [m for m in loaded if m in NOT_AT_IMPORT], loaded
    assert "torch" not in loaded, loaded
    if "--help" in argv:
        assert code == 0
    else:
        assert "no cluster address" in code


CONTROL_PLANE = ["ray_tpu_torch", "ray_tpu_torch._private.gcs",
                 "ray_tpu_torch._private.node_manager",
                 "ray_tpu_torch.scripts.cli", "ray_tpu_torch.dashboard.head",
                 "ray_tpu_torch._private.lint"]


@pytest.mark.parametrize("module", CONTROL_PLANE)
def test_control_plane_import_loads_no_torch(module):
    """The control plane runs without torch, as the reference's runs
    without jax: a fresh interpreter importing the package, the GCS, the
    node manager, the CLI, the dashboard head or the lint loads no torch
    (nor numpy)."""
    code = (f"import sys\nimport {module}\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    loaded = ast.literal_eval(out.strip().splitlines()[-1])
    assert "ray_tpu_torch" in loaded
    assert not {"torch", "numpy"} & set(loaded), loaded


def _maps_torch(pid: int) -> bool:
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


def test_head_and_gcs_processes_load_no_torch(tmp_path):
    """A head started by the CLI (the node manager in the head daemon, the
    GCS in a child of its own) runs tasks, and neither process maps
    torch. Its CPU workers may: the zygote preloads torch for them."""
    import os

    from ray_tpu_torch._private.test_utils import session_pids

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_TORCH_")}
    env["TMPDIR"] = str(tmp_path)
    log = open(tmp_path / "cli.log", "w")

    def cli(*argv, timeout=120):
        return subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch", *argv], cwd=ROOT,
            env=env, stdout=log, stderr=subprocess.STDOUT, timeout=timeout)

    assert cli("start", "--head", "--num-cpus", "1").returncode == 0
    try:
        head = int((tmp_path / "ray_tpu_torch" / "head.pid").read_text())
        driver = (
            "import ray_tpu_torch as rt\n"
            "rt.init(address='auto')\n"
            "f = rt.remote(lambda x: x + 1)\n"
            "assert rt.get([f.remote(i) for i in range(4)], timeout=60)"
            " == [1, 2, 3, 4]\n"
            "rt.shutdown()\n")
        addr = (tmp_path / "ray_tpu_torch" / "head.addr").read_text()
        assert subprocess.run(
            [sys.executable, "-c", driver], cwd=ROOT,
            env=dict(env, RAY_TPU_TORCH_ADDRESS=addr.strip()), stdout=log,
            stderr=subprocess.STDOUT, timeout=120).returncode == 0
        gcs = []
        for pid in session_pids(head, str(tmp_path)):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    if b"ray_tpu_torch._private.gcs" in f.read():
                        gcs.append(pid)
            except OSError:
                continue
        assert len(gcs) == 1, gcs
        assert not _maps_torch(head)
        assert not _maps_torch(gcs[0])
    finally:
        assert cli("stop").returncode == 0
        log.close()


_LATE_TORCH = """
import sys
import ray_tpu_torch as rt
assert "torch" not in sys.modules
rt.init(num_cpus=1)
try:
    assert rt.get(rt.put(b"before"), timeout=60) == b"before"
    import torch
    from ray_tpu_torch._private import device_objects
    device_objects.reset_stats()
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    back = rt.get(rt.put(t), timeout=60)
    made = rt.get(rt.remote(lambda n: torch.full((n,), 7.0)).remote(5),
                  timeout=60)
    st = device_objects.stats()
    print("RESULT", repr((torch.equal(back, t), made.tolist(), st)),
          flush=True)
finally:
    rt.shutdown()
"""


def test_device_objects_after_late_torch_import(tmp_path):
    """A process that imports torch after ``ray_tpu_torch`` (and after a
    first serialize, which installed no hook) still moves tensors out of
    band: a put is staged by the tensor hook and a task's return is
    rebuilt from its frame, not pickled in band."""
    out = tmp_path / "out.txt"
    with open(out, "w") as f:
        subprocess.run([sys.executable, "-c", _LATE_TORCH], cwd=ROOT,
                       stdout=f, stderr=subprocess.STDOUT, timeout=180,
                       check=False)
    text = out.read_text()
    last = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
    assert last, text
    last = last[-1][len("RESULT "):]
    equal, made, st = ast.literal_eval(last)
    assert equal and made == [7.0] * 5
    # The put is staged out of band here (and its get is the registered
    # tensor itself); the worker's return is rebuilt from its frame.
    assert (st["puts"], st["local_hits"], st["rebuilds"]) == (1, 1, 1), st


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
