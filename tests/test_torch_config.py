"""Every knob of the port's config registry is read by some module of the
port: a ``RAY_TPU_TORCH_*`` variable that a user can set does something.
The two correctness modes of the reference, the always-on profiler and
the spec-template verify mode, each turned on."""

import pathlib
import pickle
import re
import threading
import time

import pytest

import torch_core_programs as progs
from torch_runtimes import deadline

ROOT = pathlib.Path(__file__).resolve().parent.parent / "ray_tpu_torch"
CONFIG = ROOT / "_private" / "config.py"


def test_every_knob_is_read():
    names = re.findall(r'^_d\(\s*"(\w+)"', CONFIG.read_text(), re.M)
    assert len(names) > 20
    sources = "\n".join(p.read_text() for p in ROOT.rglob("*.py")
                        if p != CONFIG)
    unread = [n for n in names
              if not re.search(rf'(\.{n}\b|"{n}")', sources)]
    assert not unread, unread


def _profiler_threads():
    return [t for t in threading.enumerate() if t.name == "rtpu-profiler"]


def _wait_for(pred, timeout_s, what):
    end = time.time() + timeout_s
    while time.time() < end:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture
def always_on(monkeypatch):
    """``profiler_always_on`` on, as its variable sets it; the node
    manager ships the knob to the workers it starts."""
    from ray_tpu_torch._private.config import config

    monkeypatch.setenv("RAY_TPU_TORCH_PROFILER_ALWAYS_ON", "1")
    old = config.get("profiler_always_on")
    config.set("profiler_always_on", True)
    try:
        yield
    finally:
        config.set("profiler_always_on", old)


def test_always_on_no_thread_stacking_across_init_shutdown(always_on):
    """profiler_always_on across init()/shutdown() cycles: exactly one
    sampler while up (the driver, the GCS and the node manager share this
    process), none after shutdown; setting the mode no longer refuses
    init()."""
    import ray_tpu_torch

    for _ in range(2):
        with deadline(what="an always-on init/shutdown cycle"):
            ray_tpu_torch.init(num_cpus=1)
            try:
                assert len(_profiler_threads()) == 1
            finally:
                ray_tpu_torch.shutdown()
        _wait_for(lambda: not _profiler_threads(), 5,
                  "sampler joined on shutdown")


def test_always_on_profile_reads_every_process_running_sampler(always_on):
    """With the mode on, one ``profile`` window covers the driver, the
    node manager, the GCS and the workers, each from the sampler it
    already runs (``sampler_started`` False everywhere), and the workers'
    stacks hold the task they run."""
    import ray_tpu_torch
    from ray_tpu_torch.experimental import state

    spin = ray_tpu_torch.remote(progs.spin_for)
    with deadline(what="an always-on profile window"):
        ray_tpu_torch.init(num_cpus=2)
        try:
            assert ray_tpu_torch.get(
                [spin.remote(0.0) for _ in range(2)], timeout=60) == [0, 0]
            refs = [spin.remote(4.0) for _ in range(2)]
            time.sleep(0.3)
            processes = state.profile(duration_s=1.0)
            ray_tpu_torch.get(refs, timeout=60)
        finally:
            ray_tpu_torch.shutdown()
    ok = [p for p in processes if not p.get("error")]
    assert ok == processes, processes
    assert {"gcs", "node_manager", "driver", "worker"} <= \
        {p["kind"] for p in ok}
    assert not [p for p in ok if p["sampler_started"]], ok
    workers = [p for p in ok if p["kind"] == "worker"]
    assert any("spin_for" in stack for p in workers
               for stack in p["stacks"]), workers


def _const(job, **over):
    base = dict(job_id=job, function_key="fn:0123456789abcdef", arg_deps=[],
                num_returns=1, resources={"CPU": 1.0}, name="nop",
                max_retries=3, retries_left=0, caller_id="client-1",
                owner_node="node-1", scheduling_strategy=None,
                placement_group_id=None, placement_group_bundle_index=-1,
                runtime_env=None, trace_ctx=None)
    base.update(over)
    return base


@pytest.mark.parametrize("over", [{}, {"num_returns": 3},
                                  {"name": "a-much-longer-name-" * 8},
                                  {"scheduling_strategy": "SPREAD"}],
                         ids=["plain", "returns", "long-name", "spread"])
def test_template_verify_mode_byte_equal_and_catches_drift(over):
    """submit_template_verify re-checks every patched blob against a
    fresh pickle (equal byte for byte for args on both sides of the
    bytes-opcode boundary); a template whose frozen constants no longer
    match raises instead of shipping wrong bytes."""
    from ray_tpu_torch._private import spec_template
    from ray_tpu_torch._private.ids import JobID, TaskID
    from ray_tpu_torch._private.task_spec import TaskSpec

    job = JobID.from_int(3)
    const = _const(job, **over)
    tpl = spec_template.build(const)
    tpl.set_verify(True)
    for args in (b"", b"x" * 255, b"z" * 256, bytes(range(256)) * 16):
        tid, t = TaskID.for_task(job), time.time()
        spec = tpl.make(tid, args, t)
        assert spec_template.spec_wire(spec) == pickle.dumps(
            TaskSpec(task_id=tid, args=args, submitted_at=t, **const),
            protocol=5)
    tpl._const["name"] = "drifted"   # the frozen constants drift
    with pytest.raises(AssertionError, match="spec template verify"):
        tpl.make(TaskID.for_task(job), b"ok", time.time())


def test_template_verify_at_init_checks_every_submission(monkeypatch):
    """RAY_TPU_TORCH_SUBMIT_TEMPLATE_VERIFY=1 no longer refuses init():
    every submission through a template is patched eagerly and checked
    against a fresh pickle (``make``, not the lazy or blob-only route),
    and all of them run."""
    import ray_tpu_torch
    from ray_tpu_torch._private import spec_template
    from ray_tpu_torch._private.config import config

    checked = []
    real_make = spec_template.SpecTemplate.make

    def make(self, task_id, args, submitted_at):
        assert self._verify
        checked.append(task_id)
        return real_make(self, task_id, args, submitted_at)

    monkeypatch.setattr(spec_template.SpecTemplate, "make", make)
    spin = ray_tpu_torch.remote(progs.spin_for)
    monkeypatch.setenv("RAY_TPU_TORCH_SUBMIT_TEMPLATE_VERIFY", "1")
    old = config.get("submit_template_verify")
    config.set("submit_template_verify", True)
    try:
        with deadline(what="verified submissions"):
            ray_tpu_torch.init(num_cpus=2)
            try:
                refs = [spin.remote(0.0, i) for i in range(200)]
                assert ray_tpu_torch.get(refs, timeout=120) == \
                    list(range(200))
            finally:
                ray_tpu_torch.shutdown()
    finally:
        config.set("submit_template_verify", old)
    # The first WARMUP_CALLS submissions build no template yet.
    assert len(checked) >= 200 - 3, len(checked)
