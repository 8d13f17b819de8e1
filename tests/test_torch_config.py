"""Every knob of the port's config registry is read by some module of the
port: a ``RAY_TPU_TORCH_*`` variable that a user can set does something."""

import pathlib
import re

import pytest

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


def test_unported_modes_are_refused_at_init(monkeypatch):
    """The reference's always-on profiler and template verify mode are
    not ported: setting one fails at ``init()`` instead of being ignored.
    (The lock-order witness is ported: ``test_torch_lockdep``.)"""
    import ray_tpu_torch
    from ray_tpu_torch._private import config as cfg

    assert set(cfg.UNPORTED) == {"profiler_always_on",
                                 "submit_template_verify"}
    for name in cfg.UNPORTED:
        var = "RAY_TPU_TORCH_" + name.upper()
        monkeypatch.setenv(var, "1")
        with pytest.raises(NotImplementedError, match=var):
            ray_tpu_torch.init(num_cpus=1)
        monkeypatch.setenv(var, "0")
        cfg.refuse_unported()
