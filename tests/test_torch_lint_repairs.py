"""Faults of the port that its raylint found, each repaired and held here.

* ``config-knob-drift``: the job manager's session directory and a
  worker's assigned GPUs were raw ``os.environ`` reads; both are typed
  knobs now (``session_dir``, ``gpu_ids``), read through
  ``config.refresh_from_env`` because the node manager sets them per
  worker, after a zygote imported the config module.
* ``blocking-under-lock``: the serve controller held its proxy lock
  across the (bounded) get of a new proxy's port. A reconcile now claims
  the nodes it starts proxies for under the controller's lock and waits
  outside any lock, and concurrent reconciles still start one proxy per
  node.
"""

import threading
import time

import pytest

from ray_tpu_torch._private.config import config


@pytest.fixture
def knob(monkeypatch):
    """Set a knob's variable for one test and put the registry back."""
    saved = {}

    def set_env(name, value):
        saved.setdefault(name, config.get(name))
        monkeypatch.setenv("RAY_TPU_TORCH_" + name.upper(), value)

    yield set_env
    for name, value in saved.items():
        config.set(name, value)


def test_assigned_gpus_read_through_the_registry(knob, monkeypatch):
    from ray_tpu_torch.runtime_context import RuntimeContext

    ctx = RuntimeContext(core=None)
    monkeypatch.delenv("RAY_TPU_TORCH_GPU_IDS", raising=False)
    config.set("gpu_ids", "")
    assert ctx.get_assigned_resources() == {}
    knob("gpu_ids", "0,3")
    assert ctx.get_assigned_resources() == {"GPU": 2.0}
    assert config.gpu_ids == "0,3"
    assert config._entries["gpu_ids"].doc


def test_job_manager_session_dir_read_through_the_registry(knob, tmp_path):
    from ray_tpu_torch.job_submission.client import _JobManager

    knob("session_dir", str(tmp_path / "session"))
    jm = _JobManager("127.0.0.1:1")
    assert jm.log_dir == str(tmp_path / "session" / "logs" / "jobs")
    assert config.session_dir == str(tmp_path / "session")


class _FakeActor:
    def __init__(self, nid):
        self.nid = nid
        self.bound_port = self

    def remote(self):
        return self


class _FakeProxyClass:
    """Stands in for ``ray_tpu_torch.remote(HTTPProxy)``: records each
    proxy started, per node."""

    def __init__(self):
        self.started = []
        self._nid = None

    def options(self, scheduling_strategy):
        self._nid = scheduling_strategy.node_id
        return self

    def remote(self, port, system_config=None):
        self.started.append(self._nid)
        return _FakeActor(self._nid)


def test_proxy_reconcile_waits_outside_locks_one_proxy_per_node(
        monkeypatch):
    """Two reconciles at once (``__init__``'s and the control loop's): the
    get of a new proxy's port blocks with the controller's lock free, and
    each node still gets exactly one proxy."""
    import ray_tpu_torch
    from ray_tpu_torch.serve import controller as controller_mod

    ctrl = controller_mod.ServeController.__new__(
        controller_mod.ServeController)
    ctrl._lock = threading.RLock()
    ctrl._http_port = 8000
    ctrl._proxies = {}
    ctrl._proxy_backoff = {}
    ctrl._proxy_starting = set()
    ctrl._system_config = {}

    nodes = [{"NodeID": "a" * 56, "Alive": True},
             {"NodeID": "b" * 56, "Alive": True}]
    proxies = _FakeProxyClass()
    in_get = threading.Event()
    release = threading.Event()
    timeouts = []

    def get(ref, timeout=None):
        timeouts.append(timeout)
        in_get.set()
        assert release.wait(10)
        return 9000 + len(proxies.started)

    monkeypatch.setattr(ray_tpu_torch, "nodes", lambda: nodes)
    monkeypatch.setattr(ray_tpu_torch, "remote", lambda cls: proxies)
    monkeypatch.setattr(ray_tpu_torch, "get", get)

    first = threading.Thread(target=ctrl._reconcile_proxies)
    first.start()
    assert in_get.wait(10)
    assert ctrl._lock.acquire(blocking=False)   # free across the wait
    ctrl._lock.release()
    # A second reconcile while the first waits on a port: it must neither
    # block (no lock is held across that wait) nor start a second proxy
    # for a node the first has claimed.
    t0 = time.time()
    second = threading.Thread(target=ctrl._reconcile_proxies)
    second.start()
    second.join(5)
    assert not second.is_alive() and time.time() - t0 < 5
    assert ctrl.proxy_addresses() == {}
    release.set()
    first.join(10)
    assert not first.is_alive()
    assert sorted(proxies.started) == sorted(n["NodeID"] for n in nodes)
    assert sorted(ctrl.proxy_addresses()) == sorted(
        n["NodeID"] for n in nodes)
    assert timeouts and None not in timeouts    # every wait bounded
    assert ctrl._proxy_starting == set()
    # A later reconcile finds every node served.
    ctrl._reconcile_proxies()
    assert len(proxies.started) == len(nodes)
