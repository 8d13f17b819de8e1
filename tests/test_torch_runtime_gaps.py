"""Small gaps of the port's runtime closed against the reference: the
world address of ``_node_address`` where the runtime lists no node for
this process (``ray_tpu/parallel/collective.py::_node_ip``'s rule, on a
patched socket), and the serve handle's legacy routing probe behind
``serve_handle_stats_rpc``."""

import socket
import sys

import pytest

from ray_tpu_torch.parallel import collective
from torch_runtimes import deadline


class _Ctx:
    def __init__(self, node_id):
        self._node_id = node_id

    def get_node_id(self):
        return self._node_id


class _Runtime:
    """A runtime that lists ``nodes`` and runs on node ``node_id``."""

    def __init__(self, nodes, node_id="me"):
        self._nodes = nodes
        self._node_id = node_id

    def nodes(self):
        return self._nodes

    def get_runtime_context(self):
        return _Ctx(self._node_id)


class _Socket:
    """A UDP socket whose connect picks ``ip`` as the outbound interface,
    or raises ``error``; it records what it was asked."""

    calls = []

    def __init__(self, ip=None, error=None):
        self._ip, self._error = ip, error

    def __call__(self, family, kind):
        _Socket.calls.append(("socket", family, kind))
        return self

    def connect(self, addr):
        _Socket.calls.append(("connect", addr))
        if self._error is not None:
            raise self._error

    def getsockname(self):
        return (self._ip, 40000)

    def close(self):
        _Socket.calls.append(("close",))


@pytest.fixture
def fake_socket(monkeypatch):
    _Socket.calls = []

    def install(**kw):
        monkeypatch.setattr(collective.socket, "socket", _Socket(**kw))
        return _Socket.calls

    return install


def test_node_address_unlisted_node_takes_the_outbound_interface(
        fake_socket):
    calls = fake_socket(ip="10.1.2.3")
    rt = _Runtime([{"NodeID": "other",
                    "NodeManagerAddress": "10.9.9.9:1234"}])
    assert collective._node_address(rt) == "10.1.2.3"
    assert calls[0] == ("socket", socket.AF_INET, socket.SOCK_DGRAM)
    assert calls[1] == ("connect", collective._ROUTE_PROBE)
    assert calls[-1] == ("close",)


def test_node_address_no_route_is_the_loopback(fake_socket):
    calls = fake_socket(error=OSError("Network is unreachable"))
    assert collective._node_address(_Runtime([])) == "127.0.0.1"
    assert ("close",) in calls


def test_node_address_listed_node_keeps_its_node_manager_host(fake_socket):
    calls = fake_socket(ip="10.1.2.3")
    rt = _Runtime([{"NodeID": "me", "NodeManagerAddress": "10.7.0.5:6380"}])
    assert collective._node_address(rt) == "10.7.0.5"
    assert calls == []


def test_node_address_in_process_runtime_is_the_loopback(fake_socket):
    from ray_tpu_torch.runtime import LocalRuntime

    calls = fake_socket(ip="10.1.2.3")
    assert collective._node_address(LocalRuntime()) == "127.0.0.1"
    assert calls == []


def test_serve_handle_stats_rpc_routes_by_probing():
    """``serve_handle_stats_rpc`` on: each pick probes two replicas'
    ``stats`` (the reference's A/B baseline); the answers are the pushed
    path's."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.config import config
    from ray_tpu_torch.serve import handle as handle_mod

    probes = []
    real_get = ray_tpu_torch.get

    def counting_get(refs, *a, **kw):
        if sys._getframe(1).f_code is handle_mod.DeploymentHandle._pick.__code__:
            probes.append(len(refs))
        return real_get(refs, *a, **kw)

    with deadline(what="the serve handle's stats probe"):
        ray_tpu_torch.init(num_cpus=3, object_store_memory=96 * 1024 * 1024)
        try:
            @serve.deployment(num_replicas=2)
            def echo(x):
                return x * 3

            h = serve.run(echo.bind(), http_port=None)
            pushed = [h.remote(i).result(timeout=60) for i in range(6)]
            old = config.get("serve_handle_stats_rpc")
            config.set("serve_handle_stats_rpc", True)
            try:
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(ray_tpu_torch, "get", counting_get)
                    probed = [h.remote(i).result(timeout=60)
                              for i in range(6)]
            finally:
                config.set("serve_handle_stats_rpc", old)
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
    assert pushed == probed == [3 * i for i in range(6)]
    assert probes == [2] * 6
