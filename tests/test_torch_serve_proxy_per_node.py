"""Proxy-per-node ingress on the port's serve and runtime (twins of
tests/test_serve_proxy_per_node.py on ``ray_tpu_torch.cluster_utils``): a
two-node cluster runs a proxy on each node, route tables push to both, and
ingress survives the death of a proxy's node."""

import json
import socket
import time
import urllib.request

import pytest

from torch_runtimes import deadline


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def two_node_serve():
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import Cluster

    port = _free_port()
    with deadline(what="a two-node serve cluster on the port's runtime"):
        cluster = Cluster(initialize_head=True,
                          head_node_args={"num_cpus": 3})
        worker_nm = cluster.add_node(num_cpus=2)
        cluster.connect(object_store_memory=96 * 1024 * 1024)
        cluster.wait_for_nodes()
        serve.start(http_port=port)
        try:
            yield cluster, worker_nm, port
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()
            cluster.shutdown()


def _get(port, path, timeout=30):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def _proxy_ports(deadline_s=30, expect=2):
    import ray_tpu_torch
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME

    ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    end = time.time() + deadline_s
    while time.time() < end:
        addrs = ray_tpu_torch.get(ctrl.proxy_addresses.remote(), timeout=30)
        if len(addrs) >= expect:
            return addrs
        time.sleep(0.3)
    return ray_tpu_torch.get(ctrl.proxy_addresses.remote(), timeout=30)


def test_proxy_per_node_and_failover(two_node_serve):
    from ray_tpu_torch import serve

    cluster, worker_nm, port = two_node_serve

    @serve.deployment(num_replicas=2)
    def hello(payload):
        return {"hello": payload.get("query", {}).get("name", "world")}

    serve.run(hello.bind(), route_prefix="/hello", http_port=port)

    # One proxy per node, all serving the SAME route table.
    addrs = _proxy_ports(expect=2)
    assert len(addrs) == 2, addrs
    for p in sorted(addrs.values()):
        assert _get(p, "/hello?name=gpu") == {"hello": "gpu"}

    # Kill the worker node: its proxy (and any replica there) dies.
    worker_nid = worker_nm.node_id
    head_ports = [p for nid, p in addrs.items() if nid != worker_nid]
    assert head_ports, addrs
    cluster.remove_node(worker_nm, allow_graceful=False)

    # Ingress on the surviving node keeps working (replicas reconcile
    # back onto live nodes; the handle resubmits through replica death).
    end = time.time() + 60
    ok = False
    while time.time() < end:
        try:
            if _get(head_ports[0], "/hello?name=x",
                    timeout=10) == {"hello": "x"}:
                ok = True
                break
        except Exception:
            time.sleep(0.5)
    assert ok
    # The dead node's proxy drops from the table.
    end = time.time() + 30
    while time.time() < end:
        addrs2 = _proxy_ports(expect=1)
        if worker_nid not in addrs2:
            break
        time.sleep(0.5)
    assert worker_nid not in addrs2, addrs2


def test_route_table_pushes_to_proxies(two_node_serve):
    """A new deployment is routable on EVERY node's proxy within one push
    (no TTL wait): deploy, then at once hit both proxies."""
    from ray_tpu_torch import serve

    _cluster, _worker_nm, port = two_node_serve

    @serve.deployment
    def ping(payload):
        return {"pong": True}

    serve.run(ping.bind(), route_prefix="/ping", http_port=port)
    addrs = _proxy_ports(expect=2)
    assert len(addrs) == 2, addrs
    for p in addrs.values():
        assert _get(p, "/ping") == {"pong": True}
