"""The HTTP/SSE ingress on both runtimes: the reference's aiohttp proxy on
``ray_tpu``, then the port's ``asyncio`` proxy on ``ray_tpu_torch``, one
after the other, each given the same HTTP requests (twins of
``tests/test_serve_ingress.py`` and ``test_serve_proxy_per_node.py``).

Compared: status codes, JSON bodies, SSE frame sequences, ``Retry-After``
on sheds, keep-alive, the catch-all route's payload (path, query, method,
JSON or raw body), a client disconnect cancelling the replica stream, and
a ``RequestMigrationExhaustedError`` from the deployment, which is a 503
on both (on the port's runtime the port's own class). The LLM behind
``/v1/completions`` is ``tests/torch_serve_programs.py``'s ``FakeLLM``:
the ingress contract, not the engine (``test_torch_serve_llm`` holds the
engine's tokens on the port's runtime). ``AdmissionController`` of both
runs one scripted arrival sequence on a fake clock and gives the same
grants, sheds and retry hints.
"""

import asyncio
import http.client
import json
import socket
import threading
import time

import pytest

import ray_tpu
import torch_serve_programs as progs
from torch_runtimes import deadline, ports_runtime

SYSTEM_CONFIG = {
    "serve_ingress_max_inflight": 2,
    "serve_ingress_queue_watermark": 1,
    "serve_ingress_queue_timeout_s": 5.0,
}
PROMPT = [5, 9, 2]


def _proxy_port(rt):
    ctrl = progs._controller(rt)
    ports = progs._until(
        lambda: rt.get(ctrl.proxy_addresses.remote(), timeout=30), 30.0)
    assert ports, "the ingress proxy never came up"
    return next(iter(ports.values()))


def _request(port, method, path, body=None, headers=None, conn=None):
    """(status, Retry-After, Content-Type, parsed body) of one request."""
    own = conn is None
    conn = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    conn.request(method, path, body=body, headers=dict(headers or {}))
    resp = conn.getresponse()
    raw = resp.read()
    ctype = (resp.getheader("Content-Type") or "").split(";")[0]
    out = (resp.status, resp.getheader("Retry-After"), ctype,
           json.loads(raw) if ctype == "application/json" else raw)
    if own:
        conn.close()
    return out


def _sse(port, body):
    """(status, Content-Type, every ``data:`` payload in order)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/completions", body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read().decode()
    conn.close()
    frames = [line[len("data: "):] for line in raw.split("\n")
              if line.startswith("data: ")]
    return resp.status, resp.getheader("Content-Type"), frames


def _sheds(port):
    """Four slow completions at once through a budget of two in flight and
    a waiting room of one: three are served, one is shed."""
    out = [None] * 4

    def client(i):
        out[i] = _request(port, "POST", "/v1/completions",
                          {"model": "llm", "prompt": [-1, i],
                           "max_tokens": 2})
    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
        time.sleep(0.05)
    for t in threads:
        t.join(timeout=60)
    return sorted((s, retry, body["error"]["type"] if s != 200 else None)
                  for s, retry, _, body in out)


def _disconnect(rt, port):
    """Read one SSE frame of a slow stream, drop the socket, and wait for
    the replica's generator to be closed."""
    llm = progs._serve(rt).get_deployment_handle("llm")
    before = llm.cancelled.remote().result(timeout=60)
    body = json.dumps({"model": "llm", "prompt": [-3, 1], "max_tokens": 40,
                       "stream": True}).encode()
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\nContent-Length: "
                 + str(len(body)).encode() + b"\r\n\r\n" + body)
    got = b""
    while b"data: " not in got:
        got += sock.recv(4096)
    sock.close()
    cancelled = progs._until(
        lambda: llm.cancelled.remote().result(timeout=60) > before, 20.0)
    return got.split(b"\r\n")[0], bool(cancelled)


def _exchange(rt):
    serve = progs._serve(rt)
    serve.run(serve.deployment(progs.Adding, name="adder").bind(),
              route_prefix="/add")
    serve.run(serve.deployment(progs.FakeLLM, name="llm").bind(rt.__name__),
              route_prefix="/llm")
    port = _proxy_port(rt)
    completion = {"model": "llm", "prompt": PROMPT, "max_tokens": 5,
                  "seed": 1}
    out = {
        "json_route": _request(port, "POST", "/add?x=1&x=2&y=",
                               {"a": 3, "b": 4}),
        "get_route": _request(port, "GET", "/add/deeper"),
        "raw_body": _request(port, "PUT", "/add", b"\xff\x00"),
        "no_route": _request(port, "GET", "/nowhere"),
        "bad_json": _request(port, "POST", "/v1/completions", b"{not json"),
        "no_prompt": _request(port, "POST", "/v1/completions",
                              {"model": "llm", "max_tokens": 2}),
        "completion": _request(port, "POST", "/v1/completions",
                               completion),
        "default_model": _request(port, "POST", "/v1/completions",
                                  {"prompt": PROMPT, "max_tokens": 3}),
        "sse": _sse(port, dict(completion, stream=True)),
        "migration_exhausted": _request(
            port, "POST", "/v1/completions",
            {"model": "llm", "prompt": [-2], "max_tokens": 2}),
        "sheds": _sheds(port),
        "disconnect": _disconnect(rt, port),
    }
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    out["keep_alive"] = [
        _request(port, "POST", "/v1/completions", completion, conn=conn)[0]
        for _ in range(3)]
    conn.close()
    serve.delete("adder")
    serve.delete("llm")
    return out


@pytest.fixture(scope="module")
def exchanges():
    import ray_tpu.serve as jserve

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ray_tpu.init(num_cpus=4, object_store_memory=128 * 1024 * 1024,
                     _system_config=SYSTEM_CONFIG)
    try:
        with deadline(what="the ingress exchange on ray_tpu"):
            jserve.start(http_port=0)
            out["ray_tpu"] = _exchange(ray_tpu)
            jserve.shutdown()
    finally:
        ray_tpu.shutdown()
    with ports_runtime(num_cpus=4, _system_config=SYSTEM_CONFIG) as rt:
        import ray_tpu_torch.serve as tserve

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            requested = s.getsockname()[1]
        tserve.start(http_port=requested)
        try:
            out["ray_tpu_torch"] = _exchange(rt)
            table = rt.get(progs._controller(rt).proxy_addresses.remote(),
                           timeout=30)
            out["proxy_table"] = (requested, list(table.values()))
        finally:
            tserve.shutdown()
    return out


TOKENS = [(sum(PROMPT) + 1 + i) % 97 for i in range(5)]
EXPECTED = {
    "json_route": (200, None, "application/json",
                   {"sum": 7, "path": "/add", "query": {"x": "1", "y": ""},
                    "method": "POST"}),
    "get_route": (200, None, "application/json",
                  {"path": "/add/deeper", "method": "GET"}),
    "raw_body": (200, None, "application/json", {"raw": 2}),
    "no_route": (404, None, "application/json",
                 {"error": "no deployment routes /nowhere"}),
    "bad_json": (400, None, "application/json",
                 {"error": {"type": "bad_request",
                            "message": "body must be JSON"}}),
    "no_prompt": (400, None, "application/json",
                  {"error": {"type": "bad_request",
                             "message": "missing 'prompt' (token id list)"}}),
    "completion": (200, None, "application/json",
                   {"object": "text_completion", "model": "llm",
                    "choices": [{"index": 0, "tokens": TOKENS,
                                 "finish_reason": "stop"}],
                    "usage": {"completion_tokens": 5}}),
    "default_model": (200, None, "application/json",
                      {"object": "text_completion", "model": "llm",
                       "choices": [{"index": 0,
                                    "tokens": [16, 17, 18],
                                    "finish_reason": "stop"}],
                       "usage": {"completion_tokens": 3}}),
    "sse": (200, "text/event-stream; charset=utf-8",
            [json.dumps({"model": "llm",
                         "choices": [{"index": 0,
                                      "tokens": TOKENS[i:i + 2]}]})
             for i in range(0, 5, 2)] + ["[DONE]"]),
    "sheds": [(200, None, None)] * 3 + [(429, "1", "overloaded")],
    "disconnect": (b"HTTP/1.1 200 OK", True),
    "keep_alive": [200, 200, 200],
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_same_http_answers_on_both_proxies(exchanges, name):
    ref, port = exchanges["ray_tpu"][name], exchanges["ray_tpu_torch"][name]
    assert ref == EXPECTED[name], ref
    assert port == ref


def test_request_migration_exhausted_is_a_503(exchanges):
    """The port's router raises the port's class; on the port's runtime
    the ingress knows it (it was a 500 behind the reference's proxy)."""
    for rt in ("ray_tpu", "ray_tpu_torch"):
        status, retry, ctype, body = \
            exchanges[rt]["migration_exhausted"]
        assert (status, retry, ctype) == (503, "1", "application/json")
        assert body["error"]["type"] == "overloaded"
        assert "3 migrations" in body["error"]["message"]
    assert exchanges["ray_tpu"]["migration_exhausted"] == \
        exchanges["ray_tpu_torch"]["migration_exhausted"]


def test_one_proxy_a_node_on_the_requested_port(exchanges):
    """The controller's start and its reconcile loop both bring up the
    ingress; one at a time, so the node's one proxy holds the requested
    port (two at once left a second proxy on an ephemeral port listed in
    place of the first)."""
    requested, ports = exchanges["proxy_table"]
    assert ports == [requested]


# ------------------------------------------------ admission, scripted

class _Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t


async def _admission_script(mod, exc, clock):
    ac = mod.AdmissionController(
        max_inflight=2, queue_watermark=3, queue_timeout_s=0.3,
        tenant_rate=2.0, tenant_burst=2.0)
    log = []

    async def arrive(name, tenant):
        try:
            await ac.acquire(tenant)
            log.append(("grant", name))
        except exc as e:
            log.append(("shed", name, e.reason,
                        getattr(e, "http_status", 429),
                        round(e.retry_after_s, 3)))

    async def step():
        for _ in range(5):
            await asyncio.sleep(0)

    tasks = []
    for name, tenant in (("a1", "a"), ("a2", "a"), ("a3", "a"),
                         ("b1", "b"), ("c1", "c"), ("b2", "b"),
                         ("c2", "c"), ("d1", "d")):
        tasks.append(asyncio.ensure_future(arrive(name, tenant)))
        await step()
    log.append(("stats", dict(ac.stats())))
    clock.t += 0.25          # a's bucket refills half a token
    tasks.append(asyncio.ensure_future(arrive("a4", "a")))
    await step()
    for _ in range(2):       # two slots free: DRR serves b then c
        ac.release()
        await step()
    log.append(("stats", dict(ac.stats())))
    await asyncio.sleep(0.4)  # b2 waits past the queue timeout
    await asyncio.gather(*tasks)
    log.append(("stats", dict(ac.stats())))
    return log


def test_admission_controllers_agree_on_a_scripted_sequence(monkeypatch):
    from ray_tpu.exceptions import ServeOverloadedError as JErr
    from ray_tpu.serve.ingress import admission as jadm
    from ray_tpu_torch.exceptions import ServeOverloadedError as TErr
    from ray_tpu_torch.serve.ingress import admission as tadm

    logs = []
    for mod, exc in ((jadm, JErr), (tadm, TErr)):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        logs.append(asyncio.run(_admission_script(mod, exc, clock)))
    assert logs[1] == logs[0]
    grants = [e[1] for e in logs[0] if e[0] == "grant"]
    sheds = {e[1]: e[2:] for e in logs[0] if e[0] == "shed"}
    assert grants == ["a1", "a2", "b1", "c1"]
    assert sheds["a3"][:2] == ("tenant_rate", 429)
    assert sheds["a3"][2] == 0.5
    assert sheds["d1"][:2] == ("queue_watermark", 429)
    assert sheds["b2"][:2] == ("queue_timeout", 503)
