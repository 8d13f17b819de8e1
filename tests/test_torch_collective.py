"""The port's collectives (ray_tpu_torch.parallel.collective) against the
JAX package's on the same seeded numpy inputs.

- ``store`` and ``torch_dist`` (gloo) groups of 2 ranks, each rank a
  ``ray_tpu`` worker process that also holds the JAX package's
  ``StoreGroup`` and ``XlaDistributedGroup`` of the same world: every op
  and ``ReduceOp`` (the cases of tests/test_parallel.py and
  tests/test_collective_dist.py) gives the JAX group's result, exactly for
  integers and for SUM, MAX, MIN and PRODUCT of two values, to 1e-6 for
  AVG (a sum and a division, in another order on each side).
- ``LocalGroup`` over 4 CPU devices against ``XlaGroup`` on 4 of the
  host platform's devices, as tests/test_parallel.py runs it.
- Poisoning: a pending store op raises ``GangMemberDiedError`` within 2x
  the gang heartbeat of ``poison_group``; a pending gloo op whose peer is
  alive but absent ends, poisoned, within the world's op timeout.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu.parallel import collective as jc
from ray_tpu_torch.exceptions import GangMemberDiedError
from ray_tpu_torch.parallel import collective as tc

WORLD = 2
OP_TIMEOUT_S = 5.0            # the torch_dist world's op timeout here
HEARTBEAT_S = 1.0             # the port's default gang heartbeat
DETECT_BOUND_S = 2 * HEARTBEAT_S + 3.0
OPS = ["SUM", "PRODUCT", "MIN", "MAX", "AVG"]


@pytest.fixture(scope="module")
def ray_cluster():
    """A 4-CPU cluster whose processes, and this one, run torch on one
    thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ctx = ray_tpu.init(num_cpus=4,
                           object_store_memory=128 * 1024 * 1024)
    yield ctx
    ray_tpu.shutdown()
    torch.set_num_threads(threads)


def _inputs(rank):
    """Rank ``rank``'s seeded values of every case."""
    rng = np.random.default_rng(100 + rank)
    return {
        "f32": rng.normal(size=(4, 3)).astype(np.float32),
        "i32": rng.integers(-5, 6, size=(5,)).astype(np.int32),
        "scatter": rng.normal(size=(2 * WORLD, 3)).astype(np.float32),
        "bcast": rng.normal(size=(6,)).astype(np.float32),
        "p2p": np.full((4,), 7.0, np.float32) + rank,
    }


def _cases(g, rank, backend, sum_avg_scatter):
    """Every op of ``g`` on rank ``rank``'s inputs, results as numpy.
    ``sum_avg_scatter``: the group reduce-scatters with SUM and AVG only
    (the JAX xla_dist group)."""
    x = _inputs(rank)
    out = {}
    for name in OPS:
        op = backend.ReduceOp[name]
        out[f"allreduce-f32-{name}"] = g.allreduce(x["f32"], op=op)
        if name != "AVG":
            out[f"allreduce-i32-{name}"] = g.allreduce(x["i32"], op=op)
    out["allgather-f32"] = g.allgather(x["f32"])
    out["allgather-i32"] = g.allgather(x["i32"])
    for name in ("SUM", "AVG") if sum_avg_scatter else OPS:
        out[f"reducescatter-{name}"] = g.reducescatter(
            x["scatter"], op=backend.ReduceOp[name])
    for src in range(WORLD):
        out[f"broadcast-{src}"] = g.broadcast(x["bcast"], src_rank=src)
    if rank == 0:
        g.send(x["p2p"], dst_rank=1)
    else:
        out["send-recv"] = g.recv((4,), np.float32, src_rank=0)
    g.barrier()
    return {k: np.asarray(v) for k, v in out.items()}


class _Rank:
    """One rank holding four groups of one world: the JAX package's store
    and xla_dist groups and the port's store and torch_dist (gloo) ones."""

    def join(self, rank, tag):
        import ray_tpu as rt
        from ray_tpu.parallel import collective as jcoll
        from ray_tpu_torch._private.config import config
        from ray_tpu_torch.parallel import collective as tcoll

        config.set("collective_op_timeout_s", OP_TIMEOUT_S)
        self.rank = rank
        self.groups = {
            "xla_dist": jcoll.init_collective_group(
                WORLD, rank, backend="xla_dist", group_name=f"jd{tag}"),
            "jax_store": jcoll.init_collective_group(
                WORLD, rank, backend="store", group_name=f"js{tag}"),
            "torch_dist": tcoll.init_collective_group(
                WORLD, rank, backend="torch_dist", group_name=f"td{tag}",
                device="cpu", runtime=rt),
            "store": tcoll.init_collective_group(
                WORLD, rank, backend="store", group_name=f"ts{tag}",
                runtime=rt),
        }
        return True

    def run(self):
        from ray_tpu.parallel import collective as jcoll
        from ray_tpu_torch.parallel import collective as tcoll

        mods = {"xla_dist": jcoll, "jax_store": jcoll, "torch_dist": tcoll,
                "store": tcoll}
        return {name: _cases(g, self.rank, mods[name],
                             sum_avg_scatter=name == "xla_dist")
                for name, g in self.groups.items()}

    def pending_allreduce(self):
        """Rank 0 enters a torch_dist allreduce its peer never joins."""
        t0 = time.time()
        try:
            self.groups["torch_dist"].allreduce(np.ones(2, np.float32))
            return ("returned", time.time() - t0)
        except Exception as e:
            return (type(e).__name__, time.time() - t0)


@pytest.fixture(scope="module")
def gang(ray_cluster):
    cls = ray_tpu.remote(_Rank)
    ranks = [cls.remote() for _ in range(WORLD)]
    assert ray_tpu.get([r.join.remote(i, "p") for i, r in enumerate(ranks)],
                       timeout=180) == [True] * WORLD
    results = ray_tpu.get([r.run.remote() for r in ranks], timeout=180)
    yield ranks, results
    for r in ranks:
        ray_tpu.kill(r)


CASES = sorted([
    *(f"allreduce-f32-{n}" for n in OPS),
    *(f"allreduce-i32-{n}" for n in OPS if n != "AVG"),
    "allgather-f32", "allgather-i32",
    *(f"reducescatter-{n}" for n in OPS),
    *(f"broadcast-{s}" for s in range(WORLD)), "send-recv"])


def _assert_same(got, want, case):
    assert got.shape == want.shape, (case, got.shape, want.shape)
    if case.endswith("AVG"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("port,ref", [("store", "jax_store"),
                                      ("torch_dist", "xla_dist")])
def test_group_matches_jax(gang, port, ref, case):
    _, results = gang
    for rank, res in enumerate(results):
        if case == "send-recv" and rank == 0:
            continue      # the sender
        if case not in res[ref]:
            # The JAX xla_dist group reduce-scatters with SUM and AVG only.
            assert port == "torch_dist" and case.startswith("reducescatter")
            want = jc.StoreGroup._reduce(
                [_inputs(r)["scatter"] for r in range(WORLD)],
                jc.ReduceOp[case.split("-")[1]])[rank * 2:(rank + 1) * 2]
        else:
            want = res[ref][case]
        _assert_same(res[port][case], want, f"{port} {case}")


def test_gloo_op_whose_peer_never_comes_ends_at_the_op_timeout(gang):
    """Poison a torch_dist world while rank 0 waits in an allreduce that
    rank 1 (alive) never enters: the world's abort cannot end a gloo op,
    so it ends at the world's own timeout, as GangMemberDiedError."""
    ranks, _ = gang
    ref = ranks[0].pending_allreduce.remote()
    time.sleep(0.5)
    assert tc.poison_group("tdp", "rank 1 wedged (test)", runtime=ray_tpu)
    err, elapsed = ray_tpu.get(ref, timeout=OP_TIMEOUT_S + 30)
    assert err == "GangMemberDiedError"
    assert elapsed <= OP_TIMEOUT_S + 3.0, elapsed


def test_poison_unwedges_pending_collective(ray_cluster):
    """A rank pending in a store collective (its peer never shows up)
    raises GangMemberDiedError within about 2x the gang heartbeat of the
    group being poisoned; it does not wait out the op deadline."""
    g = tc.init_collective_group(2, 0, backend="store",
                                 group_name="poison_unit", runtime=ray_tpu)
    res = {}

    def run():
        t0 = time.time()
        try:
            g.barrier()
            res["err"] = None
        except BaseException as e:
            res["err"] = e
            res["elapsed"] = time.time() - t0

    th = threading.Thread(target=run, daemon=True)
    th.start()
    time.sleep(0.5)   # the barrier is now pending (rank 1 never joins)
    t_poison = time.time()
    assert tc.poison_group("poison_unit", "rank 1 SIGKILLed (test)",
                           runtime=ray_tpu)
    th.join(DETECT_BOUND_S + 2)
    assert not th.is_alive(), \
        "poisoned collective still pending past the detection bound"
    assert isinstance(res["err"], GangMemberDiedError)
    assert time.time() - t_poison <= DETECT_BOUND_S + 2
    assert "SIGKILLed" in str(res["err"])
    tc.destroy_collective_group("poison_unit")


def test_world_address_is_the_node_managers_host(ray_cluster):
    """Rank 0 posts its world at its node's host as the runtime lists its
    nodes, so ranks on other hosts can reach it; a runtime that lists no
    nodes (the in-process one, one process) uses the loopback."""
    from types import SimpleNamespace

    from ray_tpu_torch.runtime import LocalRuntime

    node = ray_tpu.get_runtime_context().get_node_id()
    [addr] = [n["NodeManagerAddress"] for n in ray_tpu.nodes()
              if n["NodeID"] == node]
    assert tc._node_address(ray_tpu) == addr.rpartition(":")[0]
    assert tc._node_address(LocalRuntime()) == "127.0.0.1"

    def fake(address):
        ctx = SimpleNamespace(get_node_id=lambda: "n1")
        return SimpleNamespace(
            get_runtime_context=lambda: ctx,
            nodes=lambda: [{"NodeID": "n0", "NodeManagerAddress": "h0:1"},
                           {"NodeID": "n1", "NodeManagerAddress": address}])

    assert tc._node_address(fake("10.1.2.3:4567")) == "10.1.2.3"
    assert tc._node_address(fake("/tmp/nm.sock")) == "127.0.0.1"


# --------------------------------------------------------------- local


@pytest.fixture(scope="module")
def local_groups():
    xla = jc.init_collective_group(4, 0, backend="xla",
                                   group_name="torch_twin_xla",
                                   devices=jax.devices()[:4])
    local = tc.init_collective_group(4, 0, backend="local",
                                     group_name="torch_twin_local",
                                     devices=["cpu"] * 4)
    yield xla, local
    jc.destroy_collective_group("torch_twin_xla")
    tc.destroy_collective_group("torch_twin_local")


def _local_inputs(shape=(2, 3)):
    rng = np.random.default_rng(7)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


LOCAL_CASES = {
    **{f"allreduce-{n}": (lambda g, m, n=n: g.allreduce(
        _local_inputs(), op=m.ReduceOp[n])) for n in OPS},
    "allgather": lambda g, m: g.allgather(_local_inputs()),
    "reducescatter-SUM": lambda g, m: g.reducescatter(_local_inputs((8,))),
    "reducescatter-AVG": lambda g, m: g.reducescatter(
        _local_inputs((8,)), op=m.ReduceOp.AVG),
    "broadcast": lambda g, m: g.broadcast(_local_inputs(), src_rank=3),
    "permute-ring": lambda g, m: g.permute(
        _local_inputs(), [(i, (i + 1) % 4) for i in range(4)]),
    "permute-partial": lambda g, m: g.permute(
        _local_inputs(), [(0, 2), (1, 3)]),
}


@pytest.mark.parametrize("case", sorted(LOCAL_CASES))
def test_local_group_matches_xla_group(local_groups, case):
    xla, local = local_groups
    want = LOCAL_CASES[case](xla, jc)
    got = LOCAL_CASES[case](local, tc)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (case, g.shape, w.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)


def test_local_module_api():
    tc.init_collective_group(4, 0, backend="local", group_name="tmod",
                             devices=["cpu"] * 4)
    try:
        assert tc.is_group_initialized("tmod")
        assert tc.get_rank("tmod") == 0
        assert tc.get_collective_group_size("tmod") == 4
        out = tc.allreduce([np.ones(2) for _ in range(4)], group_name="tmod")
        np.testing.assert_allclose(out[0].numpy(), 4.0)
        tc.barrier("tmod")
        with pytest.raises(RuntimeError, match="already initialized"):
            tc.init_collective_group(4, 0, backend="local",
                                     group_name="tmod", devices=["cpu"] * 4)
    finally:
        tc.destroy_collective_group("tmod")
    assert not tc.is_group_initialized("tmod")
