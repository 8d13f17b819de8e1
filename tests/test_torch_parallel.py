"""The port's parallel layer (ray_tpu_torch.parallel): meshes, sharding
rules, the SPMD collectives and the pipeline, the twins of
tests/test_parallel.py's mesh and sharding tests.

The port's meshes are ``DeviceMesh``es over ranks, so its side runs in a
gloo world of 8 spawned CPU ranks (``torch_spmd.World``); where the JAX
test reads a device mesh, the port's reads the same names and shape.
"""

import numpy as np
import pytest
import torch

import torch_spmd
from ray_tpu_torch import graft_entry
from ray_tpu_torch.parallel import MeshConfig, make_mesh, topology_info
from ray_tpu_torch.parallel.collective import join_world


@pytest.fixture(scope="module")
def world():
    w = torch_spmd.World(8)
    yield w
    w.close()


# ------------------------------------------------------------------- mesh


def test_mesh_config_resolve():
    cfg = MeshConfig(dp=-1, tp=2).resolve(8)
    assert cfg.dp == 4 and cfg.tp == 2
    with pytest.raises(ValueError):
        MeshConfig(dp=3, tp=2).resolve(8)
    with pytest.raises(ValueError):
        MeshConfig(dp=-1, tp=-1).resolve(8)
    with pytest.raises(ValueError):
        MeshConfig(dp=-1, tp=3).resolve(8)


def test_make_mesh_drops_trivial_axes(world):
    assert world.run(torch_spmd.mesh_facts, {"dp": 4, "tp": 2}, False)[0] \
        == (("dp", "tp"), (4, 2))
    assert world.run(torch_spmd.mesh_facts, {"dp": 8, "tp": 1}, False)[0] \
        == (("dp",), (8,))


def test_make_mesh_keep_trivial(world):
    assert world.run(torch_spmd.mesh_facts, {"dp": 8}, True)[0] == (
        ("dp", "fsdp", "pp", "ep", "sp", "tp"), (8, 1, 1, 1, 1, 1))


def test_make_mesh_size_errors(world):
    with pytest.raises(RuntimeError, match="needs 4 devices, have 8"):
        world.run(torch_spmd.mesh_facts, {"dp": 2, "tp": 2}, False)


def test_topology_info(world):
    for r, (info, local, host) in enumerate(world.run(torch_spmd.topology)):
        assert info["platform"] == "cpu"
        assert info["num_devices"] == 8
        assert info["num_hosts"] == 1
        assert local == 8 and host == list(range(8))


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    """Without a GPU the port's entry points raise unless the caller says
    ``device="cpu"``; NCCL is never picked for the CPU, and ranks that
    share a GPU name gloo themselves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_mesh(axes={"dp": 1}),
                 lambda: topology_info(),
                 lambda: graft_entry.dryrun_multichip(4),
                 graft_entry.entry):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        join_world("127.0.0.1:1", 1, 0, device="cpu", backend="nccl")
    with pytest.raises(ValueError):
        join_world("127.0.0.1:1", 1, 0, device="cpu", backend="mpi")


# --------------------------------------------------------------- sharding


def test_axis_rules_spec_and_sharding(world):
    spec, placements, spec2, placements2, raw = \
        world.run(torch_spmd.rules_facts)[0]
    assert spec == (("dp", "fsdp"), None, "tp")
    assert placements == ["S(0)", "S(0)", "S(2)"]
    # Rules naming absent mesh axes degrade to replication on that dim.
    assert spec2 == ("dp", None) and placements2 == ["S(0)"]
    assert raw == (("dp", "fsdp"), "fsdp", None)


def test_shard_pytree(world):
    w = np.arange(32, dtype=np.float32).reshape(8, 4)
    b = np.zeros((4,), np.float32)
    for out in world.run(torch_spmd.shard_tree, w, b):
        placements, local, whole, (i, j) = out["w"]
        assert placements == ["S(0)", "S(1)"]
        np.testing.assert_array_equal(local, w[2 * i:2 * i + 2,
                                                2 * j:2 * j + 2])
        np.testing.assert_array_equal(whole, w)
        assert out["b"][0] == ["R", "R"]
        np.testing.assert_array_equal(out["b"][2], b)


@pytest.mark.parametrize("axes,want", [
    ({"fsdp": 2, "tp": 2}, {
        "tok_embed": ["R", "R"], "pos_embed": ["S(1)", "R"],
        "wqkv": ["S(1)", "S(3)"], "wo": ["S(3)", "S(1)"],
        "w_up": ["S(2)", "S(3)"], "b_up": ["R", "S(2)"],
        "wg": ["S(1)", "R"], "lnf_scale": ["S(0)", "R"]}),
    ({"pp": 2, "ep": 2}, {
        "tok_embed": ["R", "R"], "wqkv": ["R", "R"],
        "w_up": ["R", "S(1)"], "w_down": ["R", "S(1)"],
        "b_down": ["R", "S(1)"], "wg": ["R", "R"]}),
])
def test_shard_params_follow_param_logical_axes(world, axes, want):
    got = world.run(torch_spmd.param_placements, axes)[0]
    flat = dict(got, **got.pop("blocks"))
    for name, placements in want.items():
        assert flat[name] == placements, name


@pytest.mark.parametrize("src,dst", [
    (("S0", "S1"), ("R", "R")), (("R", "R"), ("S1", "S0")),
    (("P", "R"), ("S0", "R")), (("P", "P"), ("R", "S1")),
    (("S0", "S0"), ("R", "S0")), (("S0", "R"), ("R", "S0")),
    (("R", "S0"), ("S0", "S0")), (("S1", "P"), ("S0", "R")),
])
def test_redistribute_local_keeps_the_whole(world, src, dst):
    full = np.arange(48, dtype=np.float32).reshape(8, 6)
    for out in world.run(torch_spmd.redistribute_case, src, dst, full)[:4]:
        np.testing.assert_allclose(out, full, rtol=0, atol=1e-6)


def test_with_logical_constraint(world):
    full = np.arange(32, dtype=np.float32).reshape(4, 8)
    outs = world.run(torch_spmd.constrain_case, full)[:4]
    for r, (placements, local, grad) in enumerate(outs):
        assert placements == ["R", "S(1)"]
        j = r % 2
        np.testing.assert_array_equal(local, full[:, 4 * j:4 * j + 4])
        # A DTensor's gradient laid out Replicate is the value on every
        # replica (DTensor's semantics): d sum(2 y) / dx = 2, laid back out
        # as x.
        np.testing.assert_array_equal(grad, np.full_like(full, 2.0))


# ------------------------------------------------------------- collectives


@pytest.mark.parametrize("perm", [
    [(i, (i + 1) % 8) for i in range(8)],
    [(0, 3), (3, 5), (5, 0)],
])
def test_ppermute_and_its_gradient(world, perm):
    x = np.random.default_rng(0).normal(size=(8, 5)).astype(np.float32)
    outs = world.run(torch_spmd.ppermute_case, perm, x)
    dst = dict(perm)
    src = {d: s for s, d in perm}
    for r, (out, grad) in enumerate(outs):
        want = x[src[r]] if r in src else np.zeros(5, np.float32)
        np.testing.assert_array_equal(out, want)
        # The gradient runs the inverse permutation: rank r's x reached
        # rank dst[r], whose loss weighs it by dst[r] + 1.
        np.testing.assert_array_equal(
            grad, np.full(5, dst[r] + 1.0 if r in dst else 0.0, np.float32))


@pytest.mark.parametrize("microbatches", [2, 4])
def test_pipeline_apply(world, microbatches):
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(4, 6, 6)) * 0.5).astype(np.float32)
    x = rng.normal(size=(8, 6)).astype(np.float32)
    tw = torch.from_numpy(w).requires_grad_()
    h = torch.from_numpy(x)
    for i in range(4):
        h = torch.tanh(h @ tw[i])
    h.sum().backward()
    for out, grad in world.run(torch_spmd.pipeline_case, w, x,
                               microbatches)[:2]:
        np.testing.assert_allclose(out.reshape(8, 6), h.detach().numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(grad, tw.grad.numpy(), atol=1e-5)
