"""``torch.Tensor`` as a store object (ray_tpu_torch/_private/device_objects.py)
through the JAX package's ``plasma`` store: the store-level contracts of
tests/test_device_objects.py on CPU tensors, with the port's hook
installed on the ``ray_tpu`` runtime's serializer and uninstalled after
each test (its one hook slot is process-wide, and a file's tests share a
process).

The port's design differs from the reference's in one place, on purpose:
a rebuild copies once off the arena view (torch has no read-only tensors),
so the store pin is released when ``get`` returns, not when the tensor is
collected."""

import gc
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu._private import serialization
from ray_tpu.object_store import plasma
from ray_tpu_torch._private import device_objects as tdo
from ray_tpu_torch._private.config import config as tconfig


def _oid(i: int) -> bytes:
    return b"TD" + i.to_bytes(4, "little") + b"\x00" * 22


@pytest.fixture
def hook():
    """The port's hook on the ``ray_tpu`` serializer, chained to the JAX
    hook it replaces; the JAX hook is back after the test."""
    uninstall = tdo.install_on(ray_tpu)
    assert uninstall is not None
    try:
        yield
    finally:
        uninstall()
    assert not getattr(serialization._reducer_hook, "torch_device_objects",
                       False)


@pytest.fixture
def store(tmp_path, hook):
    path = str(tmp_path / "arena")
    plasma.create_store(path, capacity=64 * 1024 * 1024, max_objects=1024)
    client = plasma.PlasmaClient(path)
    yield client
    client.close()


def _tensor(n_bytes: int, dtype=torch.float32) -> torch.Tensor:
    n = n_bytes // torch.empty((), dtype=dtype).element_size()
    return torch.arange(n).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_roundtrip_preserves_dtype_shape_values(store, dtype):
    t = torch.arange(4096).to(getattr(torch, dtype)).reshape(64, 64)
    store.put_value(_oid(1), t)
    back, ok = store.get_value(_oid(1), timeout_ms=0)
    assert ok
    assert type(back) is torch.Tensor
    assert back.dtype == t.dtype and back.shape == t.shape
    assert torch.equal(back, t)


def test_roundtrip_nested_in_dict(store):
    t = _tensor(2 << 20)
    store.put_value(_oid(2), {"weights": t, "step": 7, "tag": "ckpt"})
    back, ok = store.get_value(_oid(2), timeout_ms=0)
    assert ok and back["step"] == 7 and back["tag"] == "ckpt"
    assert torch.equal(back["weights"], t)


def test_frame_is_oob_not_inband(hook):
    """The bytes ride the out-of-band channel, not the pickle stream
    (torch's own pickling puts them in band). The arena-wide staging
    counter is not charged for a tensor (a limit of the runtime seam):
    the port counts the bytes in its own stats instead."""
    t = _tensor(4 << 20)
    tdo.reset_stats()
    sobj = serialization.serialize(t)
    assert len(sobj.metadata) < 64 * 1024
    assert sum(b.nbytes for b in sobj.buffers) >= t.nbytes
    assert sobj.device_bytes == 0
    assert tdo.stats()["staged_bytes"] == t.nbytes


def test_put_no_host_materialization(store):
    """A contiguous CPU tensor: its numpy view aliases it, so the only copy
    is the arena write."""
    t = _tensor(8 << 20)
    tdo.reset_stats()
    store.put_value(_oid(3), t)
    s = tdo.stats()
    assert s["puts"] == 1
    assert s["host_materializations"] == 0
    assert s["staged_bytes"] == t.nbytes


def test_noncontiguous_put_counts_its_copy(store):
    t = _tensor(8 << 20).reshape(1024, -1)[:, ::2]
    tdo.reset_stats()
    store.put_value(_oid(9), t)
    assert tdo.stats()["host_materializations"] == 1
    back, _ = store.get_value(_oid(9), timeout_ms=0)
    assert torch.equal(back, t)


def test_get_exactly_one_rebuild_and_pin_lifecycle(store):
    """One rebuild per get; the rebuild is a copy, so the slot is unpinned
    as soon as get returns, while the tensor lives on."""
    t = _tensor(8 << 20)  # > zero_copy_min: an arena-backed view
    store.put_value(_oid(4), t)
    tdo.reset_stats()
    back, ok = store.get_value(_oid(4), timeout_ms=0)
    assert ok
    assert tdo.stats()["rebuilds"] == 1
    gc.collect()
    st = store.stats_ex()
    assert st["pinned_objects"] == 0 and st["pinned_bytes"] == 0
    assert torch.equal(back, t)


def test_rebuilt_tensor_survives_eviction_pressure(store):
    """The rebuilt tensor owns its bytes: churn evicts the stored object
    (nothing pins it) and the tensor is unchanged."""
    t = _tensor(8 << 20)
    store.put_value(_oid(5), t)
    back, ok = store.get_value(_oid(5), timeout_ms=0)
    assert ok
    for i in range(80):
        store.put_value(_oid(100 + i), np.ones(1 << 20, np.uint8))
    assert store.stats()["evictions"] > 0
    assert not store.contains(_oid(5))
    assert torch.equal(back, t)


def test_write_into_rebuilt_tensor_leaves_store_unchanged(store):
    t = _tensor(4 << 20)
    store.put_value(_oid(6), t)
    first, _ = store.get_value(_oid(6), timeout_ms=0)
    first.fill_(-1.0)
    second, _ = store.get_value(_oid(6), timeout_ms=0)
    assert torch.equal(second, t)


def test_enabled_toggle(store):
    """Off: the hook stands down and tensors take torch's own pickling,
    in band; they still round-trip."""
    tconfig.set("device_objects_enabled", False)
    try:
        t = _tensor(2 << 20)
        tdo.reset_stats()
        sobj = serialization.serialize(t)
        assert len(sobj.metadata) >= t.nbytes
        store.put_value(_oid(7), t)
        assert tdo.stats()["puts"] == 0
        back, ok = store.get_value(_oid(7), timeout_ms=0)
        assert ok and torch.equal(back, t)
    finally:
        tconfig.set("device_objects_enabled", True)


def test_hook_chains_to_the_jax_hook(store):
    """One frame holds a jax.Array and a torch.Tensor: both ride out of
    band, and each comes back as its own type."""
    import jax

    arr = jnp.arange(1 << 18, dtype=jnp.float32)
    t = _tensor(1 << 20)
    sobj = serialization.serialize({"jax": arr, "torch": t})
    assert len(sobj.metadata) < 64 * 1024
    assert sum(b.nbytes for b in sobj.buffers) >= arr.nbytes + t.nbytes
    store.put_value(_oid(8), {"jax": arr, "torch": t})
    back, ok = store.get_value(_oid(8), timeout_ms=0)
    assert ok
    assert isinstance(back["jax"], jax.Array)
    assert type(back["torch"]) is torch.Tensor
    np.testing.assert_array_equal(np.asarray(back["jax"]), np.asarray(arr))
    assert torch.equal(back["torch"], t)


def test_install_and_uninstall_restore_the_slot():
    """``install`` chains to the hook it is given and the uninstall puts
    that hook back."""
    slot = {"hook": None}

    def register(fn):
        slot["hook"] = fn

    def previous(obj):
        return ("previous", obj) if obj == "mine" else None

    uninstall = tdo.install(register, previous)
    hook = slot["hook"]
    assert hook("mine") == ("previous", "mine")
    assert hook(3) is None
    assert hook(torch.ones(2))[0] is tdo.rebuild_tensor
    uninstall()
    assert slot["hook"] is previous


def test_same_process_lookup_by_reference():
    """``note_put``/``lookup_local``: the tensor itself, counted as a local
    hit, for as long as its ref lives; nothing when the feature is off."""

    class Ref:
        pass

    t, ref = torch.ones(4), Ref()
    tdo.reset_stats()
    tdo.note_put(ref, t)
    assert tdo.lookup_local(ref) is t
    assert tdo.lookup_local(Ref()) is None
    assert tdo.stats()["local_hits"] == 1
    tconfig.set("device_objects_enabled", False)
    try:
        assert tdo.lookup_local(ref) is None
    finally:
        tconfig.set("device_objects_enabled", True)
    del ref
    gc.collect()
    assert len(tdo._local) == 0


@pytest.fixture
def ray_1cpu():
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        ctx = ray_tpu.init(num_cpus=1,
                           object_store_memory=256 * 1024 * 1024)
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old
    yield ctx
    ray_tpu.shutdown()


@ray_tpu.remote
def _make_tensor(n):
    """A task that installs the port's hook in its worker and returns a
    tensor, as a prefill replica publishes its KV block."""
    import ray_tpu as runtime
    from ray_tpu_torch._private import device_objects

    device_objects.install_on(runtime)
    return torch.arange(n, dtype=torch.float32)


def test_cross_process_task_returns_tensor_rebuilt_once(ray_1cpu):
    n = 1 << 21
    tdo.reset_stats()
    back = ray_tpu.get(_make_tensor.remote(n))
    assert type(back) is torch.Tensor
    assert torch.equal(back, torch.arange(n, dtype=torch.float32))
    assert tdo.stats()["rebuilds"] == 1
    assert tdo.stats()["puts"] == 0       # staged in the worker, not here
