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


# --------------------------------------------- on the port's own runtime


def test_frame_is_charged_by_the_ports_serializer():
    """The port's own serializer installs the hook itself and drains the
    staging ledger into the object: the arena-wide counter is charged."""
    from ray_tpu_torch._private import serialization as tser

    t = _tensor(4 << 20)
    tdo.reset_stats()
    sobj = tser.serialize(t)
    assert getattr(tser._reducer_hook, "torch_device_objects", False)
    assert len(sobj.metadata) < 64 * 1024
    assert sobj.device_bytes == t.nbytes
    assert tdo.stats()["staged_bytes"] == t.nbytes
    assert torch.equal(tser.deserialize_framed(
        memoryview(sobj.to_bytes())), t)


def test_cross_process_round_trip_charges_the_arena_on_the_ports_runtime():
    """``runtime=ray_tpu_torch``: a task's tensor crosses to the driver,
    rebuilt once, and its worker's staging charges the node arena's
    ``device_staged_bytes`` with the tensor's bytes. A second get in the
    process that put a tensor is a local hit, with no rebuild."""
    import torch_core_programs as progs
    from torch_runtimes import ports_runtime

    from ray_tpu_torch._private import worker as tworker

    n = 1 << 21
    with ports_runtime(num_cpus=1, object_store_memory=256 * 1024 * 1024
                       ) as rt:
        arena = tworker.global_worker().store
        before = arena.stats_ex()["device_staged_bytes"]
        tdo.reset_stats()
        back = rt.get(rt.remote(progs.make_tensor).remote(n))
        assert type(back) is torch.Tensor
        assert torch.equal(back, torch.arange(n, dtype=torch.float32))
        assert tdo.stats()["rebuilds"] == 1
        assert tdo.stats()["puts"] == 0
        assert arena.stats_ex()["device_staged_bytes"] - before == 4 * n
        t = _tensor(1 << 20)
        ref = rt.put(t)
        assert rt.get(ref) is t
        assert tdo.stats()["local_hits"] == 1
        assert tdo.stats()["rebuilds"] == 1


# ------------------------------------------------------------ donation
# Twins of tests/test_device_objects.py's donation tests: a returned
# tensor's storage is released (``untyped_storage().resize_(0)``) once
# every return slot is staged; a tensor that does not span its whole
# storage is left alone.


class _Core:
    def __init__(self):
        self._device_local = {}


def test_donation_releases_producer_storage_unit():
    core = _Core()
    t = _tensor(1 << 20)
    tdo.reset_stats()
    tdo.note_return(core, b"d" * 28, t, donate=True)
    assert t.untyped_storage().nbytes() == 0
    assert tdo.stats()["donations"] == 1
    assert core._device_local == {}  # donated tensors are not registered

    t2 = _tensor(1 << 20)
    tdo.note_return(core, b"e" * 28, t2, donate=False)
    assert t2.untyped_storage().nbytes() == 1 << 20
    assert core._device_local[b"e" * 28] is t2
    assert tdo.stats()["donations"] == 1


def test_donation_leaves_a_view_of_a_larger_storage_alone():
    """Releasing a storage empties every view of it, where JAX deletes one
    array: a slice, or a tensor past offset 0, is registered as without
    donation and its storage kept; a tensor over the whole storage (a
    reshape, a transpose) is donated."""
    core = _Core()
    base = _tensor(1 << 20)
    tdo.reset_stats()
    for i, view in enumerate((base[: base.numel() // 2],
                              base[base.numel() // 2:])):
        assert not tdo.donatable(view)
        tdo.note_return(core, bytes([i]) * 28, view, donate=True)
        assert core._device_local[bytes([i]) * 28] is view
    assert base.untyped_storage().nbytes() == 1 << 20
    assert torch.equal(base, _tensor(1 << 20))
    assert tdo.stats()["donations"] == 0

    whole = _tensor(1 << 20).reshape(512, 512).t()
    assert tdo.donatable(whole)
    tdo.note_return(core, b"w" * 28, whole, donate=True)
    assert whole.untyped_storage().nbytes() == 0
    assert tdo.stats()["donations"] == 1


def test_donate_result_flag_plumbs_to_task_spec():
    import pickle

    from ray_tpu_torch.remote_function import RemoteFunction
    from ray_tpu_torch._private.ids import JobID, TaskID
    from ray_tpu_torch._private.task_spec import TaskSpec

    rf = RemoteFunction(lambda: None, {"_donate_result": True})
    assert rf._options["_donate_result"] is True
    assert TaskSpec.__dataclass_fields__["donate_result"].default is False
    assert "donate_result" in TaskSpec._STATE_FIELDS
    job = JobID.from_int(1)
    spec = TaskSpec(task_id=TaskID.for_task(job), job_id=job,
                    function_key="f", args=b"", arg_deps=[], num_returns=1,
                    resources={"CPU": 1.0}, donate_result=True)
    assert pickle.loads(pickle.dumps(spec)).donate_result is True


def test_donation_multi_return_same_tensor():
    """num_returns=2 returning (x, x): donation waits until BOTH slots are
    staged — releasing at slot 0 would make slot 1 serialize an empty
    storage and fail the task after user code ran."""
    from torch_runtimes import ports_runtime

    with ports_runtime(num_cpus=1, object_store_memory=128 * 1024 * 1024
                       ) as rt:
        @rt.remote(num_returns=2, _donate_result=True)
        def twice():
            import torch

            x = torch.full((64,), 5.0)
            return x, x

        a, b = rt.get(list(twice.remote()), timeout=60)
        assert torch.equal(a, torch.full((64,), 5.0))
        assert torch.equal(b, a)


def test_donation_end_to_end():
    """A producer task stages its return and donation releases its storage;
    a follow-up task in the same worker process sees the storage at 0
    bytes. A returned view of a larger tensor keeps its storage."""
    from torch_runtimes import ports_runtime

    with ports_runtime(num_cpus=1, object_store_memory=128 * 1024 * 1024
                       ) as rt:
        @rt.remote(_donate_result=True)
        def produce(view):
            import builtins

            import torch

            a = torch.ones((256, 256), dtype=torch.float32)
            builtins._rtpu_torch_donated_probe = a
            return a[:128] if view else a

        @rt.remote
        def check():
            import builtins

            from ray_tpu_torch._private import device_objects

            # Absent in any other worker than the producer's.
            a = builtins._rtpu_torch_donated_probe
            return (a.untyped_storage().nbytes(),
                    device_objects.stats()["donations"])

        t = rt.get(produce.remote(False), timeout=60)
        assert torch.equal(t, torch.ones((256, 256)))
        nbytes, donations = rt.get(check.remote(), timeout=60)
        assert nbytes == 0
        assert donations >= 1

        t = rt.get(produce.remote(True), timeout=60)
        assert torch.equal(t, torch.ones((128, 256)))
        nbytes, donations2 = rt.get(check.remote(), timeout=60)
        assert nbytes == 256 * 256 * 4   # a view: its storage kept
        assert donations2 == donations
