"""``tests/test_object_store.py`` on the port's shared-memory store
(``ray_tpu_torch/object_store/plasma.py`` over its own ``store.cpp``),
test by test. These read the store's client API and its ``stats``, so
they run on the port's store alone, translated name for name.
"""

import multiprocessing
import threading
import time

import numpy as np
import pytest

from ray_tpu_torch.object_store import plasma
from torch_mirror import assert_mirrored


@pytest.fixture
def store(tmp_path):
    path = str(tmp_path / "arena")
    plasma.create_store(path, capacity=64 * 1024 * 1024, max_objects=1024)
    client = plasma.PlasmaClient(path)
    yield client
    client.close()


def oid(i: int) -> bytes:
    return i.to_bytes(4, "little") + b"\x00" * 24


def test_create_seal_get(store):
    buf = store.create(oid(1), 5)
    buf[:] = b"hello"
    del buf
    store.seal(oid(1))
    view = store.get_buffer(oid(1), timeout_ms=0)
    assert bytes(view) == b"hello"
    del view
    store.release(oid(1))
    assert store.contains(oid(1))


def test_get_missing_nonblocking(store):
    assert store.get_buffer(oid(99), timeout_ms=0) is None


def test_get_timeout(store):
    t0 = time.monotonic()
    assert store.get_buffer(oid(98), timeout_ms=100) is None
    assert time.monotonic() - t0 >= 0.09


def test_seal_wakes_getter(store):
    result = {}

    def getter():
        v = store.get_buffer(oid(5), timeout_ms=5000)
        result["data"] = bytes(v) if v else None
        if v is not None:
            del v
            store.release(oid(5))

    t = threading.Thread(target=getter)
    t.start()
    time.sleep(0.05)
    buf = store.create(oid(5), 3)
    buf[:] = b"abc"
    del buf
    store.seal(oid(5))
    t.join(timeout=5)
    assert result["data"] == b"abc"


def test_value_roundtrip(store):
    arr = np.arange(10000, dtype=np.float32)
    store.put_value(oid(7), {"arr": arr, "n": 3})
    val, ok = store.get_value(oid(7), timeout_ms=0)
    assert ok
    np.testing.assert_array_equal(val["arr"], arr)
    assert val["n"] == 3


def test_delete_and_exists(store):
    store.put_value(oid(8), "x")
    with pytest.raises(plasma.ObjectExistsError):
        store.create(oid(8), 4)
    assert store.delete(oid(8))
    assert not store.contains(oid(8))


def test_lru_eviction(tmp_path):
    path = str(tmp_path / "small")
    plasma.create_store(path, capacity=1024 * 1024, max_objects=64)
    c = plasma.PlasmaClient(path)
    # Fill beyond capacity; old sealed unpinned objects must be evicted.
    for i in range(10):
        buf = c.create(oid(i), 200 * 1024)
        del buf
        c.seal(oid(i))
    stats = c.stats()
    assert stats["evictions"] > 0
    assert c.contains(oid(9))  # newest survives
    assert not c.contains(oid(0))  # oldest evicted
    c.close()


def test_pinned_objects_not_evicted(tmp_path):
    path = str(tmp_path / "pin")
    plasma.create_store(path, capacity=1024 * 1024, max_objects=64)
    c = plasma.PlasmaClient(path)
    buf = c.create(oid(0), 300 * 1024)
    del buf
    c.seal(oid(0))
    view = c.get_buffer(oid(0), timeout_ms=0)  # pin it
    for i in range(1, 8):
        b = c.create(oid(i), 200 * 1024)
        del b
        c.seal(oid(i))
    assert c.contains(oid(0))  # pinned despite pressure
    del view
    c.release(oid(0))
    c.close()


def test_oom_when_all_pinned(tmp_path):
    path = str(tmp_path / "oom")
    plasma.create_store(path, capacity=512 * 1024, max_objects=64)
    c = plasma.PlasmaClient(path)
    buf = c.create(oid(0), 400 * 1024)  # unsealed = pinned by creator
    with pytest.raises(plasma.StoreFullError):
        c.create(oid(1), 400 * 1024)
    del buf
    c.abort(oid(0))
    b2 = c.create(oid(1), 400 * 1024)  # now fits
    del b2
    c.close()


def _child_put(path: str):
    c = plasma.PlasmaClient(path)
    c.put_value(b"B" * 28, np.arange(1000))
    c.close()


def test_cross_process_sharing(tmp_path):
    path = str(tmp_path / "xproc")
    plasma.create_store(path, capacity=8 * 1024 * 1024, max_objects=256)
    c = plasma.PlasmaClient(path)
    ctx = multiprocessing.get_context("fork")
    p = ctx.Process(target=_child_put, args=(path,))
    p.start()
    val, ok = c.get_value(b"B" * 28, timeout_ms=10000)
    p.join()
    assert ok
    np.testing.assert_array_equal(val, np.arange(1000))
    c.close()


def test_stats(store):
    s0 = store.stats()
    store.put_value(oid(40), b"x" * 1000)
    s1 = store.stats()
    assert s1["num_objects"] == s0["num_objects"] + 1
    assert s1["used_bytes"] > s0["used_bytes"]


def test_mirrors_every_reference_test():
    assert_mirrored("object_store")
