"""Python client for the native shared-memory object store.

Role-equivalent to the reference's plasma client
(reference: src/ray/object_manager/plasma/client.h) but server-less: the C++
library (``store.cpp``) keeps all store state inside one mmap'd tmpfs arena,
so create/seal/get are direct library calls — no socket round-trip and
zero-copy reads for every process on the node.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import subprocess
import threading
import weakref
from typing import Optional


def _release_pin(client: "PlasmaClient", object_id: bytes) -> None:
    """weakref.finalize target for zero-copy values: unpin the object once
    the last arena view is collected. Tolerates an already-closed client
    (finalizers can outlive the store at interpreter shutdown)."""
    try:
        if not client._closed:
            client._lib.rtpu_release(client._handle, object_id)
    except Exception:
        pass

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.config import config as _config
from ray_tpu_torch.exceptions import OutOfMemoryError

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_PATH = os.path.join(_DIR, "store.cpp")
# The port builds its own copy of the store into its build directory
# (the JAX package's library sits beside its own store.cpp).
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")

RTPU_OK = 0
RTPU_EXISTS = -1
RTPU_OOM = -2
RTPU_TIMEOUT = -3
RTPU_NOT_FOUND = -4
RTPU_BAD_STATE = -5
RTPU_FULL_TABLE = -6
RTPU_IO = -7

ID_SIZE = 28

_build_lock = threading.Lock()
_lib = None


def _ensure_built() -> str:
    """Compile the store library on first use (no install step needed).

    RAY_TPU_TORCH_STORE_SO overrides the library path entirely (no
    build). The library is named by a hash of its source, and processes
    that build at once take turns on the build directory's lock file.
    """
    from ray_tpu_torch._private.config import config

    from pathlib import Path

    from ray_tpu_torch._private.build_dir import exclusive_build_dir

    override = config.refresh_from_env("store_so")
    if override:
        return override
    with open(_SRC_PATH, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"librtpu_store-{digest}.so")
    with _build_lock:
        if os.path.exists(so_path):
            return so_path
        with exclusive_build_dir(Path(_BUILD_DIR)):
            if not os.path.exists(so_path):
                tmp = so_path + f".tmp.{os.getpid()}"
                cmd = ["g++", "-O2", "-shared", "-fPIC", "-pthread",
                       "-o", tmp, _SRC_PATH]
                subprocess.run(cmd, check=True, capture_output=True)
                os.replace(tmp, so_path)
        return so_path


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_ensure_built())
    u64, i64, i32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32
    p = ctypes.c_void_p
    cp = ctypes.c_char_p
    bp = ctypes.POINTER(ctypes.c_uint8)

    lib.rtpu_store_init.argtypes = [cp, u64, u64]
    lib.rtpu_store_init.restype = ctypes.c_int
    lib.rtpu_store_attach.argtypes = [cp]
    lib.rtpu_store_attach.restype = p
    lib.rtpu_store_detach.argtypes = [p]
    lib.rtpu_store_detach.restype = None
    lib.rtpu_store_base.argtypes = [p]
    lib.rtpu_store_base.restype = p
    lib.rtpu_store_capacity.argtypes = [p]
    lib.rtpu_store_capacity.restype = u64
    lib.rtpu_create.argtypes = [p, cp, u64, ctypes.POINTER(u64)]
    lib.rtpu_create.restype = ctypes.c_int
    lib.rtpu_seal.argtypes = [p, cp]
    lib.rtpu_seal.restype = ctypes.c_int
    lib.rtpu_abort.argtypes = [p, cp]
    lib.rtpu_abort.restype = ctypes.c_int
    lib.rtpu_get.argtypes = [p, cp, i64, ctypes.POINTER(u64), ctypes.POINTER(u64)]
    lib.rtpu_get.restype = ctypes.c_int
    lib.rtpu_release.argtypes = [p, cp]
    lib.rtpu_release.restype = ctypes.c_int
    lib.rtpu_delete.argtypes = [p, cp]
    lib.rtpu_delete.restype = ctypes.c_int
    lib.rtpu_contains.argtypes = [p, cp]
    lib.rtpu_contains.restype = ctypes.c_int
    lib.rtpu_info.argtypes = [p, cp, ctypes.POINTER(u64), ctypes.POINTER(i32),
                              ctypes.POINTER(i32)]
    lib.rtpu_info.restype = ctypes.c_int
    lib.rtpu_stats.argtypes = [p] + [ctypes.POINTER(u64)] * 4
    lib.rtpu_stats.restype = None
    lib.rtpu_stats_ex.argtypes = [p] + [ctypes.POINTER(u64)] * 3
    lib.rtpu_stats_ex.restype = None
    lib.rtpu_add_staged.argtypes = [p, u64]
    lib.rtpu_add_staged.restype = None
    lib.rtpu_list.argtypes = [p, bp, u64]
    lib.rtpu_list.restype = u64
    lib.rtpu_set_allow_evict.argtypes = [p, ctypes.c_int]
    lib.rtpu_set_allow_evict.restype = None
    _lib = lib
    return lib


def create_store(path: str, capacity: int, max_objects: int = 1 << 16) -> None:
    lib = _load_lib()
    rc = lib.rtpu_store_init(path.encode(), capacity, max_objects)
    if rc != RTPU_OK:
        raise OSError(f"failed to initialize object store at {path}: rc={rc}")


class StoreFullError(OutOfMemoryError):
    pass


class ObjectExistsError(Exception):
    pass


class PlasmaClient:
    """Per-process connection to the node's shared-memory store."""

    def __init__(self, path: str):
        self._lib = _load_lib()
        self._path = path
        self._handle = self._lib.rtpu_store_attach(path.encode())
        if not self._handle:
            detail = "file missing" if not os.path.exists(path) else \
                f"file present, {os.path.getsize(path)} bytes"
            raise OSError(
                f"failed to attach to object store at {path} ({detail})")
        # Map the arena file for zero-copy buffer access from Python.
        self._fd = os.open(path, os.O_RDWR)
        self._map = mmap.mmap(self._fd, 0)
        self._view = memoryview(self._map)
        self._closed = False
        # Backpressure hook: called as on_full(needed_bytes) when a create
        # hits RTPU_OOM with eviction disabled; returning True means "space
        # may have been freed, retry" (the CoreWorker wires this to the
        # node manager's spill_now — reference: CreateRequestQueue spill
        # retry in plasma/create_request_queue.h).
        self.on_full = None

    # -- raw byte-level API ---------------------------------------------------

    def _check_open(self) -> None:
        if self._closed:
            raise OSError("object store client is closed")

    def set_allow_evict(self, allow: bool) -> None:
        self._check_open()
        self._lib.rtpu_set_allow_evict(self._handle, 1 if allow else 0)

    def create(self, object_id: bytes, size: int) -> memoryview:
        self._check_open()
        attempts_left = 3
        while True:
            off = ctypes.c_uint64()
            rc = self._lib.rtpu_create(self._handle, object_id, size,
                                       ctypes.byref(off))
            if rc == RTPU_EXISTS:
                raise ObjectExistsError(object_id.hex())
            if rc in (RTPU_OOM, RTPU_FULL_TABLE):
                if rc == RTPU_OOM and self.on_full is not None \
                        and attempts_left > 0 and self.on_full(size):
                    attempts_left -= 1
                    continue
                raise StoreFullError(
                    f"object store full creating {size} bytes (rc={rc})"
                )
            if rc != RTPU_OK:
                raise OSError(f"create failed rc={rc}")
            return self._view[off.value : off.value + size]

    def seal(self, object_id: bytes) -> None:
        self._check_open()
        rc = self._lib.rtpu_seal(self._handle, object_id)
        if rc != RTPU_OK:
            raise OSError(f"seal failed rc={rc}")

    def abort(self, object_id: bytes) -> None:
        self._lib.rtpu_abort(self._handle, object_id)

    def get_buffer(self, object_id: bytes, timeout_ms: int = -1) -> Optional[memoryview]:
        """Pinned zero-copy view of a sealed object; None on timeout/missing.

        Callers must ``release`` when done with the view.
        """
        self._check_open()
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rtpu_get(self._handle, object_id, timeout_ms,
                                ctypes.byref(off), ctypes.byref(size))
        if rc in (RTPU_TIMEOUT, RTPU_NOT_FOUND):
            return None
        if rc != RTPU_OK:
            raise OSError(f"get failed rc={rc}")
        return self._view[off.value : off.value + size.value]

    def release(self, object_id: bytes) -> None:
        self._lib.rtpu_release(self._handle, object_id)

    def delete(self, object_id: bytes) -> bool:
        self._check_open()
        return self._lib.rtpu_delete(self._handle, object_id) == RTPU_OK

    def contains(self, object_id: bytes) -> bool:
        self._check_open()
        return bool(self._lib.rtpu_contains(self._handle, object_id))

    def stats(self) -> dict:
        self._check_open()
        used = ctypes.c_uint64()
        cap = ctypes.c_uint64()
        n = ctypes.c_uint64()
        ev = ctypes.c_uint64()
        self._lib.rtpu_stats(self._handle, ctypes.byref(used), ctypes.byref(cap),
                             ctypes.byref(n), ctypes.byref(ev))
        return {
            "used_bytes": used.value,
            "capacity_bytes": cap.value,
            "num_objects": n.value,
            "evictions": ev.value,
        }

    def stats_ex(self) -> dict:
        """``stats()`` plus pin/staging accounting. The pin numbers cost
        an O(max_objects) entry scan under the arena lock — fine for the
        1/s heartbeat and tests, NOT for hot loops (the memory monitor
        and spill loop poll plain ``stats()``, which stays O(1)).

        Pinned = objects held by zero-copy readers or in-progress
        writers; they cannot be evicted, so climbing pinned_bytes under
        store pressure is the first thing to look at (surfaced on the
        dashboard /metrics). device_staged_bytes is the cumulative
        device-array bytes DMA-staged into this arena, node-wide."""
        out = self.stats()
        pinned_n = ctypes.c_uint64()
        pinned_b = ctypes.c_uint64()
        staged = ctypes.c_uint64()
        self._lib.rtpu_stats_ex(self._handle, ctypes.byref(pinned_n),
                                ctypes.byref(pinned_b), ctypes.byref(staged))
        out["pinned_objects"] = pinned_n.value
        out["pinned_bytes"] = pinned_b.value
        out["device_staged_bytes"] = staged.value
        return out

    def list_objects(self, max_n: int = 4096) -> list:
        self._check_open()
        buf = (ctypes.c_uint8 * (max_n * ID_SIZE))()
        n = self._lib.rtpu_list(self._handle, buf, max_n)
        raw = bytes(buf)
        return [raw[i * ID_SIZE : (i + 1) * ID_SIZE] for i in range(n)]

    # -- value-level API ------------------------------------------------------

    def put_value(self, object_id: bytes, value) -> int:
        """Serialize and store a Python value; returns stored size."""
        sobj = serialization.serialize(value)
        size = sobj.total_size()
        buf = self.create(object_id, size)
        try:
            sobj.write_into(buf)
        except BaseException:
            del buf
            self.abort(object_id)
            raise
        del buf  # drop the memoryview before any later delete/eviction
        self.seal(object_id)
        self._charge_staged(sobj)
        return size

    def put_serialized(self, object_id: bytes, sobj) -> int:
        size = sobj.total_size()
        buf = self.create(object_id, size)
        try:
            sobj.write_into(buf)
        finally:
            del buf
        self.seal(object_id)
        self._charge_staged(sobj)
        return size

    def _charge_staged(self, sobj) -> None:
        """Charge device-array bytes staged into this object to the
        arena-wide counter (read back by every client's stats(), ridden
        by the node manager's heartbeat for staging-bytes accounting)."""
        n = getattr(sobj, "device_bytes", 0)
        if n:
            self._lib.rtpu_add_staged(self._handle, n)

    @property
    def zero_copy_min(self) -> int:
        """Objects at or above this deserialize zero-copy out of the
        arena, pinned until the returned value is garbage collected
        (reference: plasma zero-copy numpy reads — arrays are READ-ONLY
        views). Below it, copying costs less than pin bookkeeping.
        Env-overridable: RAY_TPU_TORCH_ZERO_COPY_MIN (config registry)."""
        return int(_config.zero_copy_min)

    def get_value(self, object_id: bytes, timeout_ms: int = -1):
        """Deserialize a stored value.

        Small objects are copied out of the arena before unpickling so
        the slot can be evicted safely after release. Large objects
        deserialize zero-copy: their buffers (e.g. numpy arrays) view
        the shm arena directly, read-only, and the object stays pinned
        in the store until the last such view is garbage collected —
        O(1) heap for any object size (the property the chunked-transfer
        memory test asserts end to end).
        """
        self._check_open()
        off = ctypes.c_uint64()
        size_c = ctypes.c_uint64()
        rc = self._lib.rtpu_get(self._handle, object_id, timeout_ms,
                                ctypes.byref(off), ctypes.byref(size_c))
        if rc in (RTPU_TIMEOUT, RTPU_NOT_FOUND):
            return None, False
        if rc != RTPU_OK:
            raise OSError(f"get failed rc={rc}")
        size = size_c.value
        if size < self.zero_copy_min:
            view = self._view[off.value:off.value + size]
            try:
                data = bytes(view)  # copy out; eviction decoupled from GC
            finally:
                del view
                self.release(object_id)
            return serialization.loads_oob(data), True
        # Zero-copy path: a ctypes exporter over the arena slab. Views
        # sliced from it (pickle5 out-of-band buffers) keep the exporter
        # alive, and the exporter's collection releases the store pin.
        exporter = (ctypes.c_char * size).from_buffer(self._map, off.value)
        weakref.finalize(exporter, _release_pin, self, bytes(object_id))
        view = memoryview(exporter).cast("B").toreadonly()
        try:
            value = serialization.loads_oob(view)
        finally:
            del view
        return value, True

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._view.release()
            try:
                self._map.close()
            except BufferError:
                # Live zero-copy values still export arena buffers; the
                # mapping stays until they are collected (process exit
                # cleans up regardless).
                pass
            os.close(self._fd)
        finally:
            self._lib.rtpu_store_detach(self._handle)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
