"""Serialization: the port's pickler + pickle-5 out-of-band buffers.

Role-equivalent to the reference's ``python/ray/_private/serialization.py``
(SerializationContext, :92): values are pickled with protocol 5 so large
contiguous buffers (numpy / jax host arrays) are captured out-of-band and can
be written into — and later mapped zero-copy out of — the shared-memory
object store. Functions and classes a worker cannot import travel by value
(``_private/pickler.py``, the port's stand-in for cloudpickle).

Wire layout of a stored object (64-byte aligned buffers for zero-copy numpy):

    u32 magic | u32 n_buffers | u64 meta_len | (u64 offset, u64 len) * n
    | metadata(pickle bytes) | pad | buffer_0 | pad | buffer_1 | ...
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import pickler

_MAGIC = 0x52545055  # "RTPU"
_ALIGN = 64
_HEADER = struct.Struct("<IIQ")
_BUF_DESC = struct.Struct("<QQ")

# Pluggable reducer hook (device objects — _private/device_objects.py): a
# callable consulted for every object the pickler visits; returns a reduce
# tuple to take over serialization of that object, or None to fall through
# to default pickling. The port's torch hook is installed at the first
# serialize after torch is imported.
_reducer_hook: Optional[Callable[[Any], Optional[tuple]]] = None


_roots_cache: Tuple[tuple, list] = ((), [])


def import_roots() -> list:
    """sys.path entries that exist on disk — the import roots workers
    need to resolve by-reference pickles. Cached on the sys.path tuple:
    isdir-scanning the whole path on every worker spawn / actor
    creation showed up in head-process CPU profiles under churn, and
    sys.path changes rarely."""
    global _roots_cache
    key = tuple(sys.path)
    if _roots_cache[0] != key:
        import os

        _roots_cache = (key,
                        [p for p in key if p and os.path.isdir(p)])
    return _roots_cache[1]


def register_reducer_hook(fn: Callable[[Any], Optional[tuple]]) -> None:
    global _reducer_hook
    _reducer_hook = fn


class _HookedPickler(pickler.Pickler):
    """The port's pickler with the registered reducer hook consulted
    first."""

    def reducer_override(self, obj):
        r = _reducer_hook(obj)
        if r is not None:
            return r
        return super().reducer_override(obj)


def _maybe_install_device_hook() -> None:
    """Install the torch tensor reducer once torch exists in this process.
    Cheap when idle (one sys.modules probe): a process that never imports
    torch (the GCS, the node manager, the CLI) can hold no tensor, and
    never loads torch for this. A failure to install raises (no quiet
    fallback to pickling tensors in band)."""
    if _reducer_hook is not None or "torch" not in sys.modules:
        return
    from ray_tpu_torch._private import device_objects

    device_objects.maybe_install()


class SerializedObject:
    __slots__ = ("metadata", "buffers", "device_bytes")

    def __init__(self, metadata: bytes, buffers: Sequence[memoryview],
                 device_bytes: int = 0):
        self.metadata = metadata
        self.buffers = list(buffers)
        # Raw device-array bytes staged into this object's buffers: the
        # plasma client charges these to the arena-wide staging counter
        # on seal (node-manager staging-bytes accounting).
        self.device_bytes = device_bytes

    def total_size(self) -> int:
        size = _HEADER.size + _BUF_DESC.size * len(self.buffers)
        size += len(self.metadata)
        for b in self.buffers:
            size = _aligned(size) + b.nbytes
        return size

    def write_into(self, out: memoryview) -> int:
        """Write the framed object into ``out``; returns bytes written."""
        n = len(self.buffers)
        desc_off = _HEADER.size
        data_off = desc_off + _BUF_DESC.size * n
        _HEADER.pack_into(out, 0, _MAGIC, n, len(self.metadata))
        out[data_off : data_off + len(self.metadata)] = self.metadata
        cursor = data_off + len(self.metadata)
        for i, buf in enumerate(self.buffers):
            cursor = _aligned(cursor)
            _BUF_DESC.pack_into(out, desc_off + i * _BUF_DESC.size, cursor, buf.nbytes)
            out[cursor : cursor + buf.nbytes] = buf
            cursor += buf.nbytes
        return cursor

    def to_bytes(self) -> bytes:
        buf = bytearray(self.total_size())
        self.write_into(memoryview(buf))
        return bytes(buf)


def _aligned(offset: int) -> int:
    return (offset + _ALIGN - 1) & ~(_ALIGN - 1)


def serialize(value: Any) -> SerializedObject:
    _maybe_install_device_hook()
    buffers: List[pickle.PickleBuffer] = []

    def buffer_callback(pb: pickle.PickleBuffer) -> bool:
        buffers.append(pb)
        return False  # do not serialize in-band

    device_bytes = 0
    if _reducer_hook is None:
        meta = pickler.dumps(value, protocol=5,
                                 buffer_callback=buffer_callback)
    else:
        from ray_tpu_torch._private import device_objects

        # Drop bytes a FAILED earlier dump left in the thread ledger —
        # otherwise they would be mischarged to this unrelated object.
        device_objects.take_pending_stage_bytes()
        with io.BytesIO() as f:
            _HookedPickler(f, protocol=5,
                           buffer_callback=buffer_callback).dump(value)
            meta = f.getvalue()
        device_bytes = device_objects.take_pending_stage_bytes()
    views = []
    for pb in buffers:
        try:
            views.append(pb.raw())
        except BufferError:
            # Non-contiguous buffer: fall back to a contiguous copy.
            views.append(memoryview(bytes(pb)))
    return SerializedObject(meta, views, device_bytes=device_bytes)


def deserialize_framed(view: memoryview) -> Any:
    """Deserialize a framed object, zero-copy over ``view``.

    The returned value may hold references into ``view`` (numpy arrays over
    shared memory). Callers that need the store slot released must copy.
    """
    magic, n, meta_len = _HEADER.unpack_from(view, 0)
    if magic != _MAGIC:
        raise ValueError("corrupt object header")
    desc_off = _HEADER.size
    data_off = desc_off + _BUF_DESC.size * n
    meta = bytes(view[data_off : data_off + meta_len])
    bufs = []
    for i in range(n):
        off, length = _BUF_DESC.unpack_from(view, desc_off + i * _BUF_DESC.size)
        bufs.append(view[off : off + length])
    return pickle.loads(meta, buffers=bufs)


def dumps_oob(value: Any) -> bytes:
    """One-shot framed serialize (for socket payloads)."""
    return serialize(value).to_bytes()


def loads_oob(data: bytes | memoryview) -> Any:
    if isinstance(data, (bytes, bytearray)):
        data = memoryview(data)
    return deserialize_framed(data)
