"""``torch.Tensor`` as a store object (port of
``ray_tpu/_private/device_objects.py``, which does this for ``jax.Array``).

The contract is the reference's, bounded copies:

* **put** — a reducer hook, consulted by the store's pickler for every
  object, turns a tensor into one small JSON header ``{dtype, shape,
  device}`` and its raw bytes as a pickle-5 out-of-band buffer, which the
  store's frame writer copies straight into the object's arena slab. The
  bytes are ``t.view(torch.uint8)`` of the contiguous tensor, so every
  dtype travels, bf16 included (numpy has no bf16; the header names the
  torch dtype). Host copies beyond the arena slab, counted in
  ``host_materializations``: none for a contiguous CPU tensor (its numpy
  view aliases it); one for a CUDA tensor (the device-to-host copy, the
  landing buffer the reference also counts); one more for a
  non-contiguous tensor (``.contiguous()``).
* **get** — ``rebuild_tensor`` runs off the read-only arena view. A tensor
  put from ``cuda:i`` is rebuilt on ``cuda:i`` when this process has that
  device, else on the CPU (the reference's numpy fallback: a fact of the
  consumer's process, not a change of device the caller asked for).
  numpy's read-only flag protects the reference's views; torch has no such
  flag, and an in-place write into a tensor over the arena would change
  the stored object. So the rebuild copies once: a CUDA rebuild is one
  host-to-device copy off the view, a CPU rebuild one host copy off it.
  The store pin is released as soon as that copy is made (the view is
  dropped); a write into the rebuilt tensor never reaches the store.
* **same process** — ``note_put`` registers a tensor under the ref it was
  put as, and ``lookup_local`` returns that tensor itself, with no copy
  (``local_hits``). The ``ray_tpu`` runtime asks only its JAX registry for
  local hits, so ``kv_transfer`` consults this one first. An entry lives
  as long as its ref does, as a store object does. The port's own runtime
  keeps the reference's per-worker registry instead (``core_note_put``,
  ``core_lookup_local``, ``note_return``), keyed by object id.
* **arena accounting** — the reducer runs deep inside a pickler, so it
  accrues the bytes it stages in a per-thread ledger; the port's
  ``serialization.serialize`` drains it (``take_pending_stage_bytes``)
  into the object, and the store charges the arena-wide
  ``device_staged_bytes`` on seal, as the reference does for
  ``jax.Array``. Another runtime's serializer never drains the ledger, so
  there the bytes show only in this module's ``staged_bytes``.

The hook is installed with ``install(register_reducer_hook,
previous_hook)``: the store has one hook slot, so the port's hook hands
every object it does not take to the hook it replaced (the JAX one, say),
and the returned uninstall puts that hook back. ``install_on(runtime)``
finds the two in ``runtime._private.serialization`` when the runtime has
one (the ``ray_tpu`` module does), without importing anything;
``LocalRuntime`` needs no hook, since its values never leave the process.

On the port's own runtime the serializer installs the hook itself at its
first serialize once torch is loaded in the process (``maybe_install``),
as the reference's does once jax is: no tensor can exist before then, and
the control plane (GCS, node manager, CLI, dashboard head) never loads
torch at all. This module imports torch only inside the calls that handle
a tensor.

* **donation** — a task submitted with ``_donate_result=True`` hands its
  returned tensor over: once every return slot is staged into the arena,
  ``note_return(..., donate=True)`` releases the tensor's storage
  (``untyped_storage().resize_(0)``, torch's counterpart of JAX's
  ``Array.delete()``), counted in ``donations``, and does not register it
  for same-process gets. Two differences from the reference follow from
  torch. A storage can back many tensors, where a JAX array owns its
  buffer: only a tensor that spans its whole storage (offset 0, the
  storage's byte size) is donated, since releasing the storage of a view
  would empty every other view of it; any other tensor is left alone
  (and registered as without donation). And a CUDA storage's memory goes
  back to PyTorch's caching allocator, not to the driver:
  ``torch.cuda.memory_allocated()`` falls, ``nvidia-smi`` does not.
"""

from __future__ import annotations

import json
import pickle
import sys
import threading
import time
import warnings
import weakref
from typing import TYPE_CHECKING, Any, Callable, Optional

from ray_tpu_torch._private.config import config

if TYPE_CHECKING:
    import torch

_stats_lock = threading.Lock()
_stats = {
    "puts": 0,                   # tensors staged into a frame
    "staged_bytes": 0,           # raw tensor bytes written out of band
    "host_materializations": 0,  # host copies beyond the arena slab
    "rebuilds": 0,               # tensors rebuilt from a frame (gets)
    "local_hits": 0,             # same-process gets by reference
    "donations": 0,              # returned tensors whose storage was released
}

_install_lock = threading.Lock()
_local: "weakref.WeakKeyDictionary[Any, torch.Tensor]" = \
    weakref.WeakKeyDictionary()


def _is_tensor(obj: Any) -> bool:
    """``obj`` is a ``torch.Tensor``, without importing torch: where torch
    was never imported, no tensor can exist either."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(obj, torch.Tensor)
_local_lock = threading.Lock()


class _TLS(threading.local):
    """Per-thread staging ledger, drained by ``take_pending_stage_bytes``."""

    def __init__(self):
        self.pending_stage_bytes = 0


_tls = _TLS()


def take_pending_stage_bytes() -> int:
    n = _tls.pending_stage_bytes
    _tls.pending_stage_bytes = 0
    return n


def _trace(kind: str, start: float, end: Optional[float] = None,
           **attrs: Any) -> None:
    """A device-object hop as a span of the running trace (the KV
    hand-off's publish is a ``device_put``, its adopt a ``device_get``),
    under whatever task or span stages it; nothing outside a trace, where
    the span would link to nothing."""
    from ray_tpu_torch.util import tracing

    if tracing.current() is not None:
        name = "device_object.put" if kind == "device_put" \
            else "device_object.get"
        tracing.emit_span(name, kind=kind, start=start, end=end,
                          attrs=attrs)


def _bump(key: str, n: int = 1) -> None:
    with _stats_lock:
        _stats[key] += n


def stats() -> dict:
    with _stats_lock:
        return dict(_stats)


def reset_stats() -> None:
    with _stats_lock:
        for k in _stats:
            _stats[k] = 0


def enabled() -> bool:
    return bool(config.device_objects_enabled)


def takes(obj: Any) -> bool:
    """A plain dense tensor the frame can carry; everything else (grad
    leaves, parameters, sparse or meta tensors) keeps torch's pickling."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    return (type(obj) is torch.Tensor and obj.layout == torch.strided
            and not obj.requires_grad and obj.device.type in ("cpu", "cuda"))


# ------------------------------------------------------------------ staging

def frame(t: torch.Tensor):
    """``(header, raw, host_copies)`` of a tensor ``takes`` accepts: the
    JSON header ``load_tensor`` reads, the tensor's bytes as a host
    uint8 numpy array, and how many host copies making it took (one for a
    CUDA tensor, one more for a non-contiguous one)."""
    import numpy as np
    import torch

    header = json.dumps({
        "v": 1,
        "dtype": str(t.dtype).removeprefix("torch."),
        "shape": list(t.shape),
        "device": str(t.device),
    }).encode()
    copies = 0
    if not t.is_contiguous():
        t = t.contiguous()
        copies += 1
    if t.device.type == "cuda":
        t = t.cpu()
        copies += 1
    # numpy's view through DLPack, not ``Tensor.numpy()``: the latter marks
    # the storage as not resizable for good, and donation releases a
    # returned tensor's storage by resizing it.
    raw = np.from_dlpack(t.reshape(-1).view(torch.uint8))
    return header, raw, copies


def reduce_tensor(obj: Any) -> Optional[tuple]:
    """The reducer: a reduce tuple for a tensor it takes, else None."""
    if not takes(obj) or not enabled():
        return None
    t0 = time.time()
    header, raw, copies = frame(obj.detach())
    _bump("host_materializations", copies)
    _bump("puts")
    _bump("staged_bytes", raw.nbytes)
    _tls.pending_stage_bytes += raw.nbytes
    _trace("device_put", t0, bytes=int(raw.nbytes), shape=list(obj.shape))
    return (rebuild_tensor, (header, pickle.PickleBuffer(raw)))


# ------------------------------------------------------------------ rebuild

def _pick_device(meta: dict) -> torch.device:
    """``cuda:i`` for a tensor put from ``cuda:i`` when this process has
    that device; the CPU otherwise."""
    import torch

    dev = torch.device(meta.get("device", "cpu"))
    if dev.type == "cuda" and torch.cuda.is_available():
        index = dev.index or 0
        if index < torch.cuda.device_count():
            return torch.device("cuda", index)
    return torch.device("cpu")


def rebuild_tensor(header: bytes, buf) -> torch.Tensor:
    """Unpickle target of a staged tensor: ``load_tensor``, counted as one
    of the store's rebuilds."""
    t0 = time.time()
    out = load_tensor(header, buf)
    _bump("rebuilds")
    _trace("device_get", t0, bytes=int(out.nbytes), shape=list(out.shape),
           local_hit=False)
    return out


def load_tensor(header: bytes, buf) -> torch.Tensor:
    """The tensor of a ``frame``: one copy off ``buf`` (the read-only
    arena view, or bytes) onto the device ``_pick_device`` chooses.
    Nothing returned refers to ``buf``. Counts nothing: a workflow's
    checkpoint loads through it, outside the store."""
    import numpy as np
    import torch

    meta = json.loads(header)
    dtype = getattr(torch, meta["dtype"])
    device = _pick_device(meta)
    view = memoryview(buf).cast("B")
    out = torch.empty(view.nbytes, dtype=torch.uint8, device=device)
    if not view.nbytes:
        pass
    elif device.type == "cpu":
        # numpy's copy, not torch's: one memcpy, whatever torch's thread
        # pool is doing.
        np.copyto(out.numpy(), np.frombuffer(view, np.uint8))
    else:
        with warnings.catch_warnings():
            # The view is read-only; it is only ever read from here.
            warnings.simplefilter("ignore", UserWarning)
            src = torch.frombuffer(view, dtype=torch.uint8)
        out.copy_(src)
        del src
    view.release()
    return out.view(dtype).reshape(meta["shape"])


# ---------------------------------------------------------- same process

def note_put(ref: Any, value: Any) -> None:
    """Register a tensor this process put as ``ref``, for ``lookup_local``."""
    if not _is_tensor(value) or not enabled():
        return
    try:
        with _local_lock:
            _local[ref] = value
    except TypeError:
        pass  # a ref that cannot be weakly keyed: a registry miss, still right


def lookup_local(ref: Any) -> Optional[torch.Tensor]:
    """The tensor this process put as ``ref``, or None."""
    if not enabled():
        return None  # off: the store path is the baseline under test
    try:
        with _local_lock:
            t = _local.get(ref)
    except TypeError:
        return None
    if t is not None:
        _local_hit(t)
    return t


def core_note_put(core, oid_bytes: bytes, value: Any) -> None:
    """The port's runtime: record a tensor this worker put or returned,
    for by-reference gets (the reference's ``note_put``)."""
    if not _is_tensor(value) or not enabled():
        return
    core._device_local[oid_bytes] = value


def core_lookup_local(core, oid_bytes: bytes) -> Optional[torch.Tensor]:
    """The port's runtime: the tensor this worker put as ``oid_bytes``, or
    None (the reference's ``lookup_local``)."""
    if not enabled():
        return None
    t = core._device_local.get(oid_bytes)
    if t is not None:
        _local_hit(t)
    return t


def _local_hit(t: torch.Tensor) -> None:
    """A by-reference get: counted, and a zero-length ``device_get`` span
    of the running trace (the same-process leg of a KV hand-off)."""
    _bump("local_hits")
    now = time.time()
    _trace("device_get", now, now, bytes=int(t.nbytes), local_hit=True)


def donatable(value: Any) -> bool:
    """A tensor whose storage holds exactly its own bytes (offset 0, the
    storage's byte size): releasing that storage frees no other tensor's
    data than views of the whole tensor itself."""
    return (_is_tensor(value) and value.storage_offset() == 0
            and value.untyped_storage().nbytes()
            == value.numel() * value.element_size())


def note_return(core, oid_bytes: bytes, value: Any, donate: bool) -> None:
    """Post-staging hook for task and actor returns. Registers the tensor
    for same-process gets — or, under ``_donate_result``, releases its
    storage now that the arena holds the only copy (see the module
    docstring: a tensor that is a view of a larger storage is registered,
    never donated). A tensor returned in two slots is released at the
    first and left as it is at the second."""
    if not _is_tensor(value) or not enabled():
        return
    if donate and value.numel() and not value.untyped_storage().nbytes():
        return   # released already (the same tensor in an earlier slot)
    if not (donate and donatable(value)):
        core_note_put(core, oid_bytes, value)
        return
    if value.device.type == "cuda":
        import torch

        # Synchronize, not record_stream: staging copied the tensor to
        # the host with a blocking copy on the current stream, but
        # kernels queued on that stream after the producer's (by the
        # caller, or another thread) may still read the storage. Once
        # the stream has drained, the caching allocator may hand the
        # block to the next tensor.
        torch.cuda.current_stream(value.device).synchronize()
    try:
        value.untyped_storage().resize_(0)
    except Exception:
        return   # a storage torch cannot resize (numpy's, say): kept
    _bump("donations")


# ------------------------------------------------------------- the hook

def install(register_reducer_hook: Callable[[Any], None],
            previous_hook: Optional[Callable[[Any], Optional[tuple]]] = None
            ) -> Callable[[], None]:
    """Register the tensor hook in the store's single slot, chained to
    ``previous_hook`` (the hook it replaces). Returns the uninstall, which
    registers ``previous_hook`` again."""

    def hook(obj):
        r = reduce_tensor(obj)
        if r is None and previous_hook is not None:
            return previous_hook(obj)
        return r

    hook.torch_device_objects = True
    register_reducer_hook(hook)

    def uninstall() -> None:
        register_reducer_hook(previous_hook)

    return uninstall


def install_on(runtime: Any) -> Optional[Callable[[], None]]:
    """Install the hook into ``runtime``'s serializer when it has one
    (``runtime._private.serialization``, as the ``ray_tpu`` module has) and
    the hook is not there yet. Returns the uninstall, or None when there is
    nothing to do. The runtime's own hook (JAX's, when JAX is loaded) gets
    its chance to claim the slot first, so the port's hook chains to it."""
    ser = getattr(getattr(runtime, "_private", None), "serialization", None)
    if ser is None or not hasattr(ser, "register_reducer_hook"):
        return None
    with _install_lock:
        if getattr(ser._reducer_hook, "torch_device_objects", False):
            return None
        claim = getattr(ser, "_maybe_install_device_hook", None)
        if claim is not None:
            claim()
            if getattr(ser._reducer_hook, "torch_device_objects", False):
                return None  # the port's own serializer installs this hook
        return install(ser.register_reducer_hook, ser._reducer_hook)


def maybe_install() -> None:
    """Install the hook into the port's own serializer, once. The
    serializer calls this only once torch is loaded."""
    from ray_tpu_torch._private import serialization

    with _install_lock:
        if serialization._reducer_hook is None:
            install(serialization.register_reducer_hook, None)
