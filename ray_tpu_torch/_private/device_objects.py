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
  as long as its ref does, as a store object does.

The hook is installed with ``install(register_reducer_hook,
previous_hook)``: the store has one hook slot, so the port's hook hands
every object it does not take to the hook it replaced (the JAX one, say),
and the returned uninstall puts that hook back. ``install_on(runtime)``
finds the two in ``runtime._private.serialization`` when the runtime has
one (the ``ray_tpu`` module does), without importing anything;
``LocalRuntime`` needs no hook, since its values never leave the process.

Not ported: the arena-wide ``device_staged_bytes`` counter (charged from
the reference's own per-thread ledger, which this hook cannot reach;
``staged_bytes`` here counts the same bytes per process) and donation
(``_donate_result``, which needs the worker's return path).
"""

from __future__ import annotations

import json
import pickle
import threading
import warnings
import weakref
from typing import Any, Callable, Optional

import numpy as np
import torch

from ray_tpu_torch._private.config import config

_stats_lock = threading.Lock()
_stats = {
    "puts": 0,                   # tensors staged into a frame
    "staged_bytes": 0,           # raw tensor bytes written out of band
    "host_materializations": 0,  # host copies beyond the arena slab
    "rebuilds": 0,               # tensors rebuilt from a frame (gets)
    "local_hits": 0,             # same-process gets by reference
}

_install_lock = threading.Lock()
_local: "weakref.WeakKeyDictionary[Any, torch.Tensor]" = \
    weakref.WeakKeyDictionary()
_local_lock = threading.Lock()


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


def _takes(obj: Any) -> bool:
    """A plain dense tensor the frame can carry; everything else (grad
    leaves, parameters, sparse or meta tensors) keeps torch's pickling."""
    return (type(obj) is torch.Tensor and obj.layout == torch.strided
            and not obj.requires_grad and obj.device.type in ("cpu", "cuda"))


# ------------------------------------------------------------------ staging

def _host_bytes(t: torch.Tensor):
    """The tensor's bytes as a host uint8 numpy array, counting each host
    copy made on the way."""
    if not t.is_contiguous():
        t = t.contiguous()
        _bump("host_materializations")
    if t.device.type == "cuda":
        t = t.cpu()
        _bump("host_materializations")
    return t.reshape(-1).view(torch.uint8).numpy()


def reduce_tensor(obj: Any) -> Optional[tuple]:
    """The reducer: a reduce tuple for a tensor it takes, else None."""
    if not _takes(obj) or not enabled():
        return None
    header = json.dumps({
        "v": 1,
        "dtype": str(obj.dtype).removeprefix("torch."),
        "shape": list(obj.shape),
        "device": str(obj.device),
    }).encode()
    raw = _host_bytes(obj.detach())
    _bump("puts")
    _bump("staged_bytes", raw.nbytes)
    return (rebuild_tensor, (header, pickle.PickleBuffer(raw)))


# ------------------------------------------------------------------ rebuild

def _pick_device(meta: dict) -> torch.device:
    """``cuda:i`` for a tensor put from ``cuda:i`` when this process has
    that device; the CPU otherwise."""
    dev = torch.device(meta.get("device", "cpu"))
    if dev.type == "cuda" and torch.cuda.is_available():
        index = dev.index or 0
        if index < torch.cuda.device_count():
            return torch.device("cuda", index)
    return torch.device("cpu")


def rebuild_tensor(header: bytes, buf) -> torch.Tensor:
    """Unpickle target of a staged tensor: one copy off ``buf`` (the
    read-only arena view, or bytes) onto the device ``_pick_device``
    chooses. Nothing returned refers to ``buf``."""
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
    _bump("rebuilds")
    return out.view(dtype).reshape(meta["shape"])


# ---------------------------------------------------------- same process

def note_put(ref: Any, value: Any) -> None:
    """Register a tensor this process put as ``ref``, for ``lookup_local``."""
    if not isinstance(value, torch.Tensor) or not enabled():
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
        _bump("local_hits")
    return t


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
        return install(ser.register_reducer_hook, ser._reducer_hook)
