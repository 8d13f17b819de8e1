"""KV-cache handoff between the prefill and decode pools (port of
``ray_tpu/serve/llm/kv_transfer.py``), through the runtime's store.

The prefill replica publishes its bucket-sized K/V blocks with
``runtime.put``, one ref per tensor, and registers each tensor under its
ref (``_private/device_objects.note_put``):

- **same process** (a ``LocalRuntime`` app, tests): ``adopt_kv`` finds the
  published tensors in that registry and returns them themselves — no
  copy, ``local_hits`` 2, ``rebuilds`` 0;
- **another process** (the ``ray_tpu`` runtime): the put stages each tensor
  out of band into the arena (the port's reducer hook, installed on the
  runtime before the first put), and the decode side's get rebuilds it
  with one copy onto the producer's device when it has it.

The handoff descriptor is a small dict (two refs and scalars) that travels
through the serve handle like any argument. ``runtime`` is a keyword: a
``LocalRuntime``, or the ``ray_tpu`` module.
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch._private import device_objects
from ray_tpu_torch._private.config import config
from ray_tpu_torch.exceptions import KVAdoptTimeoutError


def publish_kv(kv: Dict[str, Any], true_len: int, first_token: int, *,
               runtime: Any, **meta: Any) -> Dict[str, Any]:
    """Stage one prefilled KV block into ``runtime``'s store and return the
    handoff descriptor handed to the decode pool."""
    device_objects.install_on(runtime)
    out = {"length": int(true_len), "first_token": int(first_token)}
    for name in ("k", "v"):
        ref = runtime.put(kv[name])
        device_objects.note_put(ref, kv[name])
        out[f"{name}_ref"] = ref
    out.update(meta)
    return out


def adopt_kv(handoff: Dict[str, Any], *, runtime: Any) -> Dict[str, Any]:
    """Resolve a handoff descriptor back into K/V tensors: the published
    tensors themselves when this process put them, else ``runtime.get``,
    bounded by ``serve_kv_adopt_timeout_s``. A runtime's ``TimeoutError``
    (``ray_tpu``'s ``GetTimeoutError`` is one) becomes the typed
    ``KVAdoptTimeoutError`` the router answers by re-running prefill."""
    refs = [handoff["k_ref"], handoff["v_ref"]]
    got = [device_objects.lookup_local(r) for r in refs]
    missing = [r for r, t in zip(refs, got) if t is None]
    if missing:
        timeout_s = float(config.serve_kv_adopt_timeout_s)
        try:
            fetched = iter(runtime.get(missing, timeout=timeout_s))
        except TimeoutError as e:
            raise KVAdoptTimeoutError(
                f"KV handoff refs unresolvable within "
                f"serve_kv_adopt_timeout_s={timeout_s}s (prefill replica "
                f"dead?)", timeout_s=timeout_s) from e
        got = [t if t is not None else next(fetched) for t in got]
    return {"k": got[0], "v": got[1]}
