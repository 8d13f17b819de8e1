"""The port's copy of the ``ray_tpu/_private/config.py`` knobs its serving
tier, collectives and gang trainer read, under the reference's names and
defaults. Each can be
overridden per process with a ``RAY_TPU_<NAME>`` environment variable, as
the reference's are, and in code with ``config.set(name, value)``."""

from __future__ import annotations

import os
import threading
from typing import Any, Dict

_ENV_PREFIX = "RAY_TPU_"

_DEFAULTS: Dict[str, Any] = {
    # Treat torch.Tensor as a store object: raw bytes out of band, rebuilt
    # on the producer's device (``_private/device_objects.py``).
    "device_objects_enabled": True,
    # Times one admitted request may be migrated (replica death, engine
    # failure, unresolvable KV handoff) before it is shed typed.
    "serve_request_max_migrations": 3,
    # Bound on resolving a prefill -> decode KV handoff in ``adopt_kv``.
    "serve_kv_adopt_timeout_s": 60.0,
    # Fault injection for engines built with an empty
    # ``EngineConfig.fault_inject`` ("step_error:after=N" |
    # "die:after_tokens=N").
    "serve_fault_inject": "",
    # Gang fault tolerance (``parallel/collective.py``, ``train/``): the
    # supervisor pings each member, and each collective member polls its
    # group's poison flag, at this period.
    "gang_heartbeat_s": 1.0,
    # Missed pings before a wedged-but-alive member is declared dead.
    "gang_ping_miss_limit": 30,
    # Deadline for one WorkerGroup.poll() round across all members.
    "gang_poll_timeout_s": 30.0,
    # Exponential backoff between gang re-formations, and its cap.
    "gang_restart_backoff_s": 0.5,
    "gang_restart_backoff_max_s": 30.0,
    # On poison, abort a torch.distributed world that still has an op in
    # flight after 2x the heartbeat (what aborts a NCCL communicator).
    "gang_poison_teardown_enabled": True,
    # Deadline for one collective op (a torch_dist world's own timeout).
    "collective_op_timeout_s": 300.0,
    # Deadline for group formation (coordinator lookup, address exchange,
    # world join).
    "collective_rendezvous_timeout_s": 60.0,
}


def _coerce(default: Any, raw: Any) -> Any:
    if isinstance(default, bool):
        if isinstance(raw, bool):
            return raw
        return str(raw).lower() in ("1", "true", "yes", "on")
    return type(default)(raw)


class Config:
    """The knobs as attributes; ``set`` changes one for this process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values: Dict[str, Any] = {}
        for name, default in _DEFAULTS.items():
            raw = os.environ.get(_ENV_PREFIX + name.upper())
            self._values[name] = default if raw in (None, "") \
                else _coerce(default, raw)

    def get(self, name: str) -> Any:
        return self._values[name]

    def set(self, name: str, value: Any) -> None:
        if name not in _DEFAULTS:
            raise KeyError(f"unknown config knob {name!r}")
        with self._lock:
            self._values[name] = _coerce(_DEFAULTS[name], value)

    def __getattr__(self, name: str) -> Any:
        try:
            return self.__dict__["_values"][name]
        except KeyError:
            raise AttributeError(name) from None


config = Config()
