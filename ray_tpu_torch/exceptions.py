"""The port's exception types: the serving tier's and the gang's (copies of
those in ``ray_tpu/exceptions.py``, on a local base: the port imports
nothing of ``ray_tpu``)."""

from __future__ import annotations

from typing import Optional


class RayTpuError(Exception):
    """Base class of the port's framework errors."""


class ServeOverloadedError(RayTpuError):
    """A serving-tier admission bound was hit (here: the engine's queue
    cap): the request was SHED, not failed — the caller should back off
    ``retry_after_s`` and retry."""

    def __init__(self, message: str = "serving tier overloaded", *,
                 retry_after_s: float = 1.0, reason: str = ""):
        self.retry_after_s = float(retry_after_s)
        self.reason = reason
        super().__init__(message)

    def __reduce__(self):
        return (type(self), (self.args[0] if self.args else "",),
                {"retry_after_s": self.retry_after_s, "reason": self.reason})


class KVCacheExhaustedError(RayTpuError):
    """The paged KV block pool (or the engine's KV byte budget) cannot
    hold this sequence: prompt + generation budget needs more blocks than
    the whole pool owns. Raised at ADMISSION — a clean, typed failure
    instead of an out-of-memory error mid-generation."""


class EngineFailedError(RayTpuError):
    """The serving engine failed (a scheduler-step error) or was stopped
    with this request still in flight.

    NOT terminal for the request: ``descriptor`` is a durable resume
    descriptor — ``{prompt, generated, seed, position, max_tokens}`` — and
    resubmitting it to a healthy engine continues generation
    bit-identically from position ``len(prompt) + len(generated)``
    (per-request ``fold_in(seed, position)`` sampling keys make the token
    stream a pure function of the sequence so far). ``reason`` is
    ``"step_failure"`` or ``"engine_stopped"``."""

    def __init__(self, message: str = "engine failed", *,
                 descriptor: Optional[dict] = None, reason: str = ""):
        self.descriptor = dict(descriptor or {})
        self.reason = reason
        super().__init__(message)

    def __reduce__(self):
        return (type(self), (self.args[0] if self.args else "",),
                {"descriptor": self.descriptor, "reason": self.reason})


class RequestMigrationExhaustedError(ServeOverloadedError):
    """A request was migrated across replica deaths
    ``serve_request_max_migrations`` times and still could not complete.
    A shed, not a silent failure (``http_status`` 503)."""

    def __init__(self, message: str = "request migration budget exhausted",
                 *, retry_after_s: float = 1.0, migrations: int = 0):
        super().__init__(message, retry_after_s=retry_after_s,
                         reason="migration_exhausted")
        self.http_status = 503
        self.migrations = int(migrations)

    def __reduce__(self):
        return (type(self), (self.args[0] if self.args else "",),
                {"retry_after_s": self.retry_after_s, "reason": self.reason,
                 "http_status": self.http_status,
                 "migrations": self.migrations})


class KVAdoptTimeoutError(RayTpuError, TimeoutError):
    """``kv_transfer.adopt_kv`` could not resolve the handoff KV refs within
    ``serve_kv_adopt_timeout_s``: the prefill replica that owns them is
    likely dead. Typed so the disaggregated router re-runs prefill on
    another replica instead of failing the request; a ``TimeoutError``, as
    the reference's is through its ``GetTimeoutError``."""

    def __init__(self, message: str = "KV handoff adoption timed out", *,
                 timeout_s: float = 0.0):
        self.timeout_s = float(timeout_s)
        super().__init__(message)

    def __reduce__(self):
        return (type(self), (self.args[0] if self.args else "",),
                {"timeout_s": self.timeout_s})


class GangMemberDiedError(RayTpuError):
    """A member of a gang-scheduled group (collective group / training
    worker gang) died, poisoning the whole group.

    The gang is the failure domain: one dead rank invalidates the whole
    world, so survivors blocked in a collective must unwedge promptly (the
    group coordinator's poison flag bounds the raise to the configured gang
    heartbeat) and the trainer re-forms the gang from the latest
    checkpoint. ``rank`` is the dead member's rank when known.
    """

    def __init__(self, message: str = "", *, group_name: str = "",
                 rank: Optional[int] = None, reason: str = ""):
        self.group_name = group_name
        self.rank = rank
        self.reason = reason
        if not message:
            who = f"rank {rank}" if rank is not None else "a member"
            message = (f"gang member died: {who} of group "
                       f"'{group_name or 'unknown'}'"
                       + (f" ({reason})" if reason else ""))
        super().__init__(message)

    def __reduce__(self):
        return (type(self), (self.args[0] if self.args else "",),
                {"group_name": self.group_name, "rank": self.rank,
                 "reason": self.reason})
