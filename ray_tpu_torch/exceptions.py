"""Public exception types of the port: the runtime's (copies of those in
``ray_tpu/exceptions.py``: user-facing errors that cross process boundaries
are serialized and re-raised on the caller with the remote traceback
attached), the serving tier's and the gang's, on a local base: the port
imports nothing of ``ray_tpu``."""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class of the port's framework errors."""


class RayTaskError(RayTpuError):
    """A task or actor method raised an exception remotely.

    Stored as the task's return object; re-raised from ``get`` with the
    remote traceback as the message (reference: exceptions.py RayTaskError).
    """

    def __init__(self, function_name: str = "", traceback_str: str = "",
                 cause: Optional[BaseException] = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(f"task {function_name} failed:\n{traceback_str}")

    @classmethod
    def from_exception(cls, function_name: str, exc: BaseException) -> "RayTaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        # Keep the cause only if it survives pickling; the traceback string
        # always survives.
        return cls(function_name, tb, exc)

    def as_instanceof_cause(self) -> BaseException:
        """Return an exception that is an instance of the original type."""
        if self.cause is not None and not isinstance(self.cause, RayTaskError):
            return self.cause
        return self


class RayActorError(RayTpuError):
    """The actor died before or while executing the submitted method."""

    def __init__(self, actor_id: str = "", msg: str = "actor died"):
        self.actor_id = actor_id
        super().__init__(f"{msg} (actor {actor_id})")


class ActorDiedError(RayActorError):
    pass


class ActorUnavailableError(RayActorError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id: str = ""):
        self.task_id = task_id
        super().__init__(f"task {task_id} was cancelled")


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ObjectLostError(RayTpuError):
    """The object's value was lost from all nodes and cannot be recovered."""

    def __init__(self, object_id: str = "", msg: str = ""):
        self.object_id = object_id
        super().__init__(msg or f"object {object_id} is lost")


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class OwnerDiedError(ObjectLostError):
    """The object's owner process died, so its value can never be resolved."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get`` timed out before the object became available."""


class CompletionAbsorbError(RayTpuError):
    """The driver's completion-absorb stage died on a frame.

    The lease conn thread parks raw completion frames; a dedicated
    absorb executor unpickles and applies them. If absorption raises
    (corrupt frame, absorb-thread death), every return object the
    frame's lease still had in flight gets this error attached and its
    waiters woken — a typed failure at get(), never a silent hang."""


class RuntimeEnvSetupError(RayTpuError):
    """Preparing a worker's runtime environment failed."""


class NodeDiedError(RayTpuError):
    pass


class PlacementGroupSchedulingError(RayTpuError):
    """The placement group could not be scheduled with current resources."""


class OutOfMemoryError(RayTpuError):
    """Raised when the object store cannot admit an object."""


class PendingCallsLimitExceeded(RayTpuError):
    """Actor's pending call queue exceeded max_pending_calls."""


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


class ReplicaDrainingError(RayTpuError):
    """The replica is draining (rolling restart / scale-down) and no
    longer admits new requests or streams. The caller should re-pick a
    healthy replica and resubmit — the serve handle does this
    transparently."""

    def __init__(self, message: str = "replica is draining", *,
                 replica_id: str = ""):
        self.replica_id = replica_id
        super().__init__(message)

    def __reduce__(self):
        return (type(self), (self.args[0] if self.args else "",),
                {"replica_id": self.replica_id})


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


class KVAdoptTimeoutError(GetTimeoutError):
    """``kv_transfer.adopt_kv`` could not resolve the handoff KV refs within
    ``serve_kv_adopt_timeout_s``: the prefill replica that owns them is
    likely dead. Typed so the disaggregated router re-runs prefill on
    another replica instead of failing the request; a ``GetTimeoutError``,
    as the reference's is."""

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
