"""Binary entity IDs for the ray_tpu_torch control plane.

The binary layout follows the reference framework's ID specification
(reference: src/ray/design_docs/id_specification.md, src/ray/common/id.h):

    JobID     4 bytes   monotonically assigned by the GCS
    ActorID  16 bytes   = 12 random bytes || JobID(4)
    TaskID   24 bytes   = 8 unique bytes  || ActorID(16)
    ObjectID 28 bytes   = TaskID(24) || little-endian u32 index

Embedding the parent ID in the suffix means the job / actor / owning task of
any object can be recovered without a directory lookup — the property the
scheduler and reference counter rely on.  The implementation here is
original (pure Python, no code taken from the reference).
"""

from __future__ import annotations

import os
import struct
import threading

# Entropy for ID minting is drawn from a refilled PER-THREAD buffer: one
# urandom syscall per ~2048 IDs and no lock per ID (ID creation is on
# the task submission hot path — the old shared buffer's lock was a
# measurable tower in the r08/r09 driver submit profiles; reference ids
# are likewise cheap random bytes).
_ENTROPY_CHUNK = 65536
_entropy_local = threading.local()
# Fork generation: a forked child must not replay any thread's buffered
# entropy — identical ID streams would collide across the processes.
# Bumping the generation invalidates every thread-local buffer at once.
_fork_gen = 0


def _rand_bytes(n: int) -> bytes:
    loc = _entropy_local
    try:
        if loc.gen != _fork_gen:
            raise AttributeError
        buf, off = loc.buf, loc.off
    except AttributeError:
        buf = os.urandom(_ENTROPY_CHUNK)
        off = 0
        loc.buf, loc.gen = buf, _fork_gen
    end = off + n
    if end > len(buf):
        buf = loc.buf = os.urandom(_ENTROPY_CHUNK)
        off, end = 0, n
    loc.off = end
    return buf[off:end]


def _discard_entropy_after_fork() -> None:
    global _fork_gen
    _fork_gen += 1


os.register_at_fork(after_in_child=_discard_entropy_after_fork)


JOB_ID_SIZE = 4
ACTOR_ID_SIZE = 16
TASK_ID_SIZE = 24
OBJECT_ID_SIZE = 28
NODE_ID_SIZE = 28
WORKER_ID_SIZE = 28
PLACEMENT_GROUP_ID_SIZE = 18
_ACTOR_UNIQUE_BYTES = ACTOR_ID_SIZE - JOB_ID_SIZE
_TASK_UNIQUE_BYTES = TASK_ID_SIZE - ACTOR_ID_SIZE


class BaseID:
    """An immutable fixed-width binary identifier."""

    SIZE = 0
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, "
                f"got {len(id_bytes)}"
            )
        self._bytes = bytes(id_bytes)
        # Hash lazily: id minting is on the task-submission hot path and
        # most ids (return ids in flight, parsed peers) are never used
        # as dict keys in this process.
        self._hash = None

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(_rand_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self) -> int:
        h = self._hash
        if h is None:
            h = self._hash = hash(self._bytes)
        return h

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other) -> bool:
        return self._bytes < other._bytes

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = JOB_ID_SIZE

    _counter_lock = threading.Lock()
    _counter = 0

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(struct.pack("<I", value))

    def int_value(self) -> int:
        return struct.unpack("<I", self._bytes)[0]

    @classmethod
    def next(cls) -> "JobID":
        """Process-local monotonic job id (the GCS assigns the real ones)."""
        with cls._counter_lock:
            cls._counter += 1
            return cls.from_int(cls._counter)


class ActorID(BaseID):
    SIZE = ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(_rand_bytes(_ACTOR_UNIQUE_BYTES) + job_id.binary())

    _nil_cache: dict = {}

    @classmethod
    def nil_for_job(cls, job_id: JobID) -> "ActorID":
        """The placeholder actor id embedded in non-actor task ids
        (cached per job: this runs once per task submission)."""
        key = job_id.binary()
        cached = cls._nil_cache.get(key)
        if cached is None:
            cached = cls._nil_cache[key] = cls(
                b"\xff" * _ACTOR_UNIQUE_BYTES + key)
        return cached

    def job_id(self) -> JobID:
        return JobID(self._bytes[_ACTOR_UNIQUE_BYTES:])


class TaskID(BaseID):
    SIZE = TASK_ID_SIZE

    @classmethod
    def for_task(cls, job_id: JobID) -> "TaskID":
        # Hot path (one per task submission): skip the constructor's
        # width check + defensive copy — both inputs are fixed-width by
        # construction.
        tid = cls.__new__(cls)
        tid._bytes = _rand_bytes(_TASK_UNIQUE_BYTES) \
            + ActorID.nil_for_job(job_id)._bytes
        tid._hash = None
        return tid

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(_rand_bytes(_TASK_UNIQUE_BYTES) + actor_id.binary())

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        # Actor creation tasks use the deterministic all-zero unique prefix so
        # they can be recovered from the actor id alone.
        return cls(b"\x00" * _TASK_UNIQUE_BYTES + actor_id.binary())

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[_TASK_UNIQUE_BYTES:])

    def job_id(self) -> JobID:
        return self.actor_id().job_id()


class ObjectID(BaseID):
    SIZE = OBJECT_ID_SIZE

    # Small return indices are the overwhelmingly common case; their
    # packed form is cached and the constructor's width check is skipped
    # (the input is task_id.binary() + 4 bytes by construction).
    _IDX_PACKED = tuple(struct.pack("<I", i) for i in range(64))

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        if not 0 <= index < 2**32:
            raise ValueError(f"return index out of range: {index}")
        packed = cls._IDX_PACKED[index] if index < 64 \
            else struct.pack("<I", index)
        oid = cls.__new__(cls)
        oid._bytes = task_id._bytes + packed
        oid._hash = None
        return oid

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Puts share the task-id prefix; the high bit of the index marks them
        # as puts so return ids never collide with put ids.
        return cls(task_id.binary() + struct.pack("<I", put_index | 0x80000000))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:TASK_ID_SIZE])

    def index(self) -> int:
        return struct.unpack("<I", self._bytes[TASK_ID_SIZE:])[0]

    def is_put(self) -> bool:
        return bool(self.index() & 0x80000000)

    def job_id(self) -> JobID:
        return self.task_id().job_id()


class NodeID(BaseID):
    SIZE = NODE_ID_SIZE


class WorkerID(BaseID):
    SIZE = WORKER_ID_SIZE


class PlacementGroupID(BaseID):
    SIZE = PLACEMENT_GROUP_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(_rand_bytes(cls.SIZE - JOB_ID_SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[self.SIZE - JOB_ID_SIZE :])
