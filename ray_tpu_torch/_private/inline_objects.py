"""In-band small-object return tables (the worker-turnaround fast path).

Role-equivalent to the reference core worker's in-band small returns
(reference: src/ray/core_worker/task_manager.cc — returns at or below
``max_direct_call_object_size`` ride the reply as ``ReturnObject.data``;
only larger objects are put in plasma). Here the split is:

- **Producer (worker)**: a result whose framed serialization is OOB-free
  and at or under ``worker_inline_return_max`` skips the plasma put and
  ships as a raw blob inside the completion message (worker_main.py
  ``_store_returns``) — a nop task touches the store zero times.
- **Driver** (``InlineCache``): lease-path completions deliver the blob
  straight to the submitting driver, which holds it in a byte-bounded
  LRU that backs ``get()`` / ``deserialize_args`` directly. Eviction is
  safe: by then the GCS table (flushed on the lease report cadence) is
  the authoritative copy and the normal directory path serves a miss.
- **GCS** (``InlineTable``): the cluster-visible copy, per-job bounded
  at ``gcs_inline_table_bytes``. Other clients resolve inline objects
  through ``object_locations`` (the reply carries the blob); table
  pressure MATERIALIZES the oldest entries of the over-budget job into
  a node's store (``store_inline_objects``) — the entry is dropped only
  once the store copy's ``add_object_locations`` confirms, so a reader
  can never observe the object in neither place.

Both containers are lock-leaf (they take no other lock while holding
their own), so they can be used under the GCS object shard and inside
lease completion handlers without ordering concerns.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

# Pseudo node id under which the GCS object directory lists an object
# whose only copy is the GCS inline table. Never a real node id (real
# ids are hex), so routing paths that resolve directory entries against
# ``_nodes`` simply skip it; readiness checks (``wait_for_objects``,
# dep-parking) see a non-empty location set and proceed.
INLINE_LOCATION = "::inline"


def eligible(sobj, limit: int) -> bool:
    """True when a SerializedObject may travel in-band: OOB-free only —
    pickle-5 out-of-band buffers (numpy, staged device arrays) always
    take the store path — and framed size at or under ``limit``."""
    return (limit > 0 and not sobj.buffers
            and getattr(sobj, "device_bytes", 0) == 0
            and sobj.total_size() <= limit)


class InlineCache:
    """Byte-bounded LRU of oid -> framed blob (one per CoreWorker).

    Holds inline results delivered to this process (lease completions,
    ``object_locations`` replies) so ``get()`` never round-trips the
    store — or anything else — for bytes already in hand. A miss is
    never an error: the GCS table / store path serves it.
    """

    def __init__(self, max_bytes: int):
        self._max = max(0, int(max_bytes))
        self._lock = threading.Lock()
        self._ent: "collections.OrderedDict[bytes, bytes]" = \
            collections.OrderedDict()
        self._bytes = 0

    def put(self, oid: bytes, blob: bytes) -> None:
        if self._max <= 0:
            return
        with self._lock:
            old = self._ent.pop(oid, None)
            if old is not None:
                self._bytes -= len(old)
            self._ent[oid] = blob
            self._bytes += len(blob)
            # Never evict the entry just inserted (len > 1): a cache
            # smaller than one blob still serves the get() in progress.
            while self._bytes > self._max and len(self._ent) > 1:
                _, dropped = self._ent.popitem(last=False)
                self._bytes -= len(dropped)

    def get(self, oid: bytes) -> Optional[bytes]:
        with self._lock:
            blob = self._ent.get(oid)
            if blob is not None:
                self._ent.move_to_end(oid)
            return blob

    def __contains__(self, oid: bytes) -> bool:
        # Lock-free membership probe (GIL-atomic dict read): this sits
        # on get()/wait() readiness checks, and staleness only costs
        # the caller the always-correct slow path.
        return oid in self._ent

    def pop(self, oid: bytes) -> Optional[bytes]:
        with self._lock:
            blob = self._ent.pop(oid, None)
            if blob is not None:
                self._bytes -= len(blob)
            return blob


class InlineTable:
    """The GCS-side inline-object table: oid -> (blob, job, node_id),
    insertion-ordered, per-job byte-bounded.

    ``insert`` returns the entries the insertion pushed over the job's
    budget — the caller ships them to a node manager for store
    materialization (``store_inline_objects``) and calls ``drop`` only
    when the store copy's location report lands (keep-until-confirmed:
    a reader can never find the object in neither place). Entries
    pending materialization are excluded from re-selection for
    ``spill_retry_s`` so a lost notify (NM death) is re-sent rather
    than leaked.

    Lock-leaf; callers typically already hold the GCS object shard.
    """

    SPILL_RETRY_S = 5.0

    def __init__(self, per_job_bytes: int):
        self._budget = max(0, int(per_job_bytes))
        self._lock = threading.Lock()
        # oid -> (blob, job_key, producer_node_id)
        self._ent: Dict[bytes, tuple] = {}
        # job -> insertion-ordered oid set: bounds every pressure scan
        # to the over-budget job's own entries (a single shared order
        # would make each insert under pressure O(whole table) inside
        # the GCS object-shard critical section).
        self._job_order: Dict[bytes, "collections.OrderedDict"] = {}
        self._job_bytes: Dict[bytes, int] = collections.defaultdict(int)
        self._spilling: Dict[bytes, float] = {}

    def insert(self, oid: bytes, blob: bytes, job: bytes,
               node_id: str) -> List[Tuple[bytes, bytes, str]]:
        """Insert (idempotent) and return [(oid, blob, node_id), ...]
        entries that must materialize to a store to honor the job's
        byte budget (the oldest entries of THAT job, this one included
        if it alone exceeds the budget)."""
        with self._lock:
            if oid in self._ent:
                return []   # duplicate delivery (retry / redelivery)
            self._ent[oid] = (blob, job, node_id)
            self._job_order.setdefault(
                job, collections.OrderedDict())[oid] = None
            self._job_bytes[job] += len(blob)
            return self._select_spills_locked(job, time.monotonic())

    def _select_spills_locked(self, job: bytes,
                              now: float) -> List[Tuple[bytes, bytes,
                                                        str]]:
        """Oldest entries of ``job`` that must materialize to bring it
        back under budget (in-flight spills within SPILL_RETRY_S count
        as freed but are not re-sent). Caller holds the table lock."""
        if self._budget <= 0:
            return []
        over = self._job_bytes.get(job, 0) - self._budget
        if over <= 0:
            return []
        out: List[Tuple[bytes, bytes, str]] = []
        freed = 0
        for o in self._job_order.get(job, ()):
            if freed >= over:
                break
            b, _j, n = self._ent[o]
            ts = self._spilling.get(o)
            if ts is not None and now - ts < self.SPILL_RETRY_S:
                freed += len(b)   # already in flight: counts
                continue
            self._spilling[o] = now
            out.append((o, b, n))
            freed += len(b)
        return out

    def pressure_spills(self) -> List[Tuple[bytes, bytes, str]]:
        """Re-select spills for every over-budget job — the periodic
        retry sweep for store_inline_objects notifies lost to NM death
        or send failure (insert() only re-selects when the SAME job
        inserts again; a job that stopped producing would otherwise
        hold its over-budget bytes forever)."""
        now = time.monotonic()
        with self._lock:
            out: List[Tuple[bytes, bytes, str]] = []
            for job in list(self._job_order):
                out.extend(self._select_spills_locked(job, now))
            return out

    def get(self, oid: bytes) -> Optional[bytes]:
        with self._lock:
            ent = self._ent.get(oid)
            return ent[0] if ent is not None else None

    def note_spill_target(self, oid: bytes, node_id: str) -> bool:
        """Record the node a spill was ACTUALLY sent to (the producer
        may be dead and the send re-targeted to another live node):
        retries and free-tombstones must name the node the store-copy
        confirm will come from. True if the entry still exists."""
        with self._lock:
            ent = self._ent.get(oid)
            if ent is None:
                return False
            self._ent[oid] = (ent[0], ent[1], node_id)
            return True

    def spill_inflight(self, oid: bytes) -> Optional[str]:
        """The node id a store_inline_objects materialization of ``oid``
        may be in flight to (selected for spill, confirm not landed) —
        None otherwise. Lets free() tombstone the oid so the late
        confirm report is answered with a delete instead of
        resurrecting a freed object."""
        with self._lock:
            if oid in self._spilling:
                ent = self._ent.get(oid)
                if ent is not None:
                    return ent[2]
            return None

    def __contains__(self, oid: bytes) -> bool:
        # Lock-free membership probe (GIL-atomic dict read); callers on
        # the location-add hot path use it to skip the locked ops when
        # the table has no entry for the oid.
        return oid in self._ent

    def drop(self, oid: bytes) -> bool:
        """Remove an entry (store copy confirmed, or the object was
        freed). Returns True if it existed."""
        with self._lock:
            ent = self._ent.pop(oid, None)
            if ent is None:
                return False
            blob, job, _node = ent
            self._spilling.pop(oid, None)
            order = self._job_order.get(job)
            if order is not None:
                order.pop(oid, None)
                if not order:
                    del self._job_order[job]
            left = self._job_bytes.get(job, 0) - len(blob)
            if left > 0:
                self._job_bytes[job] = left
            else:
                self._job_bytes.pop(job, None)
            return True

    def stats(self) -> Tuple[int, int]:
        with self._lock:
            return len(self._ent), sum(self._job_bytes.values())
