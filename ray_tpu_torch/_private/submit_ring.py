"""Shared-memory submit ring: driver -> same-node node manager.

The third stage of the SCALE_r08 submit-ceiling attack: for a driver
whose node manager is reachable on the same box, dep-free classic-path
submissions stop being socket frames at all. The driver appends
template-patched spec blobs into a per-client SPSC byte ring in a
mmapped session file; the NM drains the ring and relays the raw blobs
to the GCS in ``submit_task_batch`` frames (it never unpickles them).
The arena-slab store proved the mmap substrate; this is the
control-plane twin.

The ring substrate itself (layout, publication protocol, doorbell
discipline, liveness rules, memory-model caveats) lives in
``shm_ring`` — this module only binds the submit-transport roles:

- the DRIVER creates the file and dials the doorbell (RingWriter); it
  arms only after the NM acks registration (``active``);
- the NM maps the existing file, owns the doorbell, and beats the
  heartbeat (RingReader);
- ring full -> the writer declines (caller falls back to the socket
  batch path; driver_submit_ring_full_total counts it);
- NM death  -> the consumer heartbeat goes stale; the driver recovers
  every unconsumed record (``recover_unconsumed``) and resubmits it
  over the socket. The consumer advances the head only AFTER its GCS
  relay returns, so recovery is at-least-once — the GCS submit-batch
  handler dedups on task id (specs are retained by id at submit);
- teardown    -> the writer created the file, so its close() unlinks
  it; the reader's close() only unlinks the bell it bound.
"""

from __future__ import annotations

from ray_tpu_torch._private import shm_ring

MAGIC = b"RTSUBMR1"
HDR_SIZE = shm_ring.HDR_SIZE
PARK_TIMEOUT_S = shm_ring.PARK_TIMEOUT_S


class RingWriter(shm_ring.Producer):
    """Driver side: creates the ring file + dials the doorbell.
    Declines every append until registration is acked (``active``)."""

    def __init__(self, path: str, capacity: int):
        super().__init__(path, MAGIC, create=True, capacity=capacity,
                         active=False, kind="submit ring")


class RingReader(shm_ring.Consumer):
    """NM side: maps an existing ring, owns the doorbell socket."""

    def __init__(self, path: str):
        super().__init__(path, MAGIC, kind="submit ring")
