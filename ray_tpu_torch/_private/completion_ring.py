"""Shared-memory completion transport into a same-node driver.

Two producer families feed a driver's completion ingestion without a
socket on the hot path:

1. The NM relay (SCALE_r10 stage 2): the node manager relays each
   classic-path worker ``task_done_batch`` record blob into the
   driver's main ring AS WELL AS to the GCS (the socket path stays
   authoritative). Role inversion relative to ``submit_ring``: here
   the DRIVER is the consumer — it creates the ring file, owns the
   doorbell socket, and beats the heartbeat — while the NM is the
   producer that maps the existing file and appends.

2. Worker segments: a same-node LEASED worker appends its
   lease-completion record blobs directly into a per-worker SPSC
   SEGMENT alongside the driver's main ring, skipping its holder conn
   entirely. The segment is a separate file (``<ring>.w<pid>_<n>``)
   the WORKER creates after the driver advertises its ring over the
   lease conn; the driver maps it (SegmentConsumer), acks, and drains
   it from the same consumer thread that drains the main ring. The
   segments share the main ring's doorbell — the worker's producer
   dials ``<ring>.bell`` — so one park covers every producer, and the
   driver flags each segment parked around its main-ring park.

Lifecycle rules (both families; the creation-ownership rule is the
``shm_ring`` default):

- ring full     -> the producer skips the append; the NM's GCS relay
  (family 1) or the worker's socket ``lease_tasks_done_b`` fallback
  (family 2) delivers the record, and a counter records the miss;
- driver death  -> the consumer heartbeat goes stale; the producer
  tears its mapping down (conn close is the prompt path, staleness
  the backstop for a wedged driver);
- producer death-> records already in the ring/segment are still
  valid shared memory; the driver keeps draining them, and delivery
  stays at-least-once because every absorb step is
  redelivery-idempotent;
- teardown      -> the NM producer never unlinks (the driver owns the
  main ring); a worker unlinks its OWN segment on graceful close, and
  the driver force-unlinks mapped segments on detach so a SIGKILLed
  worker cannot leak one (double-unlink is idempotent).

Doorbell, park bound, and memory-model caveats live in ``shm_ring``:
payload-before-tail relies on x86-64 TSO store-store ordering, so
rings and segments are only enabled on x86-64.
"""

from __future__ import annotations

from ray_tpu_torch._private import shm_ring

MAGIC = b"RTCOMPR1"
SEG_MAGIC = b"RTWSEGR1"
HDR_SIZE = shm_ring.HDR_SIZE
PARK_TIMEOUT_S = shm_ring.PARK_TIMEOUT_S


class RingConsumer(shm_ring.Consumer):
    """Driver side of the main ring: creates the ring file, owns the
    doorbell socket, beats the consumer heartbeat the producers watch
    for liveness. close() unlinks both files (creation ownership)."""

    def __init__(self, path: str, capacity: int):
        super().__init__(path, MAGIC, create=True, capacity=capacity,
                         kind="completion ring")


class RingProducer(shm_ring.Producer):
    """NM side of the main ring: maps the driver-created ring and
    appends record blobs. Appends come from any worker-conn serve
    thread; the core's lock serializes them into the single logical
    producer the layout requires. close() never unlinks — the driver
    owns the file and removes it on disconnect."""

    def __init__(self, path: str):
        super().__init__(path, MAGIC, kind="completion ring")


class SegmentProducer(shm_ring.Producer):
    """Worker side of a completion segment: creates its own segment
    file next to the driver's advertised ring and dials the driver's
    MAIN ring bell (shared doorbell). Declines every append until the
    driver maps the segment and acks (``active``) — until then, and
    whenever the segment is full or the consumer heartbeat goes stale,
    completions fall back to the socket ``lease_tasks_done_b`` path.
    close() unlinks the worker-created file (the driver's force-unlink
    on detach makes the remove idempotent from either side)."""

    def __init__(self, path: str, capacity: int, bell_path: str):
        super().__init__(path, SEG_MAGIC, create=True, capacity=capacity,
                         bell_path=bell_path, active=False,
                         kind="completion segment")


class SegmentConsumer(shm_ring.Consumer):
    """Driver side of a completion segment: maps the worker-created
    file. No bell of its own — the main ring's bell wakes the shared
    consumer thread, which flags this segment parked around its park
    (``set_parked``) so the producer knows when to ring. Detach calls
    close(unlink=True): the driver force-removes segments so a
    SIGKILLed worker cannot leak one."""

    def __init__(self, path: str):
        super().__init__(path, SEG_MAGIC, bind_bell=False,
                         kind="completion segment")
