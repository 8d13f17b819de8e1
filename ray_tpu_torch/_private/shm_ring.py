"""Shared SPSC mmap byte-ring core for the shm transports.

One tested implementation of the ring substrate that ``submit_ring``
(driver -> same-node NM), ``completion_ring`` (NM -> same-node driver)
and the worker completion segments (worker -> same-node driver) are
thin role wrappers over. The three transports differ only in who
creates the file, who owns the doorbell, and what the magic is — the
layout, the publication protocol, the park/bell discipline and the
liveness rules are identical, and before this module existed they were
~320 lines of near-twin code per transport.

Layout (offsets in bytes; all fields little-endian u64 unless noted):
    0   magic (8 bytes, per-transport)
    8   data capacity
    16  tail (producer cursor, monotonically increasing)
    24  head (consumer cursor)
    32  consumer parked flag
    40  producer closed flag
    48  consumer heartbeat (f64 CLOCK_MONOTONIC seconds)
    64  data region (byte ring of [u32 length][payload] records)

Roles and ownership:

- The CONSUMER always beats the heartbeat and (usually) owns the
  doorbell socket bound at ``bell_path`` (default ``path + ".bell"``);
  the producer dials it. A consumer mapped with ``bind_bell=False``
  shares some other ring's bell (the worker segments share the
  driver's main completion-ring bell — one park covers N producers).
- ``close()`` unlinks the ring file if and only if this end CREATED
  it (ownership follows creation); a bound bell socket is always
  unlinked by its consumer. Callers may override with ``unlink=``
  for cross-owner cleanup (idempotent: ENOENT is ignored).
- Delivery is at-least-once: ``drain()`` never advances the shared
  head; the caller ``commit()``s only after the records are absorbed,
  and every absorber in the tree is redelivery-idempotent.

Doorbell discipline (futex-style): while the consumer is actively
draining, a producer append is pure memcpy + one 8-byte tail publish —
no syscall. Only when the consumer has parked itself (flag in the
header) does the producer poke a tiny AF_UNIX datagram doorbell. The
consumer's park is additionally bounded (PARK_TIMEOUT_S recv timeout)
so the classic parked-flag/tail store-load race (x86 TSO gives no
store-load ordering) costs at worst one bounded timeout, never a lost
wakeup.

Memory model: the payload-before-tail publication depends on
STORE-STORE ordering, which pure-Python mmap writes cannot fence —
x86-64 TSO provides it; weaker models (arm64) do not, so every ring
user gates itself on x86-64.
"""

from __future__ import annotations

import mmap
import os
import socket
import struct
import threading
import time
from typing import List, Optional, Tuple

HDR_SIZE = 64
_OFF_CAPACITY = 8
_OFF_TAIL = 16
_OFF_HEAD = 24
_OFF_PARKED = 32
_OFF_CLOSED = 40
_OFF_BEAT = 48

_U64 = struct.Struct("<Q")
_F64 = struct.Struct("<d")
_LEN = struct.Struct("<I")

# Consumer park bound: also the worst-case delivery delay added by the
# parked-flag/tail publication race (no cross-process fence in pure
# Python; see module docstring).
PARK_TIMEOUT_S = 0.1


class _Mapped:
    """Shared mmap plumbing for both ends."""

    def __init__(self, path: str, magic: bytes, create: bool,
                 capacity: int = 0, kind: str = "shm ring"):
        self.path = path
        self.created = create
        if create:
            fd = os.open(path, os.O_CREAT | os.O_TRUNC | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, HDR_SIZE + capacity)
                self._mm = mmap.mmap(fd, HDR_SIZE + capacity)
            finally:
                os.close(fd)
            self._mm[0:8] = magic
            self._mm[_OFF_CAPACITY:_OFF_CAPACITY + 8] = _U64.pack(capacity)
            self.capacity = capacity
        else:
            fd = os.open(path, os.O_RDWR)
            try:
                size = os.fstat(fd).st_size
                self._mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
            if self._mm[0:8] != magic:
                self._mm.close()
                raise ValueError(f"not a {kind}: {path}")
            self.capacity = _U64.unpack(
                self._mm[_OFF_CAPACITY:_OFF_CAPACITY + 8])[0]

    def _get(self, off: int) -> int:
        return _U64.unpack_from(self._mm, off)[0]

    def _put(self, off: int, val: int) -> None:
        _U64.pack_into(self._mm, off, val)

    def _read_data(self, pos: int, n: int) -> bytes:
        """Wrap-aware read of n bytes at ring position pos."""
        cap = self.capacity
        i = pos % cap
        if i + n <= cap:
            return bytes(self._mm[HDR_SIZE + i:HDR_SIZE + i + n])
        first = cap - i
        return bytes(self._mm[HDR_SIZE + i:HDR_SIZE + cap]) + \
            bytes(self._mm[HDR_SIZE:HDR_SIZE + n - first])

    def _write_data(self, pos: int, data: bytes) -> None:
        cap = self.capacity
        i = pos % cap
        n = len(data)
        if i + n <= cap:
            self._mm[HDR_SIZE + i:HDR_SIZE + i + n] = data
        else:
            first = cap - i
            self._mm[HDR_SIZE + i:HDR_SIZE + cap] = data[:first]
            self._mm[HDR_SIZE:HDR_SIZE + n - first] = data[first:]

    def close_map(self) -> None:
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass

    def _unlink_ring(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


class Producer(_Mapped):
    """The appending end. Appends may come from any thread (worker
    serve threads, driver user threads); the lock serializes them into
    the single logical producer the layout requires."""

    # Bell sends are rate-limited: under a sustained flood the consumer
    # re-parks between GIL slices and a naive producer would pay one
    # syscall per append (~9% of the submit hot path in the r09
    # profile). Suppression only applies under a deep backlog (see
    # append), where the flood's next append past the window rings; a
    # burst's final records always ring, so no record waits out the
    # bounded park for lack of a bell.
    BELL_MIN_INTERVAL_S = 0.005

    def __init__(self, path: str, magic: bytes, *, create: bool = False,
                 capacity: int = 0, bell_path: Optional[str] = None,
                 active: bool = True, kind: str = "shm ring"):
        super().__init__(path, magic, create, capacity, kind)
        # A producer mapping an EXISTING file resumes at the published
        # tail (0 for a fresh ring either way).
        self._tail = self._get(_OFF_TAIL)
        self._lock = threading.Lock()
        self._bell: Optional[socket.socket] = None
        self._bell_path = bell_path if bell_path is not None \
            else path + ".bell"
        self._last_bell = 0.0
        # Gated producers (``active=False``) decline every append until
        # the attach handshake completes — the submit ring arms after
        # the NM ack, the worker segments after the driver maps them.
        self.active = active
        self.dead = False

    def connect_bell(self) -> None:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        s.setblocking(False)
        s.connect(self._bell_path)
        self._bell = s

    def append(self, blob: bytes) -> bool:
        """One record in, or False on ring-full / inactive / dead ring.
        A False is never a failure: every caller has a socket path the
        record falls back to."""
        n = _LEN.size + len(blob)
        with self._lock:
            if self.dead or not self.active:
                return False
            head = self._get(_OFF_HEAD)
            if self.capacity - (self._tail - head) < n:
                return False
            self._write_data(self._tail, _LEN.pack(len(blob)) + blob)
            # Publish AFTER the payload bytes: the consumer loads tail
            # first, so it can never read an unwritten record.
            self._tail += n
            self._put(_OFF_TAIL, self._tail)
            parked = self._get(_OFF_PARKED)
            backlog = self._tail - head
        if parked:
            # Rate-limit only under a DEEP backlog (a flood guarantees
            # more appends, one of which passes the window). A shallow
            # backlog may be the last record of a burst — suppressing
            # its bell would strand it for the full bounded park.
            now = time.monotonic()
            if backlog <= 4096 \
                    or now - self._last_bell >= self.BELL_MIN_INTERVAL_S:
                self._last_bell = now
                self._ring_bell()
        return True

    def append_batch(self, blobs: List[bytes]) -> int:
        """Append a FLUSH BATCH of records with at most ONE doorbell.

        Same publication protocol as ``append`` — payload bytes first,
        then one tail publish covering the whole batch — but the parked
        check and bell write happen once per flush instead of once per
        record (the remaining worker return-path tower in PROFILE_r12:
        a parked driver cost one ``os.write`` per completion). Returns
        the number of LEADING records appended; a short count means the
        ring filled and the caller falls back to its socket path for
        the rest (a partial batch is still fully published)."""
        done = 0
        with self._lock:
            if self.dead or not self.active:
                return 0
            head = self._get(_OFF_HEAD)
            tail = self._tail
            for blob in blobs:
                n = _LEN.size + len(blob)
                if self.capacity - (tail - head) < n:
                    break
                self._write_data(tail, _LEN.pack(len(blob)) + blob)
                tail += n
                done += 1
            if not done:
                return 0
            # Publish AFTER every payload of the batch: the consumer
            # loads tail first, so it can never read an unwritten
            # record — and sees the whole batch at one load.
            self._tail = tail
            self._put(_OFF_TAIL, self._tail)
            parked = self._get(_OFF_PARKED)
            backlog = self._tail - head
        if parked:
            now = time.monotonic()
            if backlog <= 4096 \
                    or now - self._last_bell >= self.BELL_MIN_INTERVAL_S:
                self._last_bell = now
                self._ring_bell()
        return done

    def _ring_bell(self) -> None:
        s = self._bell
        if s is None:
            return
        try:
            s.send(b"!")
        except (BlockingIOError, OSError):
            pass   # a wakeup is already pending, or the consumer is gone
        # (either way the bounded park covers it)

    def consumer_stale(self, budget_s: float) -> bool:
        """True when records are pending but the consumer heartbeat has
        not moved for budget_s — the consuming process (or its drain
        thread) is gone and this ring should be torn down."""
        if self.dead or not self.active:
            return False
        with self._lock:
            pending = self._tail > self._get(_OFF_HEAD)
        if not pending:
            return False
        beat = _F64.unpack_from(self._mm, _OFF_BEAT)[0]
        return (time.monotonic() - beat) > budget_s

    def recover_unconsumed(self) -> List[bytes]:
        """Mark the ring dead and return every record past the consumer
        head, for resubmission over the socket path."""
        out: List[bytes] = []
        with self._lock:
            self.dead = True
            pos = self._get(_OFF_HEAD)
            while pos < self._tail:
                (n,) = _LEN.unpack(self._read_data(pos, _LEN.size))
                out.append(self._read_data(pos + _LEN.size, n))
                pos += _LEN.size + n
        return out

    def close(self, unlink: Optional[bool] = None) -> None:
        """Producer teardown: flag closed, wake the consumer so it
        observes the flag, unmap. Unlinks the ring file only when this
        end created it (default) — a mapping producer's consumer owns
        the file and removes it on disconnect."""
        with self._lock:
            self.dead = True
            try:
                self._put(_OFF_CLOSED, 1)
            except (ValueError, IndexError):
                pass
        self._ring_bell()
        if self._bell is not None:
            try:
                self._bell.close()
            except OSError:
                pass
        self.close_map()
        if self.created if unlink is None else unlink:
            self._unlink_ring()


class Consumer(_Mapped):
    """The draining end: beats the heartbeat the producer watches for
    liveness, and (unless ``bind_bell=False``) owns the doorbell
    socket parked on when idle."""

    def __init__(self, path: str, magic: bytes, *, create: bool = False,
                 capacity: int = 0, bind_bell: bool = True,
                 kind: str = "shm ring"):
        super().__init__(path, magic, create, capacity, kind)
        self._head = self._get(_OFF_HEAD)
        self._bell: Optional[socket.socket] = None
        if bind_bell:
            bell = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
            try:
                os.unlink(path + ".bell")
            except FileNotFoundError:
                pass
            bell.bind(path + ".bell")
            bell.settimeout(PARK_TIMEOUT_S)
            self._bell = bell
        self.stopped = False
        # First heartbeat at creation/map time: the producer's
        # staleness check must never see a zero beat between the attach
        # handshake and the consumer thread's first loop.
        self.beat()

    def beat(self) -> None:
        _F64.pack_into(self._mm, _OFF_BEAT, time.monotonic())

    def producer_closed(self) -> bool:
        return bool(self._get(_OFF_CLOSED))

    def pending(self) -> bool:
        return self._get(_OFF_TAIL) > self._head

    def backlog_bytes(self) -> int:
        return max(0, self._get(_OFF_TAIL) - self._head)

    def drain(self, max_records: int = 512) -> Tuple[List[bytes], int]:
        """Read up to max_records pending records WITHOUT advancing the
        shared head. Returns (blobs, new_head); the caller commits the
        head only after the records are absorbed (at-least-once — every
        absorb step is redelivery-idempotent)."""
        tail = self._get(_OFF_TAIL)
        pos = self._head
        out: List[bytes] = []
        while pos < tail and len(out) < max_records:
            (n,) = _LEN.unpack(self._read_data(pos, _LEN.size))
            out.append(self._read_data(pos + _LEN.size, n))
            pos += _LEN.size + n
        return out, pos

    def commit(self, new_head: int) -> None:
        self._head = new_head
        self._put(_OFF_HEAD, new_head)

    def set_parked(self, parked: bool) -> None:
        """Expose the parked flag for consumers that park on a SHARED
        bell (the driver flags each worker segment parked around its
        main-ring park, so segment producers know when to ring)."""
        self._put(_OFF_PARKED, 1 if parked else 0)

    def park_wait(self) -> None:
        """Park until a producer rings the bell (bounded; see
        PARK_TIMEOUT_S). Caller re-checks the ring either way."""
        self._put(_OFF_PARKED, 1)
        try:
            # Lost-wakeup guard: a record published between our last
            # drain and the flag store is caught by this re-check; the
            # bounded recv covers the symmetric store-load race.
            if self._get(_OFF_TAIL) > self._head:
                return
            if self._bell is None:
                # Bell-less consumer (shared-bell segment): the owner
                # of the shared bell parks for us; this path only runs
                # if a caller parks a segment directly.
                time.sleep(PARK_TIMEOUT_S)
                return
            try:
                # raylint: disable-next=unbounded-wait (bounded: the
                # socket carries a PARK_TIMEOUT_S settimeout set at
                # construction)
                self._bell.recv(64)
            except socket.timeout:
                pass
            except OSError:
                time.sleep(PARK_TIMEOUT_S)
        finally:
            self._put(_OFF_PARKED, 0)

    def close(self, unlink: Optional[bool] = None) -> None:
        """Consumer teardown: a bound bell is always closed + unlinked
        (its binder owns it); the ring file is unlinked when this end
        created it (default), or per the ``unlink`` override — the
        driver force-unlinks worker-created segments so a SIGKILLed
        worker cannot leak one."""
        self.stopped = True
        if self._bell is not None:
            try:
                self._bell.close()
            except OSError:
                pass
            try:
                os.unlink(self.path + ".bell")
            except OSError:
                pass
        self.close_map()
        if self.created if unlink is None else unlink:
            self._unlink_ring()
