"""Length-framed socket RPC used by the control plane.

Role-equivalent to the reference's gRPC plumbing (reference: src/ray/rpc/
grpc_server.h:73, client_call.h:181): every control-plane process (GCS, node
manager, worker, driver) exchanges framed messages over TCP / Unix sockets.
A message is ``(msg_id, reply_to, mtype, payload, is_error)``; replies are
matched to outstanding request futures, everything else is handed to the
connection's handler.

The data plane (tensors) does NOT flow through here in the common case — it
lives in the shared-memory object store; this channel carries task specs,
scheduling decisions, and small control payloads (plus cross-node object
chunks, the analog of the reference's object-manager Push RPC).
"""

from __future__ import annotations

import collections
import io
import os
import pickle
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

_LEN = struct.Struct("<Q")
_MAX_FRAME = 1 << 34  # 16 GiB sanity bound

# Local-first scheduling message vocabulary (worker <-> node manager, plus
# the GCS -> node-manager fairness signal). Message types are plain strings
# on the wire; these constants keep the three parties (lease.py,
# node_manager.py, gcs.py) agreeing on the hybrid local-first/spillback
# protocol (reference: raylet/scheduling/policy/hybrid_scheduling_policy.h).
REQUEST_LOCAL_LEASE = "request_local_lease"    # caller -> own NM (request)
RETURN_LOCAL_LEASE = "return_local_lease"      # caller -> own NM (notify)
REVOKE_LOCAL_LEASE = "revoke_local_lease"      # GCS -> NM (fairness, notify)
REVOKE_LEASE = "revoke_lease"                  # NM/GCS -> holder (notify)
SCHEDULER_STATS = "scheduler_stats"            # any -> NM (request)
# Decentralized actor creation (the actor analog of the local-first task
# lease): the driver asks its OWN node manager to place the actor; the NM
# reports the placement to the GCS asynchronously. ACTOR_PLACED must be
# sent on the NM's GCS conn BEFORE any actor_state for the same actor —
# same-conn FIFO is the ordering guarantee the GCS relies on.
REQUEST_CREATE_ACTOR = "request_create_actor"  # driver -> own NM (request)
ACTOR_PLACED = "actor_placed"                  # NM -> GCS (notify)
# Driver completion ingestion fast path (SCALE_r10): workers ship lease
# completions as frames of pre-pickled per-record blobs (the completion
# twin of lease_run_tasks_b) so the driver's conn thread only parks raw
# bytes; drivers register a per-driver shm completion ring with their
# own node manager (the submit ring's return-path twin).
LEASE_TASKS_DONE_B = "lease_tasks_done_b"      # worker -> caller (notify)
REGISTER_COMPLETION_RING = "register_completion_ring"  # driver -> NM (request)
# Worker->driver shm completion segments: the driver
# advertises its completion ring over the lease conn at grant time; the
# worker creates a per-worker segment beside it and answers with the
# segment path; the driver maps it and acks — only then does the worker
# arm the segment (socket fallback until, and whenever the segment is
# full / the driver's heartbeat goes stale). The worker also mirrors
# attach/detach to its NM, whose registry reaps segment files a
# SIGKILLed worker (or a vanished driver) left behind.
ATTACH_COMPLETION_RING = "attach_completion_ring"        # caller -> worker
ATTACH_COMPLETION_SEGMENT = "attach_completion_segment"  # worker -> caller
ATTACH_COMPLETION_SEGMENT_ACK = \
    "attach_completion_segment_ack"                      # caller -> worker


class ConnectionClosed(Exception):
    pass


class RemoteCallError(Exception):
    """The peer's handler raised; message carries the remote traceback."""


def _recv_exact(sock: socket.socket, n: int, into: Optional[memoryview] = None):
    buf = into if into is not None else memoryview(bytearray(n))
    got = 0
    while got < n:
        try:
            # raylint: disable-next=unbounded-wait (dedicated reader
            # thread: blocking forever between frames IS the job; exit
            # is conn close, which aborts the recv with an OSError)
            k = sock.recv_into(buf[got:], n - got)
        except (ConnectionResetError, OSError):
            raise ConnectionClosed()
        if k == 0:
            raise ConnectionClosed()
        got += k
    return buf


class Conn:
    """One bidirectional connection with request/reply multiplexing."""

    def __init__(self, sock: socket.socket, handler=None, name: str = ""):
        self._sock = sock
        self._handler = handler
        self._pending: Dict[int, "_Future"] = {}
        self._pending_lock = threading.Lock()
        self._next_id_lock = threading.Lock()
        self._next_id = 1
        self._closed = False
        # The socket fd is closed by the LAST thread that uses it (writer /
        # serve loop), never by close() itself: closing an fd while another
        # thread is blocked in recv/accept on it lets the OS recycle the fd
        # number for a brand-new socket, and the still-blocked syscall then
        # reads (or accepts) traffic that belongs to the new socket.
        self._fd_refs = 1  # the writer thread
        self._fd_lock = threading.Lock()
        self.name = name
        self.on_close: Optional[Callable[["Conn"], None]] = None
        # peer-assigned metadata, used by servers to track who this is
        self.meta: Dict[str, Any] = {}
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # unix sockets
        # Sends go through a dedicated writer thread so a handler running on
        # a receive loop never blocks on a full socket buffer (two peers both
        # blocked in send() with full buffers = distributed deadlock; the
        # reference avoids it with asio async writes, common/asio/).
        self._send_q: collections.deque = collections.deque()
        self._send_ev = threading.Event()
        self._send_inflight = False
        self._send_bytes = 0
        self._send_cv = threading.Condition()
        # Serializes actual socket writes between the writer thread and
        # the inline fast path in _send (frames must never interleave).
        self._write_lock = threading.Lock()
        self._writer = threading.Thread(
            target=self._write_loop, daemon=True, name=f"rtpu-send-{name}")
        self._writer.start()

    # Backpressure bound: senders block (briefly) once this much data is
    # queued, so a wedged peer surfaces as slowness + eventual error rather
    # than unbounded sender memory. Kept high enough that only bulk object
    # transfer can hit it — control messages never will.
    MAX_QUEUED_BYTES = 256 * 1024 * 1024
    QUEUE_FULL_TIMEOUT = 60.0

    # -- sending --------------------------------------------------------------

    def _alloc_id(self) -> int:
        with self._next_id_lock:
            i = self._next_id
            self._next_id += 1
            return i

    # Control frames at or under this size try a non-blocking inline
    # write from the calling thread when the queue is idle — saving the
    # writer-thread wakeup that otherwise sits on every hot-path message
    # (task submit, lease result). Bulk frames always take the queue.
    INLINE_SEND_MAX = 64 * 1024

    def _send(self, msg_id, reply_to, mtype, payload, is_error=False):
        data = pickle.dumps((msg_id, reply_to, mtype, payload, is_error),
                            protocol=5)
        frame = _LEN.pack(len(data)) + data
        if self._closed:
            raise ConnectionClosed()
        # Fast path: empty queue + idle writer -> write inline.
        # MSG_DONTWAIT preserves the no-blocking-in-handlers guarantee
        # (two peers both blocked in send() with full buffers would be a
        # distributed deadlock): a full socket buffer falls through to
        # the queued path instead of blocking. A send error closes the
        # conn and drops the frame — exactly the queued path's fate.
        if len(frame) <= self.INLINE_SEND_MAX and not self._send_q \
                and self._write_lock.acquire(False):
            try:
                if not self._send_q and not self._closed \
                        and self._acquire_fd():
                    try:
                        sent = self._sock.send(frame, socket.MSG_DONTWAIT)
                    except (BlockingIOError, InterruptedError):
                        pass          # buffer full: queue it below
                    except OSError:
                        self.close()
                        return
                    else:
                        if sent == len(frame):
                            return
                        # Partial write: the remainder MUST go out before
                        # any other frame — front of the queue, while we
                        # still hold the write lock.
                        rest = frame[sent:]
                        with self._send_cv:
                            self._send_bytes += len(rest)
                        self._send_q.appendleft(rest)
                        self._send_ev.set()
                        return
                    finally:
                        self._release_fd()
            finally:
                self._write_lock.release()
        if self._send_bytes >= self.MAX_QUEUED_BYTES and \
                threading.current_thread() is not self._writer:
            with self._send_cv:
                ok = self._send_cv.wait_for(
                    lambda: self._closed
                    or self._send_bytes < self.MAX_QUEUED_BYTES,
                    timeout=self.QUEUE_FULL_TIMEOUT)
            if not ok or self._closed:
                raise ConnectionClosed()
        with self._send_cv:
            self._send_bytes += len(frame)
        self._send_q.append(frame)
        self._send_ev.set()

    def _acquire_fd(self) -> bool:
        with self._fd_lock:
            if self._fd_refs <= 0:
                return False  # fd already closed
            self._fd_refs += 1
            return True

    def _release_fd(self):
        with self._fd_lock:
            self._fd_refs -= 1
            last = self._fd_refs == 0
        if last:
            try:
                self._sock.close()
            except OSError:
                pass

    def _write_loop(self):
        try:
            self._write_loop_inner()
        finally:
            self._release_fd()

    # One gathered write flushes up to this many queued frames / bytes
    # per syscall (bounded by IOV_MAX=1024 and by how much we want a
    # single sendmsg to pin the write lock).
    GATHER_MAX_FRAMES = 64
    GATHER_MAX_BYTES = 4 * 1024 * 1024

    def _write_loop_inner(self):
        while True:
            # raylint: disable-next=unbounded-wait (dedicated writer
            # thread parked for work; close() sets the event to wake it)
            self._send_ev.wait()
            while True:
                if not self._send_q:
                    break
                # The queue head is read AND sent under the write lock:
                # an inline fast-path sender (_send) that just pushed a
                # partial frame's remainder to the front must see it go
                # out before anything else, and frames must never
                # interleave. A run of ready frames drains in ONE
                # gathered sendmsg instead of one send per frame — a
                # submit burst costs one writer wakeup + one syscall.
                # raylint: disable-next=blocking-under-lock (the write
                # lock serializes frame bytes on the wire; the inline
                # fast path only ever tries acquire(False), so no
                # handler thread can block behind this send)
                with self._write_lock:
                    if not self._send_q:
                        break
                    # Indexed reads, NOT iteration: producers append to
                    # the deque without the write lock, and iterating a
                    # deque while another thread appends raises
                    # RuntimeError (which would kill this writer). Only
                    # this thread pops, so indices [0, n) stay valid.
                    bufs = []
                    total = 0
                    n = min(len(self._send_q), self.GATHER_MAX_FRAMES)
                    for i in range(n):
                        f = self._send_q[i]
                        bufs.append(f)
                        total += len(f)
                        if total >= self.GATHER_MAX_BYTES:
                            break
                    self._send_inflight = True  # flush() can't miss it
                    try:
                        if len(bufs) == 1:
                            self._sock.sendall(bufs[0])
                            sent = len(bufs[0])
                        else:
                            sent = self._sock.sendmsg(bufs)
                    except (BrokenPipeError, ConnectionResetError, OSError):
                        self._send_inflight = False
                        self.close()
                        return
                    # Pop fully-sent frames; a partially-sent frame's
                    # remainder replaces it at the queue head (still
                    # under the write lock, so nothing interleaves).
                    freed = 0
                    left = sent
                    for f in bufs:
                        if left >= len(f):
                            left -= len(f)
                            freed += len(self._send_q.popleft())
                        else:
                            if left:
                                self._send_q[0] = f[left:]
                                freed += left
                            break
                    self._send_inflight = False
                with self._send_cv:
                    self._send_bytes = max(0, self._send_bytes - freed)
                    self._send_cv.notify_all()
            self._send_ev.clear()
            if self._send_q:
                self._send_ev.set()
            elif self._closed:
                return

    def notify(self, mtype: str, payload: Any = None) -> None:
        """Fire-and-forget message. Notifies never get replies, so no
        msg id is allocated (ids exist only to match replies to pending
        request futures) — the per-message _next_id_lock round trip
        stays off the hot path. 0 is never a pending-slot key (ids
        start at 1), so a peer's stray reply-to-0 resolves nothing."""
        self._send(0, None, mtype, payload)

    def flush(self, timeout: float = 5.0) -> bool:
        """Best-effort wait until queued sends hit the socket (call before
        process exit; daemon writer threads die with the process)."""
        deadline = time.monotonic() + timeout
        while (self._send_q or self._send_inflight) \
                and time.monotonic() < deadline:
            if self._closed:
                return False
            time.sleep(0.001)
        return not self._send_q and not self._send_inflight

    def request_nowait(self, mtype: str, payload: Any = None) -> "_Future":
        fut = _Future()
        msg_id = self._alloc_id()
        fut.msg_id = msg_id
        with self._pending_lock:
            self._pending[msg_id] = fut
        try:
            self._send(msg_id, None, mtype, payload)
        except BaseException:
            with self._pending_lock:
                self._pending.pop(msg_id, None)
            raise
        return fut

    def request(self, mtype: str, payload: Any = None,
                timeout: Optional[float] = None) -> Any:
        fut = self.request_nowait(mtype, payload)
        try:
            return fut.result(timeout)
        except TimeoutError:
            # Abandon the pending slot: with control RPCs bounded by
            # default (gcs_rpc_timeout_s), timeouts are a routine path —
            # leaving the future registered would leak an entry per
            # timed-out request for the life of the conn, and a late
            # reply would resolve into a future nobody holds.
            with self._pending_lock:
                self._pending.pop(fut.msg_id, None)
            raise

    def abandon(self, fut: "_Future") -> None:
        """Drop a request_nowait future's pending slot after handling a
        timeout yourself — a late reply then resolves nothing, and the
        slot doesn't leak for the life of the conn (the same hygiene
        ``request`` applies internally)."""
        if fut.msg_id is not None:
            with self._pending_lock:
                self._pending.pop(fut.msg_id, None)

    def reply(self, to_msg_id: int, payload: Any = None) -> None:
        # Replies are matched by reply_to alone; their own msg id is
        # never read — skip the id allocation (see notify).
        self._send(0, to_msg_id, "reply", payload)

    def reply_error(self, to_msg_id: int, err: str) -> None:
        self._send(0, to_msg_id, "reply", err, is_error=True)

    # -- receiving ------------------------------------------------------------

    def serve(self) -> None:
        """Blocking receive loop (run in a dedicated thread)."""
        if not self._acquire_fd():
            return
        try:
            hdr = bytearray(_LEN.size)
            while not self._closed:
                _recv_exact(self._sock, _LEN.size, memoryview(hdr))
                (length,) = _LEN.unpack(hdr)
                if length > _MAX_FRAME:
                    raise ConnectionClosed()
                body = _recv_exact(self._sock, length)
                msg_id, reply_to, mtype, payload, is_error = pickle.loads(body)
                if reply_to is not None:
                    with self._pending_lock:
                        fut = self._pending.pop(reply_to, None)
                    if fut is not None:
                        if is_error:
                            fut.set_error(RemoteCallError(payload))
                        else:
                            fut.set(payload)
                elif self._handler is not None:
                    self._handler(self, mtype, payload, msg_id)
        except ConnectionClosed:
            pass
        except Exception:
            pass
        finally:
            self.close()
            self._release_fd()

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.serve, daemon=True,
                             name=f"rtpu-conn-{self.name}")
        t.start()
        return t

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._send_ev.set()  # wake the writer so it can exit
        with self._send_cv:
            self._send_cv.notify_all()  # wake blocked senders
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        # No _sock.close() here: the writer/serve threads release the fd
        # when they exit (see _fd_refs) to avoid fd-number recycling races.
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for fut in pending:
            fut.set_error(ConnectionClosed())
        cb, self.on_close = self.on_close, None
        if cb is not None:
            try:
                cb(self)
            except Exception:
                pass

    @property
    def closed(self) -> bool:
        return self._closed


def fanout_requests(targets, mtype: str, payload: Any,
                    timeout_s: float, floor_s: float = 0.1):
    """Bounded parallel request fan-out: ``request_nowait`` to every
    conn in ``targets`` ([(key, Conn), ...]), then collect under ONE
    shared deadline, abandoning the pending slot of anything that timed
    out (the per-request hygiene ``request`` applies internally).
    Returns ``[(key, ok, reply_or_error_str), ...]`` in target order —
    used by the GCS's per-node agent fan-in and the node agent's
    per-worker stack capture."""
    futs = []
    for key, conn in targets:
        try:
            futs.append((key, conn, conn.request_nowait(mtype, payload)))
        except Exception as e:
            futs.append((key, conn, f"{type(e).__name__}: {e}"))
    deadline = time.monotonic() + timeout_s
    out = []
    for key, conn, fut in futs:
        if isinstance(fut, str):        # request_nowait itself failed
            out.append((key, False, fut))
            continue
        try:
            out.append((key, True, fut.result(
                max(floor_s, deadline - time.monotonic()))))
        except Exception as e:
            out.append((key, False, f"{type(e).__name__}: {e}"))
            try:
                conn.abandon(fut)
            except Exception:
                pass
    return out


class _Future:
    __slots__ = ("_ev", "_value", "_error", "_cbs", "_cb_lock", "msg_id")

    def __init__(self):
        self._ev = threading.Event()
        self._value = None
        self._error = None
        self._cbs: list = []
        self._cb_lock = threading.Lock()
        self.msg_id: Optional[int] = None  # set by request_nowait

    def set(self, value):
        self._value = value
        self._ev.set()
        self._fire_callbacks()

    def set_error(self, err):
        self._error = err
        self._ev.set()
        self._fire_callbacks()

    def add_done_callback(self, cb: Callable[["_Future"], None]):
        """cb(self) runs when the result/error lands (immediately if it
        already has). Runs on the conn's serve thread — keep it short."""
        with self._cb_lock:
            if not self._ev.is_set():
                self._cbs.append(cb)
                return
        cb(self)

    def _fire_callbacks(self):
        with self._cb_lock:
            cbs, self._cbs = self._cbs, []
        for cb in cbs:
            try:
                cb(self)
            except Exception:
                pass

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("rpc timed out")
        if self._error is not None:
            raise self._error
        return self._value


class Server:
    """Accepts connections and runs a receive loop per client."""

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0,
                 unix_path: Optional[str] = None, name: str = ""):
        self._handler = handler
        self.name = name
        self.on_disconnect: Optional[Callable[[Conn], None]] = None
        if unix_path is not None:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                os.unlink(unix_path)
            except FileNotFoundError:
                pass
            self._sock.bind(unix_path)
            self.address = unix_path
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            self.address = "%s:%d" % self._sock.getsockname()[:2]
        self._sock.listen(512)
        self._conns: list = []
        self._closed = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True,
                                        name=f"rtpu-accept-{name}")
        self._thread.start()

    def _accept_loop(self):
        while not self._closed:
            try:
                # raylint: disable-next=unbounded-wait (dedicated accept
                # thread; close() shuts the socket down to unblock it)
                client, _ = self._sock.accept()
            except OSError:
                break
            conn = Conn(client, self._handler, name=self.name)
            conn.on_close = self._on_conn_close
            self._conns.append(conn)
            conn.start()

    def _on_conn_close(self, conn: Conn):
        try:
            self._conns.remove(conn)
        except ValueError:
            pass
        if self.on_disconnect is not None and not self._closed:
            try:
                self.on_disconnect(conn)
            except Exception:
                pass

    def close(self):
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        # Join BEFORE closing the fd: a thread still blocked in accept(2)
        # on this fd number would otherwise start accepting connections for
        # whatever new listener the OS assigns the number to next — a
        # stale server silently serving a fresh server's clients.
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=5)
        try:
            self._sock.close()
        except OSError:
            pass
        for conn in list(self._conns):
            conn.close()


def connect(address: str, handler=None, name: str = "",
            timeout: float = 30.0) -> Conn:
    """Connect to ``host:port`` or a unix-socket path; starts the recv loop."""
    deadline = time.monotonic() + timeout
    last_err: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            if ":" in address:
                host, port = address.rsplit(":", 1)
                sock = socket.create_connection((host, int(port)), timeout=5)
                sock.settimeout(None)
            else:
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.connect(address)
            conn = Conn(sock, handler, name=name)
            conn.start()
            return conn
        except (ConnectionRefusedError, FileNotFoundError, socket.timeout,
                OSError) as e:
            last_err = e
            time.sleep(0.05)
    raise ConnectionError(f"could not connect to {address}: {last_err}")
