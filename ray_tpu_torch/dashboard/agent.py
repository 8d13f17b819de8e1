"""Per-node observability agent (reference: ``dashboard/agent.py:65`` —
the DashboardAgent process running beside every raylet, with its log and
reporter modules ``dashboard/modules/log/log_agent.py`` /
``modules/reporter/reporter_agent.py:253``).

Delta from the reference: no separate agent process and no new server stack — the
agent lives inside the node manager and serves over the NM's existing
protocol transport (AF_UNIX + TCP), with the GCS as the fan-in hop the
dashboard head and the CLI talk to. Three capabilities:

- **log access** — tail/stream any worker's stdout/stderr straight from
  the per-worker session log files the NM already redirects into
  (including workers that have since died — their files outlive them).
- **live stack capture** — fan a ``dump_stacks`` request out to every
  registered worker's connection; workers answer IN-BAND from their
  socket listener thread with ``sys._current_frames()`` rendered as
  data, so a rank wedged inside a collective (main thread blocked)
  still reports exactly where it is. No SIGUSR2, no log spelunking.
- **flight recorder** — a bounded ring of recent task events/spans/
  hardware samples/lifecycle events on this node, auto-dumped to a file
  when a worker dies unexpectedly or the gang supervisor declares slice
  death, so every gang restart leaves a postmortem artifact.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import re
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, TYPE_CHECKING

if TYPE_CHECKING:
    from ray_tpu_torch._private.node_manager import NodeManager

logger = logging.getLogger("ray_tpu_torch.agent")

_LOG_FILE_RE = re.compile(r"^worker-([0-9a-f]{12})\.(out|err)$")
_STREAM_NAME = {"out": "stdout", "err": "stderr"}


def current_stacks() -> List[Dict[str, Any]]:
    """Every thread of THIS process as formatted stack data (the in-band
    payload workers reply with; also used for the node manager's own
    threads)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append({
            "thread_id": tid,
            "thread_name": names.get(tid, ""),
            "stack": "".join(traceback.format_stack(frame)),
        })
    return out


def tail_file_at(path: str, max_lines: int, max_bytes: int = 1 << 20
                 ) -> "tuple[List[str], int]":
    """Last ``max_lines`` lines of ``path`` plus the byte offset the
    read CONSUMED TO (bounded read from the end). The offset is the
    stat'ed size the read was capped at — never a re-stat after the
    read — so a follow cursor seeded from it skips nothing the tail
    didn't show, even if the file grew mid-read."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            f.seek(max(0, size - max_bytes))
            # Cap at the stat'ed size: bytes appended after the stat
            # belong to the NEXT cursor read, not this tail.
            data = f.read(min(size, max_bytes))
    except OSError:
        return [], 0
    lines = data.decode("utf-8", "replace").splitlines()
    if size > max_bytes and lines:
        lines = lines[1:]   # first line is likely truncated mid-way
    return lines[-max_lines:], size


def tail_file(path: str, max_lines: int, max_bytes: int = 1 << 20
              ) -> List[str]:
    """Last ``max_lines`` lines of ``path`` (bounded read from the end)."""
    return tail_file_at(path, max_lines, max_bytes)[0]


def read_file_from(path: str, offset: int, max_bytes: int = 1 << 20
                   ) -> "tuple[List[str], int]":
    """Complete lines of ``path`` from byte ``offset`` (the log-follow
    cursor read): returns ``(lines, next_offset)``. Only whole lines are
    consumed — a partial trailing line stays unread until its newline
    lands (unless it alone exceeds ``max_bytes``). An offset past EOF
    (truncation/rotation) restarts from 0."""
    try:
        size = os.path.getsize(path)
        if offset > size:
            offset = 0   # file was truncated/rotated under the cursor
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(max_bytes)
    except OSError:
        return [], offset
    if not data:
        return [], offset
    end = data.rfind(b"\n")
    if end < 0:
        if len(data) < max_bytes:
            return [], offset   # partial line: wait for its newline
        end = len(data) - 1     # overlong line: forced flush
    chunk = data[:end + 1]
    return chunk.decode("utf-8", "replace").splitlines(), \
        offset + len(chunk)


class FlightRecorder:
    """Bounded ring of recent node events; dumps to disk on demand."""

    def __init__(self, node_id: str, session_dir: str, maxlen: int):
        self.node_id = node_id
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=maxlen)
        self._dump_dir = os.path.join(session_dir, "flight_recorder")
        self._last_dump_path: Optional[str] = None

    def record(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(event)

    def record_many(self, events: List[Dict[str, Any]]) -> None:
        with self._lock:
            self._ring.extend(events)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    @property
    def last_dump_path(self) -> Optional[str]:
        return self._last_dump_path

    def dump(self, reason: str) -> Optional[str]:
        """Write the ring to a postmortem file; returns the path. Never
        raises (the dump rides failure paths — worker death handling,
        gang teardown — that must not gain new failure modes)."""
        try:
            os.makedirs(self._dump_dir, exist_ok=True)
            ts = time.time()
            path = os.path.join(
                self._dump_dir,
                f"flight-{self.node_id[:12]}-{int(ts * 1000)}.json")
            payload = {
                "node_id": self.node_id,
                "reason": reason,
                "ts": ts,
                "events": self.snapshot(),
            }
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=repr)
            os.replace(tmp, path)
            self._last_dump_path = path
            logger.warning("flight recorder dumped %d events to %s (%s)",
                           len(payload["events"]), path, reason)
            return path
        except Exception:
            logger.exception("flight recorder dump failed")
            return None


class NodeAgent:
    """The agent facade the node manager delegates observability
    messages to. Holds no locks of its own beyond the recorder ring —
    worker-table snapshots are taken under the NM lock by the NM-facing
    helpers, and all fan-out I/O happens lock-free."""

    def __init__(self, nm: "NodeManager", ring_size: int = 4096):
        self._nm = nm
        self.recorder = FlightRecorder(nm.node_id, nm.session_dir,
                                       ring_size)
        # wid12 -> {worker_id (full), actor_id, pid}: identity outlives
        # the NM's worker table, so a DEAD worker's on-disk logs stay
        # reachable by actor id / full worker id (the postmortem query).
        # Upserted for live workers on every listing and from the
        # worker_death event; bounded like the flight ring.
        self._ident_lock = threading.Lock()
        self._ident: collections.OrderedDict = collections.OrderedDict()
        self._ident_max = max(1024, ring_size)

    def _note_identity(self, worker_id: str,
                       actor_id: Optional[str], pid) -> None:
        with self._ident_lock:
            prev = self._ident.pop(worker_id[:12], None) or {}
            self._ident[worker_id[:12]] = {
                "worker_id": worker_id,
                "actor_id": actor_id or prev.get("actor_id"),
                "pid": pid if pid is not None else prev.get("pid"),
            }
            while len(self._ident) > self._ident_max:
                self._ident.popitem(last=False)

    # ----------------------------------------------------------- recording

    def record_event(self, kind: str, **fields) -> None:
        ev = {"kind": kind, "ts": time.time(),
              "node_id": self._nm.node_id}
        ev.update(fields)
        if kind == "worker_death" and fields.get("worker_id"):
            self._note_identity(fields["worker_id"],
                               fields.get("actor_id"),
                               fields.get("pid"))
        self.recorder.record(ev)

    def record_task_events(self, events: List[Dict[str, Any]]) -> None:
        self.recorder.record_many(events)

    # ---------------------------------------------------------------- logs

    def _worker_rows(self) -> List[Dict[str, Any]]:
        """Live workers (under the NM lock) plus dead workers' log files
        still on disk — logs must outlive the process that wrote them."""
        rows: Dict[str, Dict[str, Any]] = {}
        nm: NodeManager = self._nm
        with nm._lock:
            workers = list(nm._workers.values())
        for w in workers:
            wid = w.worker_id.hex()
            aid = w.actor_id.hex() if w.actor_id else None
            self._note_identity(wid, aid, w.proc.pid)
            rows[wid[:12]] = {
                "worker_id": wid,
                "pid": w.proc.pid,
                "actor_id": aid,
                "alive": w.proc.poll() is None,
                "log_paths": dict(w.log_paths),
            }
        log_dir = os.path.join(nm.session_dir, "logs")
        try:
            names = os.listdir(log_dir)
        except OSError:
            names = []
        for name in names:
            m = _LOG_FILE_RE.match(name)
            if m is None:
                continue
            wid12, suffix = m.group(1), m.group(2)
            if wid12 not in rows:
                # Dead worker: recover its full identity (actor id,
                # pid) from the agent's index so postmortem lookups by
                # actor id still resolve.
                with self._ident_lock:
                    ident = dict(self._ident.get(wid12) or {})
                rows[wid12] = {
                    "worker_id": ident.get("worker_id", wid12),
                    "pid": ident.get("pid"),
                    "actor_id": ident.get("actor_id"),
                    "alive": False, "log_paths": {}}
            rows[wid12]["log_paths"].setdefault(
                _STREAM_NAME[suffix], os.path.join(log_dir, name))
        return list(rows.values())

    def list_logs(self) -> Dict[str, Any]:
        return {"node_id": self._nm.node_id,
                "workers": [
                    {k: v for k, v in row.items() if k != "log_paths"}
                    | {"streams": sorted(row["log_paths"])}
                    for row in self._worker_rows()]}

    def get_logs(self, worker_id: Optional[str] = None,
                 actor_id: Optional[str] = None,
                 ident: Optional[str] = None,
                 stream: Optional[str] = None,
                 lines: int = 100,
                 offsets: Optional[Dict[str, int]] = None
                 ) -> List[Dict[str, Any]]:
        """Tail the matching workers' log files. ``worker_id``/
        ``actor_id`` match on hex prefixes (``ident`` matches either —
        the CLI's one-argument form); no filter = every worker on the
        node. Matching is symmetric-prefix so a FULL id query still
        finds a dead-worker row recovered from a 12-hex filename.

        ``offsets`` switches to cursor reads (the log-follow path):
        each entry is read from its byte offset (a path absent from the
        dict — a worker that appeared mid-follow — starts at 0), and
        entries with no new bytes are omitted. Every entry carries
        ``path``/``next_offset`` so the follower's next poll resumes
        where this one stopped."""
        def _match(row_id: Optional[str], q: str) -> bool:
            return bool(row_id) and (row_id.startswith(q)
                                     or q.startswith(row_id))

        out = []
        for row in self._worker_rows():
            if worker_id and not _match(row["worker_id"], worker_id):
                continue
            if actor_id and not _match(row["actor_id"], actor_id):
                continue
            if ident and not (_match(row["worker_id"], ident)
                              or _match(row["actor_id"], ident)):
                continue
            for stream_name, path in sorted(row["log_paths"].items()):
                if stream and stream_name != stream:
                    continue
                if offsets is not None:
                    off = int(offsets.get(path, 0))
                    entry_lines, next_off = read_file_from(path, off)
                    if not entry_lines and next_off == off \
                            and path in offsets:
                        continue   # follow tick with nothing new
                else:
                    entry_lines, next_off = tail_file_at(
                        path, max_lines=lines)
                out.append({
                    "node_id": self._nm.node_id,
                    "worker_id": row["worker_id"],
                    "actor_id": row["actor_id"],
                    "pid": row["pid"],
                    "stream": stream_name,
                    "path": path,
                    "next_offset": next_off,
                    "lines": entry_lines,
                })
        return out

    # -------------------------------------------------------------- stacks

    def collect_stacks(self, timeout_s: float = 5.0) -> Dict[str, Any]:
        """Snapshot every worker's Python stacks via the in-band
        ``dump_stacks`` RPC (fanned out in parallel, bounded), plus the
        node manager's own threads."""
        from ray_tpu_torch._private import protocol

        nm: NodeManager = self._nm
        with nm._lock:
            targets = [((w.worker_id.hex(), w.proc.pid,
                         w.actor_id.hex() if w.actor_id else None),
                        w.conn)
                       for w in nm._workers.values()
                       if w.conn is not None and not w.conn.closed
                       and w.proc.poll() is None]
        workers = []
        for (wid, pid, aid), ok, reply in protocol.fanout_requests(
                targets, "dump_stacks", None, timeout_s):
            entry = {"worker_id": wid, "pid": pid, "actor_id": aid}
            if ok:
                entry.update(reply or {})
            else:
                entry["error"] = reply
            workers.append(entry)
        return {
            "node_id": nm.node_id,
            "node_manager": {"pid": os.getpid(),
                             "threads": current_stacks()},
            "workers": workers,
        }

    # ------------------------------------------------------------ profiles

    def collect_profiles(self, duration_s: float = 5.0,
                         hz: Optional[float] = None, mode: str = "wall",
                         worker_id: Optional[str] = None,
                         actor_id: Optional[str] = None
                         ) -> Dict[str, Any]:
        """One bounded sampling-profile window across this node: fan the
        ``profile`` verb out to every live worker's listener thread
        (exactly the ``collect_stacks`` transport, so a rank wedged in a
        collective still answers) while the node manager's own process
        samples itself CONCURRENTLY — total wall time is one window,
        not one per process. Stragglers are abandoned, not waited on."""
        from ray_tpu_torch._private import profiler, protocol

        nm: NodeManager = self._nm
        with nm._lock:
            targets = [((w.worker_id.hex(), w.proc.pid,
                         w.actor_id.hex() if w.actor_id else None),
                        w.conn)
                       for w in nm._workers.values()
                       if w.conn is not None and not w.conn.closed
                       and w.proc.poll() is None]
        if worker_id:
            targets = [(k, c) for k, c in targets
                       if k[0].startswith(worker_id)]
        if actor_id:
            targets = [(k, c) for k, c in targets
                       if k[2] and k[2].startswith(actor_id)]
        payload = {"duration_s": duration_s, "hz": hz, "mode": mode}
        # NM self-profile on a helper thread so its window overlaps the
        # workers' windows; skipped when the query names one worker.
        self_box: Dict[str, Any] = {}
        self_thread = None
        if not worker_id and not actor_id:
            def self_profile():
                self_box["out"] = profiler.profile_self(
                    duration_s=duration_s, hz=hz, mode=mode,
                    kind="node_manager", node_id=nm.node_id)

            self_thread = threading.Thread(
                target=self_profile, daemon=True, name="rtpu-nm-selfprof")
            self_thread.start()
        processes = []
        for (wid, pid, aid), ok, reply in protocol.fanout_requests(
                targets, "profile", payload,
                duration_s + max(5.0, float(duration_s))):
            if ok:
                processes.append(reply or {})
            else:
                processes.append({"kind": "worker", "worker_id": wid,
                                  "pid": pid, "actor_id": aid,
                                  "node_id": nm.node_id, "error": reply})
        if self_thread is not None:
            # 3x + margin: in the in-process topology this profiler is
            # shared with the GCS's and the driver's self-profile
            # windows, and windows serialize — the NM's may queue
            # behind two full windows.
            self_thread.join(timeout=3.0 * duration_s + 10.0)
            if self_box.get("out"):
                processes.insert(0, self_box["out"])
        return {"node_id": nm.node_id, "processes": processes}

    # ------------------------------------------------------------ dispatch

    def handle(self, mtype: str, payload: Optional[dict]) -> Any:
        """Agent RPC surface (called from the NM's message handlers,
        off the conn serve thread for the blocking fan-outs)."""
        p = payload or {}
        if mtype == "collect_stacks":
            return self.collect_stacks(
                timeout_s=float(p.get("timeout_s", 5.0)))
        if mtype == "profile":
            return self.collect_profiles(
                duration_s=float(p.get("duration_s", 5.0)),
                hz=p.get("hz"),
                mode=p.get("mode", "wall"),
                worker_id=p.get("worker_id"),
                actor_id=p.get("actor_id"))
        if mtype == "agent_logs":
            if p.get("list"):
                return self.list_logs()
            return self.get_logs(
                worker_id=p.get("worker_id"),
                actor_id=p.get("actor_id"),
                ident=p.get("id"),
                stream=p.get("stream"),
                lines=int(p.get("lines", 100)),
                offsets=p.get("offsets"))
        if mtype == "flight_snapshot":
            return {"node_id": self._nm.node_id,
                    "events": self.recorder.snapshot(),
                    "last_dump_path": self.recorder.last_dump_path}
        if mtype == "flight_dump":
            return self.recorder.dump(p.get("reason") or "requested")
        raise ValueError(f"agent: unknown message {mtype}")
