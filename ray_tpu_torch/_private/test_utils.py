"""Chaos / fault-injection test utilities against the port's
``NodeManager`` (the counterpart of ``ray_tpu/_private/test_utils.py``;
reference:
``python/ray/_private/test_utils.py:1347`` NodeKillerActor + ``:1423``
_kill_raylet — the reference's chaos tests SIGKILL raylets and workers
mid-flight to exercise every failure path).

Here nodes are in-process ``NodeManager`` objects with real worker
SUBPROCESSES, so worker-level chaos is a genuine ``SIGKILL`` and
node-level chaos is an abrupt (non-graceful) teardown.
"""

from __future__ import annotations

import os
import random
import signal
import subprocess
import threading
import time
from typing import List, Optional, TYPE_CHECKING

if TYPE_CHECKING:
    from ray_tpu_torch._private.node_manager import NodeManager


def worker_pids(nm: "NodeManager") -> List[int]:
    """PIDs of every live worker subprocess on a node. A worker still
    being spawned has no process yet (its placeholder's pid is -1, and
    ``kill(-1, ...)`` would signal every process of the user): it is
    left out."""
    with nm._lock:
        return [w.proc.pid for w in nm._workers.values()
                if w.proc.pid > 0 and w.proc.poll() is None]


def busy_worker_pids(nm: "NodeManager") -> List[int]:
    """PIDs of workers currently executing a task or hosting an actor.

    Leased workers count as busy: direct-transport tasks run on them
    without appearing in the node manager's ``current_tasks`` (the caller
    streams specs straight to the worker), and killing one exercises the
    lease-fallback retry path."""
    with nm._lock:
        return [w.proc.pid for w in nm._workers.values()
                if w.proc.pid > 0 and w.proc.poll() is None
                and (w.current_tasks or w.actor_id is not None
                     or w.state == "leased")]


def kill_worker(pid: int) -> None:
    """SIGKILL a worker subprocess — the 'worker crashed' failure path."""
    os.kill(pid, signal.SIGKILL)


def kill_any_busy_worker(nm, timeout: float = 10.0) -> Optional[int]:
    """Wait until some worker is mid-task, then SIGKILL it."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        pids = busy_worker_pids(nm)
        if pids:
            pid = random.choice(pids)
            kill_worker(pid)
            return pid
        time.sleep(0.02)
    return None


def kill_node(cluster, nm) -> None:
    """Abruptly remove a node: SIGKILL its workers, then drop its
    server/GCS connections without graceful teardown (the in-process
    analog of SIGKILLing a raylet, reference test_utils.py:1423). Its
    zygotes go with it, as a raylet's forked children would: the node
    leaves the cluster's list, so no later shutdown reaches them."""
    for pid in worker_pids(nm):
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for z in nm._zygotes:
        try:
            z["proc"].kill()
            z["proc"].wait(timeout=5)
        except (ProcessLookupError, subprocess.TimeoutExpired):
            pass
    nm._shutdown = True  # stop reap/heartbeat/spill loops rescuing it
    try:
        nm.gcs.close()    # GCS sees an abrupt conn drop -> node death
    except Exception:
        pass
    try:
        nm.server.close()
    except Exception:
        pass
    if nm in getattr(cluster, "nodes", ()):
        cluster.nodes.remove(nm)


class NodeKiller:
    """Background chaos monkey: periodically SIGKILLs a busy worker on a
    random node (reference: NodeKillerActor, test_utils.py:1347)."""

    def __init__(self, nodes, period_s: float = 0.5,
                 kill_workers_only: bool = True):
        self._nodes = list(nodes)
        self._period = period_s
        self._stop = threading.Event()
        self.kills: List[int] = []
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rtpu-node-killer")

    def start(self):
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self._period):
            nm = random.choice(self._nodes)
            pids = busy_worker_pids(nm)
            if not pids:
                continue
            pid = random.choice(pids)
            try:
                os.kill(pid, signal.SIGKILL)
                self.kills.append(pid)
            except ProcessLookupError:
                pass

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


def session_pids(root_pid: int, session_dir: str) -> List[int]:
    """Live processes of a session: ``root_pid`` (a head daemon, say) and
    its descendants, and every process whose command line or environment
    names ``session_dir`` (workers, zygotes, the GCS child). Linux
    ``/proc`` only; processes of other users go unseen."""
    parents, found = {}, set()
    needle = session_dir.encode()
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        pid = int(entry)
        try:
            with open(f"/proc/{pid}/stat", "rb") as f:
                parents[pid] = int(f.read().rsplit(b")", 1)[1].split()[1])
            for name in ("cmdline", "environ"):
                with open(f"/proc/{pid}/{name}", "rb") as f:
                    if needle in f.read():
                        found.add(pid)
        except (OSError, ValueError, IndexError):
            continue
    tree = {root_pid} if root_pid in parents else set()
    grew = True
    while grew:
        grew = False
        for pid, ppid in parents.items():
            if ppid in tree and pid not in tree:
                tree.add(pid)
                grew = True
    return sorted((tree | found) - {os.getpid()})
