"""Runtime lock-order witness ("lockdep") for the port's control plane (a
copy of ``ray_tpu/_private/lockdep.py``).

The kernel lockdep idea, scaled to this codebase: when installed, every
``threading.Lock()`` / ``threading.RLock()`` **created by ray_tpu_torch
code** is wrapped in a proxy that records, per thread, the stack of
held locks, and folds every (held → newly-acquired) pair into a global
acquisition-order graph keyed by the lock's CREATION SITE (its "class",
so all instances of ``NodeManager._lock`` are one node). The first
acquisition that closes a cycle in that graph is recorded as a
violation carrying the witness cycle and both edges' acquire sites —
the interleaving that WOULD deadlock, caught on a run where it merely
inverted order.

Why record-don't-raise: an AssertionError thrown inside arbitrary
control-plane code (often under the very locks in question) would turn
a latent ordering bug into an immediate crash of an unrelated test.
Instead violations accumulate; the test harness asserts none at test
boundaries, and a unit test proves the detector on a constructed AB/BA
deadlock. A process that ends with violations prints them (the
out-of-process GCS exits 3, as the reference's does).

Enabled by the ``lockdep_enabled`` config knob
(``RAY_TPU_TORCH_LOCKDEP_ENABLED=1``), installed at ``import
ray_tpu_torch``; every process of the runtime (GCS, node manager,
workers) inherits the variable. Overhead is a few dict operations per
acquire on ray_tpu_torch locks only — stdlib-internal locks (Condition
waiters, queue internals created from threading.py) are untouched
because the creation-site filter only wraps locks born in ray_tpu_torch
files.

Known limits (deliberate):
- Locks created BEFORE install() (module import order) stay unwrapped.
- Same-class edges (two instances of one lock class acquired together)
  are skipped: per-object locks acquired in a deliberate global order
  (e.g. sorted by id) would otherwise false-positive; the self-nesting
  case goes unseen.
- Cross-process ordering is invisible (each process has its own graph);
  the protocol layer's no-blocking-sends design owns that axis.
"""

from __future__ import annotations

import os
import sys
import threading
import _thread
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

# Internal state guarded by a RAW lock (never a wrapped one).
_state_lock = _thread.allocate_lock()
_installed = False
_orig_lock = None
_orig_rlock = None

# class-key -> set of class-keys acquired while it was held
_graph: Dict[str, Set[str]] = {}
# (a, b) -> "file:line" of the acquire that first created the edge
_edge_sites: Dict[Tuple[str, str], str] = {}
_violations: List["LockdepViolation"] = []
_tls = threading.local()

_PKG_MARKER = os.sep + "ray_tpu_torch" + os.sep
_SELF_FILE = os.path.abspath(__file__)


@dataclass
class LockdepViolation:
    """One witnessed ordering cycle."""
    cycle: List[str]               # [A, B, ..., A] class keys
    edge_sites: List[str]          # acquire site per edge in the cycle
    thread: str
    acquire_site: str              # where the closing acquire happened

    def __str__(self) -> str:
        steps = " -> ".join(self.cycle)
        sites = "; ".join(
            f"{self.cycle[i]}->{self.cycle[i + 1]} acquired at "
            f"{self.edge_sites[i]}"
            for i in range(len(self.cycle) - 1))
        return (f"lock-order cycle {steps} (closing acquire at "
                f"{self.acquire_site} on thread {self.thread}): {sites}")


def _short(path: str) -> str:
    idx = path.rfind(_PKG_MARKER)
    if idx >= 0:
        return path[idx + 1:]
    return os.path.basename(path)


def _caller_site() -> str:
    """file:line of the nearest frame outside this module."""
    f = sys._getframe(2)
    while f is not None and \
            os.path.abspath(f.f_code.co_filename) == _SELF_FILE:
        f = f.f_back
    if f is None:
        return "?"
    return f"{_short(f.f_code.co_filename)}:{f.f_lineno}"


def _held_stack() -> List["_TrackedLock"]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _find_path(start: str, goal: str) -> Optional[List[str]]:
    """DFS path start→goal in the class graph (None if unreachable)."""
    stack = [(start, [start])]
    seen = {start}
    while stack:
        cur, path = stack.pop()
        if cur == goal:
            return path
        for nxt in _graph.get(cur, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_acquired(lock: "_TrackedLock", blocking: bool = True) -> None:
    held = _held_stack()
    # Re-entering an RLock this thread already holds never waits either:
    # its order was recorded when the thread first took it, and edges
    # from locks taken since (``with sched, actor, obj:`` then a helper's
    # ``with actor:``) would report a cycle that cannot deadlock.
    if blocking and not any(h is lock for h in held):
        for h in held:
            if h.class_key == lock.class_key:
                # Same-class acquisition: no edge (see module
                # docstring).
                continue
            _record_edge(h.class_key, lock.class_key)
    # A try-acquire (blocking=False) never waits, so it can never be the
    # blocked edge of a deadlock — record no dependency edges for it
    # (kernel lockdep's trylock rule; the protocol layer's inline-send
    # fast path acquire(False) vs the writer thread is the canonical
    # benign inversion). It still joins the held stack: BLOCKING
    # acquires made while it is held are real edges.
    held.append(lock)


def _record_edge(a: str, b: str) -> None:
    with _state_lock:
        if b in _graph.get(a, ()):
            return
        # Does acquiring b while holding a close a cycle b ~> a?
        back_path = _find_path(b, a)
        _graph.setdefault(a, set()).add(b)
        site = _caller_site()
        _edge_sites[(a, b)] = site
        if back_path is not None:
            cycle = [a, b] + back_path[1:]     # a->b->...->a
            sites = []
            for i in range(len(cycle) - 1):
                sites.append(_edge_sites.get(
                    (cycle[i], cycle[i + 1]), "?"))
            _violations.append(LockdepViolation(
                cycle=cycle, edge_sites=sites,
                thread=threading.current_thread().name,
                acquire_site=site))


def _note_released(lock: "_TrackedLock") -> None:
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i] is lock:
            del held[i]
            return


class _TrackedLock:
    """Transparent proxy over a raw Lock/RLock. Implements the full
    lock protocol plus the private Condition hooks (_release_save /
    _acquire_restore / _is_owned) so ``threading.Condition`` works
    unchanged over a tracked lock."""

    __slots__ = ("_inner", "class_key")

    def __init__(self, inner, class_key: str):
        self._inner = inner
        self.class_key = class_key

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _note_acquired(self, blocking=blocking)
        return ok

    def release(self):
        _note_released(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    # --- Condition integration -----------------------------------------
    def _release_save(self):
        _note_released(self)
        inner_save = getattr(self._inner, "_release_save", None)
        if inner_save is not None:
            return inner_save()
        self._inner.release()
        return None

    def _acquire_restore(self, state):
        inner_restore = getattr(self._inner, "_acquire_restore", None)
        if inner_restore is not None:
            inner_restore(state)
        else:
            self._inner.acquire()
        _note_acquired(self)

    def _is_owned(self):
        inner_owned = getattr(self._inner, "_is_owned", None)
        if inner_owned is not None:
            return inner_owned()
        # Plain Lock: owned iff locked and not acquirable.
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self):
        return f"<lockdep {self.class_key} over {self._inner!r}>"


_THREADING_FILE = getattr(threading, "__file__", "<threading>")


def _make_factory(orig, kind: str):
    def factory(*args, **kwargs):
        inner = orig(*args, **kwargs)
        try:
            # Walk out of threading.py internals (bounded): a bare
            # ``threading.Condition()`` / ``Event()`` allocates its lock
            # FROM threading.py, but the object belongs to whoever
            # called the constructor — attribute the lock to that frame
            # so ray_tpu_torch's cv locks are tracked too.
            frame = sys._getframe(1)
            hops = 0
            while frame is not None and hops < 6 and \
                    frame.f_code.co_filename == _THREADING_FILE:
                frame = frame.f_back
                hops += 1
            if frame is None:
                return inner
            fname = frame.f_code.co_filename
        except Exception:
            return inner
        if _PKG_MARKER not in os.path.abspath(fname):
            return inner
        key = f"{_short(os.path.abspath(fname))}:{frame.f_lineno}"
        return _TrackedLock(inner, key)
    factory.__name__ = kind
    return factory


def tracked(inner=None, *, key: str) -> _TrackedLock:
    """Explicitly wrap a lock under a chosen class key (used by tests
    and by code outside the ray_tpu_torch tree that wants coverage)."""
    if inner is None:
        inner = (_orig_lock or threading.Lock)()
    return _TrackedLock(inner, key)


def install() -> bool:
    """Monkeypatch the threading lock factories. Idempotent. Returns
    True if lockdep is installed after the call."""
    global _installed, _orig_lock, _orig_rlock
    with _state_lock:
        if _installed:
            return True
        _orig_lock = threading.Lock
        _orig_rlock = threading.RLock
        _installed = True
    threading.Lock = _make_factory(_orig_lock, "Lock")
    threading.RLock = _make_factory(_orig_rlock, "RLock")
    return True


def uninstall() -> None:
    """Restore the original factories (existing proxies keep working)."""
    global _installed
    with _state_lock:
        if not _installed:
            return
        _installed = False
    threading.Lock = _orig_lock
    threading.RLock = _orig_rlock


def installed() -> bool:
    return _installed


def maybe_install() -> bool:
    """Install iff the ``lockdep_enabled`` knob
    (RAY_TPU_TORCH_LOCKDEP_ENABLED) is on. Called at ray_tpu_torch
    import."""
    from ray_tpu_torch._private.config import config
    if bool(config.lockdep_enabled):
        return install()
    return False


def current_held() -> List[str]:
    """Class keys of the tracked locks the CALLING thread holds right
    now (empty when lockdep is not installed)."""
    if not _installed:
        return []
    return [lk.class_key for lk in _held_stack()]


def note_blocking_region(what: str) -> None:
    """Record a violation if the calling thread enters a blocking region
    (child-process wait, bootstrap poll, ...) while holding any tracked
    lock — e.g. the GCS subprocess bootstrap/shutdown path, which must never wait on the
    child while holding a control-plane lock. No-op unless installed."""
    if not _installed:
        return
    held = _held_stack()
    if not held:
        return
    cycle = [h.class_key for h in held] + [f"<blocking:{what}>"]
    with _state_lock:
        _violations.append(LockdepViolation(
            cycle=cycle,
            edge_sites=["(held at blocking region)"] * (len(cycle) - 1),
            thread=threading.current_thread().name,
            acquire_site=_caller_site()))


def violations() -> List[LockdepViolation]:
    with _state_lock:
        return list(_violations)


def take_violations() -> List[LockdepViolation]:
    """Return and clear recorded violations (test-boundary check)."""
    with _state_lock:
        out = list(_violations)
        _violations.clear()
        return out


def reset() -> None:
    """Clear the order graph and violations (NOT the install state).
    Tests call this between unrelated scenarios so one module's edges
    don't constrain another's."""
    with _state_lock:
        _graph.clear()
        _edge_sites.clear()
        _violations.clear()


def graph_snapshot() -> Dict[str, Set[str]]:
    with _state_lock:
        return {k: set(v) for k, v in _graph.items()}


def witnessed_graph() -> List[Dict[str, str]]:
    """Runtime-observed lock-order edges with their witness sites. Each
    entry: ``{"held": <class-key>, "acquired": <class-key>, "site":
    file:line}`` where class keys are creation sites
    (``ray_tpu_torch/...py:lineno``) and
    ``site`` is where the inner acquire happened while the outer was
    held — the witness stack's tip."""
    with _state_lock:
        return [{"held": a, "acquired": b,
                 "site": _edge_sites.get((a, b), "?")}
                for a, edges in sorted(_graph.items())
                for b in sorted(edges)]
