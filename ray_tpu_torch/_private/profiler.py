"""In-process sampling profiler — always-available flamegraphs for every
process in the cluster (reference: Ray's per-worker py-spy integration,
``dashboard/modules/reporter/reporter_agent.py`` CpuProfilingManager; the
Ray paper treats per-worker profiling as a first-class dashboard verb).

Delta from the reference: no external profiler binary and no ptrace — a daemon
sampler thread inside the target process walks ``sys._current_frames()``
at a configurable rate (default ~67 Hz) and accumulates FOLDED call
stacks per thread into a bounded table. Pure Python means it can run in
any process we own — workers, drivers, node managers, the GCS
subprocess, serve proxies/replicas — and can answer over the process's
existing protocol listener thread, so a rank whose main thread is wedged
inside a collective still profiles (the same in-band property as
``collect_stacks``).

Two modes:

- **wall** — every sample of every thread counts: where threads spend
  wall-clock time, waits included.
- **cpu** — a CPU-time estimate: samples whose leaf frame is a known
  blocking primitive (lock/cv waits, socket recv/accept, select/poll,
  sleep) are counted as idle and excluded from the table. Pure Python
  cannot read per-thread scheduler state portably; the leaf-frame
  heuristic is the standard wall-sampler approximation.

The folded table is BOUNDED (``profiler_max_stacks`` distinct stacks,
``profiler_max_frames`` frames per stack): deep or churning stacks
evict the smallest-count entry, and every evicted sample is accounted
in ``profiler_dropped_samples_total`` so a truncated profile is visible
as truncated. Output renders as folded lines (flamegraph.pl /
``inferno``) or merges — across every process of a cluster capture —
into ONE speedscope JSON document (``speedscope_document``), so a whole
cluster capture opens in a single view.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import config

# Leaf frames that mean "this thread is parked, not burning CPU" — the
# cpu-mode idle filter. Function names, matched on the innermost frame.
_IDLE_LEAF_FUNCS = frozenset({
    "wait", "wait_for", "sleep", "select", "poll", "epoll", "kqueue",
    "accept", "recv", "recv_into", "recvfrom", "read", "readinto",
    "acquire", "_recv_exact", "settimeout", "getaddrinfo", "connect",
    "flush", "join",
})

# Hard ceilings (knobs clamp into these): a profile request is a remote
# verb, and a bad payload must not pin a sampler at 10 kHz for an hour.
_MAX_HZ = 1000.0
_MIN_HZ = 1.0
_MAX_DURATION_S = 600.0

_metrics_lock = threading.Lock()
_metrics: Optional[Dict[str, Any]] = None


def _counters() -> Dict[str, Any]:
    """The profiler's /metrics counters, registered once per process
    (samples recorded vs samples dropped by the bounded-table guard)."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util import metrics

            _metrics = {
                "samples": metrics.Counter(
                    "profiler_samples_total",
                    "Call-stack samples recorded by the in-process "
                    "sampling profiler"),
                "dropped": metrics.Counter(
                    "profiler_dropped_samples_total",
                    "Samples discarded by the profiler's bounded folded-"
                    "stack table (evictions under deep/churning stacks)"),
            }
        return _metrics


# Frame names fold at FUNCTION granularity (co_firstlineno, not the
# sampled f_lineno): flamegraph-standard, and it makes the name a pure
# function of the code object — cacheable, so steady-state sampling
# does one dict hit per frame instead of string formatting (the
# difference between ~5% and ~20% overhead at the default rate on a
# 30-thread driver). Bounded: dynamic code (exec/JIT) could mint code
# objects forever, so the cache clears at a ceiling.
_frame_names: Dict[Any, str] = {}
_FRAME_CACHE_MAX = 16384


def _frame_name(code) -> str:
    name = _frame_names.get(code)
    if name is None:
        fname = code.co_filename
        # Compact module-ish path: last two components are enough to
        # attribute a frame and keep folded keys short.
        parts = fname.replace("\\", "/").rsplit("/", 2)
        short = "/".join(parts[-2:]) if len(parts) > 1 else fname
        name = f"{code.co_name} ({short}:{code.co_firstlineno})"
        if len(_frame_names) >= _FRAME_CACHE_MAX:
            _frame_names.clear()
        _frame_names[code] = name
    return name


class SamplingProfiler:
    """Daemon sampler thread + bounded folded-stack table for THIS
    process. One instance per process (``get_profiler``); start/stop is
    idempotent so repeated ``init()``/``shutdown()`` cycles never stack
    sampler threads (the reporter-lifecycle contract)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self._hz = float(config.profiler_hz)
        self._mode = "wall"
        # folded stack -> sample count. Bounded: see _add.
        self._table: Dict[str, int] = {}
        self._samples = 0
        self._dropped = 0
        self._idle = 0
        self._window_start = time.time()
        # Lifetime tallies behind the /metrics counters; synced in
        # batches (~1 Hz + at collect) — a per-sample Counter.inc would
        # be thousands of locked tag-tuple builds per second.
        self._life_samples = 0
        self._life_dropped = 0
        self._ctr_synced = [0, 0]
        # Per-thread stack memo: tid -> (frame id, code id, f_lasti,
        # folded-or-None). A parked thread's top frame is the SAME
        # object at the SAME instruction tick after tick — reusing its
        # folded key turns the ~30 parked threads of a driver into dict
        # hits and leaves only threads that actually moved to be walked
        # (the difference between ~15% and ~3% overhead on a pure-
        # Python submit loop). No strong frame refs are held (ids
        # only); the code-id + lasti check bounds stale-address reuse.
        self._tid_memo: Dict[int, tuple] = {}
        # One collection window at a time: a second profile() request
        # queues behind the first instead of resetting its table.
        self._window_lock = threading.Lock()

    # ------------------------------------------------------------ lifecycle

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self, hz: Optional[float] = None,
              mode: Optional[str] = None) -> bool:
        """Start the sampler thread; True if this call started it, False
        if it was already running (idempotent — no thread stacking)."""
        with self._lock:
            if self.running:
                return False
            if hz is not None:
                self._hz = min(_MAX_HZ, max(_MIN_HZ, float(hz)))
            if mode is not None:
                self._mode = "cpu" if mode == "cpu" else "wall"
            stop = threading.Event()
            self._stop = stop
            t = threading.Thread(target=self._run, args=(stop,),
                                 daemon=True, name="rtpu-profiler")
            self._thread = t
            t.start()
            return True

    def stop(self, timeout: float = 2.0) -> None:
        """Stop and join the sampler (idempotent)."""
        with self._lock:
            t, self._thread = self._thread, None
            stop, self._stop = self._stop, None
        if stop is not None:
            stop.set()
        if t is not None and t.is_alive():
            t.join(timeout=timeout)

    # ------------------------------------------------------------- sampling

    def _run(self, stop: threading.Event) -> None:
        my_ident = threading.get_ident()
        # Thread-name map refreshed at ~1 Hz, not per tick: enumerate()
        # allocates under the threading module lock and names are
        # near-static; a brand-new thread shows as thread-<id> for under
        # a second.
        names: Dict[int, str] = {}
        names_refreshed = 0.0
        while not stop.wait(1.0 / self._hz):
            now = time.time()
            if now - names_refreshed >= 1.0:
                names = {t.ident: t.name for t in threading.enumerate()}
                names_refreshed = now
                self._sync_counters()
            try:
                self._sample_once(my_ident, names)
            except Exception:
                # A torn frame during interpreter teardown must not kill
                # the sampler mid-window; the miss is one tick. (No
                # logging here: this fires at sampling rate.)
                self._dropped += 1

    def _sample_once(self, skip_ident: int,
                     names: Dict[int, str]) -> None:
        max_frames = max(2, int(config.profiler_max_frames))
        cpu_mode = self._mode == "cpu"
        memo = self._tid_memo
        new_memo: Dict[int, tuple] = {}
        for tid, frame in sys._current_frames().items():
            if tid == skip_ident:
                continue   # never profile the sampler itself
            code = frame.f_code
            fid, cid, lasti = id(frame), id(code), frame.f_lasti
            ent = memo.get(tid)
            if ent is not None and ent[0] == fid and ent[1] == cid \
                    and ent[2] == lasti:
                new_memo[tid] = ent
                folded = ent[3]
                if folded is None:
                    self._idle += 1   # cached cpu-mode idle leaf
                else:
                    self._add(folded)
                continue
            if cpu_mode and code.co_name in _IDLE_LEAF_FUNCS:
                self._idle += 1
                new_memo[tid] = (fid, cid, lasti, None)
                continue
            frames: List[str] = []
            f = frame
            while f is not None and len(frames) <= max_frames:
                frames.append(_frame_name(f.f_code))
                f = f.f_back
            frames.reverse()   # root -> leaf, flamegraph orientation
            if len(frames) > max_frames:
                frames = ["<truncated>"] + frames[-max_frames:]
            thread = names.get(tid) or f"thread-{tid}"
            folded = ";".join([thread.replace(";", ":")] + frames)
            new_memo[tid] = (fid, cid, lasti, folded)
            self._add(folded)
        self._tid_memo = new_memo

    def _add(self, folded: str, count: int = 1) -> None:
        """Accumulate one folded stack, bounded: a NEW stack arriving at
        a full table evicts the current smallest-count entry, and the
        evicted entry's samples are accounted as dropped — a truncated
        profile says so instead of silently under-reporting."""
        max_stacks = max(16, int(config.profiler_max_stacks))
        with self._lock:
            self._samples += count
            self._life_samples += count
            if folded not in self._table and \
                    len(self._table) >= max_stacks:
                victim = min(self._table, key=self._table.get)
                evicted = self._table.pop(victim)
                self._dropped += evicted
                self._life_dropped += evicted
            self._table[folded] = self._table.get(folded, 0) + count

    def _sync_counters(self) -> None:
        with self._lock:
            ds = self._life_samples - self._ctr_synced[0]
            dd = self._life_dropped - self._ctr_synced[1]
            self._ctr_synced = [self._life_samples, self._life_dropped]
        if ds or dd:
            c = _counters()
            if ds:
                c["samples"].inc(ds)
            if dd:
                c["dropped"].inc(dd)

    # ------------------------------------------------------------- windows

    def reset(self) -> None:
        with self._lock:
            self._table = {}
            self._samples = 0
            self._dropped = 0
            self._idle = 0
            self._window_start = time.time()

    def collect(self, reset: bool = False) -> Dict[str, Any]:
        """Snapshot this process's profile as a JSON-able dict."""
        with self._lock:
            out = {
                "pid": os.getpid(),
                "mode": self._mode,
                "hz": self._hz,
                "duration_s": round(time.time() - self._window_start, 3),
                "samples": self._samples,
                "dropped": self._dropped,
                "idle_samples": self._idle,
                "stacks": dict(self._table),
            }
        self._sync_counters()
        if reset:
            self.reset()
        return out

    def profile(self, duration_s: float = 5.0,
                hz: Optional[float] = None,
                mode: str = "wall") -> Dict[str, Any]:
        """Blocking convenience: run one bounded collection window and
        return the profile. Safe to call from any service thread (the
        sampling happens on the daemon sampler thread); concurrent
        windows serialize. If the sampler was already running (the
        always-on mode), it keeps running afterwards with its table
        reset; otherwise it is stopped again. ``sampler_started`` in the
        result says whether this window had to start the sampler."""
        duration_s = min(_MAX_DURATION_S, max(0.05, float(duration_s)))
        # Bounded by construction: the window lock holder exits within
        # its own clamped duration, so the longest wait is one window.
        with self._window_lock:
            started_here = self.start(hz=hz, mode=mode)
            restore = None
            if not started_here and (
                    (hz is not None and
                     min(_MAX_HZ, max(_MIN_HZ, float(hz))) != self._hz)
                    or (mode is not None and mode != self._mode)):
                # Always-on sampler running with different knobs: re-arm
                # with the REQUESTED hz/mode for this window (a cpu-mode
                # 250 Hz request must not silently come back wall@67),
                # then restore the standing configuration after.
                restore = (self._hz, self._mode)
                # raylint: disable-next=blocking-under-lock (bounded 2s
                # join of the sampler thread, which never takes the
                # window lock; see the stop() below for the rationale)
                self.stop()
                self.start(hz=hz, mode=mode)
            self.reset()
            # raylint: disable-next=blocking-under-lock (the window lock
            # exists to serialize collection windows; the sleep IS the
            # window, bounded by the clamped duration_s above, and the
            # sampler thread it waits on never takes this lock)
            time.sleep(duration_s)
            out = self.collect(reset=True)
            if started_here:
                # raylint: disable-next=blocking-under-lock (the join
                # inside stop() is bounded (2s) and the sampler thread
                # being joined never acquires the window lock; stopping
                # inside it keeps a racing second window from observing
                # a half-stopped sampler)
                self.stop()
            elif restore is not None:
                # raylint: disable-next=blocking-under-lock (same
                # bounded join as above; the always-on sampler resumes
                # with its standing hz/mode)
                self.stop()
                self.start(hz=restore[0], mode=restore[1])
        out["duration_s"] = duration_s
        out["sampler_started"] = started_here
        return out


_profiler_lock = threading.Lock()
_profiler: Optional[SamplingProfiler] = None


def get_profiler() -> SamplingProfiler:
    """This process's profiler singleton."""
    global _profiler
    with _profiler_lock:
        if _profiler is None:
            _profiler = SamplingProfiler()
        return _profiler


def maybe_start_always_on() -> bool:
    """Start the background sampler if ``profiler_always_on`` is set
    (the overhead-A/B toggle and the 'always-available' deployment
    mode). Idempotent."""
    if not bool(config.profiler_always_on):
        return False
    return get_profiler().start(hz=float(config.profiler_hz))


def stop_always_on() -> None:
    """Stop the background sampler on shutdown (repeated init/shutdown
    cycles must not stack sampler threads)."""
    prof = _profiler
    if prof is not None:
        prof.stop()


def profile_self(duration_s: float, hz: Optional[float] = None,
                 mode: str = "wall", **identity) -> Dict[str, Any]:
    """One bounded profile window of THIS process, tagged with caller-
    supplied identity fields (kind/node_id/worker_id/...)."""
    out = get_profiler().profile(duration_s=duration_s, hz=hz, mode=mode)
    out.update(identity)
    return out


# ---------------------------------------------------------------- rendering


def _process_label(p: Dict[str, Any]) -> str:
    kind = p.get("kind") or "process"
    bits = [kind]
    if p.get("node_id"):
        bits.append(f"node={p['node_id'][:12]}")
    if p.get("worker_id"):
        bits.append(f"worker={p['worker_id'][:12]}")
    if p.get("actor_id"):
        bits.append(f"actor={p['actor_id'][:12]}")
    if p.get("client_id"):
        bits.append(f"client={str(p['client_id'])[:12]}")
    if p.get("pid") is not None:
        bits.append(f"pid={p['pid']}")
    return " ".join(bits)


def folded_lines(processes: List[Dict[str, Any]]) -> List[str]:
    """Flamegraph-ready folded output across processes: one
    ``label;thread;frame;... count`` line per distinct stack."""
    lines = []
    for p in processes:
        if not isinstance(p, dict) or p.get("error"):
            continue
        label = _process_label(p).replace(";", ":")
        for folded, count in sorted((p.get("stacks") or {}).items()):
            lines.append(f"{label};{folded} {count}")
    return lines


def speedscope_document(processes: List[Dict[str, Any]],
                        name: str = "ray_tpu_torch cluster profile"
                        ) -> Dict[str, Any]:
    """Merge per-process profiles into ONE speedscope JSON document
    (https://www.speedscope.app/file-format-schema.json): a shared
    named-frame table plus one sampled profile per (process, thread), so
    a whole-cluster capture opens in a single speedscope view."""
    frame_index: Dict[str, int] = {}
    frames: List[Dict[str, str]] = []

    def fidx(fname: str) -> int:
        i = frame_index.get(fname)
        if i is None:
            i = frame_index[fname] = len(frames)
            frames.append({"name": fname})
        return i

    profiles = []
    for p in processes:
        if not isinstance(p, dict) or p.get("error"):
            continue
        label = _process_label(p)
        # Group this process's folded stacks by their thread prefix.
        by_thread: Dict[str, List[Tuple[List[str], int]]] = {}
        for folded, count in (p.get("stacks") or {}).items():
            parts = folded.split(";")
            thread, stack = parts[0], parts[1:]
            by_thread.setdefault(thread, []).append((stack, count))
        for thread in sorted(by_thread):
            samples, weights = [], []
            for stack, count in sorted(by_thread[thread]):
                samples.append([fidx(f) for f in stack])
                weights.append(count)
            total = sum(weights)
            profiles.append({
                "type": "sampled",
                "name": f"{label} :: {thread}",
                "unit": "none",
                "startValue": 0,
                "endValue": total,
                "samples": samples,
                "weights": weights,
            })
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": profiles,
        "name": name,
        "activeProfileIndex": 0,
        "exporter": "ray_tpu_torch profile",
    }
