"""Application metrics API (reference: ``python/ray/util/metrics.py`` —
Counter/Gauge/Histogram over the C++ OpenCensus registry
``stats/metric.h:103``; exported per node by ``_private/metrics_agent.py:375``
as Prometheus text).

Here: a process-local registry; each worker/driver periodically reports
samples to the GCS (``report_metrics``), and the dashboard's ``/metrics``
endpoint renders the cluster-wide aggregate in Prometheus exposition
format. ``value`` reads one tag set back in this process.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger("ray_tpu_torch.metrics")

_registry_lock = threading.Lock()
_registry: Dict[str, "_Metric"] = {}

_DEFAULT_BOUNDARIES = [0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                       2.5, 5.0, 10.0]


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            existing = _registry.get(name)
            if existing is not None and existing.kind != self.kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{existing.kind}")
            _registry[name] = self

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _tags_tuple(self, tags: Optional[Dict[str, str]]) -> Tuple:
        merged = dict(self._default_tags)
        merged.update(tags or {})
        unknown = set(merged) - set(self.tag_keys)
        if unknown:
            raise ValueError(f"unknown tags {unknown} for {self.name}")
        return tuple((k, merged.get(k, "")) for k in self.tag_keys)

    def samples(self) -> List[tuple]:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("counters only increase")
        key = self._tags_tuple(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, tags: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(self._tags_tuple(tags), 0.0)

    def samples(self):
        with self._lock:
            return [(self.name, dict(k), v)
                    for k, v in self._values.items()]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._tags_tuple(tags)
        with self._lock:
            self._values[key] = float(value)

    def value(self, tags: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(self._tags_tuple(tags), 0.0)

    def samples(self):
        with self._lock:
            return [(self.name, dict(k), v)
                    for k, v in self._values.items()]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, description="", boundaries=None,
                 tag_keys=None):
        super().__init__(name, description, tag_keys)
        self.boundaries = list(boundaries or _DEFAULT_BOUNDARIES)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._totals: Dict[Tuple, int] = {}

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None):
        key = self._tags_tuple(tags)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def value(self, tags: Optional[Dict[str, str]] = None
              ) -> Dict[str, object]:
        """Bucket counts (each bucket holds the values up to its
        boundary), sum and count of one tag set."""
        key = self._tags_tuple(tags)
        with self._lock:
            counts = list(self._counts.get(
                key, [0] * (len(self.boundaries) + 1)))
            return {"counts": counts, "sum": self._sums.get(key, 0.0),
                    "count": self._totals.get(key, 0)}

    def samples(self):
        out = []
        with self._lock:
            for key, counts in self._counts.items():
                tags = dict(key)
                cum = 0
                for b, c in zip(self.boundaries, counts):
                    cum += c
                    out.append((f"{self.name}_bucket",
                                {**tags, "le": str(b)}, cum))
                out.append((f"{self.name}_bucket",
                            {**tags, "le": "+Inf"},
                            cum + counts[-1]))
                out.append((f"{self.name}_sum", tags, self._sums[key]))
                out.append((f"{self.name}_count", tags,
                            self._totals[key]))
        return out


# ------------------------------------------------------------- exposition


def collect_samples() -> List[dict]:
    """All local metric samples as JSON-able dicts (shipped to the GCS)."""
    with _registry_lock:
        metrics = list(_registry.values())
    out = []
    for m in metrics:
        for name, tags, value in m.samples():
            out.append({"name": name, "tags": tags, "value": value,
                        "kind": m.kind, "help": m.description})
    return out


def prometheus_text(sample_groups: List[List[dict]]) -> str:
    """Render sample groups (one per reporting process) as Prometheus
    exposition text (reference: metrics_agent.py Prometheus export).

    Same-name+tags series from different processes are AGGREGATED (summed
    for counters/histogram components, last-write for gauges) and emitted
    grouped per metric family — Prometheus rejects duplicate or
    interleaved series.
    """
    # (name, tags_tuple) -> [value, kind, help]
    merged: Dict[Tuple[str, Tuple], list] = {}
    order: List[Tuple[str, Tuple]] = []
    for group in sample_groups:
        for s in group:
            key = (s["name"], tuple(sorted(s["tags"].items())))
            if key not in merged:
                merged[key] = [s["value"], s.get("kind", "untyped"),
                               s.get("help", "")]
                order.append(key)
            elif merged[key][1] == "gauge":
                merged[key][0] = s["value"]
            else:  # counters and histogram buckets/sums/counts add up
                merged[key][0] += s["value"]

    families: Dict[str, list] = {}
    for name, tags in order:
        base = name.removesuffix("_bucket").removesuffix(
            "_sum").removesuffix("_count")
        families.setdefault(base, []).append((name, tags))

    lines: List[str] = []
    for base, series in families.items():
        _, kind, help_ = merged[series[0]]
        lines.append(f"# HELP {base} {help_}")
        lines.append(f"# TYPE {base} {kind}")
        for name, tags in series:
            value = merged[(name, tags)][0]
            tag_str = ",".join(f'{k}="{v}"' for k, v in tags)
            lines.append(f"{name}{{{tag_str}}} {value}"
                         if tag_str else f"{name} {value}")
    return "\n".join(lines) + "\n"


# One warning per failure KIND (exception type): metric reporting is
# best-effort by contract, but a silently-failing reporter left stale
# gauges on /metrics for whole incidents before anyone noticed — say it
# once, without turning a flaky GCS into a log flood.
_report_failures_logged: set = set()


def report_to_gcs() -> bool:
    """Push this process's samples to the GCS metrics table. The payload
    carries the reporting period so the GCS can expire this client's
    series once it misses ~3 periods (downscaled replicas must not
    report stale gauges forever)."""
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker()
    if w is None:
        return False
    try:
        w.gcs.notify("report_metrics", {
            "client_id": w.client_id,
            "samples": collect_samples(),
            "ts": time.time(),
            "period_s": _reporter_period_s(),
        })
        return True
    except Exception as e:
        kind = type(e).__name__
        if kind not in _report_failures_logged:
            _report_failures_logged.add(kind)
            logger.warning(
                "metrics report to the GCS failed (%s: %s); further "
                "failures of this kind are not logged", kind, e)
        return False


def lazy_metrics(factory):
    """Zero-arg accessor for a lazily-built metric family: the first
    call runs ``factory()`` (which registers the Counter/Gauge/
    Histogram objects), starts the background reporter, and caches the
    result — so importing a module that DEFINES metrics never spins
    the reporter thread. Thread-safe (double-checked)."""
    lock = threading.Lock()
    cache: List = []

    def get():
        if not cache:
            with lock:
                if not cache:
                    built = factory()
                    start_reporter()
                    cache.append(built)
        return cache[0]

    return get


# Reporter lifecycle: ONE daemon thread per process, stoppable. Every
# subsystem that wants its metrics shipped (lease manager, gang
# supervisor, serve replicas) calls start_reporter(); only the first
# call spawns the thread, and shutdown() joins it — repeated
# init()/shutdown() cycles must not stack reporter threads.
_reporter_lock = threading.Lock()
_reporter_thread: Optional[threading.Thread] = None
_reporter_stop: Optional[threading.Event] = None
_reporter_period = 5.0


def _reporter_period_s() -> float:
    with _reporter_lock:
        return _reporter_period


def start_reporter(period_s: float = 5.0) -> threading.Thread:
    """Start (or return) this process's metrics push loop (the
    per-process analog of the reference's per-node metrics agent push
    loop). Idempotent: the first caller's thread serves everyone; a
    caller asking for a faster period tightens the running loop's."""
    global _reporter_thread, _reporter_stop, _reporter_period
    with _reporter_lock:
        if _reporter_thread is not None and _reporter_thread.is_alive():
            _reporter_period = min(_reporter_period, period_s)
            return _reporter_thread
        _reporter_period = period_s
        stop = threading.Event()
        _reporter_stop = stop

        def loop():
            while not stop.wait(_reporter_period_s()):
                report_to_gcs()

        t = threading.Thread(target=loop, daemon=True, name="rtpu-metrics")
        _reporter_thread = t
        t.start()
        return t


def stop_reporter(timeout: float = 2.0) -> None:
    """Stop and join the reporter thread (called from
    ``ray_tpu_torch.shutdown()``)."""
    global _reporter_thread, _reporter_stop
    with _reporter_lock:
        t, _reporter_thread = _reporter_thread, None
        stop, _reporter_stop = _reporter_stop, None
    if stop is not None:
        stop.set()
    if t is not None and t.is_alive():
        t.join(timeout=timeout)
