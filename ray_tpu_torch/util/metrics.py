"""In-process metric instruments (``Counter``, ``Gauge``, ``Histogram``)
with the names, tags and methods of ``ray_tpu/util/metrics.py``, for the
serving engine. Values stay in the process: the reference's export to the
cluster's dashboard rides its runtime, which is not ported yet. ``value``
reads one tag set back."""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

_DEFAULT_BOUNDARIES = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                       2.5, 5.0, 10.0)

Tags = Optional[Dict[str, str]]


class _Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._lock = threading.Lock()

    def _key(self, tags: Tags) -> Tuple:
        tags = tags or {}
        unknown = set(tags) - set(self.tag_keys)
        if unknown:
            raise ValueError(f"unknown tags {unknown} for {self.name}")
        return tuple((k, tags.get(k, "")) for k in self.tag_keys)


class Counter(_Metric):
    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0, tags: Tags = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        key = self._key(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, tags: Tags = None) -> float:
        with self._lock:
            return self._values.get(self._key(tags), 0.0)


class Gauge(_Metric):
    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, tags: Tags = None) -> None:
        key = self._key(tags)
        with self._lock:
            self._values[key] = float(value)

    def value(self, tags: Tags = None) -> float:
        with self._lock:
            return self._values.get(self._key(tags), 0.0)


class Histogram(_Metric):
    """Bucket counts (each bucket holds the values up to its boundary),
    sum and count per tag set."""

    def __init__(self, name, description="", boundaries=None,
                 tag_keys=None):
        super().__init__(name, description, tag_keys)
        self.boundaries = tuple(boundaries or _DEFAULT_BOUNDARIES)
        self._counts: Dict[Tuple, list] = {}
        self._sums: Dict[Tuple, float] = {}

    def observe(self, value: float, tags: Tags = None) -> None:
        key = self._key(tags)
        i = next((i for i, b in enumerate(self.boundaries) if value <= b),
                 len(self.boundaries))
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value

    def value(self, tags: Tags = None) -> Dict[str, object]:
        key = self._key(tags)
        with self._lock:
            counts = list(self._counts.get(
                key, [0] * (len(self.boundaries) + 1)))
            return {"counts": counts, "sum": self._sums.get(key, 0.0),
                    "count": sum(counts)}
