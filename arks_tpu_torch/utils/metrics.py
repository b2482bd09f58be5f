"""Minimal Prometheus text-format metrics registry (a copy of
``arks_tpu/utils/metrics.py``: the same families render the same text).

The engine's ``EngineMetrics`` registers its families here and the
server's ``GET /metrics`` renders them.  Thread-safe; stdlib only.
"""

from __future__ import annotations

import threading
from bisect import bisect_left


def _escape_label_value(v: str) -> str:
    # Prometheus text exposition format: label values escape backslash,
    # double-quote, and line-feed — in that order (backslash first, or
    # the other escapes get double-escaped).
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    return repr(v) if isinstance(v, float) and not v.is_integer() else str(int(v))


class _Metric:
    def __init__(self, name: str, help_: str, typ: str):
        self.name, self.help, self.type = name, help_, typ
        self._lock = threading.Lock()

    def header(self) -> list[str]:
        return [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.type}"]


class Counter(_Metric):
    def __init__(self, name: str, help_: str = ""):
        super().__init__(name, help_, "counter")
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def total(self) -> float:
        """Sum over every label combination (e.g. a tier-labeled family
        read as one number — what an unlabeled scrape used to return)."""
        with self._lock:
            return sum(self._values.values())

    def collect(self) -> list[str]:
        with self._lock:
            items = list(self._values.items())
        out = self.header()
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(dict(key))} {_fmt_value(v)}")
        return out


class Gauge(_Metric):
    def __init__(self, name: str, help_: str = ""):
        super().__init__(name, help_, "gauge")
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def total(self) -> float:
        """Sum over every label combination (see Counter.total)."""
        with self._lock:
            return sum(self._values.values())

    def collect(self) -> list[str]:
        with self._lock:
            items = list(self._values.items())
        out = self.header()
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(dict(key))} {_fmt_value(v)}")
        return out


class Histogram(_Metric):
    def __init__(self, name: str, help_: str = "", buckets: list[float] | None = None):
        super().__init__(name, help_, "histogram")
        self.buckets = sorted(buckets or [0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60])
        self._data: dict[tuple, tuple[list[int], float, int]] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            if key not in self._data:
                self._data[key] = ([0] * len(self.buckets), 0.0, 0)
            counts, total, n = self._data[key]
            i = bisect_left(self.buckets, value)
            for j in range(i, len(self.buckets)):
                counts[j] += 1
            self._data[key] = (counts, total + value, n + 1)

    def collect(self) -> list[str]:
        with self._lock:
            items = [(k, (list(c), t, n)) for k, (c, t, n) in self._data.items()]
        out = self.header()
        for key, (counts, total, n) in items:
            base = dict(key)
            for b, c in zip(self.buckets, counts):
                out.append(f"{self.name}_bucket{_fmt_labels({**base, 'le': _fmt_value(float(b))})} {c}")
            out.append(f"{self.name}_bucket{_fmt_labels({**base, 'le': '+Inf'})} {n}")
            out.append(f"{self.name}_sum{_fmt_labels(base)} {_fmt_value(total)}")
            out.append(f"{self.name}_count{_fmt_labels(base)} {n}")
        return out


class Registry:
    def __init__(self) -> None:
        self._metrics: list[_Metric] = []
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._register(Counter(name, help_))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._register(Gauge(name, help_))

    def histogram(self, name: str, help_: str = "", buckets: list[float] | None = None) -> Histogram:
        return self._register(Histogram(name, help_, buckets))

    def _register(self, m):
        with self._lock:
            for existing in self._metrics:
                if existing.name == m.name:
                    raise ValueError(
                        f"metric family {m.name!r} registered twice")
            self._metrics.append(m)
        return m

    def families(self) -> list[_Metric]:
        """Snapshot of registered metric families (for conformance tests)."""
        with self._lock:
            return list(self._metrics)

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics)
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"
