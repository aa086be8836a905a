"""Prometheus-style metrics with text exposition: the part of
``kubeflow_tpu/utils/metrics.py`` the telemetry agent uses, the port's own
copy (it imports nothing of ``kubeflow_tpu``).

Counters, gauges and cumulative-bucket histograms in a :class:`Registry`,
exposed in Prometheus text format with the reference's bytes: the same
escaping, value formatting, family order and empty-family rules, so a scrape
of the port's agent reads as the reference agent's does. A family's label
names are fixed at registration when ``labelnames`` is passed, else by its
first observation; a later call with other label names raises ``ValueError``.
"""
from __future__ import annotations

import bisect
import threading
from typing import Sequence

# prometheus DefBuckets: tuned for request/reconcile latencies in seconds
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def escape_label_value(v: str) -> str:
    """Exposition-format label escaping: backslash, quote, newline."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def escape_help(v: str) -> str:
    """HELP text escaping: backslash and newline (quotes are legal there)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def format_value(v: float) -> str:
    """Sample value formatting: integers render exactly (counters must not
    round through %g's 6 significant digits), floats keep full precision."""
    if v == int(v) and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v))


class _Metric:
    def __init__(self, name: str, help_: str, kind: str,
                 labelnames: Sequence[str] | None = None,
                 buckets: Sequence[float] | None = None) -> None:
        self.name, self.help, self.kind = name, help_, kind
        # counters/gauges: key -> float; histograms: key -> [bucket counts...,
        # +Inf count, sum] (one list per label set, len(buckets) + 2)
        self._values: dict[tuple, object] = {}
        # None = not yet frozen; () = frozen unlabeled
        self._label_names: tuple[str, ...] | None = (
            tuple(labelnames) if labelnames is not None else None)
        if kind == "histogram":
            bs = tuple(sorted(buckets if buckets is not None else DEFAULT_BUCKETS))
            if not bs:
                raise ValueError(f"histogram {name!r} needs at least one bucket")
            self.buckets: tuple[float, ...] = bs
        self._lock = threading.Lock()

    def _key(self, labels) -> tuple:
        names = tuple(sorted(labels))
        if self._label_names is None:
            self._label_names = names
        elif names != tuple(sorted(self._label_names)):
            raise ValueError(
                f"metric {self.name!r} has labels {sorted(self._label_names)}, got "
                f"{sorted(names)} — a family's label names are fixed at registration/first use")
        return tuple(labels[n] for n in self._label_names)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if self.kind == "histogram":
            raise TypeError(f"{self.name}: use observe() on histograms")
        with self._lock:
            k = self._key(labels)
            self._values[k] = self._values.get(k, 0.0) + amount

    def set(self, value: float, **labels: str) -> None:
        if self.kind == "histogram":
            raise TypeError(f"{self.name}: use observe() on histograms")
        with self._lock:
            self._values[self._key(labels)] = value

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def observe(self, value: float, **labels: str) -> None:
        if self.kind != "histogram":
            raise TypeError(f"{self.name}: observe() is histogram-only")
        with self._lock:
            k = self._key(labels)
            cells = self._values.get(k)
            if cells is None:
                cells = [0] * (len(self.buckets) + 1) + [0.0]
                self._values[k] = cells
            cells[bisect.bisect_left(self.buckets, value)] += 1  # cumulated at expose
            cells[-1] += value

    def _labelstr(self, key: tuple, extra: str = "") -> str:
        parts = [f'{n}="{escape_label_value(v)}"' for n, v in zip(self._label_names or (), key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            if not self._values:
                # an empty unlabeled counter or gauge still exposes its zero;
                # a labeled or histogram family with no series exposes none
                if not self._label_names and self.kind != "histogram":
                    lines.append(f"{self.name} 0")
                return "\n".join(lines)
            for key, val in sorted(self._values.items()):
                if self.kind != "histogram":
                    lines.append(f"{self.name}{self._labelstr(key)} {format_value(val)}")
                    continue
                cum = 0
                for i, bound in enumerate(self.buckets):
                    cum += val[i]
                    le = 'le="' + format_value(bound) + '"'
                    lines.append(f"{self.name}_bucket{self._labelstr(key, le)} {cum}")
                cum += val[len(self.buckets)]
                inf = 'le="+Inf"'
                lines.append(f"{self.name}_bucket{self._labelstr(key, inf)} {cum}")
                lines.append(f"{self.name}_sum{self._labelstr(key)} {format_value(val[-1])}")
                lines.append(f"{self.name}_count{self._labelstr(key)} {cum}")
        return "\n".join(lines)


class Registry:
    """Metric families in registration order, and the hooks run before each
    exposition (the live-scrape idiom)."""

    def __init__(self) -> None:
        self._metrics: list[_Metric] = []
        self._pre_expose: list = []

    def pre_expose(self, fn) -> None:
        """Run ``fn()`` before each exposition."""
        self._pre_expose.append(fn)

    def counter(self, name: str, help_: str, labelnames: Sequence[str] | None = None) -> _Metric:
        return self._add(_Metric(name, help_, "counter", labelnames))

    def gauge(self, name: str, help_: str, labelnames: Sequence[str] | None = None) -> _Metric:
        return self._add(_Metric(name, help_, "gauge", labelnames))

    def histogram(self, name: str, help_: str, labelnames: Sequence[str] | None = None,
                  buckets: Sequence[float] | None = None) -> _Metric:
        return self._add(_Metric(name, help_, "histogram", labelnames, buckets))

    def _add(self, m: _Metric) -> _Metric:
        """A family registered once a name: the existing one for a repeat of
        its kind and label names, ``ValueError`` for another kind or names."""
        for existing in self._metrics:
            if existing.name != m.name:
                continue
            if existing.kind != m.kind:
                raise ValueError(f"metric {m.name!r} already registered as {existing.kind}, "
                                 f"not {m.kind}")
            if m._label_names is not None:
                if existing._label_names is None:
                    existing._label_names = m._label_names
                elif tuple(existing._label_names) != tuple(m._label_names):
                    raise ValueError(
                        f"metric {m.name!r} already registered with labels "
                        f"{sorted(existing._label_names)}, got {sorted(m._label_names)} — one "
                        "registry, one schema per family")
            return existing
        self._metrics.append(m)
        return m

    def expose(self) -> str:
        for fn in self._pre_expose:
            fn()
        return "\n".join(m.expose() for m in self._metrics) + "\n"
