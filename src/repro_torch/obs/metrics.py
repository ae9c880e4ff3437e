"""Metrics registry with Prometheus-text and JSON exporters.

Counters, gauges, and histograms with flat string labels — the
host-side, pull-exportable face of the fault pipeline.  Naming follows
Prometheus conventions (``repro_`` prefix, ``_total`` suffix on
counters); the text output of :meth:`MetricsRegistry.to_prometheus` is
valid exposition format a node scraper ingests as-is.

Metric namespace used across the repo:

* ``repro_detections_total{cell=...}`` / ``repro_false_positives_total``
  / ``repro_escapes_total`` / ``repro_injections_total`` — campaign-level
  outcomes, one label per cell id, matching the artifact's CellMetrics;
* ``repro_abft_checks_total`` / ``repro_abft_errors_total``
  ``{op=..., source=...}`` — per-op FaultReport counters as they land
  host-side (serving engine steps, train-loop steps);
* ``repro_steps_total{kind=..., source=...}`` and the
  ``repro_step_duration_ms`` histogram — throughput/latency context.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]

#: default histogram buckets (ms-scale step durations)
DEFAULT_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0)


def _label_key(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_labels(key: _LabelKey, extra: Tuple[Tuple[str, str], ...] = ()
                ) -> str:
    items = key + extra
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help

    def prometheus_lines(self) -> List[str]:
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[_LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def total(self) -> float:
        return sum(self._values.values())

    def prometheus_lines(self) -> List[str]:
        return [f"{self.name}{_fmt_labels(k)} {_fmt_value(v)}"
                for k, v in sorted(self._values.items())]

    def to_json(self) -> dict:
        return {"type": self.kind, "help": self.help,
                "samples": [{"labels": dict(k), "value": v}
                            for k, v in sorted(self._values.items())]}


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:   # may go down
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[_LabelKey, List[int]] = {}
        self._sums: Dict[_LabelKey, float] = {}
        self._totals: Dict[_LabelKey, int] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        counts = self._counts.setdefault(key,
                                         [0] * (len(self.buckets) + 1))
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        self._sums[key] = self._sums.get(key, 0.0) + float(value)
        self._totals[key] = self._totals.get(key, 0) + 1

    def count(self, **labels) -> int:
        return self._totals.get(_label_key(labels), 0)

    def prometheus_lines(self) -> List[str]:
        lines = []
        for key in sorted(self._counts):
            cum = 0
            for i, ub in enumerate(self.buckets):
                cum += self._counts[key][i]
                lines.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(key, (('le', _fmt_value(ub)),))} {cum}")
            cum += self._counts[key][-1]
            lines.append(f"{self.name}_bucket"
                         f"{_fmt_labels(key, (('le', '+Inf'),))} {cum}")
            lines.append(f"{self.name}_sum{_fmt_labels(key)} "
                         f"{_fmt_value(self._sums[key])}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} "
                         f"{self._totals[key]}")
        return lines

    def to_json(self) -> dict:
        return {"type": self.kind, "help": self.help,
                "buckets": list(self.buckets),
                "samples": [{"labels": dict(k),
                             "counts": list(self._counts[k]),
                             "sum": self._sums[k],
                             "count": self._totals[k]}
                            for k in sorted(self._counts)]}


class MetricsRegistry:
    """Get-or-create registry; export order is registration order."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kwargs)
            self._metrics[name] = m
        elif not isinstance(m, cls) or (isinstance(m, Gauge)
                                        != (cls is Gauge)):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, not {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def to_prometheus(self) -> str:
        out = []
        for name, m in self._metrics.items():
            if m.help:
                out.append(f"# HELP {name} {m.help}")
            out.append(f"# TYPE {name} {m.kind}")
            out.extend(m.prometheus_lines())
        return "\n".join(out) + ("\n" if out else "")

    def to_json(self) -> dict:
        return {name: m.to_json() for name, m in self._metrics.items()}

    def write_prometheus(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_prometheus())
        return path

    def write_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
        return path


_DEFAULT: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
    return _DEFAULT


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "DEFAULT_BUCKETS"]
