"""Typed, thread-safe metrics registry — the one place counters live.

The reference stack scrapes Spark's metrics servlet; after six PRs our
equivalent was three process-global counter dicts in ``utils/profiling.py``
all serialized on ONE shared lock and readable only by bench.py. This
registry replaces them underneath (the legacy ``exec_counters()`` /
``serve_counters()`` / ``resilience_counters()`` shims keep their exact
field contract) and adds what a production operator needs:

* typed metrics — ``Counter`` (monotonic, float-valued), ``Gauge``
  (set/inc/dec), ``Histogram`` (fixed bucket bounds + sum/count, percentile
  estimation by linear interpolation inside the landing bucket);
* labels — each metric holds one value per label-tuple (``retries_total``
  broken out by ``cause=``, etc.), created on first touch;
* per-metric locking — two subsystems ticking different metrics never
  contend (the old design put the xla-compile listener, every serve tick
  and every dispatch tick behind one ``_exec_lock``);
* two exports — ``snapshot()`` (JSON-able nested dict: the bench ``obs``
  key, the run-report counter deltas) and ``to_prometheus()`` (text
  exposition format 0.0.4: the ``/metrics`` endpoint body).

The registry itself is always live — the ``OTPU_OBS=0`` kill-switch
no-ops spans and the telemetry endpoint, but the counter shims (and every
test/bench reading them) keep working unchanged.
"""

from __future__ import annotations

import math
import threading
from typing import Iterable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "get_registry",
]

# prometheus-style defaults, widened for the second-to-minutes range our
# stage timings span (seconds everywhere — the unit rides the metric name)
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_NO_LABELS = ()


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items())) if labels else _NO_LABELS


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{name}="{_escape(str(val))}"' for name, val in key)
    return "{" + inner + "}"


class _Metric:
    """Shared label-child plumbing; one lock per metric."""

    kind = "untyped"

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc
        self._lock = threading.Lock()
        self._children: dict = {}

    def labels(self) -> list[dict]:
        with self._lock:
            return [dict(k) for k in self._children]

    def reset(self) -> None:
        with self._lock:
            self._children.clear()


class Counter(_Metric):
    """Monotonic float counter (``_total`` naming convention)."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (inc {n})")
        key = _label_key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + n

    def value(self, **labels) -> float:
        key = _label_key(labels)
        with self._lock:
            return self._children.get(key, 0.0)

    def total(self) -> float:
        """Sum across every label child (the legacy flat-counter view)."""
        with self._lock:
            return sum(self._children.values())

    def per_label(self, label_name: str) -> dict:
        """{label value: count} for one label dimension (the legacy
        ``retries_by_cause``-style breakdown)."""
        out: dict = {}
        with self._lock:
            for key, v in self._children.items():
                for name, val in key:
                    if name == label_name:
                        out[val] = out.get(val, 0.0) + v
        return out


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._children[_label_key(labels)] = float(v)

    def inc(self, n: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + n

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._children.get(_label_key(labels), 0.0)


class Histogram(_Metric):
    """Fixed-bound bucket histogram (per-child: counts[], sum, count)."""

    kind = "histogram"

    def __init__(self, name: str, doc: str = "",
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, doc)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"{name}: needs at least one bucket bound")
        self.buckets = bs

    def _child(self, key):
        c = self._children.get(key)
        if c is None:
            # counts has one extra slot for the +Inf overflow bucket
            c = self._children[key] = {
                "counts": [0] * (len(self.buckets) + 1),
                "sum": 0.0, "count": 0,
            }
        return c

    def observe(self, v: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            c = self._child(key)
            i = 0
            for i, b in enumerate(self.buckets):  # noqa: B007
                if v <= b:
                    break
            else:
                i = len(self.buckets)
            c["counts"][i] += 1
            c["sum"] += v
            c["count"] += 1

    def count(self, **labels) -> int:
        with self._lock:
            c = self._children.get(_label_key(labels))
            return c["count"] if c else 0

    def sum(self, **labels) -> float:
        with self._lock:
            c = self._children.get(_label_key(labels))
            return c["sum"] if c else 0.0

    def percentile(self, q: float, **labels) -> float | None:
        """Estimated q-th percentile (0..100) by linear interpolation
        inside the landing bucket; None on an empty child. The overflow
        bucket has no upper bound — its estimate is the last bound."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        with self._lock:
            c = self._children.get(_label_key(labels))
            if c is None or c["count"] == 0:
                return None
            counts = list(c["counts"])
            total = c["count"]
        rank = q / 100.0 * total
        cum = 0
        for i, n in enumerate(counts):
            if cum + n >= rank and n > 0:
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                hi = self.buckets[min(i, len(self.buckets) - 1)]
                frac = (rank - cum) / n if n else 0.0
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += n
        return self.buckets[-1]


class MetricsRegistry:
    """Name -> metric map with get-or-create constructors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    # ------------------------------------------------------ constructors
    def _get_or_create(self, cls, name, doc, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, doc, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, doc: str = "") -> Counter:
        return self._get_or_create(Counter, name, doc)

    def gauge(self, name: str, doc: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, doc)

    def histogram(self, name: str, doc: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, doc, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self, names: Iterable[str] | None = None) -> None:
        """Zero the named metrics (all when None) — values clear, the
        metric objects (and callers' references to them) stay registered."""
        with self._lock:
            targets = [self._metrics[n] for n in names
                       if n in self._metrics] if names is not None \
                else list(self._metrics.values())
        for m in targets:
            m.reset()

    # ----------------------------------------------------------- exports
    @staticmethod
    def _copy_children(m) -> dict:
        """Deep-enough copy UNDER the metric lock: the histogram counts
        list must be duplicated too, or a concurrent observe() mutates
        the list a reader is iterating outside the lock and the exported
        buckets disagree with the copied count/sum."""
        with m._lock:
            return {
                k: ({"counts": list(v["counts"]), "sum": v["sum"],
                     "count": v["count"]} if isinstance(v, dict) else v)
                for k, v in m._children.items()
            }

    def snapshot(self) -> dict:
        """JSON-able nested view of every metric's current children."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict = {}
        for m in metrics:
            children = self._copy_children(m)
            values = []
            for key, v in sorted(children.items()):
                entry: dict = {"labels": dict(key)}
                if m.kind == "histogram":
                    entry["count"] = v["count"]
                    entry["sum"] = round(v["sum"], 9)
                    entry["buckets"] = {
                        _fmt_value(b): c for b, c in zip(
                            list(m.buckets) + [math.inf], v["counts"])}
                else:
                    entry["value"] = v
                values.append(entry)
            out[m.name] = {"type": m.kind, "doc": m.doc, "values": values}
        return out

    def to_prometheus(self) -> str:
        """Text exposition format 0.0.4 (the ``/metrics`` body)."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in sorted(metrics, key=lambda m: m.name):
            if m.doc:
                lines.append(f"# HELP {m.name} {_escape(m.doc)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            children = self._copy_children(m)
            if not children and m.kind != "histogram":
                # exposing the zero keeps scraped dashboards continuous
                lines.append(f"{m.name} 0")
            for key, v in sorted(children.items()):
                if m.kind == "histogram":
                    base = m.name
                    cum = 0
                    for b, c in zip(list(m.buckets) + [math.inf],
                                    v["counts"]):
                        cum += c
                        lk = list(key) + [("le", _fmt_value(b))]
                        lines.append(
                            f"{base}_bucket{_label_str(tuple(lk))} {cum}")
                    lines.append(
                        f"{base}_sum{_label_str(key)} {_fmt_value(v['sum'])}")
                    lines.append(
                        f"{base}_count{_label_str(key)} {v['count']}")
                else:
                    lines.append(
                        f"{m.name}{_label_str(key)} {_fmt_value(v)}")
        return "\n".join(lines) + "\n"


#: the process-wide registry every subsystem ticks into
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
