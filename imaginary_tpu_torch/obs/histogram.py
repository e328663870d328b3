"""Prometheus-native histogram and counter primitives (the port's copy of
`imaginary_tpu/obs/histogram.py`, stdlib only).

Cumulative fixed-bucket histograms (`_bucket{le=}` + `_sum`/`_count`),
which any scraper can re-quantile over any window and sum across
replicas, beside plain and labeled counters. The module owns the
process-wide REGISTRY that /metrics renders:

  * imaginary_tpu_request_duration_seconds      — end-to-end per request
  * imaginary_tpu_stage_duration_seconds{stage=} — per pipeline stage
    (fed by engine/timing.py's record hook)
  * imaginary_tpu_requests_total{route=,code=}   — RED counters per
    route x status class
"""

from __future__ import annotations

import bisect
import threading

# Prometheus' default latency ladder, extended one decade down: the
# decode/encode stages of a cached thumbnail run in the hundreds of
# microseconds and would otherwise all land in the first bucket.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_MAX_SERIES = 512  # per labeled family: a label-cardinality explosion guard


def escape_label_value(v: str) -> str:
    """Exposition-format label escaping (backslash, quote, newline) —
    exactly the three escapes the Prometheus text format defines."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def format_value(v) -> str:
    if isinstance(v, bool):
        v = int(v)
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


class Histogram:
    """Thread-safe fixed-bucket cumulative histogram.

    Buckets optionally carry OpenMetrics-style *exemplars*: the last
    (request_id, trace_id, value) that landed in each bucket, so a
    latency spike links straight to one concrete slow request. Storage
    is O(buckets) — one slot per bucket, last-writer-wins — and
    rendering them is opt-in (/metrics?exemplars=1) because a strict
    0.0.4 text-format parser rejects the trailing ``# {...}`` clause.
    """

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._exemplars: dict = {}  # bucket idx -> (rid, tid, value)
        self._lock = threading.Lock()

    def observe(self, value: float, exemplar=None) -> None:
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if exemplar is not None:
                rid, tid = exemplar
                self._exemplars[idx] = (rid, tid, value)

    def exemplars(self) -> dict:
        with self._lock:
            return dict(self._exemplars)

    def snapshot(self):
        """(cumulative_counts aligned to buckets + [+Inf], sum, count)."""
        with self._lock:
            counts = list(self._counts)
            total_sum, total_count = self._sum, self._count
        cumulative = []
        running = 0
        for c in counts:
            running += c
            cumulative.append(running)
        return cumulative, total_sum, total_count


class Counter:
    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class _LabeledFamily:
    """label-values tuple -> child metric, creation-locked and bounded."""

    def __init__(self, label_names, child_factory):
        self.label_names = tuple(label_names)
        self._children: dict = {}
        self._factory = child_factory
        self._lock = threading.Lock()

    def labels(self, *values):
        if len(values) != len(self.label_names):
            raise ValueError("label value count mismatch")
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if len(self._children) >= _MAX_SERIES:
                        # overflow series: misbehaving labels aggregate
                        # into one bucket instead of growing unbounded
                        key = tuple("_overflow" for _ in key)
                        child = self._children.setdefault(key, self._factory())
                    else:
                        child = self._children[key] = self._factory()
        return child

    def items(self):
        with self._lock:
            return list(self._children.items())


def _label_str(names, values) -> str:
    return ",".join(
        f'{n}="{escape_label_value(v)}"' for n, v in zip(names, values)
    )


class HistogramVec(_LabeledFamily):
    def __init__(self, label_names, buckets=DEFAULT_BUCKETS):
        super().__init__(label_names, lambda: Histogram(buckets))

    def observe(self, label_values, value: float, exemplar=None) -> None:
        self.labels(*label_values).observe(value, exemplar=exemplar)


class CounterVec(_LabeledFamily):
    def __init__(self, label_names):
        super().__init__(label_names, Counter)

    def inc(self, label_values, n: int = 1) -> None:
        self.labels(*label_values).inc(n)


class Registry:
    """Named metric families with HELP/TYPE-correct exposition rendering."""

    def __init__(self):
        self._families: list = []  # (name, help, collector)
        self._lock = threading.Lock()

    def _add(self, name, help_text, metric):
        with self._lock:
            self._families.append((name, help_text, metric))
        return metric

    def histogram(self, name, help_text, buckets=DEFAULT_BUCKETS):
        return self._add(name, help_text, Histogram(buckets))

    def histogram_vec(self, name, help_text, label_names,
                      buckets=DEFAULT_BUCKETS):
        return self._add(name, help_text, HistogramVec(label_names, buckets))

    def counter(self, name, help_text):
        return self._add(name, help_text, Counter())

    def counter_vec(self, name, help_text, label_names):
        return self._add(name, help_text, CounterVec(label_names))

    def render_lines(self, exemplars: bool = False) -> list:
        lines: list = []
        with self._lock:
            families = list(self._families)
        for name, help_text, metric in families:
            if isinstance(metric, Histogram):
                lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} histogram")
                _render_histogram(lines, name, "", metric, exemplars)
            elif isinstance(metric, HistogramVec):
                lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} histogram")
                for values, child in sorted(metric.items()):
                    _render_histogram(
                        lines, name,
                        _label_str(metric.label_names, values), child,
                        exemplars,
                    )
            elif isinstance(metric, Counter):
                lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {metric.value}")
            elif isinstance(metric, CounterVec):
                lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} counter")
                for values, child in sorted(metric.items()):
                    labels = _label_str(metric.label_names, values)
                    lines.append(f"{name}{{{labels}}} {child.value}")
        return lines


def _exemplar_suffix(ex) -> str:
    """OpenMetrics exemplar clause: ` # {labels} value` appended to a
    bucket sample line (only when /metrics?exemplars=1 asks)."""
    rid, tid, value = ex
    return (
        f' # {{trace_id="{escape_label_value(tid)}"'
        f',request_id="{escape_label_value(rid)}"}} '
        f"{repr(float(value))}"
    )


def _render_histogram(lines, name, labels, hist: Histogram,
                      exemplars: bool = False) -> None:
    cumulative, total_sum, total_count = hist.snapshot()
    ex = hist.exemplars() if exemplars else {}
    for idx, (le, c) in enumerate(zip(hist.buckets, cumulative)):
        sep = "," if labels else ""
        tail = _exemplar_suffix(ex[idx]) if idx in ex else ""
        lines.append(
            f'{name}_bucket{{{labels}{sep}le="{format_value(le)}"}} {c}{tail}'
        )
    sep = "," if labels else ""
    inf_idx = len(hist.buckets)
    tail = _exemplar_suffix(ex[inf_idx]) if inf_idx in ex else ""
    lines.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} {total_count}{tail}')
    suffix = f"{{{labels}}}" if labels else ""
    lines.append(f"{name}_sum{suffix} {round(total_sum, 9)}")
    lines.append(f"{name}_count{suffix} {total_count}")


# Process-wide registry (mirrors engine.timing.TIMES: one per serving
# process).
REGISTRY = Registry()

REQUEST_SECONDS = REGISTRY.histogram(
    "imaginary_tpu_request_duration_seconds",
    "End-to-end HTTP request latency in seconds.",
)
STAGE_SECONDS = REGISTRY.histogram_vec(
    "imaginary_tpu_stage_duration_seconds",
    "Per-stage processing latency in seconds (same stages as stageTimesMs).",
    ("stage",),
)
REQUESTS_TOTAL = REGISTRY.counter_vec(
    "imaginary_tpu_requests_total",
    "HTTP requests by route and status class.",
    ("route", "code"),
)
