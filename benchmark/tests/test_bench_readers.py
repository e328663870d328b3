"""The readers on canned windows: percentiles over every request from its
due time, /metrics deltas, the profiler's busy union."""

import math

import pytest

from benchmark import loadgen, server, spec, trace
from benchmark.run import Window

METRICS_BEFORE = """\
# TYPE imaginary_tpu_stage_duration_seconds histogram
imaginary_tpu_stage_duration_seconds_sum{stage="decode"} 1.0
imaginary_tpu_stage_duration_seconds_count{stage="decode"} 100
imaginary_tpu_stage_duration_seconds_sum{stage="total"} 2.0
imaginary_tpu_stage_duration_seconds_count{stage="total"} 100
imaginary_tpu_executor_items 100
imaginary_tpu_executor_batches 50
imaginary_tpu_wire_bytes_total{direction="d2h"} 1024
imaginary_tpu_wire_bytes_total{direction="h2d"} 4096
"""
METRICS_AFTER = """\
imaginary_tpu_stage_duration_seconds_sum{stage="decode"} 3.0
imaginary_tpu_stage_duration_seconds_count{stage="decode"} 300
imaginary_tpu_stage_duration_seconds_sum{stage="total"} 4.0
imaginary_tpu_stage_duration_seconds_count{stage="total"} 300
imaginary_tpu_executor_items 300
imaginary_tpu_executor_batches 90
imaginary_tpu_wire_bytes_total{direction="d2h"} 103424
imaginary_tpu_wire_bytes_total{direction="h2d"} 413696
"""


def record(due, sent, done, status=200):
    return loadgen.Record(0, 0, due, sent, done, status, "image/jpeg")


def window(records, loop="open", capture=None):
    return Window("cell", loop, 10.0, 0.0, records, [], server.parse_metrics(METRICS_BEFORE),
                  server.parse_metrics(METRICS_AFTER), 4.0, 12.5, capture)


def read(name, w):
    return spec.metric_reader(name)(w)


def test_percentile_is_nearest_rank_over_all():
    assert loadgen.percentile(list(range(1, 101)), 95) == 95
    assert loadgen.percentile([5.0], 50) == 5.0
    assert loadgen.percentile([1, 2, math.inf, math.inf], 50) == 2


def test_open_loop_latency_counts_from_due_and_failures_as_missing():
    recs = [record(i, i + 0.5, i + 0.6) for i in range(19)] + [record(19, 19.0, 19.1, 503)]
    # from due: 600 ms each (the late send counts); the 503 is infinitely late
    lat = [r.latency_s for r in recs]
    assert loadgen.percentile(lat, 50) * 1e3 == pytest.approx(600.0)
    assert loadgen.percentile(lat, 95) * 1e3 == pytest.approx(600.0)
    recs.append(record(20, 20.0, 20.1, 0))
    assert loadgen.percentile([r.latency_s for r in recs], 95) == math.inf


def test_rate_counts_only_answers_inside_the_window():
    recs = [record(0, 0, 0.1 * i) for i in range(1, 121)]  # done 0.1 .. 12.0 s
    w = window(recs, loop="closed")
    assert read("http.images_per_s.closed", w) == pytest.approx(100 / 10.0)
    assert read("http.images_per_s.closed", window(recs)) is None
    assert read("cpu_ms_per_image", w) == pytest.approx(4.0 / 120 * 1e3)
    assert read("setup_s", w) == 12.5


def test_metric_and_counter_deltas():
    w = window([record(0, 0, 0.01)], loop="closed")
    assert w.stage_ms("decode") == pytest.approx(2.0 / 200 * 1e3)
    assert read("codec.decode_ms", w) == pytest.approx(10.0)
    assert read("executor.avg_batch", w) == pytest.approx(200 / 40)
    assert read("chain.wire_kb_per_image", w) == pytest.approx((102400 + 409600) / 200 / 1024)
    assert math.isnan(w.stage_ms("encode")) and read("codec.encode_ms", w) is None


def test_busy_union_and_idle_share():
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "h2d", "ts": 50.0, "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 400.0, "dur": 100.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 160.0, "dur": 200.0},
          {"ph": "X", "cat": "cpu_op", "name": "other", "ts": 520.0, "dur": 480.0}]
    cap = trace.summarize({"traceEvents": ev})
    assert cap["busy_s"] == pytest.approx(250e-6)  # [0, 150) and [400, 500)
    assert cap["kernel_s"] == pytest.approx(200e-6)
    assert cap["span_us"] == (0.0, 1000.0)
    assert cap["idle_gaps"][0] == ["other", pytest.approx(500e-6)]  # [500, 1000)
    assert cap["idle_gaps"][1] == ["aten::copy_", pytest.approx(250e-6)]  # [150, 400)
    assert cap["device_ops"][0][0] in ("k1", "h2d", "k2")

