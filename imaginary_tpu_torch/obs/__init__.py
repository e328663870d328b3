"""Observability of the port: per-request traces and Prometheus
histograms (`trace.py`, `histogram.py`), wide events and their tail
sampling (`events.py`), /debugz and its profiler capture (`debugz.py`),
the SLO engine (`slo.py`), the cost and capacity plane (`cost.py`) and
the event-loop lag probe (`looplag.py`)."""
