"""Observability of the port: per-request traces and Prometheus
histograms (`trace.py`, `histogram.py`)."""
