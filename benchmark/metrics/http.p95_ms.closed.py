"""95th percentile of every request's latency in a closed loop, sent to
answered (kept for the record: there latency is clients over rate)."""

from benchmark.loadgen import percentile


def read(w):
    if w.loop != "closed":
        return None
    return percentile([r.done - r.sent if r.ok else float("inf") for r in w.records], 95) * 1e3
