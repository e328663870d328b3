"""Reading the card's side of a torch.profiler capture (a Chrome trace).

Device activity is every event of category `kernel`, `gpu_memcpy` or
`gpu_memset`. The card is busy where any of them runs (the union of their
intervals, so a copy beside a kernel counts once); idle elsewhere in the
capture. Each idle gap is named by the host operation that overlaps it
most (`cpu_op` or `cuda_runtime` events), or "untraced host work".
"""

from __future__ import annotations

import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _spans(events, cats) -> list:
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", ""))
                  for e in events if e.get("ph") == "X" and e.get("cat") in cats)


def merge(spans) -> list:
    """The union of (start, end, ...) intervals as sorted disjoint (start, end)."""
    out: list = []
    for a, b, *_ in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def summarize(doc: dict, top: int = 10) -> dict:
    """Busy and kernel seconds, the span covered, the device operations
    that took most time and the longest idle gaps, of one capture. Times
    in seconds; `span_us` is the capture's (first, last) event on the
    trace's own clock, `base_ns` that clock's epoch offset."""
    events = doc.get("traceEvents", [])
    dev = _spans(events, DEVICE_CATS)
    kernels = _spans(events, ("kernel",))
    busy = merge(dev)
    every = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in events if e.get("ph") == "X" and "ts" in e]
    span = (min(a for a, _ in every), max(b for _, b in every)) if every else (0.0, 0.0)
    by_name: dict = collections.defaultdict(float)
    for a, b, name in dev:
        by_name[name] += b - a
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy:
        gaps = [(span[0], busy[0][0])] + gaps + [(busy[-1][1], span[1])]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:top]
    host = _spans(events, HOST_CATS)
    named_gaps = []
    for a, b in gaps:
        best, name = 0.0, "untraced host work"
        for ha, hb, hname in host:
            if ha >= b:
                break
            overlap = min(b, hb) - max(a, ha)
            if overlap > best:
                best, name = overlap, hname
        named_gaps.append([name, (b - a) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernel_s": sum(b - a for a, b, _ in kernels) * 1e-6,
        "device_events": len(dev),
        "span_us": span,
        "base_ns": float(doc.get("baseTimeNanoseconds", 0)),
        "device_ops": [[n, s * 1e-6] for n, s in ops],
        "idle_gaps": named_gaps,
    }
