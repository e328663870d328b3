"""Per-stage timing of the executor (the port's copy of
`imaginary_tpu/engine/timing.py`: `StageTimes`/`TIMES`, the lanes'
`LaneStageTimes`/`LANE_TIMES`, the link ledger `WireLedger`/`WIRE`, the
byte-touch ledger `CopyLedger`/`COPIES` and the profiler capture).

Each stage records into a bounded ring, so /health can report count,
mean, p50 and p99 without unbounded memory, and into the stage
histogram that /metrics renders (obs/histogram.py). The pipeline records
probe, decode, encode and total on the request's host-pool thread, where
each sample also becomes a span of the request's trace (obs/trace.py).
The executor records the rest, all in milliseconds per item:

- queue_wait: submit -> launch issued (batch_form + dispatch_wait);
- batch_form: submit -> chunk close (bounded by the formation cap);
- dispatch_wait: chunk close -> launch issued (time behind in-flight
  chunks, when the bounded fetch queue held the collector back);
- launch: the collector's host time to stage and enqueue a chunk
  (H2D, kernels, D2H), shared over its items;
- drain: fetch start -> host bytes landed (the wait on the chunk's
  event), shared over its items;
- device_wait and d2h, only with a cost plane bound (obs/cost.py): the
  drain split at a second event recorded after the chunk's kernels and
  before its copy back to the host (ops/chain.py): fetch start -> the
  kernels done, then the copy.

The profiler capture (`start_profiler`, `stop_profiler`): a
torch.profiler session over the whole process, of the host and, on a
CUDA server, of the card (CUPTI records every kernel and copy whatever
thread launched it), exported as a Chrome trace. /debugz/profile takes
one from a live server (obs/debugz.py); IMAGINARY_TPU_PROFILE_DIR takes
one of the whole serving run from boot to exit (cli.py).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from imaginary_tpu_torch.obs import histogram as _obs_hist
from imaginary_tpu_torch.obs import trace as _obs_trace

_RING = 2048  # samples kept per stage for percentile estimates

STAGES = ("probe", "decode", "queue_wait", "batch_form", "dispatch_wait",
          "launch", "drain", "device_wait", "d2h", "host_gate", "host_spill",
          "encode", "total")

# the per-stage histogram children, resolved once (record is the hot path)
_STAGE_HISTS = {s: _obs_hist.STAGE_SECONDS.labels(s) for s in STAGES}


class StageTimes:
    """Thread-safe per-stage latency aggregator."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sum = {s: 0.0 for s in STAGES}
        self._count = {s: 0 for s in STAGES}
        self._ring = {s: np.zeros(_RING, dtype=np.float32) for s in STAGES}
        self._pos = {s: 0 for s in STAGES}

    def record(self, stage: str, ms: float) -> None:
        with self._lock:
            self._sum[stage] += ms
            self._count[stage] += 1
            self._ring[stage][self._pos[stage]] = ms
            self._pos[stage] = (self._pos[stage] + 1) % _RING
        # outside the lock: the histogram, and the sample as a span of the
        # request whose context the recording thread runs in (pool threads
        # do; the executor's collector and fetcher threads do not)
        _STAGE_HISTS[stage].observe(ms / 1000.0)
        tr = _obs_trace.current()
        if tr is not None:
            tr.add_span(stage, ms)

    def snapshot(self) -> dict:
        out = {}
        with self._lock:
            for s in STAGES:
                c = self._count[s]
                if not c:
                    continue
                n = min(c, _RING)
                window = np.sort(self._ring[s][:n])
                out[s] = {
                    "count": c,
                    "mean_ms": round(self._sum[s] / c, 3),
                    "p50_ms": round(float(window[int(0.50 * (n - 1))]), 3),
                    "p99_ms": round(float(window[int(0.99 * (n - 1))]), 3),
                }
        return out

    def totals(self) -> dict:
        """{stage: (count, cumulative ms)}: the monotonic view the capacity
        plane's utilization sampler diffs between snapshots."""
        with self._lock:
            return {s: (self._count[s], self._sum[s]) for s in STAGES if self._count[s]}

    def reset(self) -> None:
        with self._lock:
            for s in STAGES:
                self._sum[s] = 0.0
                self._count[s] = 0
                self._pos[s] = 0


# Process-wide registry: the executor and /health share it.
TIMES = StageTimes()


def attribute(stage_ms) -> None:
    """Add an executor item's stage times ({stage: ms}, carried back on
    its future) to the current request's trace, on the thread that
    waited for the result."""
    tr = _obs_trace.current()
    if tr is None or not stage_ms:
        return
    for stage, ms in stage_ms.items():
        tr.add_span(stage, ms)


class WireLedger:
    """Bytes that actually cross the host<->device link, booked where the
    chain runner moves them (ops/chain.py): each launch's one staged H2D
    buffer (the batch, its valid dims and its per-image params, at their
    16-byte offsets), and each copy of an output into host memory (D2H).
    The sharded and spatial launches book under their device's label too
    (`by_device`). Device-to-device copies (the spatial route's window and
    halo exchange, its gather) never touch the link and are not booked.
    Monotonic totals with the transfer counts beside them, process-wide
    like TIMES; /metrics shows them as
    imaginary_tpu_wire_bytes_total{direction=}."""

    def __init__(self):
        self._lock = threading.Lock()
        self._bytes = {"h2d": 0, "d2h": 0}
        self._transfers = {"h2d": 0, "d2h": 0}
        # direction -> device label -> bytes, only for callers that name a
        # device (the sharded and spatial launches)
        self._by_device: dict = {"h2d": {}, "d2h": {}}

    def add(self, direction: str, nbytes: int, device=None) -> None:
        with self._lock:
            self._bytes[direction] += int(nbytes)
            self._transfers[direction] += 1
            if device is not None:
                dd = self._by_device[direction]
                dd[str(device)] = dd.get(str(device), 0) + int(nbytes)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "h2d": self._bytes["h2d"],
                "d2h": self._bytes["d2h"],
                "h2d_transfers": self._transfers["h2d"],
                "d2h_transfers": self._transfers["d2h"],
            }
            if self._by_device["h2d"] or self._by_device["d2h"]:
                out["by_device"] = {
                    "h2d": dict(self._by_device["h2d"]),
                    "d2h": dict(self._by_device["d2h"]),
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._bytes = {"h2d": 0, "d2h": 0}
            self._transfers = {"h2d": 0, "d2h": 0}
            self._by_device = {"h2d": {}, "d2h": {}}


WIRE = WireLedger()


class CopyLedger:
    """Host bytes copied per stage of a request's journey, with the count
    of copy events beside them, so copies per request stay derivable. The
    port books "decode" (the codec's pixels, packed planes or
    coefficients), "transform" (the chain's frame drained to host memory)
    and "encode" (the body, again when metadata is spliced into it).
    Monotonic totals, process-wide; /metrics shows them as
    imaginary_tpu_bytes_copied_total{stage=} and
    imaginary_tpu_copy_events_total{stage=}. The bytes booked on a thread
    that carries the trace of a request a cost plane books (the handler
    and the pool's threads do; `RequestTrace.cost`) are that request's
    `cost_copied_bytes`, and a cache hit's also its `cost_cache_bytes`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._bytes: dict = {}
        self._copies: dict = {}

    def add(self, stage: str, nbytes: int, copies: int = 1) -> None:
        with self._lock:
            self._bytes[stage] = self._bytes.get(stage, 0) + int(nbytes)
            self._copies[stage] = self._copies.get(stage, 0) + int(copies)
        tr = _obs_trace.current()
        if tr is not None and tr.cost is not None:
            tr.accumulate("cost_copied_bytes", int(nbytes))
            if stage == "cache_hit":
                tr.accumulate("cost_cache_bytes", int(nbytes))

    def snapshot(self) -> dict:
        with self._lock:
            return {"bytes": dict(self._bytes), "copies": dict(self._copies)}

    def reset(self) -> None:
        with self._lock:
            self._bytes = {}
            self._copies = {}


COPIES = CopyLedger()


class LaneStageTimes:
    """Per-lane split of batch_form, dispatch_wait and drain (the lane
    tier): a count and an EWMA per (lane, stage), so a slow lane shows
    apart from its peers; the fleet percentiles stay in TIMES."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cells: dict = {}  # (lane, stage) -> [count, ewma_ms, total_ms]

    def record(self, lane: int, stage: str, ms: float) -> None:
        with self._lock:
            cell = self._cells.get((lane, stage))
            if cell is None:
                self._cells[(lane, stage)] = [1, ms, ms]
            else:
                cell[0] += 1
                cell[1] = 0.8 * cell[1] + 0.2 * ms
                cell[2] += ms

    def snapshot(self) -> dict:
        """{lane: {stage: {count, ewma_ms, total_ms}}}; empty when no lane
        recorded."""
        with self._lock:
            out: dict = {}
            for (lane, stage), (count, ewma, total) in self._cells.items():
                out.setdefault(lane, {})[stage] = {
                    "count": count, "ewma_ms": round(ewma, 3),
                    "total_ms": round(total, 3)}
            return out

    def totals(self) -> dict:
        """{(lane, stage): cumulative ms}, for the utilization deltas."""
        with self._lock:
            return {k: cell[2] for k, cell in self._cells.items()}


LANE_TIMES = LaneStageTimes()

# the active capture: (torch.profiler.profile, trace dir, records the card)
_profiler = None
_profiler_lock = threading.Lock()


def start_profiler(trace_dir: str, device="cpu") -> bool:
    """Start a torch.profiler capture that stop_profiler exports into
    `trace_dir`: the host's activity, and on a CUDA `device` the card's
    too. False when a capture is already active (one at a time, as the
    reference's). On the card a marker op runs right after the start, so
    a capture that recorded no card activity at all is a profiler that
    cannot see the card, never an idle one (stop_profiler refuses it)."""
    global _profiler
    with _profiler_lock:
        if _profiler is not None:
            return False
        import torch
        from torch.profiler import ProfilerActivity, profile

        dev = torch.device(device)
        cuda = dev.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities)
        prof.start()
        if cuda:
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize(dev)
        _profiler = (prof, trace_dir, cuda)
        return True


def profiler_active() -> bool:
    with _profiler_lock:
        return _profiler is not None


def maybe_start_profiler(device="cpu") -> bool:
    """Start a capture of the whole serving run when
    IMAGINARY_TPU_PROFILE_DIR is set; stop_profiler (at exit) exports it.
    Returns True if one started."""
    trace_dir = os.environ.get("IMAGINARY_TPU_PROFILE_DIR")
    if not trace_dir:
        return False
    return start_profiler(trace_dir, device)


def stop_profiler() -> dict:
    """Stop the active capture and export it as a Chrome trace into its
    directory: {"trace_file", "activities", "device_events"} ({} when
    none was active). Raises RuntimeError, exporting nothing, when a
    capture of the card recorded no card activity."""
    global _profiler
    with _profiler_lock:
        state = _profiler
        if state is None:
            return {}
        prof, trace_dir, cuda = state
        try:
            prof.stop()
            device_events = 0
            if cuda:
                from torch.autograd import DeviceType

                device_events = sum(1 for e in prof.events()
                                    if e.device_type == DeviceType.CUDA)
                if device_events == 0:
                    raise RuntimeError(
                        "the profiler recorded no CUDA activity (CUPTI sees no "
                        "kernel on this card); no trace was written")
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(trace_dir, f"imaginary_tpu_torch-{os.getpid()}-"
                                           f"{time.time_ns()}.pt.trace.json")
            prof.export_chrome_trace(path)
        finally:
            _profiler = None
    return {"trace_file": path, "activities": ["cpu", "cuda"] if cuda else ["cpu"],
            "device_events": device_events}
