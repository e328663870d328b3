"""Event-loop lag sampler (the port's copy of `imaginary_tpu/obs/looplag.py`).

A busy or wedged asyncio loop delays every request's admission, header
flush and response write, and no stage ledger sees it: they time work,
not the gaps between scheduling chances. The probe sleeps a fixed
interval and compares `loop.time()`'s advance with it; the overshoot is
the scheduling lag every coroutine met in that window.

Surfaces:
  * the `imaginary_tpu_event_loop_lag_seconds` histogram (every sample);
  * `/health`'s `eventLoop` block and, off it, the
    `imaginary_tpu_event_loop_lag_last_seconds` / `_max_seconds` gauges;
  * a `loop_lag_ms` stamp on a wide event when the last sample exceeded
    WIDE_EVENT_THRESHOLD_MS.

On whenever the server runs (started and stopped with the app, about 4
wakeups a second); the state is module-level like TIMES, one loop per
serving process.
"""

from __future__ import annotations

import asyncio
import threading

from imaginary_tpu_torch.obs.histogram import REGISTRY

_INTERVAL_S = 0.25
# below this a sample is ordinary CPython scheduling jitter
WIDE_EVENT_THRESHOLD_MS = 50.0

LOOP_LAG_SECONDS = REGISTRY.histogram(
    "imaginary_tpu_event_loop_lag_seconds",
    "Event-loop scheduling lag per 0.25s probe, in seconds.",
)

_lock = threading.Lock()
_state = {"last_ms": 0.0, "max_ms": 0.0, "samples": 0}


async def _run(interval: float) -> None:
    loop = asyncio.get_running_loop()
    while True:
        t0 = loop.time()
        await asyncio.sleep(interval)
        lag = max(0.0, loop.time() - t0 - interval)
        LOOP_LAG_SECONDS.observe(lag)
        lag_ms = lag * 1000.0
        with _lock:
            _state["last_ms"] = lag_ms
            if lag_ms > _state["max_ms"]:
                _state["max_ms"] = lag_ms
            _state["samples"] += 1


def start(interval: float = _INTERVAL_S):
    """Spawn the probe task on the running loop (the app's startup);
    returns the task for `stop`."""
    return asyncio.get_running_loop().create_task(_run(interval), name="looplag-probe")


def stop(task) -> None:
    if task is not None:
        task.cancel()


def last_ms() -> float:
    with _lock:
        return _state["last_ms"]


def snapshot():
    """The `eventLoop` block of /health, or None before the first sample
    (a process that never ran a loop reports nothing, not zeros)."""
    with _lock:
        if _state["samples"] == 0:
            return None
        return {
            "lagMsLast": round(_state["last_ms"], 3),
            "lagMsMax": round(_state["max_ms"], 3),
            "samples": _state["samples"],
        }
