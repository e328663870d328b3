"""Runtime introspection for the gated /debugz routes (the port's copy of
`imaginary_tpu/obs/debugz.py`).

Everything here reads live process state; only the one-shot profiler
capture changes any. The routes are off by default (`--enable-debug`):
a task dump and a cache summary are an information surface that an
internet-facing deployment must opt into.

SLOW is the slow-request exemplar ring: the trace middleware notes every
completed request's wide event, and /debugz reports the slowest of the
recent window with their full span timelines.

`profile_capture` is /debugz/profile: a torch.profiler capture of the
live process (engine/timing.start_profiler), on a CUDA server of the
host and of the card (CUPTI), exported as a Chrome trace into ?dir=.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import os
import threading
from collections import deque

_RING_KEEP = 256  # recent completed requests kept for exemplar mining


class SlowRing:
    """Ring of recent request events, mined for the slowest exemplars."""

    def __init__(self, keep: int = _RING_KEEP):
        self._ring: deque = deque(maxlen=keep)
        self._lock = threading.Lock()

    def note(self, event: dict) -> None:
        with self._lock:
            self._ring.append(event)

    def slowest(self, n: int = 32) -> list:
        with self._lock:
            recent = list(self._ring)
        recent.sort(key=lambda e: e.get("duration_ms", 0.0), reverse=True)
        return recent[:n]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


SLOW = SlowRing()


def task_dump(limit: int = 200) -> list:
    """Summaries of every live asyncio task on the current loop."""
    try:
        tasks = asyncio.all_tasks()
    except RuntimeError:  # no running loop
        return []
    out = []
    for t in list(tasks)[:limit]:
        frames = []
        try:
            for f in t.get_stack(limit=3):
                frames.append(f"{f.f_code.co_filename}:{f.f_lineno} {f.f_code.co_name}")
        except Exception:  # itpu: allow[ITPU004] a task finishing mid-walk may refuse get_stack
            pass
        out.append({"name": t.get_name(), "done": t.done(), "stack": frames})
    return out


def debug_payload(service) -> dict:
    """The /debugz JSON body: tasks, the executor and host-pool
    occupancy, the cache tiers, the slow-request exemplars, and the
    armed planes' blocks (the same dicts /health serves)."""
    from imaginary_tpu_torch import failpoints
    from imaginary_tpu_torch.codecs import native_backend
    from imaginary_tpu_torch.engine.timing import COPIES

    payload: dict = {
        "pid": os.getpid(),
        "threads": threading.active_count(),
        "tasks": task_dump(),
        "slowest_requests": SLOW.slowest(32),
        # the failpoints' spec and per-site hit/fired counters; the
        # control surface is /debugz/failpoints
        "failpoints": failpoints.snapshot(),
        # the process-wide byte-touch ledger
        "copies": COPIES.snapshot(),
    }
    arena = native_backend.arena_stats()
    if arena is not None:
        payload["arena"] = arena
    if service is not None:
        payload["executor"] = service.executor.debug_snapshot()
        payload["executor_counters"] = service.executor.stats.to_dict()
        payload["host_pool"] = {
            "workers": service.pool_workers,
            "inflight": service._inflight,
            "service_ewma_ms": round(service._service_ewma_ms, 3),
            "estimated_queue_ms": round(service.estimated_queue_ms(), 3),
        }
        payload["cache"] = service.caches.to_dict()
        if service.caches.shm is not None:
            # the fleet shm tier with its file and the whole epoch table
            payload["fleet"] = service.caches.shm.debug_snapshot()
        governor = service.pressure
        if governor is not None:
            # the rung, its signals and the whole transition history
            snap = governor.snapshot()
            snap["recent_transitions"] = list(governor._history)
            payload["pressure"] = snap
        if service.qos is not None:
            # the secret-free tenant table and per-class counters
            payload["qos"] = service.qos.snapshot()
        if service.slo is not None:
            payload["slo"] = service.slo.snapshot()
        if service.cost is not None:
            payload["capacity"] = service.cost.snapshot()
    return payload


async def profile_capture(query, device: str = "cpu") -> tuple:
    """GET /debugz/profile?seconds=N&dir=D: a torch.profiler capture of the
    live process for N seconds (clamped to 0.05-120), exported into ?dir=
    (default IMAGINARY_TPU_PROFILE_DIR); `device` is the server's torch
    device, and a CUDA one adds the card's activity. Returns (json body, status): 400
    without a directory or with a bad N, 409 while another capture is
    active (a process booted with IMAGINARY_TPU_PROFILE_DIR traces its
    whole serving loop), 500 when the profiler fails, on a CUDA server
    also when it recorded no card activity (engine/timing.stop_profiler)."""
    trace_dir = query.get("dir") or os.environ.get("IMAGINARY_TPU_PROFILE_DIR", "")
    if not trace_dir:
        return {
            "error": "no capture directory: pass ?dir= or export "
                     "IMAGINARY_TPU_PROFILE_DIR"
        }, 400
    try:
        seconds = float(query.get("seconds", "3"))
    except (TypeError, ValueError):
        return {"error": "seconds must be a number"}, 400
    seconds = min(max(seconds, 0.05), 120.0)
    from imaginary_tpu_torch.engine import timing

    loop = asyncio.get_running_loop()
    try:
        started = await loop.run_in_executor(
            _profiler_thread(), contextvars.copy_context().run, timing.start_profiler,
            trace_dir, device)
    except Exception as e:  # noqa: BLE001 - the profiler's own error is the answer
        return {"error": f"the profiler did not start: {e}"}, 500
    if not started:
        return {
            "error": "a profiler capture is already active (a process "
                     "booted with IMAGINARY_TPU_PROFILE_DIR traces its "
                     "whole serving loop)"
        }, 409
    try:
        await asyncio.sleep(seconds)
    except BaseException:
        with contextlib.suppress(Exception):
            await loop.run_in_executor(_profiler_thread(), contextvars.copy_context().run,
                                       timing.stop_profiler)
        raise
    try:
        got = await loop.run_in_executor(_profiler_thread(), contextvars.copy_context().run,
                                         timing.stop_profiler)
    except Exception as e:  # noqa: BLE001 - the profiler's own error is the answer
        return {"error": f"the profiler failed: {e}"}, 500
    return {"profile_dir": trace_dir, "seconds": seconds, **got}, 200


_PROFILER_POOL = None
_PROFILER_POOL_LOCK = threading.Lock()


def _profiler_thread():
    """The one thread that starts and stops every capture: the profiler
    is started and stopped on one thread, and its export never blocks
    the event loop."""
    global _PROFILER_POOL
    with _PROFILER_POOL_LOCK:
        if _PROFILER_POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            _PROFILER_POOL = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="itpu-profiler")
        return _PROFILER_POOL
