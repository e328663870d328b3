"""Micro-batching executor of the port (the core of
`imaginary_tpu/engine/executor.py`, with the reference's names).

Request threads submit one decoded image and its plan. A collector thread
groups items that share a chain signature (spec sequence, input bucket,
channels) and launches each group as one batched chain on the device
(`ops/chain.launch_batch`, which returns while the card works). A fetcher
thread waits for each launched chunk's copy back to host memory, slices
the per-image outputs and resolves the futures.

Batch formation is the reference's "continuous" policy: a chunk closes
the moment it holds `max_batch` items or its oldest item has waited the
formation cap (`max_form_ms`), and launches at once. Items that arrive
meanwhile form the next chunk, which is launched while earlier chunks
still compute and copy back. The bounded fetch queue
(`max_inflight`) is the only backpressure. Each item's wait splits into
`batch_form` (submit -> chunk close) and `dispatch_wait` (chunk close ->
launch); `queue_wait` is their sum (`engine/timing.py`).

Not ported yet: host spill, hedging, the breaker and watchdog, OOM
bisection, lanes and the mesh, qos, memory pressure, integrity checks,
the convoy policy, placement notes and failpoints. A failed launch or
fetch fails the futures of its own chunk and counts one device failure;
nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Optional

import numpy as np

from imaginary_tpu_torch.engine.timing import TIMES
from imaginary_tpu_torch.ops import chain as chain_mod
from imaginary_tpu_torch.ops.buckets import bucket_shape, tight_dim
from imaginary_tpu_torch.ops.plan import ImagePlan

# The micro-batch chunk cap: the CLI default derives from it.
MAX_BATCH = 16


@dataclasses.dataclass
class ExecutorConfig:
    max_batch: int = MAX_BATCH  # items per device launch
    max_inflight: int = 4  # chunks launched but not yet fetched
    max_form_ms: float = 5.0  # formation cap (--batch-form-ms)
    device: str = "cuda"


@dataclasses.dataclass
class ExecutorStats:
    items: int = 0
    batches: int = 0  # device launches (chunks of <= max_batch)
    groups: int = 0  # fetches (one per chunk here)
    max_group_seen: int = 0
    queue_depth: int = 0
    device_failures: int = 0  # failed launches and fetches
    device_owed_mb: float = 0.0  # wire MB submitted and not yet resolved

    def to_dict(self) -> dict:
        snap = TIMES.snapshot()
        form_times = snap.get("batch_form")
        disp_times = snap.get("dispatch_wait")
        return {
            "items": self.items,
            "batches": self.batches,
            "groups": self.groups,
            "avg_batch": round(self.items / self.batches, 3) if self.batches else 0.0,
            "avg_group": round(self.items / self.groups, 3) if self.groups else 0.0,
            "max_group": self.max_group_seen,
            "queue_depth": self.queue_depth,
            "compile_cache_size": chain_mod.cache_size(),
            "batch_form_p50_ms": form_times["p50_ms"] if form_times else 0.0,
            "batch_form_p99_ms": form_times["p99_ms"] if form_times else 0.0,
            "dispatch_wait_p50_ms": disp_times["p50_ms"] if disp_times else 0.0,
            "dispatch_wait_p99_ms": disp_times["p99_ms"] if disp_times else 0.0,
            "device_failures": self.device_failures,
            "device_owed_mb": round(self.device_owed_mb, 3),
        }


class _Item:
    __slots__ = ("arr", "plan", "future", "key", "t", "t_close", "wire_mb")

    def __init__(self, arr: np.ndarray, plan: ImagePlan):
        self.arr = arr
        self.plan = plan
        self.future: Future = Future()
        if plan.in_bucket is not None:  # packed transport: pre-padded array
            hb, wb = plan.in_bucket
        else:
            hb, wb = bucket_shape(arr.shape[0], arr.shape[1])
        self.key = (plan.spec_key(), hb, wb, arr.shape[2])
        # the link charges for the PADDED input and output buffers
        if plan.out_bucket is not None:  # packed yuv output: bucket * 1.5
            ob_h, ob_w = plan.out_bucket
            out_bytes = (ob_h + ob_h // 2) * ob_w
        else:
            out_bytes = tight_dim(plan.out_h) * tight_dim(plan.out_w) * arr.shape[2]
        self.wire_mb = (hb * wb * arr.shape[2] * arr.dtype.itemsize + out_bytes) / 1e6
        self.t = time.monotonic()
        # Stamped by the collector when this item's chunk closes; the
        # batch_form / dispatch_wait split reads it (_dispatch).
        self.t_close = self.t


class Executor:
    """Owns the collector and fetcher threads; submit() is thread-safe."""

    def __init__(self, config: Optional[ExecutorConfig] = None):
        self.config = config or ExecutorConfig()
        if self.config.max_batch < 1:
            raise ValueError("max_batch must be at least 1")
        self.stats = ExecutorStats()
        self._queue: queue_mod.Queue = queue_mod.Queue()
        self._fetch_queue: queue_mod.Queue = queue_mod.Queue(
            maxsize=max(1, self.config.max_inflight))
        self._lock = threading.Lock()  # guards _closed and the shared stats
        self._closed = False
        self._thread = threading.Thread(target=self._collect_continuous,
                                        name="itpu-collector", daemon=True)
        self._fetcher = threading.Thread(target=self._fetch_loop,
                                         name="itpu-fetcher", daemon=True)
        self._thread.start()
        self._fetcher.start()

    def submit(self, arr: np.ndarray, plan: ImagePlan) -> Future:
        """Enqueue one image; resolves to the chain's output (an HWC uint8
        array, YuvPlanes on the packed transports, or QuantizedBlocks with
        the dct egress). Identity chains
        resolve at once, with no device work."""
        item = _Item(arr, plan)
        if not plan.stages:
            item.future.set_result(arr)
            return item.future
        with self._lock:
            if self._closed:
                raise RuntimeError("executor is shut down")
            self.stats.device_owed_mb += item.wire_mb
            self._queue.put(item)
        return item.future

    def process(self, arr: np.ndarray, plan: ImagePlan, timeout: float = 120.0):
        """Blocking convenience wrapper."""
        return self.submit(arr, plan).result(timeout=timeout)

    def shutdown(self) -> None:
        """Stop taking items, launch and resolve every item already
        submitted, then join both threads."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._thread.join(timeout=30)
        # the collector enqueues the fetcher's sentinel itself, after its
        # final launches, so the sentinel cannot overtake them
        self._fetcher.join(timeout=30)

    # -- collector -------------------------------------------------------------

    def _collect_continuous(self):
        """A chunk closes at max_batch items or at the formation cap,
        whichever first, and launches at once. Time the collector spends
        blocked on the bounded fetch queue books as dispatch_wait for the
        items it delays, not as formation. Runs until the shutdown
        sentinel, then launches whatever is still pending."""
        form = max(self.config.max_form_ms, 0.0) / 1000.0
        cap = self.config.max_batch
        pending: dict = {}  # key -> list[_Item]
        running = True
        while running:
            timeout = None
            if pending:
                oldest = min(items[0].t for items in pending.values())
                timeout = max(0.0, oldest + form - time.monotonic())
            try:
                got = self._queue.get(timeout=timeout)
            except queue_mod.Empty:
                got = False
            # drain the backlog before deciding what is due: one-item
            # wakeups would dispatch singletons under load
            while got is not False:
                if got is None:
                    running = False
                    break
                pending.setdefault(got.key, []).append(got)
                try:
                    got = self._queue.get_nowait()
                except queue_mod.Empty:
                    got = False
            now = time.monotonic()
            due = [k for k, items in pending.items()
                   if len(items) >= cap or now - items[0].t >= form]
            for k in due:
                items = pending.pop(k)
                for start in range(0, len(items), cap):
                    self._close_chunk(items[start:start + cap], form)
            self.stats.queue_depth = self._queue.qsize() + sum(
                len(v) for v in pending.values())
        for items in pending.values():
            for start in range(0, len(items), cap):
                self._close_chunk(items[start:start + cap], form)
        self.stats.queue_depth = 0
        self._fetch_queue.put(None)

    def _close_chunk(self, items: list, form_cap_s: float) -> None:
        """Stamp the formation/dispatch boundary and launch. A chunk closes
        no later than its oldest item's submit time + the formation cap:
        time past that was spent behind in-flight chunks."""
        now = time.monotonic()
        for it in items:
            it.t_close = min(now, it.t + form_cap_s)
        self._dispatch(items)

    def _dispatch(self, items: list) -> None:
        """Launch one chunk and hand it to the fetcher."""
        now = time.monotonic()
        for it in items:
            TIMES.record("queue_wait", (now - it.t) * 1000.0)
            TIMES.record("batch_form", (it.t_close - it.t) * 1000.0)
            TIMES.record("dispatch_wait", (now - it.t_close) * 1000.0)
        try:
            chunk = self._launch_chunk(items)
        except Exception as e:
            self._fail(items, e)
            return
        TIMES.record("launch", (time.monotonic() - now) * 1000.0 / len(items))
        self.stats.items += len(items)
        self.stats.groups += 1
        self.stats.batches += 1
        self.stats.max_group_seen = max(self.stats.max_group_seen, len(items))
        # blocks when max_inflight chunks wait for the fetcher: backpressure
        self._fetch_queue.put((chunk, items))

    def _launch_chunk(self, items: list):
        """Launch one device call of <= max_batch items; returns
        (launched, arrs, plans) or raises.

        No power-of-two padding: the reference pads a chunk so that XLA
        compiles one program per padded size. Eager PyTorch compiles
        nothing per batch size, so padding would only repeat device work
        and link bytes."""
        arrs = [it.arr for it in items]
        plans = [it.plan for it in items]
        return chain_mod.launch_batch(arrs, plans, device=self.config.device), arrs, plans

    # -- fetcher ---------------------------------------------------------------

    def _fetch_loop(self) -> None:
        """Wait for each launched chunk's event in launch order, slice its
        outputs and resolve its futures."""
        while True:
            got = self._fetch_queue.get()
            if got is None:
                break
            (launched, arrs, plans), items = got
            t0 = time.monotonic()
            try:
                outs = chain_mod.fetch_batch(launched, arrs, plans)
            except Exception as e:
                self._fail(items, e)
                continue
            TIMES.record("drain", (time.monotonic() - t0) * 1000.0 / len(items))
            self._release(items)
            for it, out in zip(items, outs):
                _resolve(it.future, result=out)

    def _fail(self, items: list, e: Exception) -> None:
        """Fail one chunk's futures."""
        with self._lock:
            self.stats.device_failures += 1
        self._release(items)
        for it in items:
            _resolve(it.future, error=e)

    def _release(self, items: list) -> None:
        with self._lock:
            self.stats.device_owed_mb = max(
                0.0, self.stats.device_owed_mb - sum(it.wire_mb for it in items))


def _resolve(fut: Future, result=None, error: Optional[Exception] = None) -> None:
    """Set a future's outcome unless its caller already cancelled it."""
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass
