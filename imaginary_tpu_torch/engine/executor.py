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

Multi-GPU serving (`mesh_policy` other than "off"; the reference's lane
tier, executor.py:1702-2060): every entry of the device mesh gets a lane
(`engine/lanes.py`) with its own collector and fetcher threads, its own
formation cap, in-flight window and CUDA stream, and its own fault domain
(`engine/devhealth.py`). submit() places each item on a lane by (queue
depth x EWMA service time). "sharded" (and "auto") additionally splits a
formed chunk of at least `shard_min_items` over the healthy mesh, one
sub-chunk per entry on that entry's lane stream. A failed launch or drain
strikes the lane's device; at `breaker_threshold` consecutive strikes the
device is quarantined and its lane's items move to the surviving lanes;
after `breaker_cooldown_s` a probe (a tiny K4 launch checked against its
known answer) re-admits it. Every quarantine and re-admission is one
topology epoch (`_mesh_generation`). With every lane quarantined, items
fall through to the global collector, which launches on `device`: host
spill is not ported, so that is the end of the ladder. "off" builds no
lane object and serves exactly as the single pair does.

The oversize-single spatial route (the reference's executor.py:1660-1671
and :1882-1897): with `spatial` > 1 the lanes' mesh has a spatial axis
of that many entries, and a single-item lane chunk that is not
batch-sharded and whose input bucket crosses `spatial_threshold_px`
(with a width that splits over the axis) runs W-sharded over the row of
the mesh that holds its lane (`ops/chain.launch_spatial`), on those
entries' lane streams. It is counted in `spatial_batches`; a stage
without a W-sharded form gathers the shards explicitly and is counted in
`spatial_gathers` by spec name. Any quarantine turns the route off until
the full mesh is re-admitted. The reference pads the single image to the
mesh's batch axis; the port launches only the row that serves it.

Every launch that meets a (chain, input shape with B, device) signature
this process has not launched before (`chain_mod.cache_size()` grows)
counts one `compile_misses`, on the global, lane, sharded and spatial
dispatches alike: with `--prewarm` (prewarm.py) covering the common
chains at every B of `batch_ladder`, it stays 0. Nothing compiles per
signature here, so the count keeps the reference's meaning of a cold
launch: the first blocks of the caching allocator and of the pinned host
pool for that shape. A future cancelled while it waits (the request's
deadline passed) is dropped before its chunk launches and its owed MB
released. The failpoint sites `executor.submit` (submit) and
`device.execute` (the global dispatch, before the launch; an error
there counts one device failure and fails the chunk) are ported.

Not ported yet: host spill, hedging, the watchdog, OOM bisection,
`use_mesh` batch sharding, multi-host,
qos, memory pressure, integrity checks, devhealth's fail-slow and
corruption branches, the convoy policy and placement notes. A failed
launch or fetch on the global pair fails the futures of its own chunk and
counts one device failure; nothing falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue as queue_mod
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Optional

import numpy as np
import torch

from imaginary_tpu_torch import failpoints, kernels
from imaginary_tpu_torch.engine import lanes as lanes_mod
from imaginary_tpu_torch.engine.devhealth import DeviceHealthRegistry
from imaginary_tpu_torch.engine.timing import COPIES, LANE_TIMES, TIMES, attribute
from imaginary_tpu_torch.ops import chain as chain_mod
from imaginary_tpu_torch.ops.buckets import bucket_shape, tight_dim
from imaginary_tpu_torch.ops.plan import ImagePlan
from imaginary_tpu_torch.parallel.mesh import get_mesh, healthy_mesh

# The micro-batch chunk cap: the CLI default derives from it.
MAX_BATCH = 16


def batch_ladder(max_batch: int = MAX_BATCH) -> tuple:
    """Every chunk size the executor can launch: 1..max_batch.

    The reference pads a chunk to the next power of two, so its ladder is
    the powers of two up to max_batch. The port launches a chunk at its
    own size (`_launch_chunk`), so each B is a signature of its own and
    prewarm must visit all of them."""
    return tuple(range(1, max(1, int(max_batch)) + 1))

MESH_POLICIES = ("off", "lanes", "sharded", "auto")

# Join budget of one re-admission probe: long enough for a first launch
# that builds the kernels.
PROBE_TIMEOUT_S = 30.0


@dataclasses.dataclass
class ExecutorConfig:
    max_batch: int = MAX_BATCH  # items per device launch
    max_inflight: int = 4  # chunks launched but not yet fetched
    max_form_ms: float = 5.0  # formation cap (--batch-form-ms)
    device: str = "cuda"
    # Multi-GPU serving (module docstring): "off" (the default, one
    # collector/fetcher pair on `device`), "lanes" (one lane per mesh
    # entry), "sharded" and "auto" (lanes, plus chunks of at least
    # shard_min_items split over the healthy mesh).
    mesh_policy: str = "off"
    # The lanes' mesh: the explicit `devices` list (it may repeat a
    # device), else the first n_devices visible cards when `device` is
    # "cuda" (0: all of them), else `device` n_devices times (0: once).
    n_devices: int = 0
    devices: Optional[list] = None
    lane_form_ms: Optional[float] = None  # per-lane formation cap; None: max_form_ms
    lane_inflight: int = 2  # per-lane chunks launched but not yet fetched
    # Chunks below this many items ride one lane; 0 derives 2x the
    # healthy mesh's batch axis, so every entry gets at least 2 items.
    shard_min_items: int = 0
    # Per-device breakers: quarantine after breaker_threshold consecutive
    # failures, probe for re-admission after breaker_cooldown_s.
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 30.0
    # The oversize-single spatial route (module docstring): the mesh's
    # spatial axis, and the input-bucket pixel bar at which a single item
    # W-shards over it; spatial_mpix > 0 sets the bar in megapixels.
    spatial: int = 1
    spatial_threshold_px: int = 3840 * 2160
    spatial_mpix: float = 0.0


@dataclasses.dataclass
class ExecutorStats:
    items: int = 0
    batches: int = 0  # device launches (chunks of <= max_batch)
    groups: int = 0  # fetches (one per chunk here)
    max_group_seen: int = 0
    queue_depth: int = 0
    device_failures: int = 0  # failed launches and fetches
    device_owed_mb: float = 0.0  # wire MB submitted and not yet resolved
    # The lane tier's snapshot callable (None keeps to_dict as it is
    # without lanes) and its topology epochs.
    lanes_snapshot: Optional[object] = None
    mesh_generation: int = 0
    sharded_batches: int = 0  # lane chunks split over the mesh
    spatial_batches: int = 0  # single items W-sharded over a spatial row
    # spec name -> spatial launches gathered at that stage; None while the
    # spatial route is not armed (to_dict then shows neither key)
    spatial_gathers: Optional[dict] = None
    # launches that met a signature this process had not launched before
    # (module docstring); 0 after a prewarm that covered the traffic
    compile_misses: int = 0

    def to_dict(self) -> dict:
        snap = TIMES.snapshot()
        form_times = snap.get("batch_form")
        disp_times = snap.get("dispatch_wait")
        out = {
            "items": self.items,
            "batches": self.batches,
            "groups": self.groups,
            "avg_batch": round(self.items / self.batches, 3) if self.batches else 0.0,
            "avg_group": round(self.items / self.groups, 3) if self.groups else 0.0,
            "max_group": self.max_group_seen,
            "queue_depth": self.queue_depth,
            "compile_cache_size": chain_mod.cache_size(),
            "compile_misses": self.compile_misses,
            "batch_form_p50_ms": form_times["p50_ms"] if form_times else 0.0,
            "batch_form_p99_ms": form_times["p99_ms"] if form_times else 0.0,
            "dispatch_wait_p50_ms": disp_times["p50_ms"] if disp_times else 0.0,
            "dispatch_wait_p99_ms": disp_times["p99_ms"] if disp_times else 0.0,
            "device_failures": self.device_failures,
            "device_owed_mb": round(self.device_owed_mb, 3),
        }
        # the byte-touch ledger by stage (engine/timing.COPIES)
        copies = COPIES.snapshot()
        out["copied_bytes"] = copies["bytes"]
        out["copy_events"] = copies["copies"]
        if self.lanes_snapshot is not None:
            lanes = self.lanes_snapshot()
            if lanes:
                out["lanes"] = lanes
                out["mesh_generation"] = self.mesh_generation
        if self.spatial_gathers is not None:
            out["spatial_batches"] = self.spatial_batches
            out["spatial_gathers"] = dict(self.spatial_gathers)
        return out


# The measured link seed, installed by prewarm (prewarm.py): (ms per wire
# MB, fixed floor ms). A new executor prices its owed ledger at the seed
# instead of leaving the link unpriced until its first drain; the EWMA
# refines it from real drains at once. The port keeps the floor beside
# the rate, as the reference does, but prices by the rate alone.
_LINK_SEED: Optional[tuple] = None


def seed_link_rate(ms_per_mb: float, floor_ms: float) -> None:
    global _LINK_SEED
    _LINK_SEED = (max(float(ms_per_mb), 0.0), max(float(floor_ms), 0.0))


def link_seed() -> Optional[tuple]:
    return _LINK_SEED


class _Item:
    __slots__ = ("arr", "plan", "future", "key", "t", "t_close", "wire_mb",
                 "lane", "hops", "stage_ms")

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
        self.lane = None  # the lane that owes this item (lanes._lane_owe)
        self.hops = 0  # lane re-placements so far
        # batch_form, dispatch_wait and drain of this item, in ms: they
        # ride back on the future (`stage_ms`) to the submitting thread,
        # which adds them to its request's trace
        self.stage_ms: dict = {}


class Executor:
    """Owns the collector and fetcher threads (and, with lanes, theirs);
    submit() is thread-safe."""

    def __init__(self, config: Optional[ExecutorConfig] = None):
        self.config = config or ExecutorConfig()
        if self.config.max_batch < 1:
            raise ValueError("max_batch must be at least 1")
        if self.config.spatial_mpix > 0.0:
            # the megapixel knob maps onto the pixel bar: one bar for both
            self.config = dataclasses.replace(
                self.config,
                spatial_threshold_px=int(self.config.spatial_mpix * 1e6))
        self._mesh_policy = (self.config.mesh_policy or "off").lower()
        if self._mesh_policy not in MESH_POLICIES:
            raise ValueError(f"unknown mesh policy {self.config.mesh_policy!r} "
                             f"(one of {', '.join(MESH_POLICIES)})")
        self.stats = ExecutorStats()
        # The lane tier's state; all None / 0 with mesh_policy "off".
        self._lanes: Optional[lanes_mod.LaneScheduler] = None
        self.devhealth: Optional[DeviceHealthRegistry] = None
        self._mesh = None
        self._lane_mesh = None  # the healthy mesh sharded dispatch uses
        self._lane_streams = None  # its entries' lane streams
        self._spatial = 1  # the full mesh's spatial axis (lanes only)
        self._spatial_on = False  # the route is armed and the mesh whole
        self._lane_lock = threading.Lock()  # serialises topology refreshes
        self._lanes_devhealth_gen = 0
        self._mesh_generation = 0
        self._queue: queue_mod.Queue = queue_mod.Queue()
        self._fetch_queue: queue_mod.Queue = queue_mod.Queue(
            maxsize=max(1, self.config.max_inflight))
        self._lock = threading.Lock()  # guards _closed and the shared stats
        self._closed = False
        # drain ms per wire MB (EWMA over drained chunks): prices the owed
        # ledger for estimated_wait_ms; the prewarm's seed, else None until
        # the first drain (a zero seed leaves the link unpriced, never free)
        self._ms_per_mb: Optional[float] = None
        self.adopt_link_seed()
        if self._mesh_policy != "off":
            self._init_lanes()  # may refuse the mesh before any thread starts
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
        failpoints.hit("executor.submit")
        item = _Item(arr, plan)
        if not plan.stages:
            item.future.set_result(arr)
            return item.future
        with self._lock:
            if self._closed:
                raise RuntimeError("executor is shut down")
            self.stats.device_owed_mb += item.wire_mb
            lane = self._lanes.place(item) if self._lanes is not None else None
            if lane is None:
                self._queue.put(item)
            else:
                lanes_mod._lane_owe(lane, item)
                try:
                    lane.put(item)
                except Exception:
                    item.future.cancel()
                    raise
        return item.future

    def process(self, arr: np.ndarray, plan: ImagePlan, timeout: float = 120.0):
        """Blocking submit: the output, with the item's stage times added
        to the calling thread's request trace."""
        fut = self.submit(arr, plan)
        out = fut.result(timeout=timeout)
        attribute(getattr(fut, "stage_ms", None))
        return out

    def estimated_wait_ms(self) -> float:
        """Estimated device-path queueing delay for a new arrival: the
        wire MB submitted and not yet drained, priced at the measured
        drain ms per MB (the reference's owed-work ledger, kept per MB)."""
        with self._lock:
            rate = self._ms_per_mb
            return self.stats.device_owed_mb * rate if rate else 0.0

    def adopt_link_seed(self) -> None:
        """Price the owed ledger at the installed link seed unless a drain
        has priced it already (a boot prewarm seeds after the executor is
        built)."""
        seed = _LINK_SEED
        with self._lock:
            if self._ms_per_mb is None and seed is not None and seed[0] > 0.0:
                self._ms_per_mb = seed[0]

    def shutdown(self) -> None:
        """Stop taking items, launch and resolve every item already
        submitted, then join the threads: the lanes' first (what they
        re-place while they stop goes to the global queue), then the
        global pair."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._lanes is None:
                self._queue.put(None)
            else:
                for ln in self._lanes.lanes:
                    ln.queue.put(None)
        if self._lanes is not None:
            self.devhealth.close()
            for ln in self._lanes.lanes:
                ln.collector.join(timeout=30)
            # each lane collector enqueues its fetcher's sentinel itself
            for ln in self._lanes.lanes:
                ln.fetcher.join(timeout=30)
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

    def _close_chunk(self, items: list, form_cap_s: float, lane=None) -> None:
        """Stamp the formation/dispatch boundary and launch, on `lane` when
        one is given. A chunk closes no later than its oldest item's
        submit time + the formation cap: time past that was spent behind
        in-flight chunks."""
        now = time.monotonic()
        for it in items:
            it.t_close = min(now, it.t + form_cap_s)
        if lane is None:
            self._dispatch(items)
        else:
            self._lane_dispatch(lane, items)

    def _dispatch(self, items: list) -> None:
        """Launch one chunk and hand it to the fetcher."""
        now = time.monotonic()
        for it in items:
            bf_ms = (it.t_close - it.t) * 1000.0
            dw_ms = (now - it.t_close) * 1000.0
            TIMES.record("queue_wait", (now - it.t) * 1000.0)
            TIMES.record("batch_form", bf_ms)
            TIMES.record("dispatch_wait", dw_ms)
            it.stage_ms["batch_form"] = bf_ms
            it.stage_ms["dispatch_wait"] = dw_ms
        try:
            # delay() models a slow device or link, error() a failed
            # dispatch
            failpoints.hit("device.execute")
        except Exception as e:
            self._fail(items, e)
            return
        items = self._drop_cancelled(items)
        if not items:
            return
        before = chain_mod.cache_size()
        try:
            chunk = self._launch_chunk(items)
        except Exception as e:
            self._fail(items, e)
            return
        self._note_cold(before)
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
            drain_ms = (time.monotonic() - t0) * 1000.0
            TIMES.record("drain", drain_ms / len(items))
            self._note_drain(items, drain_ms)
            self._release(items)
            for it, out in zip(items, outs):
                _resolve(it.future, result=out, stage_ms=it.stage_ms)

    def _fail(self, items: list, e: Exception) -> None:
        """Fail one chunk's futures."""
        with self._lock:
            self.stats.device_failures += 1
        self._release(items)
        for it in items:
            _resolve(it.future, error=e)

    def _drop_cancelled(self, items: list) -> list:
        """The items still wanted: a future cancelled while it waited (its
        request's deadline passed) is not launched, and its owed MB is
        released here."""
        live, dropped = [], []
        for it in items:
            (dropped if it.future.cancelled() else live).append(it)
        if dropped:
            self._release(dropped)
        return live

    def _note_cold(self, cache_before: int) -> None:
        """One compile miss when the launch just made grew the signature
        set."""
        if chain_mod.cache_size() > cache_before:
            with self._lock:
                self.stats.compile_misses += 1

    def _release(self, items: list) -> None:
        with self._lock:
            self.stats.device_owed_mb = max(
                0.0, self.stats.device_owed_mb - sum(it.wire_mb for it in items))

    def _note_drain(self, items: list, drain_ms: float) -> None:
        """Each item's share of a drained chunk, and the chunk's drain ms
        per wire MB folded into the EWMA that estimated_wait_ms prices."""
        share = drain_ms / len(items)
        for it in items:
            it.stage_ms["drain"] = share
        mb = sum(it.wire_mb for it in items)
        if mb > 0:
            rate = drain_ms / mb
            with self._lock:
                prev = self._ms_per_mb
                self._ms_per_mb = rate if prev is None else 0.8 * prev + 0.2 * rate


    # -- lane tier (engine/lanes.py; mesh_policy != "off") ---------------------

    def _init_lanes(self) -> None:
        """One lane per mesh entry, each with its own stream, collector and
        fetcher, and one fault domain each; the re-admission prober runs
        for as long as the executor does. The global pair stays up as the
        tier items fall to when every lane is quarantined."""
        cfg = self.config
        mesh = get_mesh(cfg.n_devices or None, max(1, cfg.spatial),
                        devices=cfg.devices if cfg.devices else cfg.device)
        for dev in mesh.flat:
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available for the lanes' mesh")
        self._mesh = mesh
        devs = mesh.flat
        self.devhealth = DeviceHealthRegistry(
            len(devs), threshold=cfg.breaker_threshold,
            cooldown_s=cfg.breaker_cooldown_s)
        lanes = [lanes_mod.Lane(i, dev, max_inflight=cfg.lane_inflight,
                                stream=torch.cuda.Stream(dev)
                                if dev.type == "cuda" else None)
                 for i, dev in enumerate(devs)]
        self._lanes = lanes_mod.LaneScheduler(lanes)
        if self._mesh_policy in ("sharded", "auto"):
            self._set_lane_mesh(range(len(devs)))
        self._spatial = mesh.shape[1]
        if self._spatial > 1:
            self._spatial_on = True
            self.stats.spatial_gathers = {}
        self._lanes_devhealth_gen = self.devhealth.generation
        self.devhealth.set_lane_stats_provider(self._lanes.snapshot)
        self.stats.lanes_snapshot = self._lanes.snapshot
        self.devhealth.start_probing(self._probe_device, timeout_s=PROBE_TIMEOUT_S)
        for ln in lanes:
            ln.collector = threading.Thread(target=self._lane_collect, args=(ln,),
                                            name=f"itpu-lane{ln.idx}", daemon=True)
            ln.fetcher = threading.Thread(target=self._lane_fetch, args=(ln,),
                                          name=f"itpu-lane{ln.idx}-fetch", daemon=True)
            ln.collector.start()
            ln.fetcher.start()

    def _set_lane_mesh(self, avail) -> None:
        """Sharded dispatch's view: the healthy entries (flat indices
        `avail`) as a batch-only mesh, and their lanes' streams in the
        same order; None when nothing is available."""
        idx = sorted(avail)
        mesh = healthy_mesh(self._mesh, idx)
        self._lane_streams = ([self._lanes.lane(i).stream for i in idx]
                              if mesh is not None else None)
        self._lane_mesh = mesh

    def _lane_form_s(self) -> float:
        ms = self.config.lane_form_ms
        if ms is None:
            ms = self.config.max_form_ms
        return max(ms, 0.0) / 1000.0

    def _shard_min(self) -> int:
        """The sharded-dispatch threshold: shard_min_items when set, else
        2x the healthy mesh's batch axis."""
        if self.config.shard_min_items > 0:
            return self.config.shard_min_items
        mesh = self._lane_mesh
        return max(2, 2 * (mesh.shape[0] if mesh is not None else 1))

    def _spatial_route(self, key) -> bool:
        """The oversize-single route decision (the reference's
        `_spatial_route`): the route is armed on a whole mesh, the input
        bucket crosses the pixel bar, and its width splits evenly over the
        spatial axis."""
        if not self._spatial_on:
            return False
        _, hb, wb, _c = key
        return (hb * wb >= self.config.spatial_threshold_px
                and wb % self._spatial == 0)

    def _lane_collect(self, lane) -> None:
        """One lane's collector: the continuous policy on one entry. Its
        50 ms idle poll is also the quarantine watch: a devhealth
        generation change refreshes the topology, and an inactive lane
        moves everything it holds to the surviving lanes (it keeps
        polling, so re-admission revives it without a new thread)."""
        form = self._lane_form_s()
        cap = self.config.max_batch
        pending: dict = {}  # key -> list[_Item]
        last_gen = self._lanes_devhealth_gen
        stop = False
        while not stop:
            timeout = 0.05
            if pending:
                oldest = min(items[0].t for items in pending.values())
                timeout = max(0.0, min(timeout, oldest + form - time.monotonic()))
            try:
                got = lane.queue.get(timeout=timeout)
            except queue_mod.Empty:
                got = False
            while got is not False:
                if got is None:
                    stop = True
                    break
                pending.setdefault(got.key, []).append(got)
                try:
                    got = lane.queue.get_nowait()
                except queue_mod.Empty:
                    got = False
            gen = self.devhealth.generation
            if gen != last_gen:
                last_gen = gen
                self._refresh_lane_topology()
            if not lane.active:
                # drain-on-quarantine: what this lane holds moves on; what
                # it launched drains through its fetcher
                drained = [it for items in pending.values() for it in items]
                pending.clear()
                while not stop:
                    try:
                        more = lane.queue.get_nowait()
                    except queue_mod.Empty:
                        break
                    if more is None:
                        stop = True
                    else:
                        drained.append(more)
                if drained:
                    self._replace_lane_items(drained, exclude={lane.idx})
                continue
            now = time.monotonic()
            due = [k for k, items in pending.items()
                   if len(items) >= cap or now - items[0].t >= form]
            for k in due:
                items = pending.pop(k)
                for start in range(0, len(items), cap):
                    self._close_chunk(items[start:start + cap], form, lane)
        for items in pending.values():
            for start in range(0, len(items), cap):
                self._close_chunk(items[start:start + cap], form, lane)
        lane.fetch_queue.put(None)

    def _lane_dispatch(self, lane, items: list) -> None:
        """Launch one lane chunk: split over the healthy mesh when it
        reaches the sharded threshold; a single oversize item W-sharded
        over the spatial row of this lane's entry; else on this lane's
        device and stream. A failure strikes this lane's fault domain and
        the chunk moves to the other lanes."""
        now = time.monotonic()
        for it in items:
            bf_ms = (it.t_close - it.t) * 1000.0
            dw_ms = (now - it.t_close) * 1000.0
            TIMES.record("queue_wait", (now - it.t) * 1000.0)
            TIMES.record("batch_form", bf_ms)
            TIMES.record("dispatch_wait", dw_ms)
            LANE_TIMES.record(lane.idx, "batch_form", bf_ms)
            LANE_TIMES.record(lane.idx, "dispatch_wait", dw_ms)
            it.stage_ms["batch_form"] = bf_ms
            it.stage_ms["dispatch_wait"] = dw_ms
        items = self._drop_cancelled(items)
        if not items:
            return
        mesh, streams = self._lane_mesh, self._lane_streams
        sharded = mesh is not None and len(items) >= self._shard_min()
        spatial = (not sharded and len(items) == 1
                   and self._spatial_route(items[0].key))
        arrs = [it.arr for it in items]
        plans = [it.plan for it in items]
        before = chain_mod.cache_size()
        try:
            failpoints.hit("device.chip_error", key=lane.idx)
            if sharded:
                launched = chain_mod.launch_sharded(arrs, plans, mesh, streams)
            elif spatial:
                row = lane.idx // self._spatial
                entries = range(row * self._spatial, (row + 1) * self._spatial)
                launched = chain_mod.launch_spatial(
                    arrs[0], plans[0], self._mesh.devices[row],
                    [self._lanes.lane(i).stream for i in entries])
            else:
                launched = chain_mod.launch_batch(arrs, plans, device=lane.device,
                                                  stream=lane.stream)
        except Exception as e:
            self._note_device_failure(lane.idx, e)
            self._replace_lane_items(items, exclude={lane.idx})
            return
        self._note_cold(before)
        TIMES.record("launch", (time.monotonic() - now) * 1000.0 / len(items))
        with self._lock:
            self.stats.items += len(items)
            self.stats.groups += 1
            self.stats.batches += 1
            self.stats.sharded_batches += int(sharded)
            if spatial:
                self.stats.spatial_batches += 1
                if launched is not None and launched.gathered is not None:
                    # a new dict, so to_dict's copy never sees one change
                    g = self.stats.spatial_gathers
                    self.stats.spatial_gathers = {
                        **g, launched.gathered: g.get(launched.gathered, 0) + 1}
            self.stats.max_group_seen = max(self.stats.max_group_seen, len(items))
        lane.dispatches += 1
        # a full in-flight window blocks here: the lane's backpressure,
        # which shows as a growing placement score
        lane.fetch_queue.put((launched, arrs, plans, items))

    def _lane_fetch(self, lane) -> None:
        """One lane's fetcher: wait for each launched chunk in launch
        order and resolve it. A failed drain strikes this lane's fault
        domain and moves the unresolved items to the other lanes."""
        while True:
            got = lane.fetch_queue.get()
            if got is None:
                break
            launched, arrs, plans, items = got
            n = len(items)
            t0 = time.monotonic()
            outs, err = None, None
            lanes_mod._lane_charge(lane, n)
            try:
                outs = chain_mod.fetch_batch(launched, arrs, plans)
            except Exception as e:
                err = e
            finally:
                lanes_mod._lane_release(lane, n)
            if err is not None:
                self._note_device_failure(lane.idx, err)
                self._replace_lane_items([it for it in items if not it.future.done()],
                                         exclude={lane.idx})
                continue
            drain_ms = (time.monotonic() - t0) * 1000.0
            self.devhealth.note_ok(lane.idx, latency_ms=drain_ms)
            lane.note_service(drain_ms / n, n)
            LANE_TIMES.record(lane.idx, "drain", drain_ms / n)
            TIMES.record("drain", drain_ms / n)
            self._note_drain(items, drain_ms)
            self._release(items)
            for it, out in zip(items, outs):
                _resolve(it.future, result=out, stage_ms=it.stage_ms)

    def _replace_lane_items(self, items: list, exclude=()) -> None:
        """Move still-unresolved items to the surviving lanes. An item past
        its hop budget, every item once no lane is left, and every item
        once the executor is closing go to the global queue."""
        max_hops = 2 * len(self._lanes.lanes)
        with self._lock:
            for it in items:
                if it.future.done():
                    continue
                it.hops += 1
                lane = None
                if not self._closed and it.hops <= max_hops:
                    lane = self._lanes.place(it, exclude=exclude)
                if lane is None:
                    self._queue.put(it)
                    continue
                lanes_mod._lane_owe(lane, it)
                try:
                    lane.put(it)
                except Exception:
                    it.future.cancel()
                    raise

    def _refresh_lane_topology(self) -> None:
        """Called by the first lane collector that sees a devhealth
        generation change: re-derive every lane's active flag and the
        sharded view over the survivors, and start a new topology epoch."""
        with self._lane_lock:
            gen = self.devhealth.generation
            if gen == self._lanes_devhealth_gen:
                return
            self._lanes_devhealth_gen = gen
            avail = set(self.devhealth.available_indices())
            for ln in self._lanes.lanes:
                ln.active = ln.idx in avail
            if self._mesh_policy in ("sharded", "auto"):
                self._set_lane_mesh(avail)
            # W-sharding needs the whole grid: any quarantine turns the
            # spatial route off until the full mesh is re-admitted
            self._spatial_on = (self._spatial > 1
                                and len(avail) == len(self._lanes.lanes))
            self._mesh_generation += 1
            self.stats.mesh_generation = self._mesh_generation

    def _note_device_failure(self, idx: int, err: object = None) -> None:
        """One failed launch or drain, struck against entry `idx`."""
        self.devhealth.note_failure(idx, err)
        with self._lock:
            self.stats.device_failures += 1

    def _probe_device(self, idx: int) -> None:
        """Half-open re-admission probe of entry `idx`, raising on failure:
        a K4 window gather of a 4x4 ramp at offset (1, 2) on the entry's
        device and lane stream, held against its known answer."""
        failpoints.hit("device.chip_error", key=idx)
        lane = self._lanes.lane(idx)
        dev = lane.device
        ctx = (torch.cuda.stream(lane.stream) if lane.stream is not None
               else contextlib.nullcontext())
        with ctx:
            x = torch.arange(16, dtype=torch.float32, device=dev).reshape(1, 4, 4, 1)
            off = torch.tensor([1], dtype=torch.int32, device=dev)
            off_x = torch.tensor([2], dtype=torch.int32, device=dev)
            got = kernels.gather(x, 2, 2, off, off_x).cpu()
        want = torch.tensor([[6.0, 7.0], [10.0, 11.0]]).reshape(1, 2, 2, 1)
        if not torch.equal(got, want):
            raise RuntimeError(f"probe of device {idx} ({dev}) computed "
                               f"{got.flatten().tolist()}")

    def debug_snapshot(self) -> dict:
        """The executor's live view; with lanes, a "lanes" block with the
        reference's keys."""
        snap = {
            "queue_depth": self.stats.queue_depth,
            "inflight_chunks": self._fetch_queue.qsize(),
            "device_owed_mb": round(self.stats.device_owed_mb, 3),
        }
        if self._lanes is not None:
            snap["lanes"] = {
                "policy": self._mesh_policy,
                "mesh_generation": self._mesh_generation,
                "shard_min_items": (self._shard_min()
                                    if self._lane_mesh is not None else 0),
                "sharded_batches": self.stats.sharded_batches,
                "spatial": self._spatial,
                "spatial_on": self._spatial_on,
                "lanes": self._lanes.snapshot(),
                "stage_times": LANE_TIMES.snapshot(),
            }
        return snap


def _resolve(fut: Future, result=None, error: Optional[Exception] = None,
             stage_ms: Optional[dict] = None) -> None:
    """Set a future's outcome unless its caller already cancelled it; an
    item's stage times ride along as the future's `stage_ms`."""
    if stage_ms is not None:
        fut.stage_ms = stage_ms
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass
