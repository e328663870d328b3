"""Micro-batching executor of the port (the core of
`imaginary_tpu/engine/executor.py`, with the reference's names).

Request threads submit one decoded image and its plan. A collector thread
groups items that share a chain signature (spec sequence, input bucket,
channels) and launches each group as one batched chain on the device
(`ops/chain.launch_batch`, which returns while the card works). A fetcher
thread waits for each launched chunk's copy back to host memory, slices
the per-image outputs and resolves the futures.

Batch formation follows the reference's two policies, `batch_policy`:

  * "continuous" (the default): a chunk closes the moment it holds
    `max_batch` items or its oldest item has waited the formation cap
    (`max_form_ms`; None derives it from `window_ms`), and launches at
    once. Items that arrive meanwhile form the next chunk, which is
    launched while earlier chunks still compute and copy back. The
    bounded fetch queue (`max_inflight`) is the only backpressure.
  * "convoy" (the reference's legacy policy, kept for A/B runs): a group
    of up to `max_group` items dispatches when its oldest item has
    waited `window_ms` and the link is idle (no launched group whose
    chunks have not all drained: `_inflight`, counted from the fetch
    queue's put to the end of the group's drain, so a chunk whose CUDA
    event has not completed keeps the link busy), or at `max_hold_ms`.
    Its formation cap is infinite: the whole wait is batch_form.

A group is launched as chunks of at most `max_batch` items (and, under
memory pressure, at most the governor's batch byte cap: `_chunk_for_launch`,
counted in `pressure_capped_batches`), all drained by one fetch, so
`groups` < `batches` under convoy or the cap. The lanes keep the
continuous policy and never apply the byte cap, as in the reference.
Each item's wait splits into `batch_form` (submit -> chunk close) and
`dispatch_wait` (chunk close -> launch); `queue_wait` is their sum
(`engine/timing.py`).

Admission (the reference's executor.py:535-541, :830-913, :985-995):
with a qos policy (`qos`, qos/tenancy.QosPolicy) the FIFO intake queue is
the class-aware `qos/sched.FairScheduler` (strict priority with aging, EDF
within a class on the request's deadline, per-tenant share caps), each
item stamped in `submit` with `request_qos`; a share cap's rejection
cancels the item (refunding its owed MB) and raises the 503. With a
memory-pressure governor (`pressure`, engine/pressure.MemoryGovernor), a
batch-class (or, with qos off, any) item of at least `oversize_mpix`
source megapixels is forced to the host interpreter at elevated pressure
or worse, through the spill branch, counted in `pressure_host_forced`
and marked `X-Imaginary-Backend: host` (asked for by --pressure-rss-mb,
so it holds whatever `host_spill` says); the governor reads the
executor's host and device ledgers (`bind_sources`). Batch-class items
are never hedged.

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
after `breaker_cooldown_s` a probe re-admits it. Every quarantine and
re-admission is one topology epoch (`_mesh_generation`). A lane's
fetcher resolves each chunk as its own event completes: every chunk's D2H
is issued at its launch, so merging drains (the reference's lane drain
coalescing, which amortises one `device_get`) would save no transfer and
only hold a finished chunk behind a later one. With every lane
quarantined, items fall through to the global collector's ladder over the
same entries (with `host_spill` on, host-executable ones are served by
the host interpreter instead: the breaker's outage, below). "off" builds no lane object
and serves with the single pair, on `device`, its own fault domain (with
`n_devices` > 1 or a `devices` list, on the first of them, the rest the
ladder's failover targets).

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

The device frame tier (ops/chain.py, --cache-device-mb): the global
ladder's first rung and every lane launch may assemble a dct-transport
batch from frames resident on their card; a launch the ladder pins to
another entry, the sharded and spatial launches and the bisections'
relaunches stage anew.

Every launch that meets a (chain, input shape with B, device) signature
this process has not launched before (`chain_mod.cache_size()` grows)
counts one `compile_misses`, on the global, lane, sharded and spatial
dispatches alike: with `--prewarm` (prewarm.py) covering the common
chains at every B of `batch_ladder`, it stays 0. Nothing compiles per
signature here, so the count keeps the reference's meaning of a cold
launch: the first blocks of the caching allocator and of the pinned host
pool for that shape. A future cancelled while it waits (the request's
deadline passed, or a hedge's host twin won) is dropped before its chunk
launches, and the done-callback releases its owed MB.

Placement and the card's fault domain (the reference's executor.py:
819-1450 and 2134-2692):

  * `submit` places each item: the poison list's convicts (integrity)
    run on the host interpreter (engine/host_exec.py), as do
    `--force-host` and, with `host_spill` on, the cost model's spill
    (`_should_spill`, with its shadow probes that refresh the device's
    price) and every host-executable item while no device is
    dispatchable (the breaker's outage). The port's `host_spill` defaults
    to off, where the reference's is auto: the card is the path under
    measurement, and a struck card answers its own error rather than
    send work to the host. Every host answer is counted (`spilled`,
    `breaker_host_served`, `hedges_won`, `oom_host_routed`, integrity's
    `reserved`) and marked for `X-Imaginary-Backend: host`
    (`last_placement`, sticky for the rest of the request, or the
    future's `_hedge_placement`).
  * The global ladder (`_launch_with_failover`) launches on the device
    devhealth's sticky `pick` names and fails over to the next.
  * A capacity error (`chain.is_oom_error`: `torch.cuda.OutOfMemoryError`
    or the `device.oom` failpoint) bisects the chunk on the same device,
    down `oom_split_depth` levels; an item that still does not fit alone
    runs on the host with `host_spill` on, else fails with the device's
    error. A failed kernel launch is a crash strike instead.
  * With `integrity` armed, a sampled share of chunks is recomputed on
    the host (or another entry) before release; a mismatch is a
    corruption strike and the answer is re-served from the verified copy.
    A non-capacity launch failure of a chunk of several items is bisected
    to convict poison inputs. The probe that re-admits an entry runs the
    golden chain through the ported kernels when integrity or fail-slow is
    armed (then also with one device), else a K4 transfer probe.
  * Hedging (`hedge_threshold_ms` > 0) launches a host twin for an item
    still pending after the threshold, never past its deadline; the
    first answer wins.
  * The drain watchdog abandons a global drain stuck past
    `drain_watchdog_s`: it fails that chunk's futures and everything
    queued behind it, strikes the devices outright, and hands the queue
    to a fresh fetcher of the next generation.
  * Fail-slow (`failslow_ratio` > 0) demotes an entry whose golden-probe
    latency exceeds the ratio x its peers' median; with the lane tier a
    demoted lane leaves the rotation (at `failslow_share` 0) until its
    probes recover.

The failpoint sites `executor.submit` (submit), `device.execute` (the
global dispatch), `device.chip_error`, `device.oom` and `device.slow`
(each launch, keyed by the device's index, and the probe), `device.corrupt`
(each drained chunk and the golden probe) and `host.spill` (the spill
branch) are ported.

Mesh batch sharding (`use_mesh`, the reference's executor.py:549-575,
:1636-1700; armed only with `mesh_policy` "off": the lane tier supersedes
it): the global collector splits every formed chunk over the batch axis
of this process's mesh (`get_mesh(..., local=True)`), one sub-chunk per
row on the row's first entry (`ops/chain.launch_sharded`), counted in
`sharded_batches` and, per entry, in `mesh_dispatches`. With `spatial` >
1 a chunk whose bucket crosses the spatial bar (`_spatial_route`) runs
each item W-sharded over one row (`ops/chain.launch_spatial`, rows in
turn). A mesh launch has no single device to blame: a failed one strikes
every dispatchable domain, a capacity error bisects unsharded on the
first entry. On a devhealth generation change `_refresh_mesh_sharding`
re-forms the batch axis over the healthy entries and drops the spatial
axis until the whole mesh is back. The reference pads a chunk to a power
of two and then to a multiple of the batch axis, for XLA's compile cache;
the port pads nothing (`_launch_chunk`).

Multi-process serving: each process serves on its own devices; the
process group (`parallel/mesh.init_distributed`, `--distributed`,
`--mesh-hosts`) carries no serving collective, as the reference's does
not.

The device price: one global drain ms per wire MB (`_ms_per_mb`), and
its per-chain-key refinement (`_rate_by_key`, the reference's
executor.py:658-665, :1029-1038, :2867-2889): a drained chunk of one key
books the same sample into its key's EWMA, seeded at most 16x the
global, each later sample clamped to 4x the key's own history, the dict
cleared when a 257th key arrives. `_rate_for` reads a key's price, capped
at 8x the global, and prices every device item: its own term in the
spill test, the probe's budget and the hedge's threshold, and its charge
in the owed ledger, which stays in MB at the global price plus each
queued item's excess over it (`_owed_excess_mb`).

Cost attribution (obs/cost.py, the reference's executor.py:2087-2103,
:2832-2846): with `cost_armed` (set by the service that binds a cost
plane) each drain books its wall ms as its lane's `drain_busy` (-1 on
the global path) and stamps each item's share and wire bytes on its
request's trace (`cost_device_ms`, `cost_wire_bytes`), and each launch
records a second event before its copy to the host, which splits the
drain into `device_wait` and `d2h` (`_book_device_wait`). Without it
none of these is booked and no event is added.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue as queue_mod
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Optional

import numpy as np
import torch

from imaginary_tpu_torch import failpoints, kernels
from imaginary_tpu_torch.engine import host_exec
from imaginary_tpu_torch.engine import lanes as lanes_mod
from imaginary_tpu_torch.engine.devhealth import (
    STATE_DEGRADED,
    CorruptionError,
    DeviceHealthRegistry,
)
from imaginary_tpu_torch.engine.timing import COPIES, LANE_TIMES, TIMES, WIRE, attribute
from imaginary_tpu_torch.obs import trace as obs_trace
from imaginary_tpu_torch.ops import chain as chain_mod
from imaginary_tpu_torch.ops.buckets import bucket_shape, tight_dim
from imaginary_tpu_torch.ops.plan import ImagePlan
from imaginary_tpu_torch.parallel.mesh import get_mesh, healthy_mesh, split_batch

# The micro-batch chunk cap: the CLI default derives from it.
MAX_BATCH = 16

# qos.CLASS_INDEX["batch"]: batch-class work is never hedged and is the
# class the pressure rung forces to the host (kept literal, as in the
# reference, so this module does not import qos)
_BATCH_CLASS = 2

BATCH_POLICIES = ("continuous", "convoy")


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
    window_ms: float = 3.0  # convoy window; the formation cap when max_form_ms is None
    max_batch: int = MAX_BATCH  # items per device launch
    max_group: int = 64  # convoy: one fetch drains up to this many items
    max_hold_ms: float = 250.0  # convoy: age cap even while the link is busy
    max_inflight: int = 4  # groups launched but not yet fetched
    # "continuous" or "convoy" (module docstring)
    batch_policy: str = "continuous"
    # continuous formation cap (--batch-form-ms); None derives it from
    # window_ms, as in the reference
    max_form_ms: Optional[float] = None
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
    # Cost-model placement (the reference's): an item spills to the host
    # interpreter when its estimated device wait ((owed MB + its MB) x the
    # measured ms per MB, plus the smallest drain seen) exceeds
    # spill_factor x its estimated host cost plus the host pool's backlog.
    # Every probe_interval-th spill-eligible item also rides the device as
    # a discarded shadow, at most one per probe_min_interval_s and within
    # probe_budget_ms, to refresh the price. The same switch lets the
    # host serve host-executable items during the breaker's outage and an
    # item that runs out of device memory alone. False (the port's
    # default: the card is the path under measurement) places nothing on
    # the host this way; None is the reference's "auto" (enabled, the
    # spill governed by the cost model).
    host_spill: Optional[bool] = False
    # Every host-executable plan on the host interpreter, whatever the
    # cost model says (a measurement override; device-only plans still
    # ride the card).
    force_host: bool = False
    spill_factor: float = 6.0
    probe_interval: int = 64
    probe_min_interval_s: float = 10.0
    probe_budget_ms: float = 250.0
    # Hedging: an item still pending after max(hedge_threshold_ms, 50 ms,
    # 4x its estimated service) gets a host twin, the first answer wins;
    # at most hedge_budget x the in-flight device items (floor 1) at once.
    # 0 is off. Never past the request's deadline.
    hedge_threshold_ms: float = 0.0
    hedge_budget: float = 0.05
    # A global drain stuck this long is abandoned (module docstring); 0
    # disables the watchdog.
    drain_watchdog_s: float = 20.0
    # Levels of OOM bisection; items that still do not fit alone run on
    # the host (3 levels turn a 16-item chunk into singles).
    oom_split_depth: int = 3
    # Output integrity (engine/integrity.IntegrityState), None: off.
    integrity: Optional[object] = None
    # Fail-slow demotion (devhealth.configure_failslow), 0: off.
    failslow_ratio: float = 0.0
    failslow_min_samples: int = 8
    failslow_share: float = 0.0
    # Multi-tenant qos (qos/tenancy.QosPolicy): the fair-scheduler intake;
    # None keeps the plain FIFO queue.
    qos: Optional[object] = None
    # Memory-pressure governor (engine/pressure.MemoryGovernor): the batch
    # byte cap and the oversize-to-host rung; None runs no pressure check.
    pressure: Optional[object] = None
    # Mesh batch sharding of the global collector (module docstring), over
    # the mesh of `devices` / `n_devices` with `spatial`; only with
    # mesh_policy "off".
    use_mesh: bool = False
    # Fleet coherence (fleet/ownership.py): False on a worker that does
    # not own the card's shared state. It still launches its kernels on
    # its device, but stands up no lanes and no mesh (mesh_policy is
    # forced "off", use_mesh ignored), so those live in one process.
    device_owner: bool = True


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
    sharded_batches: int = 0  # lane or use_mesh chunks split over the mesh
    # use_mesh: sub-chunks launched on each flat mesh entry (None: unarmed)
    mesh_dispatches: Optional[list] = None
    spatial_batches: int = 0  # single items W-sharded over a spatial row
    # spec name -> spatial launches gathered at that stage; None while the
    # spatial route is not armed (to_dict then shows neither key)
    spatial_gathers: Optional[dict] = None
    # launches that met a signature this process had not launched before
    # (module docstring); 0 after a prewarm that covered the traffic
    compile_misses: int = 0
    # placement and the fault domain (module docstring)
    spilled: int = 0  # items the spill branch (or --force-host) served
    spill_errors: int = 0  # spills that fell back to the device
    breaker_opens: int = 0  # trips that left no device dispatchable
    breaker_host_served: int = 0  # items the host served during an outage
    shadow_probes: int = 0  # discarded device rides that price the link
    hedges_launched: int = 0
    hedges_won: int = 0  # the host twin answered first
    hedges_lost: int = 0  # the device answered first
    hedges_failed: int = 0  # the twin raised
    hedges_skipped: int = 0  # eligible, but over the hedge budget
    oom_events: int = 0  # capacity errors that entered bisection
    oom_splits: int = 0  # bisections performed
    oom_host_routed: int = 0  # items that did not fit alone, host-served
    oom_failed: int = 0  # items bisection could not serve anywhere
    pressure_host_forced: int = 0  # oversize items forced to the host (elevated rung)
    pressure_capped_batches: int = 0  # launches added by the batch byte cap
    device_ms_per_mb: float = 0.0  # the measured device price
    host_ms_per_mpix: float = 0.0  # the measured host price
    host_inflight: int = 0  # items on the host interpreter right now
    host_owed_mpix: float = 0.0  # their source megapixels

    def to_dict(self) -> dict:
        snap = TIMES.snapshot()
        form_times = snap.get("batch_form")
        disp_times = snap.get("dispatch_wait")
        spill_times = snap.get("host_spill")
        wire = WIRE.snapshot()
        donation = chain_mod.donation_stats()
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
            "donation_enabled": donation["enabled"],
            "donation_rejected": donation["rejected"],
            "spilled": self.spilled,
            "spill_errors": self.spill_errors,
            "device_failures": self.device_failures,
            "breaker_opens": self.breaker_opens,
            "breaker_host_served": self.breaker_host_served,
            "shadow_probes": self.shadow_probes,
            # nested, so /metrics renders one labelled family
            "hedges": {
                "launched": self.hedges_launched,
                "won": self.hedges_won,
                "lost": self.hedges_lost,
                "failed": self.hedges_failed,
                "skipped_budget": self.hedges_skipped,
            },
            "oom_events": self.oom_events,
            "oom_splits": self.oom_splits,
            "oom_host_routed": self.oom_host_routed,
            "oom_failed": self.oom_failed,
            "pressure_host_forced": self.pressure_host_forced,
            "pressure_capped_batches": self.pressure_capped_batches,
            "device_owed_mb": round(self.device_owed_mb, 3),
            "device_ms_per_mb": round(self.device_ms_per_mb, 3),
            "host_ms_per_mpix": round(self.host_ms_per_mpix, 3),
            "host_inflight": self.host_inflight,
            "host_owed_mpix": round(self.host_owed_mpix, 3),
            "host_spill_p50_ms": spill_times["p50_ms"] if spill_times else 0.0,
            "host_spill_p99_ms": spill_times["p99_ms"] if spill_times else 0.0,
            # the link ledger (engine/timing.WIRE), nested so /metrics
            # renders imaginary_tpu_wire_bytes_total{direction=}
            "wire_bytes": {"h2d": wire["h2d"], "d2h": wire["d2h"]},
            "wire_transfers": {"h2d": wire["h2d_transfers"],
                               "d2h": wire["d2h_transfers"]},
        }
        if "by_device" in wire:
            out["wire_bytes_by_device"] = wire["by_device"]
        # the byte-touch ledger by stage (engine/timing.COPIES)
        copies = COPIES.snapshot()
        out["copied_bytes"] = copies["bytes"]
        out["copy_events"] = copies["copies"]
        if self.lanes_snapshot is not None:
            lanes = self.lanes_snapshot()
            if lanes:
                out["lanes"] = lanes
                out["mesh_generation"] = self.mesh_generation
        if self.mesh_dispatches is not None:
            out["sharded_batches"] = self.sharded_batches
            out["mesh_dispatches"] = list(self.mesh_dispatches)
        if self.spatial_gathers is not None:
            out["spatial_batches"] = self.spatial_batches
            out["spatial_gathers"] = dict(self.spatial_gathers)
        return out


# The measured link seed, installed by prewarm (prewarm.py): (ms per wire
# MB, fixed floor ms). A new executor prices its owed ledger at the seed
# instead of leaving the link unpriced until its first drain; the EWMA
# refines it from real drains at once.
_LINK_SEED: Optional[tuple] = None


def seed_link_rate(ms_per_mb: float, floor_ms: float) -> None:
    global _LINK_SEED
    _LINK_SEED = (max(float(ms_per_mb), 0.0), max(float(floor_ms), 0.0))


def link_seed() -> Optional[tuple]:
    return _LINK_SEED


# Where the last submit() on this thread computed its pixels ("device" or
# "host"). A request runs on one pool thread (handler -> pipeline ->
# Executor.process), so the handler reads it after processing to answer
# X-Imaginary-Backend.
_PLACEMENT = threading.local()


def reset_placement() -> None:
    _PLACEMENT.value = None


def note_placement(value: str) -> None:
    """Record placement for work that never reaches submit() (identity
    chains), and a hedge winner's or a host-served chunk's "host"."""
    _PLACEMENT.value = value


def last_placement() -> Optional[str]:
    return getattr(_PLACEMENT, "value", None)


def _available_cpus() -> int:
    try:
        return len(os.sched_getaffinity(0)) or 1
    except AttributeError:  # not Linux
        return os.cpu_count() or 1


class _Item:
    __slots__ = ("arr", "plan", "future", "key", "t", "t_close", "wire_mb",
                 "mpix", "qos", "trace", "lane", "hops", "stage_ms")

    def __init__(self, arr: np.ndarray, plan: ImagePlan):
        self.arr = arr
        self.plan = plan
        self.future: Future = Future()
        # (tenant, class index, max_share, deadline_t), stamped by submit()
        # with a qos policy; None rides the FIFO path
        self.qos = None
        if plan.in_bucket is not None:  # packed transport: pre-padded array
            hb, wb = plan.in_bucket
            in_h, in_w = plan.in_h, plan.in_w
        else:
            hb, wb = bucket_shape(arr.shape[0], arr.shape[1])
            in_h, in_w = arr.shape[0], arr.shape[1]
        self.key = (plan.spec_key(), hb, wb, arr.shape[2])
        # the link charges for the PADDED input and output buffers
        if plan.out_bucket is not None:  # packed yuv output: bucket * 1.5
            ob_h, ob_w = plan.out_bucket
            out_bytes = (ob_h + ob_h // 2) * ob_w
        else:
            out_bytes = tight_dim(plan.out_h) * tight_dim(plan.out_w) * arr.shape[2]
        self.wire_mb = (hb * wb * arr.shape[2] * arr.dtype.itemsize + out_bytes) / 1e6
        self.mpix = in_h * in_w / 1e6  # the host's cost unit
        self.t = time.monotonic()
        # Stamped by the collector when this item's chunk closes; the
        # batch_form / dispatch_wait split reads it (_dispatch).
        self.t_close = self.t
        # the submitting request's trace: the executor's threads carry no
        # contextvar, so the placement ladder is stamped through it
        self.trace = None
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
        if self.config.batch_policy not in BATCH_POLICIES:
            raise ValueError(f"unknown batch policy {self.config.batch_policy!r} "
                             f"(one of {', '.join(BATCH_POLICIES)})")
        if self.config.host_spill is None:  # "auto": the cost model decides
            self.config = dataclasses.replace(self.config, host_spill=True)
        if self.config.spatial_mpix > 0.0:
            # the megapixel knob maps onto the pixel bar: one bar for both
            self.config = dataclasses.replace(
                self.config,
                spatial_threshold_px=int(self.config.spatial_mpix * 1e6))
        self._mesh_policy = (self.config.mesh_policy or "off").lower()
        if self._mesh_policy not in MESH_POLICIES:
            raise ValueError(f"unknown mesh policy {self.config.mesh_policy!r} "
                             f"(one of {', '.join(MESH_POLICIES)})")
        if not self.config.device_owner:
            # the card's lanes and mesh live once, on the device owner
            self._mesh_policy = "off"
        self.stats = ExecutorStats()
        # The lane tier's state; all None / 0 with mesh_policy "off".
        self._lanes: Optional[lanes_mod.LaneScheduler] = None
        self._mesh = None
        self._lane_mesh = None  # the healthy mesh sharded dispatch uses
        self._lane_streams = None  # its entries' lane streams
        self._spatial = 1  # the full mesh's spatial axis (lanes or use_mesh)
        # use_mesh: the batch view the global collector launches over (the
        # healthy entries), the flat index of each of its rows' first entry
        # and the devhealth generation it was built at; None when unarmed
        self._batch_mesh = None
        self._batch_rows: list = []
        self._mesh_devhealth_gen = 0
        self._spatial_on = False  # the route is armed and the mesh whole
        self._lane_lock = threading.Lock()  # serialises topology refreshes
        self._lanes_devhealth_gen = 0
        self._mesh_generation = 0
        if self.config.qos is not None:
            # the class-aware intake: queue.Queue's surface, so the
            # collectors are policy-agnostic
            from imaginary_tpu_torch.qos.sched import FairScheduler

            self._queue = FairScheduler(self.config.qos)
        else:
            self._queue = queue_mod.Queue()
        self._fetch_queue: queue_mod.Queue = queue_mod.Queue(
            maxsize=max(1, self.config.max_inflight))
        self._lock = threading.Lock()  # guards _closed, the ledgers and the stats
        self._closed = False
        # set by the service that binds a cost plane to this executor
        # (obs/cost.py): each drain then books its lane's busy time and
        # each item's share on its request's trace, and each launch records
        # its kernels event for the device_wait split. The executor's own
        # flag, not the process's plane, so an armed server and one with
        # no plane in one process never arm each other.
        self.cost_armed = False
        # groups launched on the global pair whose chunks have not all
        # drained (their CUDA events not all completed): the convoy's
        # link-idle test reads it
        self._inflight = 0
        self._stop = threading.Event()  # ends the watchdog
        # drain ms per wire MB (EWMA over drained chunks): prices the owed
        # ledger for estimated_wait_ms and the spill test; the prewarm's
        # seed, else None until the first drain (a zero seed leaves the
        # link unpriced, never free)
        self._ms_per_mb: Optional[float] = None
        # the per-chain-key refinement of that price (bounded at 256 keys),
        # and the MB the queued items owe beyond the global price
        self._rate_by_key: dict = {}
        self._owed_excess_mb = 0.0
        self._drain_floor_ms: Optional[float] = None  # smallest drain seen
        self.adopt_link_seed()
        # the host side of placement: its measured price (bootstrap 15 ms
        # a megapixel, the reference's), its backlog, and a gate of one
        # permit a usable CPU so waiting happens before the run
        self._host_ms_per_mpix = 15.0
        self._host_owed_mpix = 0.0
        self._host_inflight = 0
        self._ncpus = _available_cpus()
        self._host_gate = threading.BoundedSemaphore(max(1, self._ncpus))
        self._spill_seen = 0
        self._probe_slots_skipped = 0
        self._last_shadow_t = float("-inf")
        # in-flight device items and live hedges (the hedge budget)
        self._device_items = 0
        self._hedges_inflight = 0
        # the drain watchdog: (start, chunk, generation) while a global
        # drain is in flight; a fetcher whose generation is no longer
        # current is the zombie of an abandoned drain
        self._drain_state = None
        self._fetch_gen = 0
        self.integrity = self.config.integrity
        if self.config.pressure is not None:
            # the governor was built before this executor: hand it the
            # occupancy signals it samples (host megapixels at ~12 B/px of
            # f32 RGB scratch, device wire MB at ~4x for the f32
            # intermediates), as the reference's executor does
            self.config.pressure.bind_sources(
                host_mb_fn=lambda: self.stats.host_owed_mpix * 12.0,
                device_mb_fn=lambda: self.stats.device_owed_mb * 4.0)
        self._devices: list = [torch.device(self.config.device)]
        if self._mesh_policy != "off":
            # may refuse the mesh before any thread starts; replaces
            # _devices with the mesh's entries
            self._init_lanes()
        else:
            cfg = self.config
            if cfg.use_mesh and cfg.device_owner:
                self._init_batch_mesh()
            elif cfg.devices or cfg.n_devices > 1:
                # the global ladder's fault domains: the first is the
                # primary, the rest are failover targets (sticky `pick`)
                self._devices = list(get_mesh(cfg.n_devices or None, 1,
                                              devices=cfg.devices or cfg.device,
                                              local=True).flat)
            self.devhealth = self._new_devhealth(len(self._devices))
            if len(self._devices) > 1 or self._golden_probe_armed():
                # one device probes only for the golden probe: its next
                # request is its re-admission probe otherwise
                self.devhealth.start_probing(self._probe_device,
                                             timeout_s=PROBE_TIMEOUT_S)
        collect = (self._collect_convoy if self.config.batch_policy == "convoy"
                   else self._collect_continuous)
        self._thread = threading.Thread(target=collect, name="itpu-collector",
                                        daemon=True)
        self._fetcher = threading.Thread(target=self._fetch_loop, args=(0,),
                                         name="itpu-fetcher", daemon=True)
        self._thread.start()
        self._fetcher.start()
        self._watchdog = None
        if self.config.drain_watchdog_s > 0:
            self._watchdog = threading.Thread(target=self._watchdog_loop,
                                              name="itpu-watchdog", daemon=True)
            self._watchdog.start()

    def _new_devhealth(self, n: int) -> DeviceHealthRegistry:
        cfg = self.config
        reg = DeviceHealthRegistry(n, threshold=cfg.breaker_threshold,
                                   cooldown_s=cfg.breaker_cooldown_s)
        if self.integrity is not None:
            reg.corruption_clean_probes = self.integrity.config.clean_probes
        if cfg.failslow_ratio > 0.0:
            reg.configure_failslow(cfg.failslow_ratio,
                                   min_samples=cfg.failslow_min_samples,
                                   share=cfg.failslow_share)
        return reg

    # -- placement -------------------------------------------------------------

    def submit(self, arr: np.ndarray, plan: ImagePlan) -> Future:
        """Enqueue one image; resolves to the chain's output (an HWC uint8
        array, YuvPlanes on the packed transports, or QuantizedBlocks with
        the dct egress). Identity chains resolve at once, with no device
        work; the placement rungs (module docstring) may serve the item on
        the host before it queues."""
        failpoints.hit("executor.submit")
        item = _Item(arr, plan)
        if self.config.qos is not None:
            # tenant, class and deadline from the request's trace (the
            # pool thread's copied context), before the spill branch so a
            # shadow probe inherits them
            from imaginary_tpu_torch.qos.tenancy import request_qos

            item.qos = request_qos(self.config.qos)
        item.trace = obs_trace.current()
        if last_placement() != "host":  # a request's host answer stays marked
            _PLACEMENT.value = "device"
        if not plan.stages:
            if not item.future.done():
                item.future.set_result(arr)
            return item.future
        integ = self.integrity
        if integ is not None and integ.enabled and integ.poison_active():
            from imaginary_tpu_torch.engine import integrity as integrity_mod

            if integ.poison_hit(integrity_mod.item_digest(arr, item.key)):
                # an input the bisection convicted alone: the host, else 422
                if host_exec.can_execute(plan, for_spill=False):
                    try:
                        out = host_exec.run(arr, plan)
                    except Exception:  # itpu: allow[ITPU004] the 422 below answers
                        pass
                    else:
                        _PLACEMENT.value = "host"
                        self._stamp_attempts([item], ["poison_quarantine",
                                                      "host_fallback"])
                        if not item.future.done():
                            item.future.set_result(out)
                        return item.future
                from imaginary_tpu_torch.errors import new_error

                self._stamp_attempts([item], ["poison_quarantine"])
                if not item.future.done():
                    item.future.set_exception(new_error(
                        "Input is quarantined: it repeatedly failed device "
                        "execution in isolation", 422))
                return item.future
        if self.config.host_spill and self._breaker_is_open() \
                and host_exec.can_execute(plan, for_spill=False):
            # no device is dispatchable and host placement is on: every
            # host-executable item is served by the host for the outage;
            # the rest (everything, with host_spill off) still go to the
            # device and surface its error
            try:
                out = host_exec.run(arr, plan)
            except Exception:  # itpu: allow[ITPU004] the device path reports the real error
                pass
            else:
                with self._lock:
                    self.stats.breaker_host_served += 1
                _PLACEMENT.value = "host"
                self._stamp_attempts([item], ["device:quarantined", "host_fallback"])
                if not item.future.done():
                    item.future.set_result(out)
                return item.future
        forced = self.config.force_host and host_exec.can_execute(plan, for_spill=False)
        gov = self.config.pressure
        if (not forced and gov is not None
                and item.mpix >= gov.config.oversize_mpix
                # batch-class work, or everything with qos off (untyped
                # traffic has no latency contract to protect)
                and (item.qos is None or item.qos[1] == _BATCH_CLASS)
                and gov.level() >= 1  # elevated or critical
                and host_exec.can_execute(plan, for_spill=False)):
            # the elevated rung: oversize frames stop transiting the
            # device; they ride the spill branch (its gate, its ledger,
            # its placement mark)
            forced = True
            with self._lock:
                self.stats.pressure_host_forced += 1
        if forced or (self.config.host_spill and self._should_spill(item)):
            out = self._spill(item)
            if out is not None:
                if not item.future.done():
                    item.future.set_result(out)
                return item.future
        try:
            # the put stays under _lock, so shutdown's sentinel follows
            # every item it admitted
            with self._lock:
                if self._closed:
                    raise RuntimeError("executor is shut down")
                self._charge_owed(item)
                lane = self._lanes.place(item) if self._lanes is not None else None
                if lane is None:
                    self._queue.put(item)
                else:
                    lanes_mod._lane_owe(lane, item)
                    lane.put(item)
        except Exception:
            # the qos share cap (TenantShareExceeded, a 503): cancelling
            # the never-queued future fires its done-callback, which
            # refunds the owed charge (here, after _lock, which it takes)
            item.future.cancel()
            raise
        if self.config.hedge_threshold_ms > 0:
            outer = self._arm_hedge(item)
            if outer is not None:
                return outer
        return item.future

    def _spill(self, item: "_Item"):
        """The spill branch: run the item on the host interpreter behind
        the host gate, counted in `spilled`; None when the host failed
        (counted in `spill_errors`), and the item goes to the device."""
        self._host_charge(item.mpix)
        tg = time.monotonic()
        self._host_gate.acquire()
        t0 = time.monotonic()
        TIMES.record("host_gate", (t0 - tg) * 1000.0)
        c0 = time.thread_time()
        try:
            failpoints.hit("host.spill")
            out = host_exec.run(item.arr, item.plan)
        except Exception:  # noqa: BLE001 - the device path can still serve it
            with self._lock:
                self.stats.spill_errors += 1
            return None
        else:
            TIMES.record("host_spill", (time.monotonic() - t0) * 1000.0)
            # the marginal host cost: thread CPU time a source megapixel,
            # clamped like the device price
            per_mpix = (time.thread_time() - c0) * 1000.0 / max(item.mpix, 1e-3)
            with self._lock:
                per_mpix = min(per_mpix, 4.0 * self._host_ms_per_mpix)
                self._host_ms_per_mpix = 0.8 * self._host_ms_per_mpix + 0.2 * per_mpix
                self.stats.host_ms_per_mpix = self._host_ms_per_mpix
                self.stats.spilled += 1
            _PLACEMENT.value = "host"
            self._stamp_attempts([item], ["host_spill"])
            return out
        finally:
            self._host_release(item.mpix)
            self._host_gate.release()

    def _host_charge(self, mpix: float) -> None:
        with self._lock:
            self._host_inflight += 1
            self._host_owed_mpix += mpix
            self.stats.host_inflight = self._host_inflight
            self.stats.host_owed_mpix = self._host_owed_mpix

    def _host_release(self, mpix: float) -> None:
        with self._lock:
            self._host_inflight -= 1
            self._host_owed_mpix = max(0.0, self._host_owed_mpix - mpix)
            self.stats.host_inflight = self._host_inflight
            self.stats.host_owed_mpix = self._host_owed_mpix

    def _charge_owed(self, item: "_Item") -> None:
        """Book the item's wire MB against the device (call under _lock),
        and the MB its key's price owes beyond the global one; its
        future's done-callback releases exactly that, however it ends."""
        self.stats.device_owed_mb += item.wire_mb
        self._device_items += 1
        mb = item.wire_mb
        glob = self._ms_per_mb
        excess = mb * (self._rate_for_locked(item.key) / glob - 1.0) if glob else 0.0
        self._owed_excess_mb += excess
        item.future.add_done_callback(lambda _f: self._on_done(mb, excess))

    def _on_done(self, wire_mb: float, excess_mb: float = 0.0) -> None:
        with self._lock:
            self._device_items -= 1
            self.stats.device_owed_mb = max(0.0, self.stats.device_owed_mb - wire_mb)
            self._owed_excess_mb -= excess_mb
            if self._device_items == 0:
                self._owed_excess_mb = 0.0  # no float residue on an idle card

    def _rate_for(self, key) -> float:
        """The device's price for a chain key in ms per wire MB: its own
        measured rate where known, capped at 8x the global, so a key priced
        on a bad day earns the card back as the global improves; the
        global for an unknown key; 0 while the device is unpriced."""
        with self._lock:
            return self._rate_for_locked(key)

    def _rate_for_locked(self, key) -> float:
        glob = self._ms_per_mb
        if glob is None:
            return 0.0
        key_rate = self._rate_by_key.get(key)
        return glob if key_rate is None else min(key_rate, 8.0 * glob)

    def _owed_ms_locked(self) -> float:
        """The owed ledger priced: the queued MB at the global price plus
        the queued items' excess at their keys' prices."""
        rate = self._ms_per_mb
        if not rate:
            return 0.0
        return max(0.0, self.stats.device_owed_mb + self._owed_excess_mb) * rate

    def _should_spill(self, item: "_Item") -> bool:
        """The reference's cost model: spill when the device wait (owed MB
        and this item's, at the measured price, plus the smallest drain)
        exceeds spill_factor x the host cost, with the host pool's backlog
        outside the factor on the host side (it cancels when the device is
        the CPU itself)."""
        if self._ms_per_mb is None:
            return False  # the device's cost is unknown: it is the primary path
        with self._lock:
            rate = self._rate_for_locked(item.key)
            owed_ms = self._owed_ms_locked()
            host_rate = self._host_ms_per_mpix
            host_owed = self._host_owed_mpix
        wait_ms = owed_ms + item.wire_mb * rate + (self._drain_floor_ms or 0.0)
        shares_cpu = self._devices[0].type == "cpu"
        host_queue_ms = 0.0 if shares_cpu else host_owed / self._ncpus * host_rate
        host_ms = max(item.mpix, 1e-3) * host_rate
        if wait_ms <= self.config.spill_factor * host_ms + host_queue_ms:
            return False
        if not host_exec.can_execute(item.plan):
            return False
        with self._lock:
            self._spill_seen += 1
            seen = self._spill_seen
        if seen % self.config.probe_interval == 0:
            # a probe slot: a shadow rides the device to re-price it, when
            # cheap and not too soon, or ungated after 16 skipped slots
            cheap = item.wire_mb * rate <= self.config.probe_budget_ms
            now = time.monotonic()
            with self._lock:
                fresh = now - self._last_shadow_t >= self.config.probe_min_interval_s
                if not cheap:
                    self._probe_slots_skipped += 1
                ship = (cheap and fresh) or self._probe_slots_skipped >= 16
                if ship:
                    self._probe_slots_skipped = 0
                    self._last_shadow_t = now
            if ship:
                self._enqueue_shadow(item)
        return True

    def _enqueue_shadow(self, item: "_Item") -> None:
        """A copy of the item on the device queue, only to refresh the
        price; its result is discarded (the request is served by the
        host)."""
        shadow = _Item(item.arr, item.plan)
        shadow.qos = item.qos
        shadow.future.add_done_callback(
            lambda f: None if f.cancelled() else f.exception())  # swallow
        try:
            with self._lock:
                if self._closed:
                    return
                self._charge_owed(shadow)
                self._queue.put(shadow)
                self.stats.shadow_probes += 1
        except Exception:
            # a share cap drops the shadow; after _lock, since the
            # done-callback refunds the charge under it
            shadow.future.cancel()

    @staticmethod
    def _stamp_attempts(items: list, attempts: list) -> None:
        """The placement ladder an item walked, on its request's trace."""
        for it in items:
            if it.trace is not None:
                it.trace.annotate(placement_attempts=list(attempts))

    # -- hedging ---------------------------------------------------------------

    def _hedge_threshold_ms_for(self, item: "_Item") -> float:
        """The operator's threshold, floored at 50 ms and at 4x the item's
        own estimated device service time."""
        est = (self._drain_floor_ms or 0.0) + item.wire_mb * self._rate_for(item.key)
        return max(self.config.hedge_threshold_ms, 50.0, 4.0 * est)

    def _arm_hedge(self, item: "_Item") -> Optional[Future]:
        """Wrap a queued device item in an outer future that a host twin
        may answer once the threshold passes. None (the caller returns the
        plain future) for batch-class qos work, a host-inexecutable plan,
        or when the request's deadline comes before the threshold."""
        if item.qos is not None and item.qos[1] == _BATCH_CLASS:
            return None  # batch work never amplifies into host capacity
        if not host_exec.can_execute(item.plan, for_spill=False):
            return None
        threshold_ms = self._hedge_threshold_ms_for(item)
        dl = item.trace.deadline if item.trace is not None else None
        if dl is not None and dl.remaining_s() * 1000.0 <= threshold_ms:
            return None  # the deadline fires first: no hedge
        outer: Future = Future()
        lock = threading.Lock()
        state = {"exc": None, "running": False}
        timer = threading.Timer(threshold_ms / 1000.0, self._fire_hedge,
                                args=(item, outer, lock, state))
        timer.daemon = True

        def on_primary(f: Future) -> None:
            timer.cancel()
            with lock:
                if outer.done():
                    return  # the twin won (and cancelled this future)
                if f.cancelled():
                    outer.cancel()
                    return
                exc = f.exception()
                if exc is None:
                    outer.stage_ms = getattr(f, "stage_ms", None)
                    # a verified copy or an OOM host route marks the inner
                    # future; the caller reads the outer one
                    hp = getattr(f, "_hedge_placement", None)
                    if hp:
                        outer._hedge_placement = hp
                    try:
                        outer.set_result(f.result())
                    except InvalidStateError:  # a racing cancel: the result stands down
                        pass
                    return
                if state["running"]:
                    state["exc"] = exc  # the twin may still answer
                    return
                try:
                    outer.set_exception(exc)
                except InvalidStateError:  # a racing cancel
                    pass

        def on_outer(f: Future) -> None:
            # a deadline cancels the outer future: the device item too
            if f.cancelled():
                timer.cancel()
                item.future.cancel()

        item.future.add_done_callback(on_primary)
        outer.add_done_callback(on_outer)
        timer.start()
        return outer

    def _fire_hedge(self, item: "_Item", outer: Future, lock, state) -> None:
        """The timer: launch the host twin while the device item is still
        pending, within the budget."""
        with lock:
            if outer.done() or item.future.done():
                return
            dl = item.trace.deadline if item.trace is not None else None
            if dl is not None and dl.remaining_s() <= 0.0:
                return  # never a hedge past the deadline
            with self._lock:
                allowed = max(1, int(self.config.hedge_budget * max(1, self._device_items)))
                if self._hedges_inflight >= allowed:
                    self.stats.hedges_skipped += 1
                    return
                self._hedges_inflight += 1
                self.stats.hedges_launched += 1
            state["running"] = True
        won = False
        try:
            out = host_exec.run(item.arr, item.plan)
        except Exception:  # noqa: BLE001 - the device path still owns the request
            with lock:
                state["running"] = False
                with self._lock:
                    self.stats.hedges_failed += 1
                exc = state["exc"]
                if exc is not None and not outer.done():
                    with contextlib.suppress(InvalidStateError):
                        outer.set_exception(exc)
        else:
            with lock:
                state["running"] = False
                if not outer.done():
                    outer._hedge_placement = "host"
                    try:
                        outer.set_result(out)
                        won = True
                    except InvalidStateError:
                        won = False
                with self._lock:
                    if won:
                        self.stats.hedges_won += 1
                    else:
                        self.stats.hedges_lost += 1
            if won:
                # the loser: dropped before launch if still queued, its
                # result discarded if launched; its owed MB is released
                item.future.cancel()
            if item.trace is not None:
                item.trace.annotate(hedge="won" if won else "lost")
        finally:
            with self._lock:
                self._hedges_inflight -= 1

    def process(self, arr: np.ndarray, plan: ImagePlan, timeout: float = 120.0):
        """Blocking submit: the output, with the item's stage times added
        to the calling thread's request trace and a host answer noted for
        X-Imaginary-Backend."""
        fut = self.submit(arr, plan)
        out = fut.result(timeout=timeout)
        attribute(getattr(fut, "stage_ms", None))
        hp = getattr(fut, "_hedge_placement", None)
        if hp:
            _PLACEMENT.value = hp
        return out

    def estimated_wait_ms(self) -> float:
        """Estimated device-path queueing delay for a new arrival: the
        wire MB submitted and not yet drained, each item's at its key's
        measured drain ms per MB (the reference's owed-work ledger, kept
        per MB)."""
        with self._lock:
            return self._owed_ms_locked()

    def adopt_link_seed(self) -> None:
        """Price the owed ledger at the installed link seed unless a drain
        has priced it already (a boot prewarm seeds after the executor is
        built)."""
        seed = _LINK_SEED
        with self._lock:
            if self._ms_per_mb is None and seed is not None and seed[0] > 0.0:
                self._ms_per_mb = seed[0]
                self.stats.device_ms_per_mb = seed[0]
                if seed[1] > 0.0 and self._drain_floor_ms is None:
                    self._drain_floor_ms = seed[1]

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
        self.devhealth.close()
        if self._lanes is not None:
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
        self._stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=5)

    # -- collector -------------------------------------------------------------

    def _form_cap_s(self) -> float:
        """The continuous policy's formation cap in seconds: max_form_ms,
        else window_ms."""
        ms = self.config.max_form_ms
        if ms is None:
            ms = self.config.window_ms
        return max(ms, 0.0) / 1000.0

    def _collect_continuous(self):
        """A chunk closes at max_batch items or at the formation cap,
        whichever first, and launches at once. Time the collector spends
        blocked on the bounded fetch queue books as dispatch_wait for the
        items it delays, not as formation. Runs until the shutdown
        sentinel, then launches whatever is still pending."""
        form = self._form_cap_s()
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

    def _collect_convoy(self):
        """The reference's legacy accumulate-launch-drain policy. A group
        dispatches when it holds max_group items, or its oldest item has
        waited the window and the link is idle (`_inflight` 0: every
        launched group drained), or its oldest item is older than
        max_hold_ms. A group stays open until dispatch, so its whole wait
        books as batch_form (an infinite formation cap). Runs until the
        shutdown sentinel, then dispatches whatever is still pending."""
        window = self.config.window_ms / 1000.0
        hold = self.config.max_hold_ms / 1000.0
        group = max(1, self.config.max_group)
        pending: dict = {}  # key -> list[_Item]
        running = True
        while running:
            timeout = None
            if pending:
                oldest = min(items[0].t for items in pending.values())
                now = time.monotonic()
                # past the window the link may still be busy: poll briefly
                timeout = 0.002 if now - oldest >= window else oldest + window - now
            try:
                got = self._queue.get(timeout=timeout)
            except queue_mod.Empty:
                got = False
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
            with self._lock:
                link_idle = self._inflight == 0
            due = [k for k, items in pending.items()
                   if len(items) >= group
                   or (now - items[0].t >= window and link_idle)
                   or now - items[0].t >= hold]
            for k in due:
                items = pending.pop(k)
                for start in range(0, len(items), group):
                    self._close_chunk(items[start:start + group], float("inf"))
            self.stats.queue_depth = self._queue.qsize() + sum(
                len(v) for v in pending.values())
        for items in pending.values():
            for start in range(0, len(items), group):
                self._close_chunk(items[start:start + group], float("inf"))
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

    def _stamp_stages(self, items: list, now: float, lane=None) -> None:
        for it in items:
            bf_ms = (it.t_close - it.t) * 1000.0
            dw_ms = (now - it.t_close) * 1000.0
            TIMES.record("queue_wait", (now - it.t) * 1000.0)
            TIMES.record("batch_form", bf_ms)
            TIMES.record("dispatch_wait", dw_ms)
            if lane is not None:
                LANE_TIMES.record(lane.idx, "batch_form", bf_ms)
                LANE_TIMES.record(lane.idx, "dispatch_wait", dw_ms)
                if it.trace is not None:
                    it.trace.annotate(lane=lane.idx)
            it.stage_ms["batch_form"] = bf_ms
            it.stage_ms["dispatch_wait"] = dw_ms

    def _dispatch(self, items: list) -> None:
        """Launch one group as chunk-sized device calls
        (`_chunk_for_launch`) through the failover ladder and hand the
        fetcher ONE entry covering them all."""
        now = time.monotonic()
        self._stamp_stages(items, now)
        try:
            # delay() models a slow device or link, error() a failed
            # dispatch, with no device to blame: every domain is struck
            failpoints.hit("device.execute")
        except Exception as e:
            self._note_link_failure(e)
            self._stamp_attempts(items, ["device:link:error"])
            self._fail(items, e)
            return
        items = self._drop_cancelled(items)
        if not items:
            return
        before = chain_mod.cache_size()
        chunks = []
        for sub in self._chunk_for_launch(items):
            chunk = self._launch_with_failover(sub)
            if chunk is not None:  # else its futures are resolved already
                chunks.append(chunk)
        if not chunks:
            return
        cold = self._note_cold(before)
        launched = sum(len(c[3]) for c in chunks)
        TIMES.record("launch", (time.monotonic() - now) * 1000.0 / launched)
        with self._lock:
            self.stats.items += launched
            self.stats.groups += 1
            self.stats.batches += len(chunks)
            self.stats.max_group_seen = max(self.stats.max_group_seen, launched)
            self._inflight += 1
        # blocks when max_inflight groups wait for the fetcher: backpressure
        self._fetch_queue.put((chunks, cold))

    def _chunk_for_launch(self, items: list) -> list:
        """Slice a group into device calls of at most max_batch items and,
        under memory pressure, at most the governor's batch byte cap in
        wire MB (floor one item), so a tight card sees small launches up
        front instead of bisecting big ones. Each launch the cap adds is
        counted in pressure_capped_batches."""
        cap = self.config.max_batch
        cap_mb = 0.0
        gov = self.config.pressure
        if gov is not None:
            cap_mb = gov.batch_cap_mb()
        if cap_mb <= 0.0:
            return [items[s:s + cap] for s in range(0, len(items), cap)]
        subs: list = []
        cur: list = []
        cur_mb = 0.0
        for it in items:
            if cur and (len(cur) >= cap or cur_mb + it.wire_mb > cap_mb):
                subs.append(cur)
                cur, cur_mb = [], 0.0
            cur.append(it)
            cur_mb += it.wire_mb
        if cur:
            subs.append(cur)
        base = -(-len(items) // cap)  # the uncapped launch count
        if len(subs) > base:
            with self._lock:
                self.stats.pressure_capped_batches += len(subs) - base
        return subs

    def _launch_chunk(self, items: list, device=None, device_cache: bool = False):
        """Launch one device call of <= max_batch items on `device` (the
        config's by default); returns (launched, arrs, plans) or raises.
        device_cache: the ladder's first rung (the primary entry, the
        reference's unpinned launch) uses the device frame tier.

        No power-of-two padding, and none to a multiple of the mesh's
        batch axis: the reference pads a chunk so that XLA compiles one
        program per padded size. Eager PyTorch compiles nothing per batch
        size, so padding would only repeat device work and link bytes."""
        arrs = [it.arr for it in items]
        plans = [it.plan for it in items]
        dev = self.config.device if device is None else device
        return (chain_mod.launch_batch(arrs, plans, device=dev, device_cache=device_cache,
                                       split=self.cost_armed),
                arrs, plans)

    # -- mesh batch sharding (use_mesh; mesh_policy "off") ---------------------

    def _init_batch_mesh(self) -> None:
        """Arm use_mesh: this process's mesh (local=True, as the
        reference's) over `devices` / `n_devices` with the spatial axis;
        its entries become the fault domains."""
        cfg = self.config
        mesh = get_mesh(cfg.n_devices or None, max(1, cfg.spatial),
                        devices=cfg.devices or cfg.device, local=True)
        for dev in mesh.flat:
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available for the executor's mesh")
        self._mesh = mesh
        self._devices = list(mesh.flat)
        self._spatial = mesh.shape[1]
        self._set_batch_mesh(mesh, range(0, len(self._devices), self._spatial))
        self.stats.mesh_dispatches = [0] * len(self._devices)
        if self._spatial > 1:
            self.stats.spatial_gathers = {}

    def _set_batch_mesh(self, mesh, rows) -> None:
        self._batch_mesh = mesh
        self._batch_rows = list(rows)
        # W-sharding needs the whole grid
        self._spatial_on = self._spatial > 1 and mesh is self._mesh

    def _refresh_mesh_sharding(self) -> None:
        """On a devhealth generation change (an entry quarantined or
        re-admitted), re-form the batch axis over the available entries
        (`healthy_mesh`, batch-only), or the whole mesh when all are back;
        a degraded mesh drops the spatial axis. With nothing available the
        mesh stays as it is: the launch fails and the breaker owns the
        outage."""
        gen = self.devhealth.generation
        if gen == self._mesh_devhealth_gen:
            return
        self._mesh_devhealth_gen = gen
        avail = sorted(self.devhealth.available_indices())
        if len(avail) >= len(self._devices):
            self._set_batch_mesh(self._mesh, range(0, len(self._devices), self._spatial))
            return
        mesh = healthy_mesh(self._mesh, avail)
        if mesh is not None:
            self._set_batch_mesh(mesh, avail)

    def _launch_mesh_chunk(self, items: list) -> tuple:
        """Launch one chunk over the batch mesh: split over its rows, or,
        on the spatial route, each item W-sharded over one row, rows in
        turn (one ShardedLaunch part an item). Returns (launched, arrs,
        plans) or raises."""
        arrs = [it.arr for it in items]
        plans = [it.plan for it in items]
        mesh, rows = self._batch_mesh, self._batch_rows
        if self._spatial_route(items[0].key):
            parts, gathered = [], {}
            for j, (a, p) in enumerate(zip(arrs, plans)):
                sl = chain_mod.launch_spatial(a, p, mesh.devices[j % mesh.shape[0]])
                parts.append((j, j + 1, sl))
                if sl is not None and sl.gathered is not None:
                    gathered[sl.gathered] = gathered.get(sl.gathered, 0) + 1
            with self._lock:
                self.stats.spatial_batches += 1
                g = self.stats.spatial_gathers
                # a new dict, so to_dict's copy never sees one change
                self.stats.spatial_gathers = {
                    **g, **{k: g.get(k, 0) + v for k, v in gathered.items()}}
                for j in range(len(items)):
                    self.stats.mesh_dispatches[rows[j % mesh.shape[0]]] += 1
            return chain_mod.ShardedLaunch(parts), arrs, plans
        launched = chain_mod.launch_sharded(arrs, plans, mesh)
        with self._lock:
            self.stats.sharded_batches += 1
            for row, (a, b) in enumerate(split_batch(len(items), mesh)):
                if b > a:
                    self.stats.mesh_dispatches[rows[row]] += 1
        return launched, arrs, plans

    def _launch_over_mesh(self, sub: list):
        """use_mesh's dispatch: one launch over the batch mesh. A failure
        cannot be blamed on one entry, so every dispatchable domain takes
        the strike and the chunk fails; a capacity error bisects
        unsharded on the first entry (re-sharding a launch that just
        overflowed would overflow again). Returns the fetcher's chunk
        tuple with no device index, or None with the futures resolved."""
        self._refresh_mesh_sharding()
        t_launch = time.monotonic()
        try:
            failpoints.hit("device.chip_error")
            failpoints.hit("device.oom")
            launched, arrs, plans = self._launch_mesh_chunk(sub)
        except Exception as e:
            if chain_mod.is_oom_error(e):
                self._bisect_chunk(sub, self._devices[0], 0, e)
                return None
            self._note_link_failure(e)
            self._stamp_attempts(sub, ["device:mesh:error"])
            self._fail(sub, e)
            return None
        self._stamp_attempts(sub, ["device:mesh"])
        return (launched, arrs, plans, sub, None, t_launch)

    def _launch_with_failover(self, sub: list):
        """The dispatch half of the placement ladder: launch on the device
        devhealth's sticky `pick` names; a failed launch strikes that
        device and the chunk moves to the next one. A capacity error
        bisects on the same device instead (no strike, no failover). With
        integrity armed, a failed launch of several items is bisected to
        convict poison inputs first. Returns (launched, arrs, plans, sub,
        idx, t_launch), or None with the futures resolved. With use_mesh
        armed the chunk goes over the mesh instead (`_launch_over_mesh`)."""
        if self._batch_mesh is not None:
            return self._launch_over_mesh(sub)
        tried: set = set()
        attempts: list = []
        err: Optional[Exception] = None
        while True:
            idx = self.devhealth.pick(exclude=tried)
            if idx is None:
                if tried:
                    break
                # every domain is quarantined: try the primary anyway, so
                # device-only plans surface the real device error
                idx = 0
            tried.add(idx)
            dev = self._devices[idx]
            t_launch = time.monotonic()
            try:
                # keyed by the device's index: chip_error[k] fails device k,
                # oom[k] its allocator at the ceiling, slow[k] (a delay) a
                # limping device
                failpoints.hit("device.chip_error", key=idx)
                failpoints.hit("device.oom", key=idx)
                failpoints.hit("device.slow", key=idx)
                launched, arrs, plans = self._launch_chunk(sub, device=dev,
                                                           device_cache=idx == 0)
            except Exception as e:
                if chain_mod.is_oom_error(e):
                    self._bisect_chunk(sub, dev, idx, e)
                    return None
                integ = self.integrity
                if (integ is not None and integ.enabled and len(sub) > 1
                        and self._poison_bisect(sub, dev, idx, e)):
                    return None
                err = e
                self._note_device_failure(idx, e)
                attempts.append(f"device:{idx}:error")
                continue
            attempts.append(f"device:{idx}")
            self._stamp_attempts(sub, attempts)
            return (launched, arrs, plans, sub, idx, t_launch)
        self._stamp_attempts(sub, attempts)
        e = err if err is not None else RuntimeError(
            "no dispatchable device (all fault domains quarantined)")
        integ = self.integrity
        if integ is not None and integ.enabled and \
                sum(1 for a in attempts if a.endswith(":error")) >= 2:
            # two or more independent devices refused these inputs: the
            # signature of poison, recorded so a retry goes to host/422
            from imaginary_tpu_torch.engine import integrity as integrity_mod

            for it in sub:
                if not it.future.done():
                    integ.poison_add(integrity_mod.item_digest(it.arr, it.key))
        for it in sub:
            _resolve(it.future, error=e)
        return None

    # -- fetcher ---------------------------------------------------------------

    def _fetch_loop(self, gen: int) -> None:
        """Drain each launched group: wait for each of its chunks' events
        in launch order, slice its outputs, verify a sampled share and
        resolve its futures; the group leaves `_inflight` once all its
        chunks drained. A fetcher whose generation the watchdog has moved
        past hands what it holds back and exits."""
        while True:
            got = self._fetch_queue.get()
            if got is None:
                break
            with self._lock:
                stale = self._fetch_gen != gen
            if stale:
                self._fetch_queue.put(got)
                return
            chunks, cold = got
            for k in range(len(chunks)):
                if not self._drain_chunk(chunks, k, cold, gen):
                    return  # abandoned by the watchdog
            with self._lock:
                if self._fetch_gen != gen:
                    return
                self._inflight -= 1

    def _drain_chunk(self, chunks: list, k: int, cold: bool, gen: int) -> bool:
        """Drain chunk k of a group and resolve it; False when the
        watchdog abandoned the drain (it failed the group's futures)."""
        launched, arrs, plans, items, idx, t_launch = chunks[k]
        t0 = time.monotonic()
        with self._lock:
            # what the watchdog fails if this drain hangs: this chunk and
            # the rest of its group
            self._drain_state = (t0, chunks[k:], gen)
        try:
            outs = chain_mod.fetch_batch(launched, arrs, plans)
        except Exception as e:
            with self._lock:
                live = self._fetch_gen == gen
                if live:
                    self._drain_state = None
            if not live:
                return False  # the watchdog failed these futures already
            if chain_mod.is_oom_error(e):
                didx = 0 if idx is None else idx
                self._bisect_chunk(items, self._devices[didx], didx, e)
            else:
                if idx is None:  # a mesh chunk: no single device to blame
                    self._note_link_failure(e)
                else:
                    self._note_device_failure(idx, e)
                self._fail(items, e)
            return True
        with self._lock:
            live = self._fetch_gen == gen
            if live:
                self._drain_state = None
        if not live:
            # abandoned while blocked: discard what the call produced
            return False
        now = time.monotonic()
        drain_ms = (now - t0) * 1000.0
        # a mesh chunk (idx None) books its latency on every dispatchable
        # domain, as the reference's drain does
        for didx in ([idx] if idx is not None
                     else self.devhealth.available_indices() or [0]):
            self.devhealth.note_ok(didx, latency_ms=(now - t_launch) * 1000.0)
        TIMES.record("drain", drain_ms / len(items))
        if not cold:
            _book_device_wait(launched, t0, now, len(items))
        if idx is not None:
            for it in items:
                if it.trace is not None:
                    it.trace.annotate(device=idx)
        self._note_drain(items, drain_ms, cold)
        self._finish(items, outs, idx)
        return True

    def _finish(self, items: list, outs: list, idx) -> None:
        """Resolve a drained chunk: the `device.corrupt` failpoint (the
        corruption model, before verification, so the defence is tested
        end to end), sampled verification, then the futures; an answer
        re-served from the host's verified copy is marked for
        X-Imaginary-Backend: host."""
        try:
            failpoints.hit("device.corrupt", key=idx if idx is not None else 0)
        except failpoints.FailpointError:
            from imaginary_tpu_torch.engine import integrity as integrity_mod

            outs = [integrity_mod.corrupt_copy(o) for o in outs]
        reserved = self._verify_chunk(items, outs, idx)
        for i, (it, out) in enumerate(zip(items, outs)):
            if i in reserved:
                it.future._hedge_placement = "host"
            _resolve(it.future, result=out, stage_ms=it.stage_ms)

    @staticmethod
    def _fail(items: list, e: Exception) -> None:
        """Fail one chunk's futures (the caller books the failure)."""
        for it in items:
            _resolve(it.future, error=e)

    @staticmethod
    def _drop_cancelled(items: list) -> list:
        """The items still wanted: a future done while it waited (its
        request's deadline passed, or a hedge won) is not launched; its
        done-callback released its owed MB."""
        return [it for it in items if not it.future.done()]

    def _note_cold(self, cache_before: int) -> bool:
        """One compile miss when the launch just made grew the signature
        set."""
        if chain_mod.cache_size() > cache_before:
            with self._lock:
                self.stats.compile_misses += 1
            return True
        return False

    def _note_drain(self, items: list, drain_ms: float, cold: bool = False,
                    lane: int = -1) -> None:
        """Each item's share of a drained chunk, the smallest drain, and
        the chunk's drain ms per wire MB folded into the EWMA that
        estimated_wait_ms and the spill test price. A cold chunk's drain
        (its launch met a new signature) is no price sample, but its
        requests still pay it. With a cost plane bound (`cost_armed`), the
        drain's wall ms is the busy time of its lane (-1: the global path)
        and each item's share and wire bytes stamp its request's cost
        vector."""
        share = drain_ms / len(items)
        for it in items:
            it.stage_ms["drain"] = share
        if self.cost_armed:
            LANE_TIMES.record(lane, "drain_busy", drain_ms)
            for it in items:
                if it.trace is not None:
                    it.trace.accumulate("cost_device_ms", share)
                    it.trace.accumulate("cost_wire_bytes", it.wire_mb * 1e6)
        if cold:
            return
        mb = sum(it.wire_mb for it in items)
        keys = {it.key for it in items}
        with self._lock:
            if self._drain_floor_ms is None or drain_ms < self._drain_floor_ms:
                self._drain_floor_ms = drain_ms
            if mb > 0:
                rate = drain_ms / mb
                prev = self._ms_per_mb
                self._ms_per_mb = rate if prev is None else 0.8 * prev + 0.2 * rate
                self.stats.device_ms_per_mb = self._ms_per_mb
                if len(keys) == 1:
                    # a chunk of one chain prices its key too
                    self._note_key_rate(keys.pop(), rate, prev)

    def _note_key_rate(self, key, rate: float, prev: Optional[float]) -> None:
        """Fold one drain's ms per MB into `key`'s EWMA (call under _lock),
        by the reference's rule: a new key's seed clamped to 16x the global
        before this drain, a known key's sample clamped to 4x its own
        history (not the global's: a chain legitimately far dearer than
        the average must still be learned), and the dict cleared when a
        257th key arrives."""
        kprev = self._rate_by_key.get(key)
        if kprev is None:
            if len(self._rate_by_key) >= 256:
                self._rate_by_key.clear()
            self._rate_by_key[key] = rate if prev is None else min(rate, 16.0 * prev)
        else:
            self._rate_by_key[key] = 0.7 * kprev + 0.3 * min(rate, 4.0 * kprev)

    # -- the drain watchdog ----------------------------------------------------

    def _watchdog_loop(self) -> None:
        """Abandon a global drain stuck past drain_watchdog_s: fail its
        group's futures and those of every group queued behind it with
        the reference's error, strike every dispatchable device outright
        (a hang is unambiguous), and hand the queue to a fresh fetcher of
        the next generation. Every transition happens under _lock, so
        the stuck fetcher sees exactly one outcome when its call returns."""
        budget = self.config.drain_watchdog_s
        while not self._stop.wait(min(1.0, budget / 4)):
            with self._lock:
                state = self._drain_state
                if (state is None or state[2] != self._fetch_gen
                        or time.monotonic() - state[0] < budget):
                    continue
                chunks = state[1]
                self._drain_state = None
                self._fetch_gen += 1
                gen = self._fetch_gen
                self._inflight -= 1
            err = RuntimeError(f"device drain exceeded {budget:.0f}s watchdog; "
                               "link presumed hung")
            for c in chunks:
                for it in c[3]:
                    _resolve(it.future, error=err)
            for idx in (self.devhealth.available_indices() or [0]):
                self.devhealth.set_consecutive(idx, self.config.breaker_threshold - 1)
                self._note_device_failure(idx, err)
            # chunks queued behind the hung drain fail now
            while True:
                try:
                    got = self._fetch_queue.get_nowait()
                except queue_mod.Empty:
                    break
                if got is None:
                    self._fetch_queue.put(None)
                    break
                for c in got[0]:
                    for it in c[3]:
                        _resolve(it.future, error=err)
                with self._lock:
                    self._inflight -= 1
            # started before it is published: shutdown may join whichever
            # fetcher it reads, and a thread not yet started cannot be joined
            fetcher = threading.Thread(target=self._fetch_loop, args=(gen,),
                                       name="itpu-fetcher", daemon=True)
            fetcher.start()
            self._fetcher = fetcher

    # -- bisection: capacity (OOM) and poison inputs ---------------------------

    def _recover_oom_chunk(self, items: list, device, idx, err, depth: int = 0) -> None:
        """The reference's name for the OOM mode of the bisection."""
        self._bisect_chunk(items, device, idx, err, depth)

    def _bisect_chunk(self, items: list, device, idx, err, depth: int = 0) -> None:
        """A chunk that ran out of device memory: split it in half and
        relaunch each half synchronously on the same device (capacity is
        not a fault: no strike, no failover), recursing on halves that
        still do not fit, at most oom_split_depth levels; an item that
        does not fit alone runs on the host interpreter, else it fails
        with the device's error. The device's record books one capacity
        event."""
        didx = idx if idx is not None else 0
        if depth == 0:
            with self._lock:
                self.stats.oom_events += 1
            self.devhealth.note_capacity(didx, err)
        live = [it for it in items if not it.future.done()]
        if not live:
            return
        if len(live) > 1 and depth < self.config.oom_split_depth:
            with self._lock:
                self.stats.oom_splits += 1
            mid = (len(live) + 1) // 2
            for half in (live[:mid], live[mid:]):
                try:
                    # the failpoint fires on every level, as a device at
                    # its ceiling would
                    failpoints.hit("device.oom", key=didx)
                    outs = chain_mod.run_batch([it.arr for it in half],
                                               [it.plan for it in half],
                                               device=device)
                except Exception as e:
                    if chain_mod.is_oom_error(e):
                        self._bisect_chunk(half, device, idx, e, depth + 1)
                    else:
                        for it in half:
                            _resolve(it.future, error=e)
                    continue
                self._stamp_attempts(half, [f"device:{didx}:oom",
                                            f"device:{didx}:oom_split"])
                for it, out in zip(half, outs):
                    _resolve(it.future, result=out, stage_ms=it.stage_ms)
            return
        for it in live:
            if self.config.host_spill and host_exec.can_execute(it.plan, for_spill=False):
                try:
                    out = host_exec.run(it.arr, it.plan)
                except Exception:  # itpu: allow[ITPU004] the device's OOM is reported below
                    pass
                else:
                    with self._lock:
                        self.stats.oom_host_routed += 1
                    self._stamp_attempts([it], [f"device:{didx}:oom", "host_spill"])
                    it.future._hedge_placement = "host"
                    _resolve(it.future, result=out, stage_ms=it.stage_ms)
                    continue
            with self._lock:
                self.stats.oom_failed += 1
            _resolve(it.future, error=err if isinstance(err, Exception)
                     else RuntimeError("device out of memory"))

    def _poison_bisect(self, items: list, device, idx, err) -> bool:
        """A chunk's launch failed with a non-capacity error (integrity
        armed): re-run its halves on the same device down to singles.
        True when some item succeeded alone: the failure follows inputs,
        so the survivors are resolved, each convict's digest enters the
        poison list and the convict is host-served where it can be, and no
        device is struck. False, every future untouched, when nothing
        succeeded: the caller's ladder strikes as before."""
        didx = idx if idx is not None else 0
        oks, bads = [], []
        mid = (len(items) + 1) // 2
        for half in (items[:mid], items[mid:]):
            if half:
                o, b = self._poison_probe(half, device, didx)
                oks.extend(o)
                bads.extend(b)
        if not oks:
            return False
        from imaginary_tpu_torch.engine import integrity as integrity_mod

        integ = self.integrity
        for it, out in oks:
            self._stamp_attempts([it], [f"device:{didx}:poison_bisect", f"device:{didx}"])
            _resolve(it.future, result=out, stage_ms=it.stage_ms)
        for it, e in bads:
            integ.poison_add(integrity_mod.item_digest(it.arr, it.key))
            if host_exec.can_execute(it.plan, for_spill=False):
                try:
                    out = host_exec.run(it.arr, it.plan)
                except Exception:  # itpu: allow[ITPU004] the device error is reported below
                    pass
                else:
                    self._stamp_attempts([it], [f"device:{didx}:poison_bisect",
                                                "poison_quarantine", "host_fallback"])
                    it.future._hedge_placement = "host"
                    _resolve(it.future, result=out, stage_ms=it.stage_ms)
                    continue
            self._stamp_attempts([it], [f"device:{didx}:poison_bisect",
                                        "poison_quarantine"])
            _resolve(it.future, error=e)
        return True

    def _poison_probe(self, items: list, device, didx: int) -> tuple:
        """The recursive half of _poison_bisect: ([(item, output)],
        [(item, error)]), no future touched. The keyed chip_error
        failpoint fires on every level, so an injected device fault never
        convicts an input."""
        try:
            failpoints.hit("device.chip_error", key=didx)
            outs = chain_mod.run_batch([it.arr for it in items],
                                       [it.plan for it in items], device=device)
        except Exception as e:
            if len(items) == 1:
                return [], [(items[0], e)]
            mid = (len(items) + 1) // 2
            ok1, bad1 = self._poison_probe(items[:mid], device, didx)
            ok2, bad2 = self._poison_probe(items[mid:], device, didx)
            return ok1 + ok2, bad1 + bad2
        return list(zip(items, outs)), []

    # -- sampled verification --------------------------------------------------

    def _note_corruption(self, idx, err) -> None:
        """A corruption strike against device `idx` (every dispatchable
        one when the chunk has no single device)."""
        idxs = [idx] if idx is not None else (self.devhealth.available_indices() or [0])
        clean = self.integrity.config.clean_probes if self.integrity is not None else 3
        for didx in idxs:
            tripped = self.devhealth.note_corruption(didx, err, clean_probes=clean)
            with self._lock:
                self.stats.device_failures += 1
                if tripped and not self.devhealth.any_available():
                    self.stats.breaker_opens += 1

    def _verify_reference(self, it: "_Item", idx) -> tuple:
        """One item recomputed independently: (reference, exact). The host
        interpreter first (compared within the bars), else another
        dispatchable entry running the same kernels (compared exactly);
        (None, False) when neither can."""
        if host_exec.can_execute(it.plan, for_spill=False):
            try:
                return host_exec.run(it.arr, it.plan), False
            except Exception:  # itpu: allow[ITPU004] a failed recompute counts as a skip
                pass
        if len(self._devices) > 1:
            other = self.devhealth.pick(exclude={idx} if idx is not None else set())
            if other is not None and other != idx:
                try:
                    return chain_mod.run_batch([it.arr], [it.plan],
                                               device=self._devices[other])[0], True
                except Exception:  # itpu: allow[ITPU004] a failed recompute counts as a skip
                    pass
        return None, False

    def _verify_chunk(self, sub: list, outs: list, idx) -> set:
        """When this chunk draws the sample (integrity.should_sample),
        recompute each live item and compare before release. A mismatch
        strikes the device, and the item is re-served from the verified
        copy (`outs` patched in place); returns the indices whose copy
        came from the host."""
        integ = self.integrity
        if integ is None or not integ.enabled or not integ.should_sample():
            return set()
        from imaginary_tpu_torch.engine import integrity as integrity_mod

        host_served: set = set()
        mismatched = False
        for i, (it, out) in enumerate(zip(sub, outs)):
            if it.future.done():
                continue  # cancelled: nothing is released
            ref, exact = self._verify_reference(it, idx)
            if ref is None:
                integ.note_skipped()
                continue
            integ.note_check()
            if integrity_mod.outputs_match(out, ref, exact=exact,
                                           tol=integ.config.tolerance,
                                           mean_tol=integ.config.mean_tolerance):
                continue
            mismatched = True
            integ.note_mismatch()
            outs[i] = ref
            integ.note_reserved()
            if not exact:
                host_served.add(i)
        if mismatched:
            self._note_corruption(idx, CorruptionError(
                "sampled cross-verification mismatch "
                f"(device {idx if idx is not None else 'mesh'})"))
        return host_served

    # -- the fault domains -----------------------------------------------------

    def _breaker_is_open(self) -> bool:
        """No device is dispatchable (for one device: its breaker is
        open)."""
        return not self.devhealth.any_available()

    def _note_device_failure(self, idx: int, err: object = None) -> None:
        """One failed launch or drain, struck against device `idx`; a trip
        that leaves no device dispatchable counts in breaker_opens."""
        tripped = self.devhealth.note_failure(idx, err)
        with self._lock:
            self.stats.device_failures += 1
            if tripped and not self.devhealth.any_available():
                self.stats.breaker_opens += 1

    def _note_link_failure(self, err: object = None) -> None:
        """A failure with no device to blame (the device.execute site):
        every dispatchable domain takes it."""
        for idx in (self.devhealth.available_indices() or [0]):
            self._note_device_failure(idx, err)

    def _golden_probe_armed(self) -> bool:
        """The golden probe replaces the transfer probe when integrity or
        fail-slow is armed."""
        if self.integrity is not None and self.integrity.enabled:
            return True
        return self.config.failslow_ratio > 0.0

    def _probe_device(self, idx: int):
        """The re-admission (and, with fail-slow, periodic) probe of entry
        `idx`, raising on failure. Armed: the golden chain
        (prewarm.golden_case, K1 with the K4 its plan carries) through the
        ported kernels on the entry's device and lane stream, compared with
        the host's reference; wrong bytes raise CorruptionError. A cold
        first run (the signature set grew) is re-timed warm, and the warm
        ms is returned for the fail-slow signal. The chip_error, slow and
        corrupt failpoints fire here too. Not armed: a K4 window gather of
        a 4x4 ramp at offset (1, 2), held against its known answer."""
        failpoints.hit("device.chip_error", key=idx)
        dev = self._devices[idx]
        lane = self._lanes.lane(idx) if self._lanes is not None else None
        stream = lane.stream if lane is not None else None
        if self._golden_probe_armed():
            from imaginary_tpu_torch.engine import integrity as integrity_mod

            arr, plan, ref = integrity_mod.golden()

            def run():
                t0 = time.monotonic()
                failpoints.hit("device.slow", key=idx)
                launched = chain_mod.launch_batch([arr], [plan], device=dev,
                                                  stream=stream)
                out = chain_mod.fetch_batch(launched, [arr], [plan])[0]
                return out, (time.monotonic() - t0) * 1000.0

            before = chain_mod.cache_size()
            out, ms = run()
            if chain_mod.cache_size() > before:
                out, ms = run()  # price the device, not its cold blocks
            try:
                failpoints.hit("device.corrupt", key=idx)
            except failpoints.FailpointError:
                out = integrity_mod.corrupt_copy(out)
            integ = self.integrity
            tol = integ.config.tolerance if integ is not None else 96
            mean_tol = integ.config.mean_tolerance if integ is not None else 16.0
            if not integrity_mod.outputs_match(out, ref, exact=False, tol=tol,
                                               mean_tol=mean_tol):
                raise CorruptionError(
                    f"golden probe mismatch on device {idx}: checksum "
                    f"{chain_mod.output_checksum(out):#010x} vs reference "
                    f"{chain_mod.output_checksum(ref):#010x}")
            return ms
        ctx = (torch.cuda.stream(stream) if stream is not None
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
        return None

    # -- lane tier (engine/lanes.py; mesh_policy != "off") ---------------------

    def _init_lanes(self) -> None:
        """One lane per mesh entry, each with its own stream, collector and
        fetcher, and one fault domain each; the re-admission prober runs
        for as long as the executor does. The global pair stays up as the
        tier items fall to when every lane is quarantined."""
        cfg = self.config
        mesh = get_mesh(cfg.n_devices or None, max(1, cfg.spatial),
                        devices=cfg.devices if cfg.devices else cfg.device, local=True)
        for dev in mesh.flat:
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available for the lanes' mesh")
        self._mesh = mesh
        devs = mesh.flat
        self._devices = list(devs)
        self.devhealth = self._new_devhealth(len(devs))
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
            return self._form_cap_s()
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
        device and stream. A capacity error bisects on this lane's device;
        with integrity armed a failed launch of several items is bisected
        for poison inputs; any other failure strikes this lane's fault
        domain and the chunk moves to the other lanes."""
        now = time.monotonic()
        self._stamp_stages(items, now, lane)
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
            failpoints.hit("device.oom", key=lane.idx)
            failpoints.hit("device.slow", key=lane.idx)
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
                                                  stream=lane.stream, device_cache=True,
                                                  split=self.cost_armed)
        except Exception as e:
            if chain_mod.is_oom_error(e):
                # capacity, not a fault: bisect on this lane's device
                self._bisect_chunk(items, lane.device, lane.idx, e)
                return
            integ = self.integrity
            if (not sharded and not spatial and integ is not None
                    and integ.enabled and len(items) > 1
                    and self._poison_bisect(items, lane.device, lane.idx, e)):
                return
            self._note_device_failure(lane.idx, e)
            self._stamp_attempts(items, [f"device:{lane.idx}:error"])
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
        self._stamp_attempts(items, ["device:mesh:lane" if (sharded or spatial)
                                     else f"device:{lane.idx}:lane"])
        # a full in-flight window blocks here: the lane's backpressure,
        # which shows as a growing placement score
        lane.fetch_queue.put((launched, arrs, plans, items))

    def _lane_fetch(self, lane) -> None:
        """One lane's fetcher: wait for each launched chunk in launch
        order, verify a sampled share and resolve it. A capacity error
        bisects on the lane's device; another failed drain strikes this
        lane's fault domain and moves the unresolved items to the other
        lanes."""
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
                if chain_mod.is_oom_error(err):
                    self._recover_oom_chunk(items, lane.device, lane.idx, err)
                    continue
                self._note_device_failure(lane.idx, err)
                self._replace_lane_items([it for it in items if not it.future.done()],
                                         exclude={lane.idx})
                continue
            drain_ms = (time.monotonic() - t0) * 1000.0
            self.devhealth.note_ok(lane.idx, latency_ms=drain_ms)
            lane.note_service(drain_ms / n, n)
            LANE_TIMES.record(lane.idx, "drain", drain_ms / n)
            TIMES.record("drain", drain_ms / n)
            _book_device_wait(launched, t0, t0 + drain_ms / 1000.0, n)
            self._note_drain(items, drain_ms, lane=lane.idx)
            self._finish(items, outs, lane.idx)

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
            avail = self._rotation()
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

    def _rotation(self) -> set:
        """The entries the lanes serve on: the dispatchable ones, less a
        fail-slow-demoted entry while a healthy peer remains and its share
        is 0 (its traffic moves, as `pick` sheds it on the global ladder;
        its probes go on, and a recovered entry rejoins)."""
        avail = set(self.devhealth.available_indices())
        if self.config.failslow_ratio <= 0.0 or self.config.failslow_share > 0.0:
            return avail
        now = time.monotonic()
        degraded = {i for i in avail
                    if self.devhealth.record(i).state(now) == STATE_DEGRADED}
        return avail - degraded if avail - degraded else avail

    def debug_snapshot(self) -> dict:
        """The executor's live view; with lanes, a "lanes" block with the
        reference's keys."""
        now = time.monotonic()
        with self._lock:
            ds = self._drain_state
            snap = {
                "queue_depth": self.stats.queue_depth,
                "batch_policy": self.config.batch_policy,
                "batch_form_cap_ms": round(self._form_cap_s() * 1000.0, 3),
                "inflight_groups": self._inflight,
                "inflight_chunks": self._fetch_queue.qsize(),
                "device_owed_mb": round(self.stats.device_owed_mb, 3),
                "drain_in_flight_age_s": round(now - ds[0], 3) if ds else None,
                "fetcher_generation": self._fetch_gen,
                "hedges_inflight": self._hedges_inflight,
                "device_items_inflight": self._device_items,
                "rate_keys": len(self._rate_by_key),
                "device_ms_per_mb": round(self._ms_per_mb or 0.0, 3),
                "drain_floor_ms": round(self._drain_floor_ms or 0.0, 3),
                "host_ms_per_mpix": round(self._host_ms_per_mpix, 3),
                "host_inflight": self._host_inflight,
                "host_owed_mpix": round(self._host_owed_mpix, 3),
            }
        snap["breaker_open"] = self._breaker_is_open()
        # the fault domains and their quarantine-grade events, oldest first
        snap["devices"] = self.devhealth.snapshot()
        snap["strike_history"] = self.devhealth.strike_history()
        if self.config.qos is not None:
            snap["qos_queued"] = self._queue.depths()  # the fair scheduler's view
        if self.integrity is not None:
            snap["integrity"] = self.integrity.snapshot()
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


def _book_device_wait(launched, t0: float, t_done: float, n: int) -> None:
    """A drain split at its launch's kernels event (chain.Launched.ready,
    recorded only with a cost plane bound): the wait for the kernels
    (`device_wait`) and the copy to the host after them (`d2h`), per item."""
    t_ready = getattr(launched, "t_ready", None)
    if t_ready is None:
        return
    TIMES.record("device_wait", max(0.0, t_ready - t0) * 1000.0 / n)
    TIMES.record("d2h", max(0.0, t_done - t_ready) * 1000.0 / n)


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
