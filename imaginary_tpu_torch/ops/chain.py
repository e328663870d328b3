"""Chain runner: a plan's stage chain -> kernel launches on one device.

The port's counterpart of `imaginary_tpu/ops/chain.py`, with the surface
the executor calls (`launch_batch`, `launch_sharded`, `fetch_batch`,
`finish_batch`, `run_batch`, `run_single`, `pad_to_bucket`, `cache_size`,
`is_oom_error`, `output_checksum`). Every entry point takes a `device` and
runs on the card unless the caller asks for the CPU.

PyTorch runs eagerly, so there is no compiled program per chain. On a
card, a launch runs on the stream its caller names (an executor lane
passes its own, so lanes that share a card never serialise on one
stream), else on one side stream per device: it stages the
batch and its per-image params to the device in ONE copy from pinned host
memory, runs each stage's kernel in order, copies the output into a
pinned host buffer and records an event after that copy. It returns while
the card is still working. The fetch waits on that event only, not on the
stream, so it never waits for chunks launched after its own. Every device
tensor of a launch is allocated under its stream, so the caching
allocator reuses its memory only for work queued later on that stream.
`launch_sharded` splits one chunk contiguously over a mesh's batch axis,
one sub-launch per device on that device's stream, each with its own
pinned buffers and event. `launch_spatial` runs one image's chain split
on W over one row of a mesh's spatial axis (the reference's chain under
`PartitionSpec("batch", None, "spatial", None)`); see its docstring.
On the CPU the chain runs at once and the fetch has nothing to wait for.
A ShrinkBucketSpec that would copy its input unchanged launches nothing
(`live_stages`), a GraySpec right before a ToYuv420Spec folds into
that stage's launch (`launch_steps`), and each run of consecutive
orientation stages (flip, flop, transpose: /rotate, EXIF orientations)
launches as one K5 of their composed mode (`orient_runs`), so the
image moves once; the spatial route's sharded stages keep one launch a
stage, and its gathered tail folds. The chain's uint8 -> f32 cast
(int16 -> f32 for the DCT
transport's coefficients, staged as int16 in the same one H2D) and its
uint8 epilogue are fused into the first and last stages' kernels. A chain
whose last spec has `out_dtype` "int16" (ToDctSpec) drains rounded,
clamped int16 coefficients, written by that kernel itself, and
`finish_batch` re-blocks them into `QuantizedBlocks` for the host
entropy encoder.

Buffer donation (`set_donation`, on by default as in the reference): the
port's counterpart of XLA donating the batch operand. With donation on,
`launch_batch` writes the chain's last launch's output into the batch
region (offset 0) of the fresh staged device buffer, through that
kernel's `out=`, when two shape rules hold: the region holds at least
the output's bytes, and the chain has at least two launches (after the
orientation fold), so the first kernel has consumed the region before
the last one writes it (in stream order). Otherwise the chunk runs
undonated. The staged buffer is always a fresh copy, so neither the
caller's array nor its pinned host buffer is ever written; the sharded
and spatial launches never donate.
Nothing on the card refuses aliasing, so `donation_stats`' "rejected"
(a backend's refusal, which latches the reference's donation off) stays
0; its "donated" counts the launches that donated.

With `split` (an executor bound to a cost plane, obs/cost.py),
`launch_batch` records a second event on the card, after the chain's
kernels and before the copy back to the host (`Launched.ready`), and
`_to_host` notes when it completed (`Launched.t_ready`): the executor
books the fetch's wait up to it as the `device_wait` stage, the capacity
plane's link stall. Without it no second event is recorded.

Link bytes are booked in `engine/timing.WIRE`: each staged H2D buffer in
`_stage`, and each copy of an output into host memory (`_book_d2h`),
under the device's label for the sharded and spatial launches.

The device-resident frame tier (`set_device_frame_cache`, the web layer's
--cache-device-mb): a dct-transport input whose plan carries a
`frame_key` is staged on the card once and kept there, keyed by
(frame_key, device), and later launches on that card assemble their batch
from the resident frames on the device (`_device_cached_parts`), so a
launch whose items all hit moves only h, w and the dyns over the link.
The global dispatch on the executor's device, `run_single` and the
lanes ask for it (`device_cache`); a launch the failover ladder pins to
another entry, `launch_sharded`, `launch_spatial`, the executor's
relaunches through `run_batch` (OOM bisection, poison bisection,
verification) and a plan without a frame_key (prewarm's, the yuv420 and
rgb transports') bypass it.
"""

from __future__ import annotations

import threading
import time
import zlib

import numpy as np
import torch

from imaginary_tpu_torch.engine.timing import WIRE
from imaginary_tpu_torch.ops.buckets import bucket_shape
from imaginary_tpu_torch.ops.plan import ImagePlan
from imaginary_tpu_torch.ops.stages import (
    ORIENT_STAGES,
    FromDctSpec,
    FromYuv420Spec,
    GraySpec,
    ShrinkBucketSpec,
    ToDctSpec,
    ToYuv420Spec,
    TransposeSpec,
    apply_orient_run,
)
from imaginary_tpu_torch.parallel import spatial
from imaginary_tpu_torch.parallel.mesh import Mesh, split_batch

DEFAULT_DEVICE = "cuda"

# Distinct (chain, input shape, device) signatures launched so far: the
# count the executor reads as `cache_size()`. Nothing is compiled per
# signature here; the count keeps the reference's meaning of "a launch
# shape this process has seen".
_SIGNATURES: set = set()
_LOCK = threading.Lock()

_ALIGN = 16

# The side stream each device's launches run on (`_stream`).
_STREAMS: dict = {}


# The device-resident frame tier (cache.DeviceFrameCache, module
# docstring), installed by the web layer when --cache-device-mb > 0.
# Chain-level rather than executor-level, as in the reference: run_single
# and every executor launch path stage through launch_batch.
_DEVICE_FRAMES = None


def set_device_frame_cache(cache) -> None:
    global _DEVICE_FRAMES
    _DEVICE_FRAMES = cache


def device_frame_cache():
    return _DEVICE_FRAMES


def device_frame_cache_bytes() -> int:
    dc = _DEVICE_FRAMES
    return dc.bytes_used if dc is not None else 0


# Buffer donation (module docstring): process-wide, like the reference's
# switch, which --donation sets; launches that donated.
_DONATE = True
_DONATED = 0


def set_donation(enabled: bool) -> None:
    """The boot switch (--donation on|off)."""
    global _DONATE
    with _LOCK:
        _DONATE = bool(enabled)


def donation_enabled() -> bool:
    return _DONATE


def donation_stats() -> dict:
    """{"enabled", "rejected", "donated"}: "rejected" keeps the reference's
    meaning (a backend's refusal) and is 0, as nothing on the card refuses
    aliasing."""
    return {"enabled": _DONATE, "rejected": 0, "donated": _DONATED}


def cache_size() -> int:
    return len(_SIGNATURES)


def clear_cache() -> None:
    with _LOCK:
        _SIGNATURES.clear()


# Stages that read f32 only, and stages that cannot end a chain (they have
# no uint8 epilogue).
_F32_ONLY = (ToYuv420Spec, ToDctSpec)
_NOT_LAST = (FromYuv420Spec, FromDctSpec)


def _bucket_after(spec, hb: int, wb: int) -> tuple:
    """The padded-buffer dims a stage leaves (plan.py's `_final_bucket`
    step, with the transports' unpack stages)."""
    if isinstance(spec, TransposeSpec):
        return wb, hb
    if isinstance(spec, (FromYuv420Spec, FromDctSpec)):
        return spec.hb, spec.wb
    if hasattr(spec, "out_hb"):
        return spec.out_hb, spec.out_wb
    return hb, wb


def live_stages(specs, hb: int, wb: int) -> list:
    """Indices of the stages that launch, for an input bucket (hb, wb).

    A ShrinkBucketSpec whose input already has its output dims is an
    identity copy and is dropped (XLA elides it in the reference), unless
    it is the first stage and the next reads f32 only, or the last and the
    one before cannot write the uint8 epilogue. Plans keep the stage: they
    stay equal to the reference's."""
    live = []
    for i, spec in enumerate(specs):
        out = _bucket_after(spec, hb, wb)
        if isinstance(spec, ShrinkBucketSpec) and out == (hb, wb):
            nxt = specs[i + 1] if i + 1 < len(specs) else None
            keep = ((not live and isinstance(nxt, _F32_ONLY))
                    or (nxt is None and live and isinstance(specs[live[-1]], _NOT_LAST)))
            if not keep:
                continue
        live.append(i)
        hb, wb = out
    return live


def launch_steps(specs, run: list) -> list:
    """The launches of `run`, live stages that run one after another on
    one device: (stage index, luma) pairs. A GraySpec whose next stage in
    the run is ToYuv420Spec launches nothing: that K3 applies K8's luma to
    each pixel as it loads it (`luma` True), one launch for the pair and
    bit-equal to it. A GraySpec before a ToDctSpec keeps its launch. The
    spatial route passes the stages after its gather as their own run, so
    a stage split by it never fuses across the gather."""
    steps = []
    for i in run:
        if (steps and isinstance(specs[i], ToYuv420Spec)
                and isinstance(specs[steps[-1][0]], GraySpec)):
            steps[-1] = (i, True)
        else:
            steps.append((i, False))
    return steps


def _out_layout(spec, shape) -> tuple:
    """(shape, dtype) of `spec`'s chain-ending output on an input [B, Hb,
    Wb, C] of `shape`: uint8 pixels, or the packed planes of ToYuv420Spec
    (uint8) and ToDctSpec (int16)."""
    bsz, hb, wb, c = shape
    if isinstance(spec, (ToYuv420Spec, ToDctSpec)):
        dtype = torch.int16 if isinstance(spec, ToDctSpec) else torch.uint8
        return (bsz, spec.hb + spec.hb // 2, spec.wb, 1), dtype
    return (bsz,) + _bucket_after(spec, hb, wb) + (c,), torch.uint8


def _donated_out(spec, shape, donor):
    """The view of the batch region `donor` (flat uint8) that the last
    launch writes into, or None when its output does not fit there or
    its stage has no `out=` form (`donates`)."""
    if not getattr(spec, "donates", False):
        return None
    oshape, dtype = _out_layout(spec, tuple(shape))
    nbytes = int(np.prod(oshape)) * dtype.itemsize
    if nbytes > donor.numel():
        return None
    return donor[:nbytes].view(dtype).view(oshape)


def orient_runs(specs, steps: list) -> list:
    """`steps` (`launch_steps`' pairs) as the launches `_run_steps` makes:
    lists of steps, each run of consecutive orientation stages (FlipSpec,
    FlopSpec, TransposeSpec; `stages.ORIENT_STAGES`) one list, launched as
    ONE K5 of their composed mode (`stages.apply_orient_run`), every other
    step a list of its own. The spatial route's sharded stages do not take
    this path: they launch one form a stage."""
    groups = []
    for i, luma in steps:
        if (groups and type(specs[i]) in ORIENT_STAGES
                and type(specs[groups[-1][-1][0]]) in ORIENT_STAGES):
            groups[-1].append((i, luma))
        else:
            groups.append([(i, luma)])
    return groups


def _run_steps(specs, steps: list, x, h, w, dyns, donor=None):
    """Launch `steps` (`launch_steps`), each run of orientation stages as
    one launch (`orient_runs`); the last launch writes uint8 (epilogue
    fused). No steps return the input as it is. `donor`: the staged batch
    region (flat uint8) that the last of two or more launches may write
    its output into (module docstring)."""
    global _DONATED
    groups = orient_runs(specs, steps)
    for n, group in enumerate(groups):
        i, luma = group[-1]
        kw = {"luma": True} if luma else {}
        last = n == len(groups) - 1
        if last and donor is not None and len(groups) >= 2:
            shape = tuple(x.shape)
            for j, _ in group[:-1]:  # the shape the group's last stage sees
                shape = (shape[0],) + _bucket_after(specs[j], *shape[1:3]) + shape[3:]
            out = _donated_out(specs[i], shape, donor)
            if out is not None:
                kw["out"] = out
                with _LOCK:
                    _DONATED += 1
        if type(specs[i]) in ORIENT_STAGES:
            x, h, w = apply_orient_run([specs[j] for j, _ in group], x, h, w, out_u8=last,
                                       **kw)
        else:
            x, h, w = specs[i].apply(x, h, w, dyns[i], out_u8=last, **kw)
    return x, h, w


def _run_chain(specs, x, h, w, dyns, donor=None):
    """Run every live stage; the last one writes uint8 (epilogue fused).
    A chain of identity shrinks alone returns its uint8 input."""
    steps = launch_steps(specs, live_stages(specs, x.shape[1], x.shape[2]))
    return _run_steps(specs, steps, x, h, w, dyns, donor)


def pad_to_bucket(arr: np.ndarray) -> np.ndarray:
    """Zero-pad HWC uint8 to bucket dims."""
    h, w = arr.shape[:2]
    hb, wb = bucket_shape(h, w)
    if (hb, wb) == (h, w):
        return arr
    out = np.zeros((hb, wb, arr.shape[2]), dtype=arr.dtype)
    out[:h, :w] = arr
    return out


_TORCH_DTYPES = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
}


def _stage(arrays: list, device: torch.device, label=None) -> tuple:
    """Copy host arrays to `device` as ONE transfer on the current stream;
    returns (typed device views, the host buffer). The transfer is booked
    in WIRE (h2d), under `label` when one is given.

    Each entry is an array, or a list of same-shaped arrays that lands as
    their stack (the batch, written straight into the buffer). The entries
    are packed at 16-byte offsets into one host buffer (pinned when the
    target is a card, so the copy is asynchronous and runs at the link's
    full rate) and moved with one non-blocking copy. The caller keeps the
    host buffer until the copy is done."""
    metas, total = [], 0
    for a in arrays:
        parts = a if isinstance(a, list) else [a]
        shape = ((len(parts),) if isinstance(a, list) else ()) + parts[0].shape
        nbytes = sum(p.nbytes for p in parts)
        metas.append((parts, shape, parts[0].dtype, total, nbytes))
        total += (nbytes + _ALIGN - 1) // _ALIGN * _ALIGN
    pinned = device.type == "cuda"
    host = torch.empty(max(total, _ALIGN), dtype=torch.uint8, pin_memory=pinned)
    hv = host.numpy()
    for parts, _, _, off, _ in metas:
        for p in parts:
            # one pass, also for a strided part (a shard's column window)
            hv[off:off + p.nbytes].view(p.dtype).reshape(p.shape)[...] = p
            off += p.nbytes
    dev = host.to(device, non_blocking=True) if pinned else host
    WIRE.add("h2d", host.numel(), device=label)
    views = [dev[off:off + n].view(_TORCH_DTYPES[dt]).view(shape)
             for _, shape, dt, off, n in metas]
    return views, host


def _stack_dyns(plans: list) -> list:
    """Per-stage dicts of host arrays stacked over the batch."""
    out = []
    for i, st in enumerate(plans[0].stages):
        out.append({k: np.stack([np.asarray(p.stages[i].dyn[k]) for p in plans])
                    for k in st.dyn})
    return out


def _book_d2h(host: torch.Tensor, label=None) -> None:
    """Book one output's copy into host memory in WIRE (d2h)."""
    WIRE.add("d2h", host.numel() * host.element_size(), device=label)


class _Done:
    """The kernels event of a launch that ran synchronously (the CPU)."""

    @staticmethod
    def synchronize() -> None:
        pass


_DONE = _Done()


class Launched:
    """A launched chunk: its output in host memory once `event` (None on
    the CPU) has completed, and the staged host buffers kept alive until
    then. `ready`: with `split`, the event recorded after the
    chunk's kernels, before its copy to the host; `t_ready`: the
    monotonic time the fetch saw it complete."""

    __slots__ = ("host", "event", "staged", "ready", "t_ready")

    def __init__(self, host: torch.Tensor, event=None, staged=None, ready=None):
        self.host = host
        self.event = event
        self.staged = staged
        self.ready = ready
        self.t_ready = None


def _stream(device: torch.device):
    with _LOCK:
        stream = _STREAMS.get(device)
        if stream is None:
            stream = _STREAMS[device] = torch.cuda.Stream(device)
        return stream


def _device_key(device: torch.device) -> str:
    """The device half of a frame-tier key: a card by its index ("cuda"
    names the current one), so the global dispatch and the lanes of one
    card share that card's entries."""
    if device.type == "cuda" and device.index is None:
        return f"cuda:{torch.cuda.current_device()}"
    return str(device)


def _device_cached_parts(arrs: list, plans: list, dc, device: torch.device,
                         stream, label) -> tuple:
    """Per-item resident tensors from the device frame tier, and the host
    buffers of this launch's misses (kept until their copies are done).

    A miss stages that one item on the launch's stream (`_stage`, booked
    in WIRE under `label`), records an event after the copy and puts the
    resident tensor in the tier, charged the host array's nbytes. A hit
    stages nothing: the launch's stream waits on the entry's event (it may
    have been staged on another lane's stream of the same card), and the
    tensor is recorded on the stream (`record_stream`), so the caching
    allocator keeps its block until this launch has read it, even once
    the entry is evicted. Keys are (frame_key, device): a frame resident
    on one card is of no use to another's launch."""
    parts, staged = [], []
    dkey = _device_key(device)
    for a, p in zip(arrs, plans):
        key = (p.frame_key, dkey)
        got = dc.get(key)
        if got is None:
            (x,), host = _stage([a], device, label)
            event = None
            if stream is not None:
                event = torch.cuda.Event()
                event.record(stream)
            staged.append(host)
            dc.put(key, (x, event), a.nbytes)
        else:
            x, event = got
            if event is not None:
                stream.wait_event(event)
                x.record_stream(stream)
        parts.append(x)
    return parts, staged


def _stage_inputs(batch: list, plans: list, rest: list, device: torch.device,
                  stream, label, dc) -> tuple:
    """Stage a launch's inputs on the current stream: (views [x, h, w,
    dyns...], the host buffers to keep until the copies are done). Without
    the frame tier (`dc` None) the batch, h, w and the dyns go in ONE H2D;
    with it the batch is a fresh device buffer stacked from the resident
    frames (`_device_cached_parts`), so donating it never writes a
    resident tensor, and h, w and the dyns go in one H2D."""
    if dc is None:
        views, host = _stage([batch] + rest, device, label)
        return views, [host]
    parts, staged = _device_cached_parts(batch, plans, dc, device, stream, label)
    views, host = _stage(rest, device, label)
    return [torch.stack(parts)] + views, staged + [host]


def launch_batch(arrs: list, plans: list, device=DEFAULT_DEVICE, stream=None,
                 label=None, donate=None, device_cache: bool = False, split: bool = False):
    """Stage + launch one batched chain WITHOUT waiting for it.

    arrs: HWC uint8 arrays, all with the same bucket shape and C (packed
    transports: the pre-padded packed buffers, with the image dims on the
    plan). plans: matching ImagePlans with identical spec_key(). stream:
    the CUDA stream of `device` to launch on (None: the device's side
    stream). label: the device label its WIRE bytes are booked under
    (None: unlabelled). donate: None follows `set_donation`; the sharded
    and spatial launches pass False. device_cache: let the launch use the
    device frame tier when one is armed and every plan carries a
    frame_key (module docstring). split: record the kernels event of the
    device_wait split (module docstring). Returns a `Launched` (on a card,
    possibly still computing), or None for an identity chain."""
    specs = plans[0].spec_key()
    if not specs:
        return None
    device = torch.device(device)
    dc = None
    if plans[0].in_bucket is not None:
        batch = list(arrs)
        h = np.array([p.in_h for p in plans], dtype=np.int32)
        w = np.array([p.in_w for p in plans], dtype=np.int32)
        frames = _DEVICE_FRAMES
        if (device_cache and frames is not None and frames.enabled
                and all(p.frame_key is not None for p in plans)):
            dc = frames
    else:
        batch = [pad_to_bucket(a) for a in arrs]
        h = np.array([a.shape[0] for a in arrs], dtype=np.int32)
        w = np.array([a.shape[1] for a in arrs], dtype=np.int32)
    host_dyns = _stack_dyns(plans)
    rest = [h, w] + [v for d in host_dyns for v in d.values()]
    donate = _DONATE if donate is None else donate
    with _LOCK:
        _SIGNATURES.add((specs, (len(batch),) + batch[0].shape, str(device)))
    if device.type != "cuda":
        views, _ = _stage_inputs(batch, plans, rest, device, None, label, dc)
        y = _run_staged(specs, views, host_dyns, donate)
        _book_d2h(y, label)
        # on the CPU the chain has run by now: its kernels are done
        return Launched(y, ready=_DONE if split else None)
    if stream is None:
        stream = _stream(device)
    with torch.cuda.stream(stream):
        views, staged = _stage_inputs(batch, plans, rest, device, stream, label, dc)
        y = _run_staged(specs, views, host_dyns, donate)
        ready = None
        if split:
            ready = torch.cuda.Event(blocking=True)
            ready.record(stream)
        host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        host.copy_(y, non_blocking=True)
        _book_d2h(host, label)
        event = torch.cuda.Event(blocking=True)
        event.record(stream)
    return Launched(host, event, staged, ready)


class ShardedLaunch:
    """A chunk launched as contiguous sub-chunks: [(start, stop, Launched)]
    in batch order."""

    __slots__ = ("parts",)

    def __init__(self, parts: list):
        self.parts = parts


def launch_sharded(arrs: list, plans: list, mesh: Mesh, streams=None):
    """Split one chunk contiguously over the mesh's batch axis (sizes
    differ by at most one; no padding to a multiple of the axis) and
    launch each sub-chunk with `launch_batch` on its row's device and on
    streams[row] (None: the device's side stream). Returns a
    `ShardedLaunch`, or None for an identity chain."""
    if not plans[0].spec_key():
        return None
    parts = []
    for row, (a, b) in enumerate(split_batch(len(arrs), mesh)):
        if a == b:
            continue
        stream = streams[row] if streams is not None else None
        dev = mesh.devices[row][0]
        parts.append((a, b, launch_batch(arrs[a:b], plans[a:b], device=dev,
                                         stream=stream, label=str(dev),
                                         donate=False)))
    return ShardedLaunch(parts)


def spatial_split(specs, hb: int, wb: int, n: int) -> tuple:
    """How `launch_spatial` runs a chain on an input bucket (hb, wb) over n
    W-shards: (sharded, gather_at), the live stages that run W-sharded (a
    prefix of `live_stages`) and the first live stage that does not (None
    when every one does). From gather_at on, the chain runs on the row's
    first entry after an explicit gather of the shards.

    A stage runs W-sharded when its W-shard form takes the shard
    (`shard_ok`, see `stages._ShardForm`: K2 and K11 only as the first
    sharded stage, K2 and K3 on shards of even width, K11 on whole MCUs
    (`kernels.dct_shard_step`), K12 on shards of even width, K13 with a
    radius below the local width, the smartcrop on an input that splits
    into whole row-scan segments, every other stage always) and its
    output width splits evenly over n."""
    sharded = []
    for i in live_stages(specs, hb, wb):
        spec = specs[i]
        out_hb, out_wb = _bucket_after(spec, hb, wb)
        ok = (hasattr(spec, "shard_ok") and out_wb % n == 0
              and spec.shard_ok(out_wb // n, not sharded, wb, n))
        if not ok:
            return sharded, i
        sharded.append(i)
        hb, wb = out_hb, out_wb
    return sharded, None


class SpatialLaunch:
    """One image launched by `launch_spatial`: `host` is [n, 1, R, lw, C]
    when `shards` = n > 0 (each shard's output, copied back on its own
    stream, put together by `assemble`, the last stage's
    `shard_assemble`), else the gathered [1, R, Wb, C]; valid once every
    event in `events` has completed. `gathered` names the spec class at
    which the shards were gathered (None: nowhere). `windows` maps each
    stage that took an exchanged input window to its shards' windows, (k0,
    k1, parts) with parts `exchange_window`'s (source shard, g0, g1); a
    transpose's entries are its row bands (r0, r1, parts), parts
    `exchange_bands`'. `exchanged`: the bytes every exchange between the
    shards copied (windows, halos, bands, the smartcrop's totals and
    keys). The staged host buffers are kept alive until the fetch."""

    __slots__ = ("host", "events", "staged", "shards", "gathered", "windows", "assemble",
                 "exchanged")

    def __init__(self, host, events, staged, shards: int, gathered, windows=None,
                 assemble=None, exchanged: int = 0):
        self.host = host
        self.events = events
        self.staged = staged
        self.shards = shards
        self.gathered = gathered
        self.windows = windows or {}
        self.assemble = assemble
        self.exchanged = exchanged

    def to_host(self) -> np.ndarray:
        """Wait for every shard's event and assemble the batch array."""
        for ev in self.events:
            if ev is not None:
                ev.synchronize()
        self.staged = None
        if not self.shards:
            return self.host.numpy()
        return self.assemble(self.host)


def launch_spatial(arr: np.ndarray, plan: ImagePlan, row, streams=None, trace=None):
    """Stage + launch ONE image's chain split on W over the devices of
    `row` (one row of a mesh's spatial axis, n entries; streams[j] is
    entry j's stream, None: each device's side stream), without waiting.
    Returns a `SpatialLaunch`, or None for an identity chain.

    The live stages `spatial_split` admits run W-sharded: shard j owns
    output columns [j lw, (j + 1) lw) of each stage. The first sharded
    stage's input comes from the host in each shard's own H2D (its
    `shard_input`: K2's packed columns with their chroma halos, K11's
    packed coefficient columns with, at 4:2:0 and 4:2:2, k = 8, a whole
    8x8 chroma block of halo on each side, K1's and K4's input windows, a
    transpose's row band, else the shard's columns and, for K13 and the
    smartcrop, its halos), never from the device frame tier. Each stage
    runs over the row through its `run_shards`: a later stage that reads
    other columns than its own gets them from the shards that hold them
    first (a window, `shard_window`: K1's taps, K4's index maps, the
    flop's mirror, K12's whole MCUs, through
    `parallel/spatial.exchange_window`; a halo (K13) through
    `exchange_halos`; a transpose's row bands through `exchange_bands`),
    then runs its `apply_shard` on each shard (the smartcrop's form runs
    its five launches and four exchanges itself). The host follows each
    stage's input valid dims (`shard_valid`). Each stage has its
    `shard_dyn` (K7: `left` less the shard's first column); a GraySpec
    right before the ToYuv420Spec folds into that stage's launch on each
    shard (`launch_steps`; its dyn carries `luma`).
    A stage whose form refuses the shard gathers the shards onto the
    row's first entry by an explicit copy (`SpatialLaunch.gathered` names
    it) and the rest of the chain runs there. The last stage writes uint8
    (epilogue fused), or K12's int16 coefficients; each shard copies its
    output back on its own stream into one pinned host buffer of that
    dtype and records its own event, and the last stage's
    `shard_assemble` puts the shards together on the fetch (K3's and
    K12's shards as the packed planes, which `finish_batch` reads as the
    unsharded launch's).

    trace: None, or a list that gets (stage index, shard index, spec,
    apply_shard's arguments, its output) for every sharded launch of every
    shard, to hold each launch against its plain version."""
    specs = plan.spec_key()
    if not specs:
        return None
    devices = [torch.device(d) for d in row]
    n = len(devices)
    if streams is None:
        streams = [_stream(d) if d.type == "cuda" else None for d in devices]
    packed = plan.in_bucket is not None
    if packed:
        hb, wb = plan.in_bucket
    else:
        hb, wb = bucket_shape(arr.shape[0], arr.shape[1])
    sharded, gather_at = spatial_split(specs, hb, wb, n)
    if not sharded:  # the first live stage has no W-sharded form
        one = launch_batch([arr], [plan], device=devices[0], stream=streams[0],
                           label=str(devices[0]), donate=False)
        return SpatialLaunch(one.host, [one.event], [one.staged], 0,
                             type(specs[gather_at]).__name__)
    batch = arr if packed else pad_to_bucket(arr)
    img_h, img_w = (plan.in_h, plan.in_w) if packed else arr.shape[:2]
    h = np.array([img_h], dtype=np.int32)
    w = np.array([img_w], dtype=np.int32)
    host_dyns = _stack_dyns([plan])
    # each sharded stage's input bucket width, input valid dims and output
    # bucket
    in_wb, in_hw, dims, cur, vhw = {}, {}, {}, (hb, wb), (img_h, img_w)
    for i in sharded:
        in_wb[i], in_hw[i] = cur[1], vhw
        cur = dims[i] = _bucket_after(specs[i], *cur)
        vhw = specs[i].shard_valid(vhw, host_dyns[i])
    first = specs[sharded[0]]
    lw0 = dims[sharded[0]][1] // n
    inputs = [first.shard_input(batch, j * lw0, (j + 1) * lw0, img_w,
                                host_dyns[sharded[0]]) for j in range(n)]
    last = sharded[-1] if gather_at is None else None
    with _LOCK:
        _SIGNATURES.add((specs, (1,) + batch.shape, "spatial", n, str(devices[0])))
    shards, dyns, staged = [], [], []
    for j, (dev, stream) in enumerate(zip(devices, streams)):
        x, left, right, _ = inputs[j]
        hd = [specs[i].shard_dyn(d, j * (dims[i][1] // n)) if i in dims else d
              for i, d in enumerate(host_dyns)]
        flat = [[x], h, w] + [v for d in hd for v in d.values()]
        flat += [[p] for p in (left, right) if p is not None]
        sh = spatial.Shard(dev, stream, 0, 1, j * lw0)
        with spatial.on(stream):
            views, buf = _stage(flat, dev, str(dev))
            it = iter(views)
            sh.x, sh.h, sh.w = next(it), next(it), next(it)
            dyns.append([{k: next(it) for k in d} for d in hd])
            sh.left = next(it) if left is not None else None
            sh.right = next(it) if right is not None else None
            sh.ready = spatial.record(stream)
        shards.append(sh)
        staged.append(buf)
    windows, tally = {}, [0]
    for i, luma in launch_steps(specs, sharded):
        in_col0 = [inp[3] for inp in inputs] if i == sharded[0] else None
        stage_dyns = [dict(d[i], luma=True) if luma else d[i] for d in dyns]
        rec = specs[i].run_shards(shards, stage_dyns, dims[i][1] // n, in_col0, in_hw[i],
                                  in_wb[i], host_dyns[i], i == last, trace, i, tally)
        if rec is not None:
            windows[i] = rec
    if gather_at is None:
        first_x = shards[0].x
        host = torch.empty((n,) + tuple(first_x.shape), dtype=first_x.dtype,
                           pin_memory=devices[0].type == "cuda")
        events = []
        for j, sh in enumerate(shards):
            with spatial.on(sh.stream):
                host[j].copy_(sh.x, non_blocking=sh.stream is not None)
                _book_d2h(host[j], str(sh.device))
                events.append(spatial.record(sh.stream))
        return SpatialLaunch(host, events, staged, n, None, windows,
                             specs[last].shard_assemble, tally[0])
    # the gather: every shard's columns into one buffer on the row's first
    # entry, then the rest of the chain there
    s0, dev0 = streams[0], devices[0]
    ghb, gwb = dims[sharded[-1]]
    lw = gwb // n
    with spatial.on(s0):
        x = torch.empty((1, ghb, gwb, shards[0].x.shape[3]), dtype=shards[0].x.dtype,
                        device=dev0)
    for sh in shards:
        spatial.wait(s0, sh.ready)
        spatial.copy_into(x[:, :, sh.col0:sh.col0 + lw], s0, sh.x, sh.stream)
    live = live_stages(specs, hb, wb)
    rest = launch_steps(specs, live[live.index(gather_at):])
    with spatial.on(s0):
        x, _, _ = _run_steps(specs, rest, x, shards[0].h, shards[0].w, dyns[0])
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=dev0.type == "cuda")
        host.copy_(x, non_blocking=s0 is not None)
        _book_d2h(host, str(dev0))
        event = spatial.record(s0)
    return SpatialLaunch(host, [event], staged, 0, type(specs[gather_at]).__name__,
                         windows, exchanged=tally[0])


def _run_staged(specs, views: list, host_dyns: list, donate: bool = False) -> torch.Tensor:
    staged = iter(views)
    x, ht, wt = next(staged), next(staged), next(staged)
    dyns = [{k: next(staged) for k in d} for d in host_dyns]
    # the batch region as flat bytes: the donated output's home
    donor = x.reshape(-1).view(torch.uint8) if donate else None
    y, _, _ = _run_chain(specs, x, ht, wt, dyns, donor)
    return y


def _to_host(launched: Launched) -> np.ndarray:
    """Wait for the launch's copy back to host memory (its event only;
    first its kernels' event, when it has one)."""
    if launched.ready is not None:
        launched.ready.synchronize()
        launched.t_ready = time.monotonic()
    if launched.event is not None:
        launched.event.synchronize()
        launched.staged = None
    return launched.host.numpy()


def finish_batch(host_y, arrs: list, plans: list) -> list:
    """Slice per-image outputs out of a fetched (host) batch array.

    Slices are copied, so no output pins the batch buffer. yuv420- and
    dct-transport plans return YuvPlanes sliced out of the packed layout,
    or QuantizedBlocks with the dct egress."""
    if host_y is None:
        return [np.asarray(a) for a in arrs]
    if plans[0].egress == "dct":
        # the chain ended in ToDctSpec: quantized int16 coefficient planes
        # in the yuv420 packed layout, re-blocked for encode_quantized
        from imaginary_tpu_torch.codecs.jpeg_dct import unpack_dct_egress

        return [unpack_dct_egress(host_y[i], p.out_h, p.out_w, *p.out_bucket,
                                  p.egress_quality)
                for i, p in enumerate(plans)]
    if plans[0].transport in ("yuv420", "dct"):
        from imaginary_tpu_torch.codecs import unpack_planes

        return [
            unpack_planes(host_y[i], p.out_h, p.out_w, *p.out_bucket)
            for i, p in enumerate(plans)
        ]
    return [np.ascontiguousarray(host_y[i, : p.out_h, : p.out_w])
            for i, p in enumerate(plans)]


def fetch_batch(y, arrs: list, plans: list) -> list:
    """Wait for a launch_batch, launch_sharded or launch_spatial result (a
    `Launched`, a `ShardedLaunch`, a `SpatialLaunch`, or None for an
    identity chain) and slice out per-image outputs, in order."""
    if y is None:
        return [np.asarray(a) for a in arrs]
    if isinstance(y, ShardedLaunch):
        return [out for a, b, sub in y.parts
                for out in fetch_batch(sub, arrs[a:b], plans[a:b])]
    if isinstance(y, SpatialLaunch):
        return finish_batch(y.to_host(), arrs, plans)
    return finish_batch(_to_host(y), arrs, plans)


def run_batch(arrs: list, plans: list, device=DEFAULT_DEVICE,
              device_cache: bool = False) -> list:
    """Synchronous convenience: launch + fetch in one call."""
    return fetch_batch(launch_batch(arrs, plans, device=device,
                                    device_cache=device_cache), arrs, plans)


def run_single(arr: np.ndarray, plan: ImagePlan, device=DEFAULT_DEVICE):
    """Single-image convenience wrapper (the pipeline's default runner,
    with the device frame tier: the reference's unpinned launch)."""
    return run_batch([arr], [plan], device=device, device_cache=True)[0]


_OOM_MARKERS = ("out of memory", "failed to allocate", "resource exhausted",
                "device.oom")


def is_oom_error(e: BaseException) -> bool:
    """True when an exception reads as memory exhaustion rather than a
    device fault: the executor bisects such chunks (a capacity event)
    instead of striking the card (a fault). The line: the caching
    allocator's `torch.cuda.OutOfMemoryError` ("CUDA out of memory"), a
    host MemoryError and the `device.oom` failpoint's injected error are
    capacity; a hand-written kernel's failed launch ("<kernel> kernel
    launch failed: CUDA error N", kernels._launch) is a crash strike,
    whatever N, and so is any other CUDA error."""
    if isinstance(e, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    s = str(e).lower()
    return any(m in s for m in _OOM_MARKERS)


def output_checksum(out) -> int:
    """Order-sensitive CRC32 over a staged output's bytes (an ndarray or
    YuvPlanes): two launches of the same kernels on the same input are
    expected bit-identical."""
    if out is None:
        return 0
    if isinstance(out, np.ndarray):
        return zlib.crc32(np.ascontiguousarray(out).tobytes())
    crc = 0
    for k in ("y", "u", "v"):
        p = getattr(out, k, None)
        if p is not None:
            crc = zlib.crc32(np.ascontiguousarray(p).tobytes(), crc)
    return crc
