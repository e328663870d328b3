"""Boot prewarm of the common chains (the port's copy of
`imaginary_tpu/prewarm.py`).

A restarted server's first requests pay costs a warm one does not: the
CUDA context and the kernel modules' loads, and the caching allocator's
and the pinned host pool's first blocks for each launch shape. With
`--prewarm` the server launches the common (operation, options, source
dims) matrix `_COMMON` (each row's options parsed from its route's query)
on the card before it binds, at every chunk size
the executor can form (`batch_ladder`), on every transport a request of
that shape rides: rgb, packed YUV 4:2:0 (when the native codec is
present) and, with `--transport-dct` (and `--transport-dct-egress`), the
DCT chains, each at the full bucket and at the shrink-on-load bucket
JPEG traffic actually serves. After that the executor's
`compile_misses` stays 0 for that traffic. `warm_mesh_paths` does the
same for the lane tier: each lane's device and stream, the sharded
rungs, and the spatial route's W-shard launch when it is armed.

Prewarm degrades and never dies before bind: a warm that fails is
written to stderr with its chain, bucket, B and error, and counted in
the summary line beside the number warmed. Nothing falls back to the
CPU: the warms run on `device`, the card unless the caller asks for the
CPU.

`golden_input` and `golden_case` build the integrity canary
(engine/integrity.py): a 96x128 smooth gradient, its 48x36 /resize plan
and that plan's output from the host interpreter (engine/host_exec.py).

Left out of the reference's module: `enable_persistent_cache`, the XLA
compilation cache. Nothing is compiled per chain here; the kernels'
counterpart, the nvcc build directory `imaginary_tpu_torch/_build/`,
already persists.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from imaginary_tpu_torch.engine.executor import MAX_BATCH, _Item, batch_ladder
from imaginary_tpu_torch.ops import chain as chain_mod
from imaginary_tpu_torch.ops.buckets import bucket_shape
from imaginary_tpu_torch.ops.plan import plan_operation
from imaginary_tpu_torch.options import ImageOptions
from imaginary_tpu_torch.params import build_params_from_query

ENV_BATCHES = "IMAGINARY_TPU_PREWARM_BATCHES"

# (operation, query, source dims (h, w)): the hot routes at the common
# source sizes, the reference's `_COMMON` rows
COMMON_QUERIES = [
    ("resize", {"width": "300"}, (1080, 1920)),
    ("resize", {"width": "300", "height": "200"}, (1080, 1920)),
    ("thumbnail", {"width": "100"}, (1080, 1920)),
    ("crop", {"width": "300", "height": "260"}, (1080, 1920)),
    ("resize", {"width": "300"}, (740, 550)),
    ("fit", {"width": "300", "height": "300"}, (740, 550)),
]

# The golden-probe canary (engine/integrity.py): a fixed synthetic input
# and a real resize chain (K1, with the K4 its plan carries), whose
# reference output the host interpreter computes once, at first use. Small
# on purpose (96x128 -> 48x36): the probe runs at cooldown cadence.
_GOLDEN_H, _GOLDEN_W = 96, 128
_GOLDEN_OUT_W, _GOLDEN_OUT_H = 48, 36


def golden_input() -> np.ndarray:
    """A deterministic smooth gradient: host and card resamplers diverge
    most at hard edges, and the golden comparison's bars must stay far
    above honest kernel rounding and far below a corrupted byte."""
    yy, xx = np.mgrid[0:_GOLDEN_H, 0:_GOLDEN_W]
    r = (xx * 255) // max(1, _GOLDEN_W - 1)
    g = (yy * 255) // max(1, _GOLDEN_H - 1)
    b = ((xx + yy) * 255) // max(1, _GOLDEN_H + _GOLDEN_W - 2)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def golden_case() -> tuple:
    """(input, plan, host_reference): the canary, its output computed on
    the host, which never transits the card under suspicion."""
    from imaginary_tpu_torch.engine import host_exec

    arr = golden_input()
    plan = plan_operation(
        "resize", ImageOptions(width=_GOLDEN_OUT_W, height=_GOLDEN_OUT_H),
        _GOLDEN_H, _GOLDEN_W, 0, 3)
    return arr, plan, host_exec.run(arr, plan)


# (operation, options, source dims): each row's options as the request
# parser builds them from its query, so a warmed chain is the one that
# route's requests launch. The reference builds ImageOptions directly,
# whose default extend (mirror) is not a request's (copy): its 300x200
# /resize warms an EmbedSpec no request launches.
_COMMON = [(op, build_params_from_query(q), dims) for op, q, dims in COMMON_QUERIES]


def _batch_sizes(batch_sizes, max_batch: int) -> tuple:
    """The B values to warm: the caller's, else the env's comma list, else
    the executor's ladder (a malformed env degrades to the ladder)."""
    if batch_sizes is not None:
        return tuple(batch_sizes)
    env = os.environ.get(ENV_BATCHES, "")
    if env:
        try:
            return tuple(int(x) for x in env.split(",") if x.strip())
        except ValueError:
            pass
    return batch_ladder(max_batch)


def prewarm_common_chains(batch_sizes=None, verbose: bool = True, device="cuda",
                          max_batch: int = MAX_BATCH, executor=None,
                          report=None) -> int:
    """Launch the `_COMMON` matrix on `device` at every B of `batch_sizes`
    (default: the env's list, else `batch_ladder(max_batch)`), then seed
    the executor's link price from two of those warm drains. With an
    `executor` that has lanes, also warm its lane tier
    (`warm_mesh_paths`), and let it adopt the seed. Returns the number of
    programs warmed; `report`, a dict when given, gets {"warmed",
    "failed", "seconds", "seed"}."""
    sizes = _batch_sizes(batch_sizes, max_batch)
    built = 0
    seen: set = set()
    warmed: list = []  # (plan, kind, dh, dw, b) that ran clean
    failed: list = []
    t0 = time.monotonic()
    for op, opts, (h, w) in _COMMON:
        built += warm_chain(op, opts, h, w, sizes, seen=seen, warmed=warmed,
                            device=device, failed=failed)
    if executor is not None:
        for op, opts, (h, w) in _COMMON:
            built += warm_mesh_paths(executor, op, opts, h, w, sizes, failed=failed)
    seeded = _seed_link_rate(warmed, device=device)
    if executor is not None:
        executor.adopt_link_seed()
    secs = time.monotonic() - t0
    if report is not None:
        report.update(warmed=built, failed=len(failed), seconds=secs, seed=seeded)
    if verbose:
        msg = (f"prewarmed {built} op-chain programs ({len(failed)} failed) "
               f"in {secs:.1f}s on {device}")
        if seeded:
            msg += f"; link seeded at {seeded[0]:.2f} ms/MB (floor {seeded[1]:.1f} ms)"
        print(msg, flush=True)
    return built


def _plans(op: str, opts: ImageOptions, h: int, w: int) -> list:
    """(plan, kind, dh, dw) of every chain a request of this (operation,
    options, source dims) can launch: the full bucket (PNG and WEBP decode
    at full size) and the shrink-on-load bucket, on the rgb transport,
    the packed-YUV420 one when the native codec is present, and the DCT
    ones when the switches are on. kind is None (rgb), "yuv" or "dct"."""
    from imaginary_tpu_torch import codecs, pipeline
    from imaginary_tpu_torch.ops.plan import (
        choose_decode_shrink,
        wrap_plan_dct,
        wrap_plan_yuv420,
    )

    try:
        shrink = choose_decode_shrink(op, opts, h, w, 0, 3)
    except Exception:
        shrink = 1
    # decode dims -> the shrink that made them: the dct transport's chain
    # differs per (bucket, shrink), as K11's fold factor k = 8 // shrink
    dim_shrink = {(h, w): 1}
    dim_shrink.setdefault((-(-h // shrink), -(-w // shrink)), shrink)
    warm_yuv = codecs.yuv420_supported()
    warm_dct = pipeline.transport_dct_enabled()
    warm_egress = pipeline.transport_dct_egress_enabled()
    out = []
    for (dh, dw), dshrink in dim_shrink.items():
        try:
            plan = plan_operation(op, opts, dh, dw, 0, 3)
        except Exception:
            continue
        out.append((plan, None, dh, dw))
        if not plan.stages:
            continue
        if warm_yuv:
            out.append((wrap_plan_yuv420(plan, dh, dw), "yuv", dh, dw))
        if warm_dct and dshrink in (1, 2, 4, 8):
            out.append((wrap_plan_dct(plan, h, w, dshrink), "dct", dh, dw))
            if warm_egress:
                # the egress chain ends in ToDctSpec; quality rides as a
                # dyn, so one warm covers every quality
                out.append((wrap_plan_dct(plan, h, w, dshrink, egress="dct",
                                          egress_quality=80), "dct", dh, dw))
    return out


def _report_failure(failed, pl, dh, dw, b, e: Exception) -> None:
    names = " -> ".join(type(st.spec).__name__ for st in pl.stages)
    bucket = pl.in_bucket or bucket_shape(dh, dw)
    print(f"prewarm: chain [{names}] bucket {bucket} B={b} failed: "
          f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
    if failed is not None:
        failed.append((pl, dh, dw, b, e))


def warm_chain(op: str, opts: ImageOptions, h: int, w: int, batch_sizes,
               seen=None, warmed=None, device="cuda", failed=None) -> int:
    """Launch every chain one (operation, options, source dims) can run
    (`_plans`) at each B of `batch_sizes` on `device`, skipping (chain,
    bucket, B) keys already in `seen`. Returns the number warmed; each
    clean one is appended to `warmed` as (plan, kind, dh, dw, b), each
    failure written to stderr and appended to `failed`."""
    if seen is None:
        seen = set()
    built = 0
    for pl, kind, dh, dw in _plans(op, opts, h, w):
        for b in batch_sizes:
            key = (pl.spec_key(), bucket_shape(dh, dw), b)
            if key in seen:
                continue
            seen.add(key)
            try:
                arr = _dummy_input(pl, kind, dh, dw)
                chain_mod.run_batch([arr] * b, [pl] * b, device=device)
            except Exception as e:
                _report_failure(failed, pl, dh, dw, b, e)
                continue
            built += 1
            if warmed is not None:
                warmed.append((pl, kind, dh, dw, b))
    return built


def warm_mesh_paths(ex, op: str, opts: ImageOptions, h: int, w: int,
                    batch_sizes=None, failed=None) -> int:
    """Warm the lane tier's signatures for one (operation, options, source
    dims) on an executor with a mesh policy: every chain of `_plans` on
    each lane's device and stream at each B, the sharded split of each B
    that reaches the sharded threshold, and the spatial route's W-shard
    launch on each spatial row when the input bucket crosses its bar.
    Returns the number of signatures it added to the chain's set."""
    if getattr(ex, "_lanes", None) is None:
        return 0
    sizes = _batch_sizes(batch_sizes, ex.config.max_batch)
    before = chain_mod.cache_size()
    for pl, kind, dh, dw in _plans(op, opts, h, w):
        if not pl.stages:
            continue
        arr = _dummy_input(pl, kind, dh, dw)
        for ln in ex._lanes.lanes:
            for b in sizes:
                try:
                    chain_mod.fetch_batch(
                        chain_mod.launch_batch([arr] * b, [pl] * b, device=ln.device,
                                               stream=ln.stream), [arr] * b, [pl] * b)
                except Exception as e:
                    _report_failure(failed, pl, dh, dw, b, e)
        mesh, streams = ex._lane_mesh, ex._lane_streams
        if mesh is not None:
            for b in sizes:
                if b < ex._shard_min():
                    continue
                try:
                    chain_mod.fetch_batch(
                        chain_mod.launch_sharded([arr] * b, [pl] * b, mesh, streams),
                        [arr] * b, [pl] * b)
                except Exception as e:
                    _report_failure(failed, pl, dh, dw, b, e)
        if ex._spatial_on and ex._spatial_route(_Item(arr, pl).key):
            n = ex._spatial
            for row in range(len(ex._lanes.lanes) // n):
                entries = range(row * n, (row + 1) * n)
                try:
                    chain_mod.fetch_batch(
                        chain_mod.launch_spatial(
                            arr, pl, ex._mesh.devices[row],
                            [ex._lanes.lane(i).stream for i in entries]),
                        [arr], [pl])
                except Exception as e:
                    _report_failure(failed, pl, dh, dw, 1, e)
    return chain_mod.cache_size() - before


def _dummy_input(pl, kind, dh: int, dw: int) -> np.ndarray:
    """A zero input of the shape a request of this chain stages: the
    packed planes' buffer (yuv), the packed coefficients in
    `kernels.dct_in_shape`'s layout (dct), else the decoded RGB image."""
    if kind == "yuv":
        ph, wb = pl.in_bucket
        return np.zeros((ph, wb, 1), dtype=np.uint8)
    if kind == "dct":
        from imaginary_tpu_torch import kernels

        spec = pl.stages[0].spec
        return np.zeros(kernels.dct_in_shape(spec.layout, spec.k, spec.hb, spec.wb),
                        dtype=np.int16)
    return np.zeros((dh, dw, 3), dtype=np.uint8)


def _wire_mb(pl, kind, dh: int, dw: int) -> float:
    """Wire MB one item of this chain moves over the link, priced by the
    executor's own item accounting (`_Item.wire_mb`), so the seed and the
    EWMA that refines it share a unit."""
    return _Item(_dummy_input(pl, kind, dh, dw), pl).wire_mb


def _seed_link_rate(warmed: list, device="cuda"):
    """Time two warm drains of very different wire sizes and install the
    solved (ms per MB, floor ms) as the executor's link seed
    (`engine/executor.seed_link_rate`), so the first executor prices its
    owed ledger from a measurement. Returns the installed pair, or None
    (too little spread, a failed drain, or an inverted slope: a zero seed
    would price the link free)."""
    if not warmed:
        return None
    from imaginary_tpu_torch.engine import executor as executor_mod

    cands = [(_wire_mb(pl, kind, dh, dw) * b, pl, kind, dh, dw, b)
             for pl, kind, dh, dw, b in warmed]
    small = min(cands, key=lambda c: c[0])
    big = max(cands, key=lambda c: c[0])
    if big[0] - small[0] < 0.25:  # need spread to fit a slope
        return None

    def timed(c) -> float:
        _mb, pl, kind, dh, dw, b = c
        arr = _dummy_input(pl, kind, dh, dw)
        best = float("inf")
        for _ in range(2):  # min of 2 dodges a one-off stall
            t = time.monotonic()
            chain_mod.run_batch([arr] * b, [pl] * b, device=device)
            best = min(best, (time.monotonic() - t) * 1000.0)
        return best

    try:
        t_small = timed(small)
        t_big = timed(big)
    except Exception:
        return None  # the device failed mid-prewarm: serve unseeded
    rate = (t_big - t_small) / (big[0] - small[0])
    if rate <= 0.0:
        return None
    floor = max(t_small - small[0] * rate, 0.0)
    executor_mod.seed_link_rate(rate, floor)
    return rate, floor
