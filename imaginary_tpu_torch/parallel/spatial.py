"""The W-sharded Gaussian blur with a halo exchange (the counterpart of
`imaginary_tpu/parallel/spatial.py:56-124`, `sharded_blur`).

The image's width axis is split over the mesh's spatial axis and its batch
over the batch axis. JAX runs this as one `shard_map` program whose
horizontal pass `ppermute`s R-wide strips between ring neighbours; here
one process drives every shard, each on its mesh device and its own
stream, in three steps:

1. the exchange (`exchange_halos`): each shard's left halo [B, Hb, R, C]
   takes its left neighbour's last R input columns and its right halo
   its right neighbour's first R, in the input's dtype: `copy_` of the
   column slices, a peer copy across cards and a local copy on one card,
   run after the destination's stream has waited on the source's `ready`
   event;
2. K13, one launch a shard (`blur_shards`, `kernels.blur_halo`): K6's
   fused kernel over the shard's columns, reading the columns past its
   edges from the halos;
3. the caller's stream waits on every shard's `done` event and gathers
   the shards (`gather`).

Shard 0's left halo and shard n-1's right halo lie outside the image and
are left out (None): the reference's `edge` masking of wrapped ring
strips. Only input pixels cross the seams: each shard makes the vertical
sums of its halo columns itself and normalises by rowden[y] *
colden[col0 + x] over global columns, so the gathered shards equal K6's
output on the whole image bit for bit. The chain's spatial route
(`ops/chain.launch_spatial`) runs its blur stage through the same
exchange and kernel, and fills a later stage's input window (K1's taps,
the bucket shrink's columns) from the shards that hold it with
`exchange_window`: today a copy of the whole window a shard (one or more
column ranges, every row or only the row bands a stage reads), local on
one card. A transpose's shards take their row bands from every shard
(`exchange_bands`, an all-to-all of n^2 block copies). Every exchange
adds the bytes it copies to a caller's `tally` (a one-item list) when
one is given.

Nothing waits on the host (no `synchronize()`): the call returns with the
work queued on the caller's current stream. On a mesh of `cpu` entries
every step runs at once with the kernels' plain versions.
"""

from __future__ import annotations

import contextlib

import torch

from imaginary_tpu_torch import kernels
from imaginary_tpu_torch.parallel.mesh import Mesh, split_batch, split_width


class Shard:
    """One mesh entry's part of a sharded call: images [b0, b1), columns
    [col0, col0 + lw), on `device`, ordered on `stream` (None on the CPU).
    `x` is its current input, `ready` the event after `x` was written,
    `left`/`right` its halos, `out` and `done` its output and the event
    after it."""

    __slots__ = ("device", "stream", "b0", "b1", "col0", "x", "h", "w",
                 "sigma", "left", "right", "out", "ready", "done")

    def __init__(self, device, stream, b0: int, b1: int, col0: int):
        self.device = device
        self.stream = stream
        self.b0, self.b1, self.col0 = b0, b1, col0
        self.x = self.h = self.w = self.sigma = None
        self.left = self.right = self.out = None
        self.ready = self.done = None


def on(stream):
    """The stream's context (a null context on the CPU)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def record(stream):
    """A new event recorded on `stream` (None on the CPU)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def wait(stream, event) -> None:
    if stream is not None and event is not None:
        stream.wait_event(event)


def copy_into(dst: torch.Tensor, dst_stream, src: torch.Tensor, src_stream,
              tally=None) -> None:
    """dst.copy_(src) with both shards' streams current. On one card the
    copy runs on dst_stream, so src (allocated on src_stream) is marked as
    used there; across cards PyTorch runs it on src_stream and makes
    dst_stream wait for it. tally: a one-item list the copy's bytes are
    added to, or None."""
    with on(src_stream), on(dst_stream):
        if (dst_stream is not None and src.device == dst.device
                and src_stream is not dst_stream):
            src.record_stream(dst_stream)
        dst.copy_(src, non_blocking=True)
    if tally is not None:
        tally[0] += src.numel() * src.element_size()


def shard_inputs(x: torch.Tensor, h, w, sigma, mesh: Mesh, streams=None) -> list:
    """Split x [B, Hb, Wb, C] and its per-image h, w, sigma over the mesh
    and copy each part to its device: a list of batch rows, each a list of
    Shards in spatial order (rows that own no image are left out).
    `streams`, one per flat mesh entry, defaults to a new pool stream for
    each card entry."""
    bsz = x.shape[0]
    ns = mesh.shape[1]
    cols = split_width(x.shape[2], mesh)
    main = torch.cuda.current_stream(x.device) if x.is_cuda else None
    start = record(main)
    grid = []
    for bi, (b0, b1) in enumerate(split_batch(bsz, mesh)):
        if b0 == b1:
            continue
        row = []
        for si, (c0, c1) in enumerate(cols):
            dev = mesh.devices[bi][si]
            if streams is not None:
                s = streams[bi * ns + si]
            else:
                s = torch.cuda.Stream(dev) if dev.type == "cuda" else None
            sh = Shard(dev, s, b0, b1, c0)
            wait(s, start)
            with on(s):
                sh.x = torch.empty((b1 - b0, x.shape[1], c1 - c0, x.shape[3]),
                                   dtype=x.dtype, device=dev)
                sh.x.copy_(x[b0:b1, :, c0:c1], non_blocking=True)
                sh.h = h[b0:b1].to(dev, torch.int32)
                sh.w = w[b0:b1].to(dev, torch.int32)
                sh.sigma = sigma[b0:b1].to(dev, torch.float32)
                sh.ready = record(s)
            row.append(sh)
        grid.append(row)
    return grid


def exchange_halos(grid: list, radius: int, tally=None) -> None:
    """Step 1: each shard's `left` <- its left neighbour's last R input
    columns, its `right` <- its right neighbour's first R, each copy after
    the destination's stream waited on the source's `ready`. The outer
    halos of a row stay None."""
    r = radius
    for row in grid:
        for sh in row:
            sh.left = sh.right = None
        if r == 0:
            continue
        for j, dst in enumerate(row):
            for src, side in ((row[j - 1] if j > 0 else None, "left"),
                              (row[j + 1] if j + 1 < len(row) else None, "right")):
                if src is None:
                    continue
                lw = src.x.shape[2]
                part = src.x[:, :, lw - r:] if side == "left" else src.x[:, :, :r]
                wait(dst.stream, src.ready)
                with on(dst.stream):
                    halo = torch.empty(part.shape, dtype=part.dtype, device=dst.device)
                copy_into(halo, dst.stream, part, src.stream, tally)
                setattr(dst, side, halo)


def window_spans(win) -> list:
    """A window's column ranges: (k0, k1), or a tuple of such ranges laid
    side by side in the window."""
    return list(win) if isinstance(win[0], tuple) else [win]


def exchange_window(row: list, windows: list, tally=None, rows=None) -> list:
    """Each shard's `x` <- columns [k0, k1) = windows[j] of the row's
    current output, whose shards hold contiguous columns [col0, col0 + lw)
    side by side (a later sharded stage's input window,
    `stages._ShardForm.shard_window`); a window of several ranges
    (`window_spans`) holds them side by side. rows: None (every row), or
    the row ranges [(r0, r1), ...] the windows take, stacked in order.
    Each part is copied from the shard that holds it after the
    destination's stream waited on the source's `ready`; a window of every
    row equal to the shard's own columns stays as it is. Returns, for each
    shard, the parts it took as (source shard, first global column, end
    column)."""
    wins, sources = [], []
    for j, (dst, win) in enumerate(zip(row, windows)):
        spans = window_spans(win)
        if rows is None and spans == [(dst.col0, dst.col0 + dst.x.shape[2])]:
            wins.append(dst.x)
            sources.append([(j, *spans[0])])
            continue
        bands = [(0, dst.x.shape[1])] if rows is None else rows
        width = sum(k1 - k0 for k0, k1 in spans)
        shape = (dst.x.shape[0], sum(r1 - r0 for r0, r1 in bands), width) + dst.x.shape[3:]
        with on(dst.stream):
            out = torch.empty(shape, dtype=dst.x.dtype, device=dst.device)
        parts, at = [], 0
        for k0, k1 in spans:
            for s, src in enumerate(row):
                a, b = max(k0, src.col0), min(k1, src.col0 + src.x.shape[2])
                if a >= b:
                    continue
                wait(dst.stream, src.ready)
                y = 0
                for r0, r1 in bands:
                    copy_into(out[:, y:y + r1 - r0, at + a - k0:at + b - k0], dst.stream,
                              src.x[:, r0:r1, a - src.col0:b - src.col0], src.stream, tally)
                    y += r1 - r0
                parts.append((s, a, b))
            at += k1 - k0
        if sum(b - a for _, a, b in parts) != width:
            raise ValueError(f"window {spans} is not covered by the row's shards")
        wins.append(out)
        sources.append(parts)
    for sh, win in zip(row, wins):
        sh.x = win
    return sources


def exchange_bands(row: list, lw: int, tally=None) -> list:
    """A transpose's all-to-all: each shard j's `x` <- rows [j lw, (j + 1)
    lw) of the row's current output across every shard's columns, an
    assembled band [B, lw, Wb, C] whose shard s part sits at its columns
    [col0, col0 + lw_s). n^2 block copies, each after the destination's
    stream waited on the source's `ready` (a shard's own part too, a local
    copy). Returns, for each shard, the parts it took as (source shard,
    first global column, end column)."""
    width = sum(src.x.shape[2] for src in row)
    bands, sources = [], []
    for j, dst in enumerate(row):
        shape = dst.x.shape[:1] + (lw, width) + dst.x.shape[3:]
        with on(dst.stream):
            band = torch.empty(shape, dtype=dst.x.dtype, device=dst.device)
        parts = []
        for s, src in enumerate(row):
            a, b = src.col0, src.col0 + src.x.shape[2]
            wait(dst.stream, src.ready)
            copy_into(band[:, :, a:b], dst.stream, src.x[:, j * lw:(j + 1) * lw],
                      src.stream, tally)
            parts.append((s, a, b))
        bands.append(band)
        sources.append(parts)
    for sh, band in zip(row, bands):
        sh.x = band
    return sources


def blur_shards(grid: list, radius: int, wb: int, out_u8: bool = False) -> None:
    """Step 2: K13 on every shard (one launch each), then its `done`
    event."""
    for row in grid:
        for sh in row:
            with on(sh.stream):
                sh.out = kernels.blur_halo(sh.x, sh.left, sh.right, sh.h, sh.w,
                                           sh.sigma, radius, sh.col0, wb, out_u8)
                sh.done = record(sh.stream)


def gather(grid: list, out: torch.Tensor) -> torch.Tensor:
    """Step 3: out [B, Hb, Wb, C] <- every shard's `out`, after the
    caller's current stream waited on the shard's `done`."""
    main = torch.cuda.current_stream(out.device) if out.is_cuda else None
    for row in grid:
        for sh in row:
            wait(main, sh.done)
            lw = sh.out.shape[2]
            copy_into(out[sh.b0:sh.b1, :, sh.col0:sh.col0 + lw], main, sh.out, sh.stream)
    return out


def sharded_blur(x: torch.Tensor, h, w, sigma, radius: int, mesh: Mesh) -> torch.Tensor:
    """Gaussian blur of x [B, Hb, Wb, C] (uint8 or f32, C 1 to 4) sharded
    on W over the mesh's spatial axis and on B over its batch axis; h, w
    int32 [B], sigma f32 [B], radius static. Returns f32 [B, Hb, Wb, C] on
    x's device.

    Raises ValueError when Wb does not split evenly over the spatial axis
    or when the radius reaches the local shard width (a halo wider than
    its neighbour's shard)."""
    wb = x.shape[2]
    cols = split_width(wb, mesh)
    local_w = cols[0][1] - cols[0][0]
    if radius >= local_w:
        raise ValueError(f"halo radius {radius} >= local shard width {local_w}")
    grid = shard_inputs(x, h, w, sigma, mesh)
    exchange_halos(grid, radius)
    blur_shards(grid, radius, wb)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    return gather(grid, out)
