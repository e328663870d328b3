"""The W-sharded Gaussian blur with a halo exchange (the counterpart of
`imaginary_tpu/parallel/spatial.py:56-124`, `sharded_blur`).

The image's width axis is split over the mesh's spatial axis and its batch
over the batch axis. JAX runs this as one `shard_map` program whose
horizontal pass `ppermute`s R-wide strips between ring neighbours; here
one process drives every shard, each on its mesh device and its own
stream, in four steps:

1. K13's pass V writes each shard's core columns into a halo-padded f32
   buffer (`kernels.blur_halo_v`), then records an event on its stream;
2. the exchange copies each shard's last and first R core columns into
   its right and left neighbours' halo strips: `copy_` of the strip
   slices, a peer copy across cards and a local copy on one card, run
   after the destination's stream has waited on the source's event;
3. K13's pass H (`kernels.blur_halo_h`);
4. the caller's stream waits on every shard's last event and gathers the
   shards.

Shard 0's left halo and shard n-1's right halo stay zero: the reference's
`edge` masking of wrapped ring strips. Only pixels cross the seams: pass H
normalises by rowden[y] * colden[col0 + x] over global columns, equal in
exact arithmetic to the reference's exchanged mask convolution.

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
    [col0, col0 + lw), on `device`, ordered on `stream` (None on the CPU)."""

    __slots__ = ("device", "stream", "b0", "b1", "col0", "x", "h", "w",
                 "sigma", "buf", "out", "ready", "done")

    def __init__(self, device, stream, b0: int, b1: int, col0: int):
        self.device = device
        self.stream = stream
        self.b0, self.b1, self.col0 = b0, b1, col0
        self.x = self.h = self.w = self.sigma = None
        self.buf = self.out = None
        self.ready = self.done = None  # events after pass V and pass H


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _record(stream):
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _wait(stream, event) -> None:
    if stream is not None and event is not None:
        stream.wait_event(event)


def _copy(dst: torch.Tensor, dst_stream, src: torch.Tensor, src_stream) -> None:
    """dst.copy_(src) with both shards' streams current. On one card the
    copy runs on dst_stream, so src (allocated on src_stream) is marked as
    used there; across cards PyTorch runs it on src_stream and makes
    dst_stream wait for it."""
    with _on(src_stream), _on(dst_stream):
        if (dst_stream is not None and src.device == dst.device
                and src_stream is not dst_stream):
            src.record_stream(dst_stream)
        dst.copy_(src, non_blocking=True)


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
    start = _record(main)
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
            _wait(s, start)
            with _on(s):
                sh.x = torch.empty((b1 - b0, x.shape[1], c1 - c0, x.shape[3]),
                                   dtype=x.dtype, device=dev)
                sh.x.copy_(x[b0:b1, :, c0:c1], non_blocking=True)
                sh.h = h[b0:b1].to(dev, torch.int32)
                sh.w = w[b0:b1].to(dev, torch.int32)
                sh.sigma = sigma[b0:b1].to(dev, torch.float32)
            row.append(sh)
        grid.append(row)
    return grid


def blur_v(grid: list, radius: int) -> None:
    """Step 1: K13's pass V on every shard, then its `ready` event."""
    for row in grid:
        for sh in row:
            with _on(sh.stream):
                sh.buf = kernels.blur_halo_v(sh.x, sh.h, sh.w, sh.sigma, radius,
                                             sh.col0)
                sh.ready = _record(sh.stream)


def exchange_halos(grid: list, radius: int) -> None:
    """Step 2: each shard's left halo <- its left neighbour's last R core
    columns, its right halo <- its right neighbour's first R, each copy
    after the destination's stream waited on the source's `ready`. The
    outer halos of a row stay zero."""
    r = radius
    if r == 0:
        return
    for row in grid:
        for j, dst in enumerate(row):
            lw = dst.buf.shape[2] - 2 * r
            if j > 0:
                src = row[j - 1]
                _wait(dst.stream, src.ready)
                _copy(dst.buf[:, :, :r], dst.stream, src.buf[:, :, lw:lw + r],
                      src.stream)
            if j < len(row) - 1:
                src = row[j + 1]
                _wait(dst.stream, src.ready)
                _copy(dst.buf[:, :, r + lw:], dst.stream, src.buf[:, :, r:2 * r],
                      src.stream)


def blur_h(grid: list, radius: int, wb: int) -> None:
    """Step 3: K13's pass H on every shard, then its `done` event."""
    for row in grid:
        for sh in row:
            with _on(sh.stream):
                sh.out = kernels.blur_halo_h(sh.buf, sh.h, sh.w, sh.sigma, radius,
                                             sh.col0, wb)
                sh.done = _record(sh.stream)


def gather(grid: list, out: torch.Tensor) -> torch.Tensor:
    """Step 4: out [B, Hb, Wb, C] <- every shard, after the caller's
    current stream waited on the shard's `done`."""
    main = torch.cuda.current_stream(out.device) if out.is_cuda else None
    for row in grid:
        for sh in row:
            _wait(main, sh.done)
            lw = sh.out.shape[2]
            _copy(out[sh.b0:sh.b1, :, sh.col0:sh.col0 + lw], main, sh.out, sh.stream)
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
    blur_v(grid, radius)
    exchange_halos(grid, radius)
    blur_h(grid, radius, wb)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    return gather(grid, out)
