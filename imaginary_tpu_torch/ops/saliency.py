"""Smartcrop saliency: the port's copy of `imaginary_tpu/ops/saliency.py`.

Reimplements the *behavior* of libvips' smartcrop "attention" strategy
(ref: bimg GravitySmart, image.go:236-245; libvips interesting=attention):
score pixels by edge energy, colour saturation and skin-tone likelihood,
then place the crop window over the highest-scoring region.

These are the plain PyTorch versions: an elementwise saliency map with
shifted differences (the reference's formulation), a 2-D integral image,
and one masked argmax over every candidate window. The integral image sums
each row first, in the order of K9's row scan (`row_prefix`: segments of
ceil(Wb / 256) columns summed serially, the 256 segment totals scanned by
the kernel's shuffle tree, then each segment's running sums from its
exclusive prefix), then down each column (`torch.cumsum`); the reference
sums H first, so it matches the reference to a relative tolerance. The
row scan's fixed tree is what lets a W-shard compute its columns' sums
from every shard's segment totals, bit-equal to the whole image's
(`kernels.reference.saliency_scan_shard`). On the card the same work runs
as kernels K9 (`saliency_ii`: saliency map and integral image) and K10
(`window_argmax`); see `kernels/csrc/saliency.cu`. `smart_offsets`
composes the plain versions.
"""

from __future__ import annotations

import torch


def saliency_map(x: torch.Tensor, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, Hb, Wb] non-negative saliency of x [B, Hb, Wb, C >= 3], zero
    outside each image's valid (h, w). The edge term replicates the
    *bucket* border, so the last valid row and column read the padding
    next to them, as the reference does."""
    rgb = x[..., :3].float() / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    lum = 0.2126 * r + 0.7152 * g + 0.0722 * b

    # edge energy: central differences, edge-replicated
    pad_y = torch.cat([lum[:, :1], lum, lum[:, -1:]], dim=1)
    pad_x = torch.cat([lum[:, :, :1], lum, lum[:, :, -1:]], dim=2)
    dy = (pad_y[:, 2:, :] - pad_y[:, :-2, :]).abs()
    dx = (pad_x[:, :, 2:] - pad_x[:, :, :-2]).abs()
    edges = dx + dy

    sat = rgb.amax(dim=-1) - rgb.amin(dim=-1)
    # skin-tone likelihood (gaussian around a canonical skin chroma)
    skin = torch.exp(-(((r - 0.78) ** 2) + ((g - 0.57) ** 2) + ((b - 0.44) ** 2)) / 0.025)

    sal = 4.0 * edges + 1.0 * sat + 1.5 * skin

    hb, wb = x.shape[1], x.shape[2]
    ys = torch.arange(hb, dtype=torch.int32, device=x.device)
    xs = torch.arange(wb, dtype=torch.int32, device=x.device)
    valid = (ys[None, :, None] < h[:, None, None]) & (xs[None, None, :] < w[:, None, None])
    return torch.where(valid, sal, 0.0)


# Lanes of K9's row scan: a row's columns fall into this many segments.
LANES = 256
_WARP = 32


def _warp_scan(v: torch.Tensor) -> torch.Tensor:
    """Inclusive scans of v [..., 32] by the kernel's shuffle tree: five
    rounds, lane l adding lane l - o's value of the round before."""
    lane = torch.arange(_WARP, device=v.device)
    for o in (1, 2, 4, 8, 16):
        shifted = torch.nn.functional.pad(v[..., :-o], (o, 0))
        v = torch.where(lane >= o, v + shifted, v)
    return v


def scan_totals(tot: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of the segment totals tot [..., LANES] in the row
    kernel's order (`scan_rows`): each warp's 32 lanes, then the 8 warp
    totals by the same tree, then each lane plus the scanned total of the
    warps before its own."""
    warps = LANES // _WARP
    v = _warp_scan(tot.reshape(tot.shape[:-1] + (warps, _WARP)))
    wt = _warp_scan(torch.nn.functional.pad(v[..., _WARP - 1], (0, _WARP - warps)))
    before = torch.nn.functional.pad(wt[..., :warps - 1], (1, 0))[..., None]
    first = torch.arange(warps, device=tot.device)[:, None] == 0
    return torch.where(first, v, v + before).reshape(tot.shape)


def segment_totals(sal: torch.Tensor, per: int) -> torch.Tensor:
    """sal [..., n * per] -> [..., n]: each segment of per columns summed
    serially from 0 (f32), as one lane of the row kernel sums it."""
    seg = sal.reshape(sal.shape[:-1] + (-1, per))
    tot = torch.zeros(seg.shape[:-1], dtype=sal.dtype, device=sal.device)
    for k in range(per):
        tot = tot + seg[..., k]
    return tot


def segment_runs(sal: torch.Tensor, prefix: torch.Tensor, per: int) -> torch.Tensor:
    """The running sums of sal [..., n * per] within each segment, from
    its exclusive prefix [..., n]."""
    seg = sal.reshape(sal.shape[:-1] + (-1, per))
    out = torch.empty_like(seg)
    run = prefix
    for k in range(per):
        run = run + seg[..., k]
        out[..., k] = run
    return out.reshape(sal.shape)


def exclusive(incl: torch.Tensor) -> torch.Tensor:
    """Each segment's exclusive prefix from the inclusive scan."""
    return torch.nn.functional.pad(incl[..., :-1], (1, 0))


def row_prefix(sal: torch.Tensor) -> torch.Tensor:
    """[B, Hb, Wb]: each row's running sums in K9's row-scan order."""
    wb = sal.shape[-1]
    per = -(-wb // LANES)
    padded = torch.nn.functional.pad(sal, (0, LANES * per - wb))
    incl = scan_totals(segment_totals(padded, per))
    return segment_runs(padded, exclusive(incl), per)[..., :wb]


def integral_image(sal: torch.Tensor) -> torch.Tensor:
    """[B, Hb + 1, Wb + 1]: the rows' running sums (`row_prefix`), then
    cumsum over H, padded by one zero row on top and one zero column on
    the left."""
    ii = torch.cumsum(row_prefix(sal), dim=1)
    return torch.nn.functional.pad(ii, (1, 0, 1, 0))


def window_argmax(ii: torch.Tensor, h, w, win_h, win_w) -> tuple:
    """Best (top, left), int32 [B] each, for a (win_h, win_w) window over
    the integral image ii [B, Hb + 1, Wb + 1].

    Every candidate (t, l) of the bucket scores
    (ii[bot, right] - ii[t, right]) - (ii[bot, l] - ii[t, l]) with bot and
    right clipped to the bucket; candidates whose window leaves the valid
    region score -1; ties go to the first maximum in row-major order (as
    `jnp.argmax` does), so an all-masked image answers (0, 0)."""
    bsz, hb, wb = ii.shape[0], ii.shape[1] - 1, ii.shape[2] - 1
    dev = ii.device
    tops = torch.arange(hb, dtype=torch.int64, device=dev)
    lefts = torch.arange(wb, dtype=torch.int64, device=dev)
    bidx = torch.arange(bsz, device=dev)[:, None, None]
    wh = win_h.long()[:, None]
    wl = win_w.long()[:, None]
    bot = torch.clamp(tops[None, :] + wh, 0, hb)[:, :, None]  # [B, hb, 1]
    right = torch.clamp(lefts[None, :] + wl, 0, wb)[:, None, :]  # [B, 1, wb]
    t = tops[None, :, None]
    left = lefts[None, None, :]
    s = (ii[bidx, bot, right] - ii[bidx, t, right]) - (ii[bidx, bot, left] - ii[bidx, t, left])
    ok = ((t <= (h.long() - win_h.long())[:, None, None])
          & (left <= (w.long() - win_w.long())[:, None, None]))
    s = torch.where(ok, s, -1.0).reshape(bsz, -1)
    # first maximum in row-major order: the smallest index holding the max
    best = s.max(dim=1, keepdim=True).values
    idx = torch.arange(hb * wb, device=dev)[None, :].expand(bsz, -1)
    i = torch.where(s == best, idx, hb * wb).min(dim=1).values
    return (i // wb).to(torch.int32), (i % wb).to(torch.int32)


def smart_offsets(x, h, w, win_h, win_w) -> tuple:
    """Best (top, left) per batch element for a (win_h, win_w) crop window."""
    return window_argmax(integral_image(saliency_map(x, h, w)), h, w, win_h, win_w)
