"""Smartcrop saliency: the port's copy of `imaginary_tpu/ops/saliency.py`.

Reimplements the *behavior* of libvips' smartcrop "attention" strategy
(ref: bimg GravitySmart, image.go:236-245; libvips interesting=attention):
score pixels by edge energy, colour saturation and skin-tone likelihood,
then place the crop window over the highest-scoring region.

These are the plain PyTorch versions, in the reference's formulation: an
elementwise saliency map with shifted differences, a 2-D integral image
(cumsum over H, then over W), and one masked argmax over every candidate
window. On the card the same work runs as kernels K9 (`saliency_ii`:
saliency map and integral image) and K10 (`window_argmax`); see
`kernels/csrc/saliency.cu`. `smart_offsets` composes the plain versions.
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


def integral_image(sal: torch.Tensor) -> torch.Tensor:
    """[B, Hb + 1, Wb + 1]: cumsum over H, then over W, padded by one zero
    row on top and one zero column on the left."""
    ii = torch.cumsum(torch.cumsum(sal, dim=1), dim=2)
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
