"""Plain PyTorch versions of the thirteen kernels and their W-shard forms.

Each function computes what its CUDA kernel computes, in the reference's
formulation (dense sampling matrices and einsums for the resample, a
masked normalised convolution written as shifted sums for the blur, index
vectors and gathers for the rest), in IEEE f32. They are the CPU path of
the port and the oracle `chip_smoke.py` holds each kernel against on the
card. They are no yardstick of speed.

Conventions shared with the kernels: images are NHWC; `h`, `w` and the
integer dyn params are int32 [B]; uint8 inputs are cast on entry, and
`out_u8=True` applies the chain's epilogue clip(x + 0.5, 0, 255) -> uint8.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imaginary_tpu_torch.ops import saliency as _saliency

_EPS = 1e-6

RESAMPLE_KINDS = ("lanczos3", "lanczos2", "cubic", "linear", "nearest")
GATHER_MODES = ("window", "clamp", "mirror")
ORIENT_MODES = ("flip", "flop", "transpose")
DCT_LAYOUTS = ("420", "422", "444", "gray")


def epilogue_u8(x: torch.Tensor) -> torch.Tensor:
    """`_run_chain`'s uint8 epilogue: clip(x + 0.5) then a truncating cast."""
    return torch.clamp(x + 0.5, 0.0, 255.0).to(torch.uint8)


def _finish(x: torch.Tensor, out_u8: bool) -> torch.Tensor:
    return epilogue_u8(x) if out_u8 else x


def kernel_weight(kind: str, d: torch.Tensor) -> torch.Tensor:
    """The resampling kernel at (scaled) distance d (stages.py:_kernel_weight)."""
    ad = d.abs()
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    if kind == "lanczos3":
        return torch.where(ad < 3.0, torch.sinc(d) * torch.sinc(d / 3.0), zero)
    if kind == "lanczos2":
        return torch.where(ad < 2.0, torch.sinc(d) * torch.sinc(d / 2.0), zero)
    if kind == "cubic":
        a = -0.5
        w1 = (a + 2) * ad ** 3 - (a + 3) * ad ** 2 + 1
        w2 = a * ad ** 3 - 5 * a * ad ** 2 + 8 * a * ad - 4 * a
        return torch.where(ad <= 1, w1, torch.where(ad < 2, w2, zero))
    if kind == "linear":
        return torch.clamp(1.0 - ad, min=0.0)
    if kind == "nearest":
        return torch.where((d >= -0.5) & (d < 0.5), 1.0 + zero, zero)
    raise ValueError(f"unknown kernel {kind!r}")


def sample_matrix(out_b: int, in_b: int, src: torch.Tensor, dst: torch.Tensor,
                  kind: str) -> torch.Tensor:
    """[B, out_b, in_b] row-stochastic resampling matrices (stages.py:sample_matrix)."""
    dev = src.device
    y = torch.arange(out_b, dtype=torch.float32, device=dev)[None, :, None]
    k = torch.arange(in_b, dtype=torch.float32, device=dev)[None, None, :]
    src = torch.clamp(src.float(), min=1.0)[:, None, None]
    dst = torch.clamp(dst.float(), min=1.0)[:, None, None]
    scale = dst / src
    centre = (y + 0.5) / scale - 0.5
    stretch = torch.clamp(1.0 / scale, min=1.0)
    d = (k - centre) / stretch
    wts = kernel_weight(kind, d)
    valid = (k < src) & (y < dst)
    wts = torch.where(valid, wts, 0.0)
    norm = wts.sum(dim=-1, keepdim=True)
    return torch.where(norm > _EPS, wts / torch.clamp(norm, min=_EPS), 0.0)


def resample(x, h, w, dst_h, dst_w, out_hb: int, out_wb: int, kind: str,
             out_u8: bool = False, cols=None, in_col0: int = 0, in_wb=None):
    """K1's function: separable resample of [B, Hb, Wb, C] to
    [B, out_hb, out_wb, C]. Returns (out, int32 dst_h, int32 dst_w).

    W-shard form (the kernel's `cols`, `in_col0`, `in_wb`): x holds input
    columns [in_col0, in_col0 + x.shape[2]) of an in_wb-wide bucket; it is
    placed at those columns of a zero bucket, resampled whole, and output
    columns [c0, c1) are returned. The shapes are the whole image's, so
    every output takes the same sums; columns outside x weigh 0 in them
    when x covers the outputs' taps, which makes the shard equal the
    whole image's columns bit for bit."""
    xf = x.float()
    in_wb = x.shape[2] if in_wb is None else in_wb
    if xf.shape[2] != in_wb:
        full = torch.zeros(xf.shape[:2] + (in_wb, xf.shape[3]), dtype=xf.dtype,
                           device=xf.device)
        full[:, :, in_col0:in_col0 + xf.shape[2]] = xf
        xf = full
    wy = sample_matrix(out_hb, xf.shape[1], h, dst_h, kind)
    t = torch.einsum("byk,bkwc->bywc", wy, xf)
    wx = sample_matrix(out_wb, xf.shape[2], w, dst_w, kind)
    out = torch.einsum("bxw,bywc->byxc", wx, t)
    if cols is not None and tuple(cols) != (0, out_wb):
        out = out[:, :, cols[0]:cols[1]]
    return (_finish(out.contiguous(), out_u8), dst_h.to(torch.int32),
            dst_w.to(torch.int32))


def _chroma_up_indices(out_n: int, cn: torch.Tensor, chroma_b: int, pos0: int = 0):
    """(i0, i1 [B, out_n], t [out_n]) of stages.py:_chroma_up_indices, at
    luma positions [pos0, pos0 + out_n)."""
    r = torch.arange(pos0, pos0 + out_n, dtype=torch.float32, device=cn.device)
    pos = r * 0.5 - 0.25
    i0f = torch.floor(pos)
    t = pos - i0f
    hi = torch.clamp(cn - 1, min=0)[:, None]
    base = i0f.to(torch.int64)[None, :]
    i0 = torch.minimum(torch.clamp(base, min=0), hi)
    i1 = torch.minimum(torch.clamp(base + 1, min=0), hi)
    return i0, torch.clamp(i1, max=chroma_b - 1), t


def _up2(plane, i0, i1, t, j0, j1, s):
    """Centred 2x upsample of plane [B, rows, cols]: rows through (i0, i1, t)
    first, then columns through (j0, j1, s); either pair None skips its
    axis (`_yuv420_to_rgb` / `_yuv422_to_rgb`)."""
    bsz = plane.shape[0]
    if i0 is not None:
        cols = plane.shape[2]
        rows0 = torch.gather(plane, 1, i0[:, :, None].expand(bsz, i0.shape[1], cols))
        rows1 = torch.gather(plane, 1, i1[:, :, None].expand(bsz, i1.shape[1], cols))
        plane = rows0 * (1.0 - t)[None, :, None] + rows1 * t[None, :, None]
    if j0 is not None:
        rows = plane.shape[1]
        cols0 = torch.gather(plane, 2, j0[:, None, :].expand(bsz, rows, j0.shape[1]))
        cols1 = torch.gather(plane, 2, j1[:, None, :].expand(bsz, rows, j1.shape[1]))
        plane = cols0 * (1.0 - s)[None, None, :] + cols1 * s[None, None, :]
    return plane


def _ycc_to_rgb(y, uu, vv):
    """BT.601 full-range YCbCr -> RGB on level-shifted chroma, clipped."""
    r = y + 1.402 * vv
    g = y - 0.344136 * uu - 0.714136 * vv
    b = y + 1.772 * uu
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def _yuv420_planes_to_rgb(y, u, v, h, w, hb: int, wb: int):
    """stages.py:_yuv420_to_rgb on f32 planes: centred 2x chroma upsample
    (rows, then columns) and BT.601."""
    i0, i1, t = _chroma_up_indices(hb, (h.long() + 1) // 2, hb // 2)
    j0, j1, s = _chroma_up_indices(wb, (w.long() + 1) // 2, wb // 2)
    return _ycc_to_rgb(y, _up2(u, i0, i1, t, j0, j1, s) - 128.0,
                       _up2(v, i0, i1, t, j0, j1, s) - 128.0)


def yuv420_to_rgb(x: torch.Tensor, h, w, hb: int, wb: int) -> torch.Tensor:
    """K2's function: uint8 [B, hb + hb/2, wb, 1] packed planes -> f32
    [B, hb, wb, 3] RGB (stages.py:FromYuv420Spec with the chain's cast)."""
    xf = x[..., 0].float()
    return _yuv420_planes_to_rgb(xf[:, :hb], xf[:, hb:, : wb // 2],
                                 xf[:, hb:, wb // 2:], h, w, hb, wb)


def yuv420_to_rgb_shard(x: torch.Tensor, left, right, h, w, hb: int,
                        lw: int) -> torch.Tensor:
    """K2's W-shard form: one shard's packed buffer [B, hb + hb/2, lw, 1]
    and its chroma halos [B, hb/2, 2, 1] (U, V), every chroma column
    already taken by the whole image's clamped index, -> f32 RGB [B, hb,
    lw, 3]. The window [left, shard, right] of each plane is upsampled
    with the whole image's row taps and column taps ((x - 1) >> 1) + 1 and
    the one after, so each pixel blends the same chroma values as in the
    whole image."""
    xf = x[..., 0].float()
    lf, rf = left[..., 0].float(), right[..., 0].float()
    cw = lw // 2
    u = torch.cat([lf[..., 0:1], xf[:, hb:, :cw], rf[..., 0:1]], dim=2)
    v = torch.cat([lf[..., 1:2], xf[:, hb:, cw:], rf[..., 1:2]], dim=2)
    i0, i1, t = _chroma_up_indices(hb, (h.long() + 1) // 2, hb // 2)
    pos = torch.arange(lw, dtype=torch.float32, device=x.device) * 0.5 - 0.25
    jf = torch.floor(pos)
    s = pos - jf
    j0 = (jf.to(torch.int64) + 1)[None, :].expand(x.shape[0], lw)
    return _ycc_to_rgb(xf[:, :hb], _up2(u, i0, i1, t, j0, j0 + 1, s) - 128.0,
                       _up2(v, i0, i1, t, j0, j0 + 1, s) - 128.0)


def rgb_to_yuv420(x: torch.Tensor, h, w, hb: int, wb: int, luma: bool = False,
                  col0: int = 0) -> torch.Tensor:
    """K3's function: f32 [B, hb, wb, 3] RGB -> uint8 [B, hb + hb/2, wb, 1]
    packed planes (stages.py:ToYuv420Spec with the chain's uint8 epilogue).
    With `luma`, of `gray(x)`: K8 then K3, which the kernel fuses. W-shard
    form: x holds the image's columns [col0, col0 + wb) (col0 even) and
    the valid mask reads global columns."""
    if luma:
        x = gray(x)
    x = torch.clamp(x.float(), 0.0, 255.0)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    dev = x.device
    iy = torch.arange(hb, dtype=torch.int32, device=dev)[None, :, None]
    ix = col0 + torch.arange(wb, dtype=torch.int32, device=dev)[None, None, :]
    m = ((iy < h[:, None, None]) & (ix < w[:, None, None])).float()

    def pool(c):
        s = (c * m).reshape(-1, hb // 2, 2, wb // 2, 2).sum(dim=(2, 4))
        n = m.reshape(-1, hb // 2, 2, wb // 2, 2).sum(dim=(2, 4))
        return torch.where(n > 0, s / torch.clamp(n, min=1.0), 128.0)

    bottom = torch.cat([pool(cb), pool(cr)], dim=2)
    packed = torch.cat([y, bottom], dim=1)[..., None]
    return epilogue_u8(packed)


def rgb_to_yuv420_shard(x: torch.Tensor, h, w, hb: int, lw: int, col0: int,
                        luma: bool = False) -> torch.Tensor:
    """K3's W-shard form: the shard's columns [col0, col0 + lw) -> its own
    packed planes [B, hb + hb/2, lw, 1], the valid mask on global columns."""
    return rgb_to_yuv420(x, h, w, hb, lw, luma, col0)


def _axis_index(out_b: int, in_b: int, off, size, mode: str, pos0: int = 0):
    """(idx, inside) for one axis, at positions [pos0, pos0 + out_b);
    inside is None in window mode."""
    pos = pos0 + torch.arange(out_b, dtype=torch.int64, device=off.device)[None, :]
    if mode == "window":
        return torch.clamp(pos + off.long()[:, None], 0, in_b - 1), None
    size = torch.clamp(size.long(), min=1)[:, None]
    rel = pos - off.long()[:, None]
    inside = (rel >= 0) & (rel < size)
    if mode == "mirror":
        period = 2 * size
        m = torch.remainder(rel, period)
        idx = torch.where(m < size, m, period - 1 - m)
    else:
        idx = torch.minimum(torch.clamp(rel, min=0), size - 1)
    return torch.clamp(idx, 0, in_b - 1), inside


def gather(x: torch.Tensor, out_hb: int, out_wb: int, off_y=None, off_x=None,
           size_h=None, size_w=None, mode: str = "window", fill=None,
           out_u8: bool = False) -> torch.Tensor:
    """K4's function: out[b, y, x] = x[b, iy(b, y), ix(b, x)], with canvas
    pixels outside the image taking fill[b] when a fill is given (see
    csrc/gather.cu for the three index modes)."""
    bsz, in_hb, in_wb, _ = x.shape
    if mode == "window" and off_y is None:
        off_y = off_x = torch.zeros(bsz, dtype=torch.int32, device=x.device)
    iy, in_y = _axis_index(out_hb, in_hb, off_y, size_h, mode)
    ix, in_x = _axis_index(out_wb, in_wb, off_x, size_w, mode)
    bidx = torch.arange(bsz, device=x.device)[:, None, None]
    out = x.float()[bidx, iy[:, :, None], ix[:, None, :]]
    if fill is not None and in_y is not None:
        keep = (in_y[:, :, None] & in_x[:, None, :])[..., None]
        out = torch.where(keep, out, fill.float()[:, None, None, :])
    return _finish(out, out_u8)


def gather_shard(x: torch.Tensor, out_hb: int, lw: int, col0: int, in_col0: int,
                 in_wb: int, off_y=None, off_x=None, size_h=None, size_w=None,
                 mode: str = "window", fill=None, keys=None, key_wb: int = 0,
                 out_u8: bool = False) -> torch.Tensor:
    """K4's W-shard form: `gather`'s index maps at output columns [col0,
    col0 + lw) on global columns, read from x holding input columns
    [in_col0, ...) of a bucket in_wb wide; with `keys`, the offsets of the
    best of K10's shard keys (`decode_keys`)."""
    bsz, in_hb = x.shape[:2]
    if keys is not None:
        off_y, off_x = decode_keys(keys, key_wb)
    elif mode == "window" and off_y is None:
        off_y = off_x = torch.zeros(bsz, dtype=torch.int32, device=x.device)
    iy, in_y = _axis_index(out_hb, in_hb, off_y, size_h, mode)
    ix, in_x = _axis_index(lw, in_wb, off_x, size_w, mode, pos0=col0)
    bidx = torch.arange(bsz, device=x.device)[:, None, None]
    out = x.float()[bidx, iy[:, :, None], (ix - in_col0)[:, None, :]]
    if fill is not None and in_y is not None:
        keep = (in_y[:, :, None] & in_x[:, None, :])[..., None]
        out = torch.where(keep, out, fill.float()[:, None, None, :])
    return _finish(out, out_u8)


def orient(x: torch.Tensor, h, w, mode: str, out_u8: bool = False) -> torch.Tensor:
    """K5's function (stages.py:FlipSpec/FlopSpec/TransposeSpec): mirror
    rows ("flip") or columns ("flop") inside each image's valid h or w,
    copying the padding beyond it as it is, or swap H and W of the whole
    bucket ("transpose")."""
    xf = x.float()
    if mode == "transpose":
        return _finish(xf.permute(0, 2, 1, 3).contiguous(), out_u8)
    axis = 1 if mode == "flip" else 2
    valid = (h if mode == "flip" else w).long()[:, None]
    pos = torch.arange(x.shape[axis], dtype=torch.int64, device=x.device)[None, :]
    idx = torch.where(pos < valid, valid - 1 - pos, pos)
    idx = idx[:, :, None, None] if axis == 1 else idx[:, None, :, None]
    return _finish(torch.take_along_dim(xf, idx, dim=axis), out_u8)


def compose_orient(names) -> tuple:
    """The one mode (t, fy, fx) of a run of orientation stages ("flip",
    "flop", "transpose") applied in order: a flip toggles fy, a flop
    toggles fx, and a transpose toggles t and swaps fy and fx, since a
    mirror pushed past the transpose lands on the other axis (orient.cu)."""
    t = fy = fx = 0
    for name in names:
        if name == "flip":
            fy ^= 1
        elif name == "flop":
            fx ^= 1
        elif name == "transpose":
            t, fy, fx = t ^ 1, fx, fy
        else:
            raise ValueError(f"unknown orient mode {name!r}")
    return t, fy, fx


def _mirror_index(n: int, valid, on: int) -> torch.Tensor:
    """[B, n] source positions: v - 1 - i inside each image's valid v when
    `on`, i elsewhere."""
    pos = torch.arange(n, dtype=torch.int64, device=valid.device)[None, :]
    v = valid.long()[:, None]
    if not on:
        return pos.expand(v.shape[0], n)
    return torch.where(pos < v, v - 1 - pos, pos)


def orient_run(x: torch.Tensor, h, w, names, out_u8: bool = False) -> torch.Tensor:
    """K5's function for a run of orientation stages, computed directly as
    the composed index map (orient.cu): with (t, fy, fx) =
    `compose_orient(names)` and (ho, wo) the output's valid dims,
    out[b, y, x] = x[b, mx(x), my(y)] if t else x[b, my(y), mx(x)], my
    mirroring rows inside ho and mx columns inside wo when set."""
    t, fy, fx = compose_orient(names)
    bsz, hb, wb, c = x.shape
    ho, wo = (w, h) if t else (h, w)
    oh, ow = (wb, hb) if t else (hb, wb)
    rows = _mirror_index(oh, ho, fy)[:, :, None].expand(bsz, oh, ow)
    cols = _mirror_index(ow, wo, fx)[:, None, :].expand(bsz, oh, ow)
    src_r, src_c = (cols, rows) if t else (rows, cols)
    flat = x.float().reshape(bsz, hb * wb, c)
    idx = (src_r * wb + src_c).reshape(bsz, oh * ow, 1).expand(bsz, oh * ow, c)
    return _finish(torch.gather(flat, 1, idx).reshape(bsz, oh, ow, c), out_u8)


def flop_shard(x: torch.Tensor, h, w, col0: int, lw: int, in_col0: int,
               out_u8: bool = False) -> torch.Tensor:
    """K5's flop on a W-shard: global column g of [col0, col0 + lw) reads
    w - 1 - g inside the valid width, from x holding the mirrored input
    columns from in_col0, and g in the padding, from the shard's padding
    columns that end x."""
    x_ = torch.arange(lw, dtype=torch.int64, device=x.device)[None, :]
    g = col0 + x_
    valid = w.long()[:, None]
    src = torch.where(g < valid, valid - 1 - g - in_col0, x.shape[2] - lw + x_)
    return _finish(torch.take_along_dim(x.float(), src[:, None, :, None], dim=2), out_u8)


def blur_taps(sigma: torch.Tensor, radius: int) -> torch.Tensor:
    """[B, 2r+1] normalised Gaussian taps, the delta where sigma <= 0
    (stages.py:BlurSpec)."""
    taps = torch.arange(-radius, radius + 1, dtype=torch.float32,
                        device=sigma.device)[None, :]
    s = torch.clamp(sigma.float(), min=1e-3)[:, None]
    kern = torch.exp(-0.5 * (taps / s) ** 2)
    kern = kern / kern.sum(dim=-1, keepdim=True)
    delta = (taps.abs() < 0.5).float()
    return torch.where(sigma[:, None] > 0, kern, delta)


def _correlate_rows(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-image 2r+1-tap correlation of img [B, H, W, C] along H,
    zero-padded beyond the bucket ("SAME")."""
    r = (k.shape[1] - 1) // 2
    n = img.shape[1]
    padded = torch.nn.functional.pad(img, (0, 0, 0, 0, r, r))
    out = torch.zeros_like(img)
    for i in range(2 * r + 1):
        tap = k[:, i][:, None, None, None]
        out = out + tap * padded.narrow(1, i, n)
    return out


def blur(x: torch.Tensor, h, w, sigma, radius: int, out_u8: bool = False) -> torch.Tensor:
    """K6's function (stages.py:BlurSpec): separable Gaussian, vertical then
    horizontal, normalised against the valid mask, zero outside each
    image's valid (h, w). The whole image is K13's one shard, with no
    halos."""
    return blur_halo(x, None, None, h, w, sigma, radius, 0, x.shape[2], out_u8)


def blur_halo(x: torch.Tensor, left, right, h, w, sigma, radius: int, col0: int,
              wb: int, out_u8: bool = False) -> torch.Tensor:
    """K13's function: the masked Gaussian of the whole image (K6's) at one
    W-shard's columns. x [B, Hb, lw, C] holds global columns [col0, col0 +
    lw) of a bucket wb wide, left and right [B, Hb, radius, C] the
    neighbouring columns (None: outside the bucket, read as 0). The shard
    and its halos are laid side by side; conv_v(x * m) and conv_v(m) run
    over them, then the horizontal taps over the shard's columns, each as
    shifted sums in ascending tap order on global columns, so every
    output takes the same operations in the same order whatever the
    shards: the shards equal the whole image bit for bit."""
    xf = x.float()
    bsz, hb, lw, c = xf.shape
    dev = x.device

    def halo(t):
        if t is None:
            return torch.zeros((bsz, hb, radius, c), dtype=torch.float32, device=dev)
        return t.float()

    ext = torch.cat([halo(left), xf, halo(right)], dim=2)
    k = blur_taps(sigma, radius)
    iy = torch.arange(hb, dtype=torch.int32, device=dev)[None, :, None]
    ix = col0 - radius + torch.arange(lw + 2 * radius, dtype=torch.int32,
                                      device=dev)[None, None, :]
    m = ((iy < h[:, None, None]) & (ix >= 0) & (ix < wb)
         & (ix < w[:, None, None])).float()[..., None]
    v = _correlate_rows(ext * m, k)
    vm = _correlate_rows(m, k)
    num = torch.zeros_like(xf)
    den = torch.zeros((bsz, hb, lw, 1), dtype=torch.float32, device=dev)
    for i in range(2 * radius + 1):
        tap = k[:, i][:, None, None, None]
        num = num + tap * v[:, :, i:i + lw]
        den = den + tap * vm[:, :, i:i + lw]
    out = num / torch.clamp(den, min=_EPS)
    core = m[:, :, radius:radius + lw]
    return _finish(torch.where(core > 0, out, 0.0), out_u8)


def composite(x: torch.Tensor, overlay, top, left, opacity, block_h, block_w,
              replicate: bool, out_u8: bool = False) -> torch.Tensor:
    """K7's function (stages.py:CompositeSpec): the RGBA overlay block,
    tiled (replicate) or placed once at (top, left), alpha-blended over
    every pixel of the bucket; x's alpha passes through."""
    xf = x.float()
    bsz, hb, wb, c = xf.shape
    bhb, bwb = overlay.shape[1], overlay.shape[2]
    dev = x.device
    bh = block_h.long()[:, None]
    bw = block_w.long()[:, None]
    iy = torch.arange(bhb, device=dev)[None, :]
    ix = torch.arange(bwb, device=dev)[None, :]
    ovl = overlay.float() * ((iy < bh)[:, :, None] & (ix < bw)[:, None, :])[..., None]
    ys = torch.arange(hb, device=dev)[None, :]
    xs = torch.arange(wb, device=dev)[None, :]
    bidx = torch.arange(bsz, device=dev)[:, None, None]
    if replicate:
        gy = torch.clamp(torch.remainder(ys - top.long()[:, None],
                                         torch.clamp(bh, min=1)), max=bhb - 1)
        gx = torch.clamp(torch.remainder(xs - left.long()[:, None],
                                         torch.clamp(bw, min=1)), max=bwb - 1)
        canvas = ovl[bidx, gy[:, :, None], gx[:, None, :]]
    else:
        ry = ys - top.long()[:, None]
        rx = xs - left.long()[:, None]
        iny = (ry >= 0) & (ry < bh)
        inx = (rx >= 0) & (rx < bw)
        gy = torch.clamp(ry, 0, bhb - 1)
        gx = torch.clamp(rx, 0, bwb - 1)
        canvas = ovl[bidx, gy[:, :, None], gx[:, None, :]]
        canvas = canvas * (iny[:, :, None] & inx[:, None, :])[..., None]
    op = torch.clamp(opacity.float(), 0.0, 1.0)[:, None, None, None]
    alpha = canvas[..., 3:4] / 255.0 * op
    rgb = xf[..., :3] * (1.0 - alpha) + canvas[..., :3] * alpha
    out = torch.cat([rgb, xf[..., 3:]], dim=-1) if c == 4 else rgb
    return _finish(out.contiguous(), out_u8)


def gray(x: torch.Tensor, out_u8: bool = False) -> torch.Tensor:
    """K8's function (stages.py:GraySpec): Rec.709 luma broadcast over RGB,
    alpha kept."""
    xf = x.float()
    lum = 0.2126 * xf[..., 0:1] + 0.7152 * xf[..., 1:2] + 0.0722 * xf[..., 2:3]
    parts = [lum, lum, lum] + ([xf[..., 3:]] if xf.shape[3] == 4 else [])
    return _finish(torch.cat(parts, dim=-1), out_u8)


def saliency_ii(x: torch.Tensor, h, w) -> torch.Tensor:
    """K9's function (ops/saliency.py:_saliency_map and the integral image
    of smart_offsets): f32 [B, Hb + 1, Wb + 1] integral image of the
    saliency of x [B, Hb, Wb, C >= 3] (uint8 or f32)."""
    return _saliency.integral_image(_saliency.saliency_map(x, h, w))


def window_argmax(ii: torch.Tensor, h, w, win_h, win_w) -> tuple:
    """K10's function (smart_offsets.one): (top, left) int32 [B]."""
    return _saliency.window_argmax(ii, h, w, win_h, win_w)


SAL_LANES = _saliency.LANES
_SIGN64 = -(2 ** 63)  # the sign bit of an int64: XOR with it orders keys unsigned


def saliency_rows_shard(x: torch.Tensor, left, right, h, w, col0: int, wb: int) -> tuple:
    """K9's row pass on a W-shard (`kernels.saliency_rows_shard`): the
    shard's columns and halos placed at their global columns of a zero
    bucket, whose saliency map is computed whole (the same elementwise
    passes as the whole image's, so every column the halos reach is the
    whole image's bit for bit); then (sal over [col0 - per + 1, col0 + lw
    + per - 1), the totals of the segments that start in [col0, col0 +
    lw))."""
    bsz, hb, lw, c = x.shape
    per = -(-wb // SAL_LANES)
    e = per - 1
    full = torch.zeros((bsz, hb, wb, c), dtype=torch.float32, device=x.device)
    full[:, :, col0:col0 + lw] = x.float()
    if left is not None:
        full[:, :, col0 - per:col0] = left.float()
    if right is not None:
        full[:, :, col0 + lw:col0 + lw + per] = right.float()
    sal = torch.nn.functional.pad(_saliency.saliency_map(full, h, w),
                                  (e, SAL_LANES * per - wb + e))
    ext = sal[:, :, col0:col0 + lw + 2 * e]  # global col0 - e at col0 of the padded
    g0, g1 = -(-col0 // per), -(-(col0 + lw) // per)
    seg = sal[:, :, e + g0 * per:e + g1 * per]
    return ext.contiguous(), _saliency.segment_totals(seg, per)


def saliency_scan_shard(sal: torch.Tensor, totals: torch.Tensor, col0: int, lw: int,
                        wb: int) -> torch.Tensor:
    """K9's scan and column pass on a W-shard: every segment total scanned
    as the whole row is (`ops/saliency.scan_totals`), the running sums of
    the segments over the shard's columns from their exclusive prefixes
    (over the row pass's extension), then cumsum over H -> [B, Hb + 1,
    lw], the whole image's ii columns [col0 + 1, col0 + lw + 1)."""
    per = -(-wb // SAL_LANES)
    e = per - 1
    tot = torch.nn.functional.pad(totals, (0, SAL_LANES - totals.shape[2]))
    prefix = _saliency.exclusive(_saliency.scan_totals(tot))
    s0, s1 = col0 // per, -(-(col0 + lw) // per)
    region = sal[:, :, s0 * per - (col0 - e):s1 * per - (col0 - e)]
    runs = _saliency.segment_runs(region, prefix[..., s0:s1], per)
    mine = runs[:, :, col0 - s0 * per:col0 - s0 * per + lw]
    return torch.nn.functional.pad(torch.cumsum(mine, dim=1), (0, 0, 1, 0))


def score_keys(s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K10's keys as int64 bit patterns of its uint64: the order-preserving
    bits of the f32 score (-0 read as +0) above the complement of the
    index, so the larger key is the larger score, then the smaller index
    (`jnp.argmax`'s first maximum)."""
    s = torch.where(s == 0, torch.zeros_like(s), s)
    u = s.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return (u << 32) | (~idx.to(torch.int64) & 0xFFFFFFFF)


def max_key(keys: torch.Tensor, dim: int) -> torch.Tensor:
    """The unsigned maximum of int64 key bit patterns along dim."""
    return (keys ^ _SIGN64).max(dim=dim).values ^ _SIGN64


def decode_keys(keys: torch.Tensor, key_wb: int) -> tuple:
    """(top, left) int32 [B] of the best of keys int64 [B, n], an index over
    a bucket key_wb wide (0, 0 when every key is 0)."""
    best = max_key(keys, 1)
    i = torch.where(best == 0, torch.zeros_like(best), ~best & 0xFFFFFFFF)
    return (i // key_wb).to(torch.int32), (i % key_wb).to(torch.int32)


def window_argmax_shard(ii: torch.Tensor, h, w, win_h, win_w, k0: int, c0: int, c1: int,
                        hb: int, wb: int) -> torch.Tensor:
    """K10 on a W-shard: every valid candidate whose left lies in [c0, c1)
    scored as `window_argmax` scores it, from ii columns [k0, k0 + kw) of
    the rows [0, nr) (its tops) and [win_h, win_h + nr) (its bottoms),
    stacked in ii [B, 2 nr, kw] and placed in zero rows of the bucket's
    width, and the whole image's first masked candidate at -1 (the
    kernel's keys exactly; the shards' best is `window_argmax`'s choice);
    the best key, int64 [B]."""
    bsz, rows, kw = ii.shape
    nr, dev = rows // 2, ii.device
    c1 = min(c1, wb)
    full = torch.zeros((bsz, rows, wb + 1), dtype=torch.float32, device=dev)
    full[:, :, k0:k0 + kw] = ii
    tops = torch.arange(min(nr, hb), dtype=torch.int64, device=dev)
    lefts = torch.arange(c0, max(c1, c0), dtype=torch.int64, device=dev)
    bidx = torch.arange(bsz, device=dev)[:, None, None]
    right = torch.clamp(lefts[None, :] + win_w.long()[:, None], 0, wb)[:, None, :]
    t, left = tops[None, :, None], lefts[None, None, :]
    bot = nr + t
    s = ((full[bidx, bot, right] - full[bidx, t, right])
         - (full[bidx, bot, left] - full[bidx, t, left]))
    lim_t = h.long() - win_h.long()
    lim_l = w.long() - win_w.long()
    ok = (t <= lim_t[:, None, None]) & (left <= lim_l[:, None, None])
    keys = torch.where(ok, score_keys(s, t * wb + left), 0).reshape(bsz, -1)
    # the first masked candidate in row-major order, where there is one
    m = torch.where((lim_t < 0) | (lim_l < 0), 0,
                    torch.where(lim_l + 1 < wb, lim_l + 1,
                                torch.where(lim_t + 1 < hb, (lim_t + 1) * wb, -1)))
    masked = torch.where(m >= 0, score_keys(torch.full((bsz,), -1.0, device=dev), m), 0)
    return max_key(torch.cat([keys, masked[:, None]], dim=1), 1)


# stages.py:_idct_basis(k) for k = 1, 2, 4, 8, bit for bit: the f32 words
# XLA's cos and sqrt give it (torch's f32 cos differs in one entry of k = 8),
# row-major C[u, x]; kernels/csrc/dct_basis.cuh holds the same words
_IDCT_BASIS_BITS = {
    1: (
        0x3eb504f3,
    ),
    2: (
        0x3eb504f3, 0x3eb504f3, 0x3eb504f3, 0xbeb504f3,
    ),
    4: (
        0x3eb504f3, 0x3eb504f3, 0x3eb504f3, 0x3eb504f3, 0x3eec835d, 0x3e43ef15,
        0xbe43ef18, 0xbeec835f, 0x3eb504f2, 0xbeb504f2, 0xbeb504f1, 0x3eb504f7,
        0x3e43ef15, 0xbeec835d, 0x3eec835f, 0xbe43ef25,
    ),
    8: (
        0x3eb504f3, 0x3eb504f3, 0x3eb504f3, 0x3eb504f3, 0x3eb504f3, 0x3eb504f3,
        0x3eb504f3, 0x3eb504f3, 0x3efb14be, 0x3ed4db31, 0x3e8e39d9, 0x3dc7c5bc,
        0xbdc7c5c2, 0xbe8e39dc, 0xbed4db32, 0xbefb14bf, 0x3eec835e, 0x3e43ef15,
        0xbe43ef18, 0xbeec8360, 0xbeec835e, 0xbe43ef0b, 0x3e43ef1b, 0x3eec835f,
        0x3ed4db31, 0xbdc7c5c2, 0xbefb14bf, 0xbe8e39d6, 0x3e8e39dd, 0x3efb14be,
        0x3dc7c5b1, 0xbed4db34, 0x3eb504f3, 0xbeb504f3, 0xbeb504f1, 0x3eb504f7,
        0x3eb504f3, 0xbeb504fb, 0xbeb504ef, 0x3eb504f4, 0x3e8e39d9, 0xbefb14bf,
        0x3dc7c5c8, 0x3ed4db2d, 0xbed4db34, 0xbdc7c5bb, 0x3efb14bf, 0xbe8e39e4,
        0x3e43ef15, 0xbeec835e, 0x3eec835f, 0xbe43ef25, 0xbe43ef06, 0x3eec835b,
        0xbeec8362, 0x3e43ef25, 0x3dc7c5bc, 0xbe8e39d6, 0x3ed4db2d, 0xbefb14bd,
        0x3efb14c1, 0xbed4db31, 0x3e8e39e9, 0xbdc7c614,
    ),
}


@functools.lru_cache(maxsize=None)
def idct_basis(k: int, device=None) -> torch.Tensor:
    """stages.py:_idct_basis(k), C[u, x] = beta_u cos((2x+1) u pi / 2k)
    times sqrt(k/8), as the reference's f32 words (`_IDCT_BASIS_BITS`),
    made once a device (callers never write to it)."""
    words = np.array(_IDCT_BASIS_BITS[k], dtype=np.uint32).view(np.float32)
    return torch.from_numpy(words.reshape(k, k)).to(device)


def _idct(plane: torch.Tensor, kv: int, kh: int) -> torch.Tensor:
    """Per-block k-point IDCT of plane [B, ph, pw] (kv x kh blocks), +128:
    the reference's einsum "brucv,ux,vz->brxcz" summed over v, then over
    u, each in index order from 0 with every product and sum rounded on
    its own, as K11 sums. Elementwise tensor ops only, so a block's
    samples never depend on the plane's size (a W-shard's IDCT equals the
    whole image's bit for bit)."""
    bsz, ph, pw = plane.shape
    bv = idct_basis(kv, plane.device)
    bh = idct_basis(kh, plane.device)
    blk = plane.reshape(bsz, ph // kv, kv, pw // kh, kh)
    t = torch.zeros_like(blk)
    for v in range(kh):
        t = t + blk[..., v:v + 1] * bh[v]
    out = torch.zeros_like(blk)
    for u in range(kv):
        out = out + bv[u][:, None, None] * t[:, :, u:u + 1]
    return out.reshape(bsz, ph, pw) + 128.0


def from_dct(x: torch.Tensor, h, w, hb: int, wb: int, k: int,
             layout: str) -> torch.Tensor:
    """K11's function (stages.py:FromDctSpec with the chain's cast):
    dequantized, frequency-folded int16 coefficients in the packed layout
    of `layout` and `k` -> f32 RGB [B, hb, wb, 3]."""
    xf = x.float()
    if layout == "gray":
        y = _idct(xf[..., 0], k, k)
        return torch.clamp(torch.stack([y, y, y], dim=-1), 0.0, 255.0)
    if layout == "444":
        return _ycc_to_rgb(_idct(xf[..., 0], k, k), _idct(xf[..., 1], k, k) - 128.0,
                           _idct(xf[..., 2], k, k) - 128.0)
    if layout == "422":
        if k == 8:
            y = _idct(xf[:, :hb, :, 0], 8, 8)
            u = _idct(xf[:, hb:, : wb // 2, 0], 8, 8)
            v = _idct(xf[:, hb:, wb // 2:, 0], 8, 8)
            j0, j1, s = _chroma_up_indices(wb, (w.long() + 1) // 2, wb // 2)
            return _ycc_to_rgb(y, _up2(u, None, None, None, j0, j1, s) - 128.0,
                               _up2(v, None, None, None, j0, j1, s) - 128.0)
        return _ycc_to_rgb(_idct(xf[..., 0], k, k), _idct(xf[..., 1], k, 2 * k) - 128.0,
                           _idct(xf[..., 2], k, 2 * k) - 128.0)
    if k == 8:
        y = _idct(xf[:, :hb, :, 0], 8, 8)
        u = _idct(xf[:, hb:, : wb // 2, 0], 8, 8)
        v = _idct(xf[:, hb:, wb // 2:, 0], 8, 8)
        return _yuv420_planes_to_rgb(y, u, v, h, w, hb, wb)
    return _ycc_to_rgb(_idct(xf[..., 0], k, k), _idct(xf[..., 1], 2 * k, 2 * k) - 128.0,
                       _idct(xf[..., 2], 2 * k, 2 * k) - 128.0)


def dct_halo_blocks(col0: int, lw: int, w, wb: int) -> tuple:
    """The chroma blocks (global 8-column block indices of U's and V's
    planes) K11's W-shard form takes as its left and right halos at 4:2:0
    and 4:2:2, k = 8, for output columns [col0, col0 + lw) of a bucket wb
    wide whose valid width is w (an int, or an int tensor [B]): the blocks
    beside its own, each clamped to the block that holds the valid chroma
    edge hi = (w + 1) / 2 - 1, so that every chroma column the shard's taps
    read after the clamp to [0, hi] lies in its window (a shard wholly past
    the valid width reads column hi alone, in its left halo block).
    csrc/from_dct.cu maps the blocks the same way."""
    if isinstance(w, torch.Tensor):
        hi = torch.clamp(torch.clamp((w.long() + 1) // 2 - 1, min=0), max=wb // 2 - 1)
        last = hi // 8
        return (torch.clamp(torch.minimum(torch.full_like(last, col0 // 16 - 1), last), min=0),
                torch.minimum(torch.full_like(last, (col0 + lw) // 16), last))
    hi = min(max((int(w) + 1) // 2 - 1, 0), wb // 2 - 1)
    return max(min(col0 // 16 - 1, hi // 8), 0), min((col0 + lw) // 16, hi // 8)


def from_dct_shard(x: torch.Tensor, left, right, h, w, hb: int, lw: int, k: int,
                   layout: str, col0: int, wb: int) -> torch.Tensor:
    """K11's W-shard form: the shard's packed coefficients (`from_dct`'s
    layout at width lw, holding output columns [col0, col0 + lw) of a
    bucket wb wide) and, at 4:2:0 and 4:2:2 with k = 8, its chroma halos
    [B, chroma rows, 16, 1] (U's block `dct_halo_blocks` names, then V's)
    -> f32 RGB [B, hb, lw, 3], equal to `from_dct`'s columns [col0, col0 +
    lw) bit for bit. The other layouts are column-local: `from_dct` on
    the shard's own blocks. At k = 8 the window [left block, own columns,
    right block] of each chroma plane is transformed, and each pixel takes
    the whole image's clamped taps, mapped into the window."""
    if not (k == 8 and layout in ("420", "422")):
        return from_dct(x, h, w, hb, lw, k, layout)
    xf = x.float()
    cw = lw // 2
    y = _idct(xf[:, :hb, :, 0], 8, 8)

    def window(p):
        own = xf[:, hb:, p * cw:(p + 1) * cw, 0]
        lf = left[:, :, p * 8:(p + 1) * 8, 0].float()
        rf = right[:, :, p * 8:(p + 1) * 8, 0].float()
        return _idct(torch.cat([lf, own, rf], dim=2), 8, 8)

    lo, hi_blk = dct_halo_blocks(col0, lw, w, wb)
    j0g, j1g, s = _chroma_up_indices(lw, (w.long() + 1) // 2, wb // 2, col0)
    a, b = col0 // 2, (col0 + lw) // 2

    def to_window(j):
        return torch.where(j < a, j - 8 * lo[:, None],
                           torch.where(j < b, 8 + j - a, 8 + cw + j - 8 * hi_blk[:, None]))

    j0, j1 = to_window(j0g), to_window(j1g)
    u, v = window(0), window(1)
    if layout == "420":
        i0, i1, t = _chroma_up_indices(hb, (h.long() + 1) // 2, hb // 2)
    else:
        i0 = i1 = t = None
    return _ycc_to_rgb(y, _up2(u, i0, i1, t, j0, j1, s) - 128.0,
                       _up2(v, i0, i1, t, j0, j1, s) - 128.0)


def _pool2(c: torch.Tensor) -> torch.Tensor:
    """The plain 2x2 mean of c [B, H, W]: ((a + b) + c) + d, then * 0.25
    (the same number as / 4), in K12's order."""
    q = c.reshape(c.shape[0], c.shape[1] // 2, 2, c.shape[2] // 2, 2)
    return (((q[:, :, 0, :, 0] + q[:, :, 0, :, 1]) + q[:, :, 1, :, 0])
            + q[:, :, 1, :, 1]) * 0.25


def _to_dct_replicated(x: torch.Tensor, qy, qc, hb: int, wb: int) -> torch.Tensor:
    """K12 on f32 RGB [B, hb, wb, 3] whose bucket padding already
    replicates the valid edge: BT.601, the 2x2 chroma mean, the 8x8 FDCT
    (the reference's einsum "brxcz,ux,vz->brucv" summed over z, then over
    x, in index order, each product and sum rounded on its own, as K12
    sums: a block's coefficients never depend on the buffer's size), the
    division by qy / qc and the round half to even -> int16 [B, hb + hb/2,
    wb, 1]."""
    bsz = x.shape[0]
    x = torch.clamp(x, 0.0, 255.0)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    basis = idct_basis(8, x.device)

    def fdct_q(plane, q, ph, pw):
        blk = plane.reshape(bsz, ph // 8, 8, pw // 8, 8) - 128.0
        t = torch.zeros_like(blk)
        for z in range(8):
            t = t + blk[..., z:z + 1] * basis[:, z]
        coef = torch.zeros_like(blk)
        for k in range(8):
            coef = coef + basis[:, k][:, None, None] * t[:, :, k:k + 1]
        q = q.float()[:, None, :, None, :]
        return torch.round(coef / q).reshape(bsz, ph, pw)

    bottom = torch.cat([fdct_q(_pool2(cb), qc, hb // 2, wb // 2),
                        fdct_q(_pool2(cr), qc, hb // 2, wb // 2)], dim=2)
    packed = torch.cat([fdct_q(y, qy, hb, wb), bottom], dim=1)[..., None]
    return torch.clamp(packed, -32768.0, 32767.0).to(torch.int16)


def _replicate(x: torch.Tensor, h, w, hb: int, c0: int, c1: int, k0: int) -> torch.Tensor:
    """Columns [c0, c1) and rows [0, hb) of an image whose valid pixels
    replicate outward (each index clamped to h - 1, w - 1), from x, which
    holds the global columns [k0, k0 + x.shape[2])."""
    dev = x.device
    iy = torch.minimum(torch.arange(hb, device=dev)[None, :],
                       torch.clamp(h.long() - 1, min=0)[:, None])
    ix = torch.minimum(torch.arange(c0, c1, device=dev)[None, :],
                       torch.clamp(w.long() - 1, min=0)[:, None]) - k0
    if bool((ix < 0).any()) or bool((ix >= x.shape[2]).any()):
        raise ValueError(f"columns [{c0}, {c1}) read outside the window "
                         f"[{k0}, {k0 + x.shape[2]})")
    bidx = torch.arange(x.shape[0], device=dev)[:, None, None]
    return x.float()[bidx, iy[:, :, None], ix[:, None, :]]


def to_dct(x: torch.Tensor, h, w, qy, qc, hb: int, wb: int) -> torch.Tensor:
    """K12's function (stages.py:ToDctSpec + the int16 drain of
    chain.py:_run_chain): f32 RGB [B, hb, wb, 3] -> quantized int16
    [B, hb + hb/2, wb, 1] coefficients (Y above, U|V below), edges
    replicated, chroma the plain 2x2 mean, 8x8 FDCT, divided by the
    per-image qy / qc [B, 8, 8] and rounded half to even."""
    return _to_dct_replicated(_replicate(x, h, w, hb, 0, wb, 0), qy, qc, hb, wb)


def to_dct_shard(x: torch.Tensor, h, w, qy, qc, hb: int, lw: int, col0: int,
                 k0: int, wb: int) -> torch.Tensor:
    """K12's W-shard form: x f32 [B, hb, kw, 3] holds the input's global
    columns [k0, k0 + kw), every column the whole MCUs [16 floor(col0 /
    16), 16 ceil((col0 + lw) / 16)) read after the clamp to w - 1 -> the
    shard's own coefficients int16 [B, hb + hb/2, lw, 1]: Y's columns
    [col0, col0 + lw), then U's and V's [col0/2, (col0 + lw)/2) side by
    side, equal to `to_dct`'s bit for bit. The MCUs are computed whole
    and their columns outside the shard dropped."""
    m0, m1 = col0 // 16 * 16, -(-(col0 + lw) // 16) * 16
    full = _to_dct_replicated(_replicate(x, h, w, hb, m0, m1, k0), qy, qc, hb, m1 - m0)
    half, a, cw = (m1 - m0) // 2, (col0 - m0) // 2, lw // 2
    bottom = full[:, hb:]
    return torch.cat([full[:, :hb, col0 - m0:col0 - m0 + lw],
                      torch.cat([bottom[:, :, a:a + cw], bottom[:, :, half + a:half + a + cw]],
                                dim=2)], dim=1)
