"""The plain reference's arithmetic: decode, colour, geometry and
resample, in plain PyTorch on the CPU (float64 unless a caller asks for
another precision) with Pillow for the codec.

Nothing here imports the program. The semantics are imaginary's (bimg and
libvips), as the upstream project documents them: lanczos3 resampling
with its support widened by the downscale factor and each output row's
weights normalised to 1; shrink-on-load by libjpeg's DCT scaling; an
edge-copying embed; JFIF (BT.601 full-range) YCbCr.

JPEG leaves the rebuilding of 4:2:0 chroma to the decoder, and the
configuration states the decoder's (`chroma` in its file): the chroma
planes as libjpeg decodes them, at half the luma's size (at a DCT-scaled
decode libjpeg gives them at the luma's size, and they are averaged 2x2,
rounding half up), upsampled by the centred linear filter of libjpeg's
fancy upsampling (weights 3/4 and 1/4 each way) without its rounding to
integers. Luma never depends on it: without clipping, RGB's round trip
gives every pixel its luma back.

A frame is a float tensor [H, W, 3] of RGB on the 0-255 scale. `dtype`
is the precision every stage stores its result in: float64 for the
reference, bfloat16 for the control (`benchmark/control.py`).
"""

from __future__ import annotations

import io
import math

import numpy as np
import torch
from PIL import Image

REF = torch.float64

# --- decode -----------------------------------------------------------------


def image_size(body: bytes) -> tuple:
    """(width, height) from the image's header."""
    with Image.open(io.BytesIO(body)) as im:
        return im.size


def _ycc_planes(body: bytes, shrink: int) -> np.ndarray:
    """[h, w, 3] uint8 YCbCr of a JPEG decoded by libjpeg at 1/shrink (its
    DCT scaling; Pillow's draft mode), chroma at the luma's size."""
    with Image.open(io.BytesIO(body)) as im:
        w, h = im.size
        im.draft("YCbCr", (-(-w // shrink), -(-h // shrink)))
        if im.mode != "YCbCr":
            raise ValueError(f"expected a YCbCr JPEG, got mode {im.mode}")
        return np.asarray(im, dtype=np.uint8).copy()


def _average2(c: np.ndarray) -> np.ndarray:
    """2x2 means of a plane, rounding half up; a lone last row or column
    is paired with itself."""
    c = c.astype(np.int32)
    if c.shape[0] % 2:
        c = np.concatenate([c, c[-1:]], axis=0)
    if c.shape[1] % 2:
        c = np.concatenate([c, c[:, -1:]], axis=1)
    return ((c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2] + 2) // 4
            ).astype(np.uint8)


def _upsample_axis(c: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """Output i of n along `axis` blends the samples beside (i + 0.5) / 2 -
    0.5, indices clamped to the plane."""
    pos = torch.arange(n, dtype=torch.float64) * 0.5 - 0.25
    lo = torch.floor(pos)
    t = (pos - lo).to(c.dtype)
    last = c.shape[axis] - 1
    i0 = torch.clamp(lo.long(), 0, last)
    i1 = torch.clamp(lo.long() + 1, 0, last)
    if axis == 0:
        return c[i0] * (1.0 - t[:, None]) + c[i1] * t[:, None]
    return c[:, i0] * (1.0 - t[None, :]) + c[:, i1] * t[None, :]


def decode_jpeg(body: bytes, shrink: int, dtype=REF) -> torch.Tensor:
    """A 4:2:0 JPEG decoded at 1/shrink by libjpeg's DCT scaling to RGB:
    its luma as libjpeg decodes it, its chroma rebuilt as the module's
    docstring says, JFIF's BT.601 in `dtype`."""
    ycc = _ycc_planes(body, shrink)
    h, w = ycc.shape[:2]
    if shrink == 1:
        # at 1/2, libjpeg decodes chroma with its full 8x8 IDCT and hands
        # it on unscaled: the planes a full-size decode upsamples
        half = _ycc_planes(body, 2)[..., 1:]
        chroma = [half[..., 0], half[..., 1]]
    else:
        chroma = [_average2(ycc[..., 1]), _average2(ycc[..., 2])]
    if chroma[0].shape != ((h + 1) // 2, (w + 1) // 2):
        raise ValueError(f"chroma {chroma[0].shape} is not 4:2:0 of {h}x{w}")
    up = [_upsample_axis(_upsample_axis(torch.from_numpy(c).to(dtype), h, 0), w, 1)
          for c in chroma]
    y = torch.from_numpy(ycc[..., 0]).to(dtype)
    return ycc_to_rgb(torch.stack([y, up[0], up[1]], dim=-1))


def ycc_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    y, cb, cr = ycc[..., 0], ycc[..., 1] - 128.0, ycc[..., 2] - 128.0
    rgb = torch.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr, y + 1.772 * cb],
                      dim=-1)
    return torch.clamp(rgb, 0.0, 255.0)


def rgb_to_ycc(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return torch.stack([0.299 * r + 0.587 * g + 0.114 * b,
                        -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
                        0.5 * r - 0.418688 * g - 0.081312 * b + 128.0], dim=-1)


def to_u8(x: torch.Tensor) -> np.ndarray:
    """Clip, round half up: a frame as 8-bit samples."""
    return torch.floor(torch.clamp(x.double(), 0.0, 255.0) + 0.5).to(torch.uint8).numpy()


# --- geometry (bimg's dimension rules) ---------------------------------------


def vips_round(x: float) -> int:
    return int(math.floor(x + 0.5))


def embed_size(cur_h: int, cur_w: int, width: int, height: int) -> tuple:
    """(resized h, w) of bimg's embed path (no enlargement)."""
    if width and height:
        scale = min(width / cur_w, height / cur_h)
    elif width:
        scale = width / cur_w
    else:
        scale = height / cur_h
    scale = min(scale, 1.0)
    return max(1, vips_round(cur_h * scale)), max(1, vips_round(cur_w * scale))


def crop_size(cur_h: int, cur_w: int, width: int, height: int) -> tuple:
    """(resized h, w, top, left, out h, out w) of bimg's crop path, centre
    gravity, no enlargement."""
    tw, th = width or cur_w, height or cur_h
    scale = min(max(tw / cur_w, th / cur_h), 1.0)
    rw, rh = max(1, vips_round(cur_w * scale)), max(1, vips_round(cur_h * scale))
    ew, eh = min(tw, rw), min(th, rh)
    return rh, rw, (rh - eh) // 2, (rw - ew) // 2, eh, ew


def shrink_on_load(src_h: int, src_w: int, out_dims, resized_dims) -> int:
    """libvips' shrink-on-load: the largest JPEG scale denominator in
    (8, 4, 2) at whose decoded size (ceil(dim / n)) the operation gives the
    same output and resample sizes and still only shrinks, else 1.
    `out_dims(h, w)` and `resized_dims(h, w)` give the operation's output
    and its resample's size for a source of h x w."""
    want = out_dims(src_h, src_w), resized_dims(src_h, src_w)
    for n in (8, 4, 2):
        sh, sw = -(-src_h // n), -(-src_w // n)
        if sh < 8 or sw < 8:
            continue
        rh, rw = resized_dims(sh, sw)
        if (out_dims(sh, sw), (rh, rw)) == want and rh <= sh and rw <= sw:
            return n
    return 1


# --- resample -----------------------------------------------------------------


def lanczos3(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d.abs() < 3.0, torch.sinc(d) * torch.sinc(d / 3.0),
                       torch.zeros((), dtype=d.dtype))


def sample_matrix(n_out: int, n_in: int) -> torch.Tensor:
    """[n_out, n_in] lanczos3 weights in float64: output pixel y centred at
    (y + 0.5) / scale - 0.5 in the source, the kernel stretched by the
    downscale factor, each row normalised to 1."""
    scale = n_out / n_in
    centre = (torch.arange(n_out, dtype=torch.float64) + 0.5) / scale - 0.5
    stretch = max(1.0 / scale, 1.0)
    d = (torch.arange(n_in, dtype=torch.float64)[None, :] - centre[:, None]) / stretch
    wts = lanczos3(d)
    return wts / wts.sum(dim=1, keepdim=True)


def resample(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Separable lanczos3 resample of [H, W, C], rows first, in img's dtype."""
    h, w, _ = img.shape
    wy = sample_matrix(out_h, h).to(img.dtype)
    wx = sample_matrix(out_w, w).to(img.dtype)
    t = torch.einsum("yk,kwc->ywc", wy, img)
    return torch.einsum("xw,ywc->yxc", wx, t)


def embed_copy(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Centre img on an out_h x out_w canvas whose other pixels copy the
    nearest edge pixel (bimg's default extend for the embed)."""
    h, w = img.shape[:2]
    oy, ox = (out_h - h) // 2, (out_w - w) // 2
    iy = torch.clamp(torch.arange(out_h) - oy, 0, h - 1)
    ix = torch.clamp(torch.arange(out_w) - ox, 0, w - 1)
    return img[iy][:, ix]
