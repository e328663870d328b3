"""Stage specs of the port, one for one with `imaginary_tpu/ops/stages.py`.

Each stage is a (static spec, dynamic params) pair. Class names and fields
match the reference exactly, so a plan built by either package describes
the same chain and plans compare across the two.

Tensor convention: x is [B, Hb, Wb, C] on one device (uint8 or, for the
DCT transport, int16 only as the first stage's input, float32 in [0, 255]
otherwise), padded to bucket dims; h and w are int32 [B] valid dims; dyn
holds the stage's per-image params as tensors on the same device.
`apply(x, h, w, dyn, out_u8)` returns (x, h, w); with `out_u8` the stage
is the chain's last and also applies the uint8 epilogue (ToDctSpec, whose
`out_dtype` is "int16", drains rounded int16 coefficients instead). A
stage that can end a chain (`donates`) also takes `out=`, the tensor its
last kernel writes into (the chain runner's buffer donation). Every
stage runs one or more of the port's CUDA kernels on a CUDA tensor and
their plain versions on a CPU tensor (`kernels/`).

The stages with a W-shard form (K2, K1, K13, K7, K8, K4's bucket shrink,
K5's flip and K3) also carry the spatial route's side of it
(`_ShardForm`); `ops/chain.launch_spatial` drives them through that
alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from imaginary_tpu_torch import kernels
from imaginary_tpu_torch.options import Extend


def _out_kw(out) -> dict:
    """`out=` for a chain-ending kernel when the chain donates its staged
    buffer (ops/chain.py); nothing otherwise, so the stages also run over
    the plain versions (`kernels.reference`), which take no `out`."""
    return {} if out is None else {"out": out}


class _ShardForm:
    """A stage's W-shard form (the spatial route): shard j of n runs the
    stage on its own columns [col0, col0 + lw) of the stage's output
    bucket. These defaults are a column-local stage's (output column x
    reads input column x only)."""

    # input columns a shard reads past each of its edges, from its
    # neighbours (the exchange fills `left` and `right` that wide)
    shard_halo = 0

    def shard_ok(self, lw: int, first: bool) -> bool:
        """Whether the stage runs W-sharded at local output width lw;
        `first`: it would be the first sharded stage, whose input is
        staged from the host."""
        return True

    def shard_window(self, c0: int, c1: int, in_w: int, in_wb: int, dyn: dict):
        """The input columns (k0, k1) the stage reads for output columns
        [c0, c1), of an input bucket in_wb wide whose valid width is in_w
        (host params dyn); None: its own columns. A later sharded stage
        with a window gets it from the shards that hold those columns
        (`parallel/spatial.exchange_window`)."""
        return None

    def shard_input(self, img: np.ndarray, c0: int, c1: int, w: int, dyn: dict) -> tuple:
        """The first sharded stage's host input for output columns [c0,
        c1) of the bucket-padded HWC image `img` (valid width w, host
        params dyn): (x, left, right, in_col0), x's first column in the
        bucket and the halos (None where there are none)."""
        win = self.shard_window(c0, c1, w, img.shape[1], dyn)
        if win is not None:
            return img[:, win[0]:win[1]], None, None, win[0]
        wb, r = img.shape[1], self.shard_halo
        left = img[:, c0 - r:c0] if r and c0 > 0 else None
        right = img[:, c1:c1 + r] if r and c1 < wb else None
        return img[:, c0:c1], left, right, c0

    def shard_dyn(self, dyn: dict, col0: int) -> dict:
        """The host params of the shard whose output starts at col0."""
        return dyn

    def shard_valid_w(self, w: int, dyn: dict) -> int:
        """The valid width the stage leaves, from its input's (the host's
        copy of what the kernels carry on the device)."""
        return w

    def shard_assemble(self, host):
        """The chain's output as a host array [B, R, n * lw, C] from the
        last sharded stage's shards, host [n, B, R, lw, C]: the shards'
        columns side by side."""
        n, bsz, rows, lw, c = host.shape
        return host.permute(1, 2, 0, 3, 4).reshape(bsz, rows, n * lw, c).numpy()

    def apply_shard(self, x, left, right, h, w, dyn, col0: int, lw: int,
                    in_col0: int, in_wb: int, out_u8: bool, impl=kernels):
        """`apply` on one shard: x holds input columns [in_col0, ...) of a
        bucket in_wb wide, the output columns [col0, col0 + lw). impl is
        `kernels`, or `kernels.reference` for the plain version. Returns
        (x, h, w) as `apply` does."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SampleSpec(_ShardForm):
    """Separable resample to (dst_h, dst_w) inside an (out_hb, out_wb) bucket
    (kernel K1). dyn: dst_h, dst_w (f32 [B])."""

    out_hb: int
    out_wb: int
    kernel: str = "lanczos3"

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = False, out=None):
        return kernels.resample(x, h, w, dyn["dst_h"], dyn["dst_w"], self.out_hb,
                                self.out_wb, self.kernel, out_u8, **_out_kw(out))

    def shard_window(self, c0, c1, in_w, in_wb, dyn):
        # the union of the output columns' tap ranges
        return kernels.resample_window(self.kernel, in_w, float(dyn["dst_w"][0]),
                                       in_wb, self.out_wb, c0, c1)

    def shard_valid_w(self, w, dyn):
        return int(dyn["dst_w"][0])

    def apply_shard(self, x, left, right, h, w, dyn, col0, lw, in_col0, in_wb,
                    out_u8, impl=kernels):
        return impl.resample(x, h, w, dyn["dst_h"], dyn["dst_w"], self.out_hb,
                             self.out_wb, self.kernel, out_u8, cols=(col0, col0 + lw),
                             in_col0=in_col0, in_wb=in_wb)


@dataclasses.dataclass(frozen=True)
class ExtractSpec:
    """Crop a (new_h, new_w) window at dynamic (top, left), each index
    clamped on its own (kernel K4, window mode).
    dyn: top, left, new_h, new_w (i32 [B])."""

    out_hb: int
    out_wb: int

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = False, out=None):
        out = kernels.gather(x, self.out_hb, self.out_wb, dyn["top"],
                             dyn["left"], mode="window", out_u8=out_u8, **_out_kw(out))
        return out, dyn["new_h"], dyn["new_w"]


_FILL_MODES = (Extend.BLACK, Extend.WHITE, Extend.BACKGROUND)


@dataclasses.dataclass(frozen=True)
class EmbedSpec:
    """Place the image on a (canvas_h, canvas_w) canvas with an extend mode
    (kernel K4: mirror, or clamp with an optional fill).
    dyn: off_y, off_x, canvas_h, canvas_w (i32 [B]), fill (f32 [B, C])."""

    out_hb: int
    out_wb: int
    mode: Extend = Extend.MIRROR

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = False, out=None):
        mode = "mirror" if self.mode is Extend.MIRROR else "clamp"
        fill = dyn["fill"] if self.mode in _FILL_MODES else None
        out = kernels.gather(x, self.out_hb, self.out_wb, dyn["off_y"],
                             dyn["off_x"], h, w, mode=mode, fill=fill,
                             out_u8=out_u8, **_out_kw(out))
        return out, dyn["canvas_h"], dyn["canvas_w"]


@dataclasses.dataclass(frozen=True)
class FlipSpec(_ShardForm):
    """Vertical flip of the valid region; padding rows stay as they are
    (kernel K5, flip)."""

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = False, out=None):
        return kernels.orient(x, h, w, "flip", out_u8, **_out_kw(out)), h, w

    def apply_shard(self, x, left, right, h, w, dyn, col0, lw, in_col0, in_wb,
                    out_u8, impl=kernels):
        # column-local: each column mirrors its own rows inside the valid h
        return impl.orient(x, h, w, "flip", out_u8), h, w


@dataclasses.dataclass(frozen=True)
class FlopSpec:
    """Horizontal flip of the valid region; padding columns stay as they
    are (kernel K5, flop)."""

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = False, out=None):
        return kernels.orient(x, h, w, "flop", out_u8, **_out_kw(out)), h, w


@dataclasses.dataclass(frozen=True)
class TransposeSpec:
    """Swap H and W of the whole bucket, valid dims swapped with it
    (kernel K5, transpose)."""

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = False, out=None):
        return kernels.orient(x, h, w, "transpose", out_u8, **_out_kw(out)), w, h


@dataclasses.dataclass(frozen=True)
class BlurSpec(_ShardForm):
    """Separable gaussian blur, radius static, sigma dynamic, normalised
    against the valid mask and zero outside it (kernel K6). dyn: sigma
    (f32 [B])."""

    radius: int

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = False, out=None):
        out = kernels.blur(x, h, w, dyn["sigma"], self.radius, out_u8, **_out_kw(out))
        return out, h, w

    @property
    def shard_halo(self) -> int:
        return self.radius

    def shard_ok(self, lw: int, first: bool) -> bool:
        # a halo never reaches past the neighbouring shard (K13)
        return self.radius < lw

    def apply_shard(self, x, left, right, h, w, dyn, col0, lw, in_col0, in_wb,
                    out_u8, impl=kernels):
        return impl.blur_halo(x, left, right, h, w, dyn["sigma"], self.radius, col0,
                              in_wb, out_u8), h, w


@dataclasses.dataclass(frozen=True)
class CompositeSpec(_ShardForm):
    """Alpha-blend an RGBA overlay block (watermark), tiled when
    `replicate`, over the whole bucket (kernel K7).
    dyn: overlay (f32 [B, block_hb, block_wb, 4]), top, left, block_h,
    block_w (i32 [B]), opacity (f32 [B])."""

    block_hb: int
    block_wb: int
    replicate: bool = False

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = False, out=None):
        out = kernels.composite(x, dyn["overlay"], dyn["top"], dyn["left"],
                                dyn["opacity"], dyn["block_h"],
                                dyn["block_w"], self.replicate, out_u8, **_out_kw(out))
        return out, h, w

    def shard_dyn(self, dyn, col0):
        # the overlay's left edge in the shard's columns (K7 floors the
        # remainder, so a tiled or placed overlay stays exact across seams)
        return dict(dyn, left=dyn["left"] - np.int32(col0))

    def apply_shard(self, x, left, right, h, w, dyn, col0, lw, in_col0, in_wb,
                    out_u8, impl=kernels):
        out = impl.composite(x, dyn["overlay"], dyn["top"], dyn["left"], dyn["opacity"],
                             dyn["block_h"], dyn["block_w"], self.replicate, out_u8)
        return out, h, w


@dataclasses.dataclass(frozen=True)
class ShrinkBucketSpec(_ShardForm):
    """Static slice of the padded buffer down to a snugger bucket, valid dims
    unchanged (kernel K4, identity window)."""

    out_hb: int
    out_wb: int

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = False, out=None):
        out = kernels.gather(x, self.out_hb, self.out_wb, mode="window",
                             out_u8=out_u8, **_out_kw(out))
        return out, h, w

    def shard_window(self, c0, c1, in_w, in_wb, dyn):
        # output column x reads input column x, but the input bucket is
        # wider, so its shards split elsewhere
        return c0, c1

    def apply_shard(self, x, left, right, h, w, dyn, col0, lw, in_col0, in_wb,
                    out_u8, impl=kernels):
        return impl.gather(x, self.out_hb, lw, mode="window", out_u8=out_u8), h, w


@dataclasses.dataclass(frozen=True)
class FromYuv420Spec(_ShardForm):
    """Unpack the packed YUV420 transport buffer [B, hb + hb/2, wb, 1] into
    RGB: centred 2x chroma upsample, BT.601 full range (kernel K2)."""

    hb: int
    wb: int

    def apply(self, x, h, w, dyn, out_u8: bool = False):
        if out_u8:
            raise ValueError("FromYuv420Spec cannot end a chain")
        return kernels.yuv420_to_rgb(x, h, w, self.hb, self.wb), h, w

    def shard_ok(self, lw, first):
        # it reads the packed host buffer; a chroma column covers two pixels
        return first and lw % 2 == 0

    def shard_input(self, img, c0, c1, w, dyn):
        """The shard's packed buffer [hb + hb/2, lw, 1] (its Y columns,
        then chroma columns c0/2 + k of U and of V) and its one-column
        chroma halos [hb/2, 2, 1] (U, V) on each side, every chroma column
        taken by the clamped index K2 reads for the whole image, so a
        shard past the valid width gets the columns the clamp reaches."""
        hb, cwb, lw = self.hb, self.wb // 2, c1 - c0
        hi = min(max((w + 1) // 2 - 1, 0), cwb - 1)
        # window column k holds chroma column clamp(c0/2 - 1 + k, 0, hi):
        # column 0 left of 0, the columns themselves, column hi past hi
        g0, g1 = c0 // 2 - 1, c1 // 2 + 1
        n = g1 - g0
        below = min(max(-g0, 0), n)  # window columns left of column 0
        s0, s1 = max(g0, 0), min(g1, hi + 1)  # the columns inside [0, hi]
        above = min(max(hi + 1 - g0, 0), n)  # the first past column hi
        win = np.empty((hb // 2, 2, n), dtype=img.dtype)
        img = img[..., 0]  # row copies of a 2-D view run as block copies
        for p, base in enumerate((0, cwb)):
            plane = img[hb:, base:base + hi + 1]
            win[:, p, :below] = plane[:, :1]
            if s1 > s0:
                win[:, p, s0 - g0:s1 - g0] = plane[:, s0:s1]
            win[:, p, above:] = plane[:, hi:]
        x = np.empty((hb + hb // 2, lw), dtype=img.dtype)
        x[:hb] = img[:hb, c0:c1]
        x[hb:, :lw // 2] = win[:, 0, 1:-1]
        x[hb:, lw // 2:] = win[:, 1, 1:-1]
        return x[..., None], win[:, :, :1], win[:, :, -1:], c0

    def apply_shard(self, x, left, right, h, w, dyn, col0, lw, in_col0, in_wb,
                    out_u8, impl=kernels):
        if out_u8:
            raise ValueError("FromYuv420Spec cannot end a chain")
        return impl.yuv420_to_rgb_shard(x, left, right, h, w, self.hb, lw), h, w


@dataclasses.dataclass(frozen=True)
class FromDctSpec:
    """Scaled k-point IDCT of the packed DCT-coefficient buffer (int16
    dequantized, frequency-folded coefficients from codecs/jpeg_dct.py)
    into RGB, with the 4:2:0 / 4:2:2 chroma upsample at k = 8 (kernel
    K11). The input shape per (layout, k) is `kernels.dct_in_shape`'s."""

    hb: int
    wb: int
    k: int
    layout: str = "420"

    def apply(self, x, h, w, dyn, out_u8: bool = False):
        if out_u8:
            raise ValueError("FromDctSpec cannot end a chain")
        return kernels.from_dct(x, h, w, self.hb, self.wb, self.k, self.layout), h, w


@dataclasses.dataclass(frozen=True)
class ToYuv420Spec(_ShardForm):
    """Pack RGB into the YUV420 transport layout, chroma pooled over valid
    pixels, with the uint8 epilogue fused (kernel K3)."""

    hb: int
    wb: int

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = True, luma: bool = False, out=None):
        """`luma`: a GraySpec before this stage folded into it (the chain
        runner's `launch_steps`), applied to each pixel as K3 loads it."""
        if not out_u8:
            raise ValueError("ToYuv420Spec must end its chain")
        return kernels.rgb_to_yuv420(x, h, w, self.hb, self.wb, luma, **_out_kw(out)), h, w

    def shard_ok(self, lw, first):
        # a 2x2 chroma block never straddles two shards
        return lw % 2 == 0

    def apply_shard(self, x, left, right, h, w, dyn, col0, lw, in_col0, in_wb,
                    out_u8, impl=kernels):
        """dyn["luma"] True: the folded GraySpec (`apply`'s `luma`)."""
        if not out_u8:
            raise ValueError("ToYuv420Spec must end its chain")
        return impl.rgb_to_yuv420_shard(x, h, w, self.hb, lw, col0,
                                        dyn.get("luma", False)), h, w

    def shard_assemble(self, host):
        """Each shard's packed planes at their global columns: its Y at
        [col0, col0 + lw), its U and V halves at col0/2 of each plane."""
        parts = host.numpy()[..., 0]  # C is 1: block copies of 2-D rows
        n, bsz, rows, lw = parts.shape
        hb, cw, half = self.hb, lw // 2, n * lw // 2
        out = np.empty((bsz, rows, n * lw), dtype=parts.dtype)
        for j, part in enumerate(parts):
            out[:, :hb, j * lw:(j + 1) * lw] = part[:, :hb]
            out[:, hb:, j * cw:(j + 1) * cw] = part[:, hb:, :cw]
            out[:, hb:, half + j * cw:half + (j + 1) * cw] = part[:, hb:, cw:]
        return out[..., None]


@dataclasses.dataclass(frozen=True)
class ToDctSpec:
    """Forward DCT + quantize RGB into the packed egress coefficient buffer
    [B, hb + hb/2, wb, 1] int16, rounded half to even and clamped (kernel
    K12). dyn: qy, qc (f32 [B, 8, 8], the quality-scaled steps)."""

    hb: int
    wb: int

    # the chain drains int16 coefficients, not uint8 pixels
    out_dtype = "int16"

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = True, out=None):
        if not out_u8:
            raise ValueError("ToDctSpec must end its chain")
        return kernels.to_dct(x, h, w, dyn["qy"], dyn["qc"], self.hb, self.wb,
                              **_out_kw(out)), h, w


@dataclasses.dataclass(frozen=True)
class GraySpec(_ShardForm):
    """Rec.709 luma broadcast over RGB, alpha kept (kernel K8)."""

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = False, out=None):
        return kernels.gray(x, out_u8, **_out_kw(out)), h, w

    def apply_shard(self, x, left, right, h, w, dyn, col0, lw, in_col0, in_wb,
                    out_u8, impl=kernels):
        return impl.gray(x, out_u8), h, w


@dataclasses.dataclass(frozen=True)
class SmartExtractSpec:
    """Saliency-guided crop (ref: bimg GravitySmart): the saliency integral
    image (kernel K9), the best window's offsets, chosen on the device
    (K10), and the window gather at those offsets (K4), with no host
    round trip between them. dyn: new_h, new_w (i32 [B])."""

    out_hb: int
    out_wb: int

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = False, out=None):
        ii = kernels.saliency_ii(x, h, w)
        top, left = kernels.window_argmax(ii, h, w, dyn["new_h"], dyn["new_w"])
        out = kernels.gather(x, self.out_hb, self.out_wb, top, left,
                             mode="window", out_u8=out_u8, **_out_kw(out))
        return out, dyn["new_h"], dyn["new_w"]
