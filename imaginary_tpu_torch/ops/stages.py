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
`out_dtype` is "int16", drains rounded int16 coefficients instead). Every
stage runs one or more of the port's CUDA kernels on a CUDA tensor and
their plain versions on a CPU tensor (`kernels/`).

The stages with a W-shard form (K1, K13, K7, K8) also carry the spatial
route's side of it (`_ShardForm`); `ops/chain.launch_spatial` drives them
through that alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from imaginary_tpu_torch import kernels
from imaginary_tpu_torch.options import Extend


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

    def shard_input(self, img: np.ndarray, c0: int, c1: int, w: int, dyn: dict) -> tuple:
        """The first sharded stage's host input for output columns [c0,
        c1) of the bucket-padded HWC image `img` (valid width w, host
        params dyn): (x, left, right, in_col0), x's first column in the
        bucket and the halos (None where there are none)."""
        wb, r = img.shape[1], self.shard_halo
        left = img[:, c0 - r:c0] if r and c0 > 0 else None
        right = img[:, c1:c1 + r] if r and c1 < wb else None
        return img[:, c0:c1], left, right, c0

    def shard_dyn(self, dyn: dict, col0: int) -> dict:
        """The host params of the shard whose output starts at col0."""
        return dyn

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

    def apply(self, x, h, w, dyn, out_u8: bool = False):
        return kernels.resample(x, h, w, dyn["dst_h"], dyn["dst_w"],
                                self.out_hb, self.out_wb, self.kernel, out_u8)

    def shard_ok(self, lw: int, first: bool) -> bool:
        # a shard's input window is staged from the host
        return first

    def shard_input(self, img, c0, c1, w, dyn):
        k0, k1 = kernels.resample_window(self.kernel, w, float(dyn["dst_w"][0]),
                                         img.shape[1], self.out_wb, c0, c1)
        return img[:, k0:k1], None, None, k0

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

    def apply(self, x, h, w, dyn, out_u8: bool = False):
        out = kernels.gather(x, self.out_hb, self.out_wb, dyn["top"],
                             dyn["left"], mode="window", out_u8=out_u8)
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

    def apply(self, x, h, w, dyn, out_u8: bool = False):
        mode = "mirror" if self.mode is Extend.MIRROR else "clamp"
        fill = dyn["fill"] if self.mode in _FILL_MODES else None
        out = kernels.gather(x, self.out_hb, self.out_wb, dyn["off_y"],
                             dyn["off_x"], h, w, mode=mode, fill=fill,
                             out_u8=out_u8)
        return out, dyn["canvas_h"], dyn["canvas_w"]


@dataclasses.dataclass(frozen=True)
class FlipSpec:
    """Vertical flip of the valid region; padding rows stay as they are
    (kernel K5, flip)."""

    def apply(self, x, h, w, dyn, out_u8: bool = False):
        return kernels.orient(x, h, w, "flip", out_u8), h, w


@dataclasses.dataclass(frozen=True)
class FlopSpec:
    """Horizontal flip of the valid region; padding columns stay as they
    are (kernel K5, flop)."""

    def apply(self, x, h, w, dyn, out_u8: bool = False):
        return kernels.orient(x, h, w, "flop", out_u8), h, w


@dataclasses.dataclass(frozen=True)
class TransposeSpec:
    """Swap H and W of the whole bucket, valid dims swapped with it
    (kernel K5, transpose)."""

    def apply(self, x, h, w, dyn, out_u8: bool = False):
        return kernels.orient(x, h, w, "transpose", out_u8), w, h


@dataclasses.dataclass(frozen=True)
class BlurSpec(_ShardForm):
    """Separable gaussian blur, radius static, sigma dynamic, normalised
    against the valid mask and zero outside it (kernel K6). dyn: sigma
    (f32 [B])."""

    radius: int

    def apply(self, x, h, w, dyn, out_u8: bool = False):
        return kernels.blur(x, h, w, dyn["sigma"], self.radius, out_u8), h, w

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

    def apply(self, x, h, w, dyn, out_u8: bool = False):
        out = kernels.composite(x, dyn["overlay"], dyn["top"], dyn["left"],
                                dyn["opacity"], dyn["block_h"],
                                dyn["block_w"], self.replicate, out_u8)
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
class ShrinkBucketSpec:
    """Static slice of the padded buffer down to a snugger bucket, valid dims
    unchanged (kernel K4, identity window)."""

    out_hb: int
    out_wb: int

    def apply(self, x, h, w, dyn, out_u8: bool = False):
        out = kernels.gather(x, self.out_hb, self.out_wb, mode="window",
                             out_u8=out_u8)
        return out, h, w


@dataclasses.dataclass(frozen=True)
class FromYuv420Spec:
    """Unpack the packed YUV420 transport buffer [B, hb + hb/2, wb, 1] into
    RGB: centred 2x chroma upsample, BT.601 full range (kernel K2)."""

    hb: int
    wb: int

    def apply(self, x, h, w, dyn, out_u8: bool = False):
        if out_u8:
            raise ValueError("FromYuv420Spec cannot end a chain")
        return kernels.yuv420_to_rgb(x, h, w, self.hb, self.wb), h, w


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
class ToYuv420Spec:
    """Pack RGB into the YUV420 transport layout, chroma pooled over valid
    pixels, with the uint8 epilogue fused (kernel K3)."""

    hb: int
    wb: int

    def apply(self, x, h, w, dyn, out_u8: bool = True, luma: bool = False):
        """`luma`: a GraySpec before this stage folded into it (the chain
        runner's `launch_steps`), applied to each pixel as K3 loads it."""
        if not out_u8:
            raise ValueError("ToYuv420Spec must end its chain")
        return kernels.rgb_to_yuv420(x, h, w, self.hb, self.wb, luma), h, w


@dataclasses.dataclass(frozen=True)
class ToDctSpec:
    """Forward DCT + quantize RGB into the packed egress coefficient buffer
    [B, hb + hb/2, wb, 1] int16, rounded half to even and clamped (kernel
    K12). dyn: qy, qc (f32 [B, 8, 8], the quality-scaled steps)."""

    hb: int
    wb: int

    # the chain drains int16 coefficients, not uint8 pixels
    out_dtype = "int16"

    def apply(self, x, h, w, dyn, out_u8: bool = True):
        if not out_u8:
            raise ValueError("ToDctSpec must end its chain")
        return kernels.to_dct(x, h, w, dyn["qy"], dyn["qc"], self.hb, self.wb), h, w


@dataclasses.dataclass(frozen=True)
class GraySpec(_ShardForm):
    """Rec.709 luma broadcast over RGB, alpha kept (kernel K8)."""

    def apply(self, x, h, w, dyn, out_u8: bool = False):
        return kernels.gray(x, out_u8), h, w

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

    def apply(self, x, h, w, dyn, out_u8: bool = False):
        ii = kernels.saliency_ii(x, h, w)
        top, left = kernels.window_argmax(ii, h, w, dyn["new_h"], dyn["new_w"])
        out = kernels.gather(x, self.out_hb, self.out_wb, top, left,
                             mode="window", out_u8=out_u8)
        return out, dyn["new_h"], dyn["new_w"]
