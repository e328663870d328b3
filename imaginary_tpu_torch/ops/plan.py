"""Host geometry planner: (operation, ImageOptions, source facts) -> stage chain.

The port's copy of `imaginary_tpu/ops/plan.py`, bound to the port's stage
specs (`imaginary_tpu_torch.ops.stages`), so both packages plan the same
chain for the same request. `plan_from_dict` rebuilds a port plan from a
plain description of a reference plan.

This module encodes the reference's *dimension semantics* — what bimg's
resizer does with Width/Height/Crop/Embed/Force/Enlarge/Zoom (SURVEY.md
section 2.12, validated against the reference's golden tests, e.g.
image_test.go: 550x740 resize width=300 -> 300x404; nocrop=false -> 300x740;
fit 300x300 -> 223x300) — as pure host integer math that emits device stages.

All *shapes* it produces are static bucket dims (the jit cache key); all
*values* (actual dims, scales, offsets, colors) are per-request dynamic
params. The planner is pure Python/numpy: fully unit-testable without JAX.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import numpy as np

from imaginary_tpu_torch import kernels
from imaginary_tpu_torch.errors import ImageError, new_error
from imaginary_tpu_torch.imgtype import ImageType, image_type
from imaginary_tpu_torch.options import Colorspace, Extend, Gravity, ImageOptions, apply_aspect_ratio
from imaginary_tpu_torch.ops import stages as stages_mod
from imaginary_tpu_torch.ops.buckets import MAX_DIM, bucket_dim, bucket_shape, dct_packed_geometry, tight_dim
from imaginary_tpu_torch.ops.stages import (
    BlurSpec,
    CompositeSpec,
    EmbedSpec,
    ExtractSpec,
    FlipSpec,
    FlopSpec,
    FromDctSpec,
    FromYuv420Spec,
    GraySpec,
    SampleSpec,
    ShrinkBucketSpec,
    SmartExtractSpec,
    ToDctSpec,
    ToYuv420Spec,
    TransposeSpec,
)

_f32 = np.float32
_i32 = np.int32


def _rnd(x: float) -> int:
    """vips-style round half away from zero (positive domain)."""
    return int(math.floor(x + 0.5))


@dataclasses.dataclass
class StageInstance:
    spec: object  # one of the frozen specs from stages.py
    dyn: dict  # str -> numpy scalar/array for THIS image


@dataclasses.dataclass
class ImagePlan:
    """Device work for one request: the chain key is (specs, in-bucket, C).

    transport: "rgb" (HWC arrays both ways), "yuv420" (packed subsampled
    planes both ways — half the link bytes; JPEG-in/JPEG-out requests only),
    or "dct" (packed quantized DCT coefficients in, packed yuv420 out — the
    host ships entropy-decoded coefficients and the device runs the IDCT).
    For packed-transport plans the item array is the pre-padded packed
    buffer, so the packed dims (in_bucket), the true image dims (in_h/in_w),
    and the output Y bucket (out_bucket, for host-side plane slicing) ride
    on the plan.

    frame_key: identity of the staged input for the device-resident frame
    cache ((content digest, shrink, transport, packed dims) — see
    cache.DeviceFrameCache). None means "don't device-cache this input".

    egress: "" (pixel readback) or "dct" (the chain ends in ToDctSpec and
    the readback is quantized int16 coefficient planes — finish_batch
    re-blocks them into QuantizedBlocks for the host entropy encoder).
    egress_quality: the JPEG quality the device quantized at (the encoder
    writes the matching DQT); rides on the plan, not the spec, so the jit
    key stays quality-independent.
    """

    stages: list
    out_h: int
    out_w: int
    transport: str = "rgb"
    in_bucket: Optional[tuple] = None  # packed array dims (hb + hb/2, wb)
    in_h: int = 0
    in_w: int = 0
    out_bucket: Optional[tuple] = None  # output Y bucket dims (hb, wb)
    frame_key: Optional[tuple] = None
    egress: str = ""
    egress_quality: int = 0

    def spec_key(self) -> tuple:
        return tuple(s.spec for s in self.stages)


def wrap_plan_yuv420(plan: ImagePlan, src_h: int, src_w: int) -> ImagePlan:
    """Re-express an RGB plan as a packed-YUV420-transport plan.

    Prepends the device-side unpack (chroma upsample + YCbCr->RGB) and
    appends the repack (RGB->YCbCr + 2x2 chroma pool); the wrapped chain is
    the SAME RGB geometry in the middle, so every operation composes
    unchanged. Identity plans return unchanged — the caller short-circuits
    those straight from decoded planes to the raw encoder with no device
    round-trip at all.
    """
    if not plan.stages:
        return plan
    hb, wb = bucket_shape(src_h, src_w)
    out_hb, out_wb = _final_bucket(plan.stages, src_h, src_w)
    stages = (
        [StageInstance(FromYuv420Spec(hb, wb), {})]
        + plan.stages
        + [StageInstance(ToYuv420Spec(out_hb, out_wb), {})]
    )
    return ImagePlan(
        stages=stages,
        out_h=plan.out_h,
        out_w=plan.out_w,
        transport="yuv420",
        in_bucket=(hb + hb // 2, wb),
        in_h=src_h,
        in_w=src_w,
        out_bucket=(out_hb, out_wb),
    )


def dct_in_bucket(shrink: int, hb: int, wb: int, layout: str) -> tuple:
    """Packed coefficient-array dims for one (shrink, layout) combination,
    as K11 takes them (`kernels.dct_in_shape`).

    4:2:0 at full scale packs yuv420-style [hb + hb/2, wb, 1]; 4:2:2 at
    full scale stacks chroma in a second full-height band [2*hb, wb, 1];
    grayscale/4:4:4 and every shrunk scale fold into [hb, wb, C] (see
    codecs/jpeg_dct.pack_dct for the channel counts).
    """
    return kernels.dct_in_shape(layout, 8 // shrink, hb, wb)[:2]


def wrap_plan_dct(plan: ImagePlan, src_h: int, src_w: int, shrink: int,
                  frame_key: Optional[tuple] = None,
                  layout: str = "420", egress: str = "",
                  egress_quality: int = 75) -> ImagePlan:
    """Re-express an RGB plan (planned at the SHRUNK dims) as a
    dct-transport plan.

    Prepends the device-side scaled IDCT + chroma upsample (FromDctSpec
    consumes codecs/jpeg_dct.py's packed coefficient buffer) and appends
    the yuv420 repack for the readback; the wrapped chain is the SAME RGB
    geometry in the middle, so every operation composes unchanged. `plan`
    must have been planned at (ceil(src/shrink)) dims — the dims the
    scaled IDCT reconstructs. Identity plans return unchanged: with no
    pixels host-side there is nothing to short-circuit to, so the caller
    must route those to the rgb/yuv paths instead.

    The coefficient bucket can exceed bucket_shape(shrunk dims) when the
    MCU-padded block grid crosses a ladder rung; a static ShrinkBucketSpec
    restores the exact mid-chain geometry the RGB plan was built against.

    egress="dct" swaps the ToYuv420Spec repack for ToDctSpec: the chain
    ends with a device-side forward DCT + quantization at egress_quality
    (qy/qc ride as per-image dyn [8, 8] f32) and the readback is int16
    coefficients for the host entropy encoder.

    frame_key: the packed buffer's identity (digest, shrink, "dct") from
    the decoded-frame tier, under which ops/chain.py keeps the staged
    device copy resident (`set_device_frame_cache`); None stages it anew.
    """
    if not plan.stages:
        return plan
    k, h2, w2, hb, wb = dct_packed_geometry(src_h, src_w, shrink, layout)
    stages = [StageInstance(FromDctSpec(hb, wb, k, layout), {})]
    bh2, bw2 = bucket_shape(h2, w2)
    if (hb, wb) != (bh2, bw2):
        stages.append(StageInstance(ShrinkBucketSpec(bh2, bw2), {}))
    out_hb, out_wb = _final_bucket(plan.stages, h2, w2)
    if egress == "dct":
        from imaginary_tpu_torch.codecs.jpeg_dct import quality_tables

        qy, qc = quality_tables(int(egress_quality))
        tail = StageInstance(
            ToDctSpec(out_hb, out_wb),
            {"qy": qy.astype(np.float32), "qc": qc.astype(np.float32)},
        )
    else:
        tail = StageInstance(ToYuv420Spec(out_hb, out_wb), {})
    stages = stages + plan.stages + [tail]
    return ImagePlan(
        stages=stages,
        out_h=plan.out_h,
        out_w=plan.out_w,
        transport="dct",
        in_bucket=dct_in_bucket(shrink, hb, wb, layout),
        in_h=h2,
        in_w=w2,
        out_bucket=(out_hb, out_wb),
        frame_key=frame_key,
        egress=egress,
        egress_quality=int(egress_quality),
    )


class _Planner:
    """Tracks current dims while stages accumulate."""

    def __init__(self, h: int, w: int):
        self.h, self.w = h, w
        self.stages: list = []

    def add(self, spec, **dyn):
        self.stages.append(StageInstance(spec, dyn))

    # -- primitive geometry ----------------------------------------------------

    def sample(self, dst_h: int, dst_w: int, kernel: str = "lanczos3"):
        dst_h, dst_w = max(1, dst_h), max(1, dst_w)
        if dst_h > MAX_DIM or dst_w > MAX_DIM:
            raise new_error("Requested dimensions are too large", 422)
        if (dst_h, dst_w) == (self.h, self.w):
            return
        self.add(
            SampleSpec(bucket_dim(dst_h), bucket_dim(dst_w), kernel),
            dst_h=_f32(dst_h),
            dst_w=_f32(dst_w),
        )
        self.h, self.w = dst_h, dst_w

    def extract(self, top: int, left: int, eh: int, ew: int):
        if eh <= 0 or ew <= 0:
            raise new_error("extract_area: bad extract area", 400)
        if top + eh > self.h or left + ew > self.w or top < 0 or left < 0:
            raise new_error("extract_area: bad extract area", 400)
        if (top, left) == (0, 0) and (eh, ew) == (self.h, self.w):
            return
        self.add(
            ExtractSpec(bucket_dim(eh), bucket_dim(ew)),
            top=_i32(top),
            left=_i32(left),
            new_h=_i32(eh),
            new_w=_i32(ew),
        )
        self.h, self.w = eh, ew

    def smart_extract(self, eh: int, ew: int):
        self.add(
            SmartExtractSpec(bucket_dim(eh), bucket_dim(ew)),
            new_h=_i32(eh),
            new_w=_i32(ew),
        )
        self.h, self.w = eh, ew

    def embed(self, ch: int, cw: int, mode: Extend, background: tuple, channels: int):
        if ch > MAX_DIM or cw > MAX_DIM:
            raise new_error("Requested dimensions are too large", 422)
        if (ch, cw) == (self.h, self.w):
            return
        fill = np.zeros((channels,), dtype=_f32)
        if mode is Extend.WHITE:
            fill[:] = 255.0
        elif mode is Extend.BACKGROUND and background:
            rgb = list(background[:3]) + [0] * (3 - len(background[:3]))
            fill[:3] = rgb
        if channels == 4:
            fill[3] = 255.0
        self.add(
            EmbedSpec(bucket_dim(ch), bucket_dim(cw), mode),
            off_y=_i32(max(0, (ch - self.h) // 2)),
            off_x=_i32(max(0, (cw - self.w) // 2)),
            canvas_h=_i32(ch),
            canvas_w=_i32(cw),
            fill=fill,
        )
        self.h, self.w = ch, cw

    def flip(self):
        self.add(FlipSpec())

    def flop(self):
        self.add(FlopSpec())

    def transpose(self):
        self.add(TransposeSpec())
        self.h, self.w = self.w, self.h

    def rotate(self, angle: int):
        """Exact 90-degree-family rotation; angle is degrees clockwise.

        In-range non-multiples FLOOR to the lower 90 multiple (135 -> 90,
        275 -> 270): vips_rot supports only the D90 family and bimg's
        getAngle (resizer.go) floors before dispatching, so rotate=135
        must turn the image, not no-op. Above the family getAngle clamps
        with min(angle, 270), so rotate=450 rotates 270. Negatives no-op
        (Go's -90 % 90 == 0 leaves the angle outside the D90 switch) —
        they CAN arrive via pipeline JSON params (the query-string layer
        abs()es, the JSON layer does not — same as the reference's
        split)."""
        angle -= angle % 90
        angle = min(angle, 270)
        if angle == 90:
            self.transpose()
            self.flop()
        elif angle == 180:
            self.flip()
            self.flop()
        elif angle == 270:
            self.transpose()
            self.flip()

    def exif_orient(self, orientation: int):
        """EXIF orientation -> upright (ref: image.go:155-179 table)."""
        if orientation == 2:
            self.flop()
        elif orientation == 3:
            self.flip()
            self.flop()
        elif orientation == 4:
            self.flip()
        elif orientation == 5:
            self.transpose()
        elif orientation == 6:
            self.transpose()
            self.flop()
        elif orientation == 7:
            self.transpose()
            self.flip()
            self.flop()
        elif orientation == 8:
            self.transpose()
            self.flip()


# --- bimg-equivalent resize resolution ---------------------------------------

def _resolve_resize(p: _Planner, o: ImageOptions, *, force: bool, crop: bool,
                    embed: bool, enlarge: bool, channels: int):
    """The heart of bimg's dimension semantics (see module docstring)."""
    width, height = apply_aspect_ratio(o)
    if width == 0 and height == 0:
        return
    cur_w, cur_h = p.w, p.h

    if force:
        p.sample(height or cur_h, width or cur_w)
        return

    if crop:
        tw = width or cur_w
        th = height or cur_h
        scale = max(tw / cur_w, th / cur_h)
        if scale > 1.0 and not enlarge:
            scale = 1.0
        rw, rh = max(1, _rnd(cur_w * scale)), max(1, _rnd(cur_h * scale))
        p.sample(rh, rw)
        ew, eh = min(tw, rw), min(th, rh)
        if o.gravity is Gravity.SMART:
            p.smart_extract(eh, ew)
        else:
            top, left = _gravity_offsets(o.gravity, rh, rw, eh, ew)
            p.extract(top, left, eh, ew)
        return

    if embed:
        if width and height:
            scale = min(width / cur_w, height / cur_h)
        elif width:
            scale = width / cur_w
        else:
            scale = height / cur_h
        if scale > 1.0 and not enlarge:
            scale = 1.0
        rw, rh = max(1, _rnd(cur_w * scale)), max(1, _rnd(cur_h * scale))
        p.sample(rh, rw)
        cw, ch = (width or rw), (height or rh)
        if (cw, ch) != (rw, rh):
            p.embed(ch, cw, o.extend, o.background, channels)
        return

    # plain path: both dims force exact (bimg normalization); one dim scales
    if width and height:
        p.sample(height, width)
        return
    scale = (width / cur_w) if width else (height / cur_h)
    if scale > 1.0 and not enlarge:
        scale = 1.0
    p.sample(max(1, _rnd(cur_h * scale)), max(1, _rnd(cur_w * scale)))


def _gravity_offsets(g: Gravity, rh: int, rw: int, eh: int, ew: int) -> tuple:
    """Window placement for non-smart gravities (ref: params.go:439-453)."""
    cy, cx = (rh - eh) // 2, (rw - ew) // 2
    if g is Gravity.NORTH:
        return 0, cx
    if g is Gravity.SOUTH:
        return rh - eh, cx
    if g is Gravity.WEST:
        return cy, 0
    if g is Gravity.EAST:
        return cy, rw - ew
    return cy, cx


# --- shared transform pipeline (the Process() equivalent) ---------------------

def _common_prelude(p: _Planner, o: ImageOptions, orientation: int):
    """EXIF autorotate + explicit rotate + flip flags (applied by every op
    that funnels through Process; ref: bimg rotateAndFlipImage)."""
    if not o.no_rotation and orientation > 1:
        p.exif_orient(orientation)
    if o.rotate:
        p.rotate(o.rotate)
    if o.flip:
        p.flip()
    if o.flop:
        p.flop()


def _common_postlude(p: _Planner, o: ImageOptions, channels: int):
    """Blur + colorspace, applied to every Process()-routed op
    (ref: options.go:164-169 GaussianBlur hook; Interpretation)."""
    if o.sigma > 0 or o.min_ampl > 0:
        p.add(BlurSpec(_blur_radius(o.sigma, o.min_ampl)), sigma=_f32(o.sigma))
    if o.colorspace is Colorspace.BW:
        p.add(GraySpec())


def _blur_radius(sigma: float, min_ampl: float) -> int:
    """libvips gaussmat radius: ceil(sigma * sqrt(-2 ln(min_ampl))),
    default min_ampl 0.2; bucketed so radius stays a small static set."""
    ma = min_ampl if 0 < min_ampl < 1 else 0.2
    r = max(1, math.ceil(max(sigma, 0.5) * math.sqrt(-2.0 * math.log(ma))))
    for rung in (2, 4, 8, 16, 32, 64):
        if r <= rung:
            return rung
    return 64


# --- per-operation planners (ref: image.go:115-410) ---------------------------

def _require(cond: bool, msg: str):
    if not cond:
        raise new_error(msg, 400)


def plan_resize(p, o, channels):
    _require(o.width != 0 or o.height != 0, "Missing required param: height or width")
    crop = False
    if o.is_defined("no_crop"):
        crop = not o.no_crop
    _resolve_resize(p, o, force=o.force, crop=crop, embed=not crop,
                    enlarge=False, channels=channels)


def plan_fit(p, o, channels):
    _require(o.width != 0 and o.height != 0, "Missing required params: height, width")
    # fit box computed against the *oriented* dims (image.go:155-185)
    fw, fh = _fit_dims(p.w, p.h, o.width, o.height)
    fitted = dataclasses.replace(o, width=fw, height=fh, aspect_ratio="")
    fitted.defined = o.defined
    _resolve_resize(p, fitted, force=o.force, crop=False, embed=True, enlarge=False,
                    channels=channels)


def _fit_dims(image_w: int, image_h: int, fit_w: int, fit_h: int) -> tuple:
    """ref: calculateDestinationFitDimension, image.go:190-200."""
    if image_w * fit_h > fit_w * image_h:
        fit_h = round(fit_w * image_h / image_w)  # constrained by width
    else:
        fit_w = round(fit_h * image_w / image_h)  # constrained by height
    return fit_w, fit_h


def plan_enlarge(p, o, channels):
    _require(o.width != 0 and o.height != 0, "Missing required params: height, width")
    _resolve_resize(p, o, force=o.force, crop=not o.no_crop, embed=o.embed,
                    enlarge=True, channels=channels)


def plan_extract(p, o, channels):
    _require(o.area_width != 0 and o.area_height != 0,
             "Missing required params: areawidth or areaheight")
    p.extract(o.top, o.left, o.area_height, o.area_width)
    _resolve_resize(p, o, force=o.force, crop=False, embed=o.embed, enlarge=False,
                    channels=channels)


def plan_crop(p, o, channels):
    _require(o.width != 0 or o.height != 0, "Missing required param: height or width")
    _resolve_resize(p, o, force=o.force, crop=True, embed=o.embed, enlarge=False,
                    channels=channels)


def plan_smartcrop(p, o, channels):
    _require(o.width != 0 or o.height != 0, "Missing required param: height or width")
    smart = dataclasses.replace(o, gravity=Gravity.SMART)
    smart.defined = o.defined
    _resolve_resize(p, smart, force=o.force, crop=True, embed=o.embed, enlarge=False,
                    channels=channels)


def plan_rotate(p, o, channels):
    _require(o.rotate != 0, "Missing required param: rotate")
    _resolve_resize(p, o, force=o.force, crop=False, embed=o.embed, enlarge=False,
                    channels=channels)


def plan_autorotate(p, o, channels):
    # handled entirely by the prelude's EXIF stages (image.go:255-265)
    pass


def plan_flip(p, o, channels):
    p.flip()
    _resolve_resize(p, o, force=o.force, crop=False, embed=o.embed, enlarge=False,
                    channels=channels)


def plan_flop(p, o, channels):
    p.flop()
    _resolve_resize(p, o, force=o.force, crop=False, embed=o.embed, enlarge=False,
                    channels=channels)


def plan_thumbnail(p, o, channels):
    _require(o.width != 0 or o.height != 0, "Missing required params: width or height")
    _resolve_resize(p, o, force=o.force, crop=False, embed=o.embed, enlarge=False,
                    channels=channels)


def plan_zoom(p, o, channels):
    _require(o.factor != 0, "Missing required param: factor")
    _require(o.factor > 0, "Invalid zoom factor")
    if o.top > 0 or o.left > 0:
        _require(o.area_width != 0 or o.area_height != 0,
                 "Missing required params: areawidth, areaheight")
        p.extract(o.top, o.left, o.area_height or p.h, o.area_width or p.w)
    _resolve_resize(p, o, force=o.force, crop=False, embed=o.embed, enlarge=False,
                    channels=channels)
    # vips_zoom replicates pixels: factor x dims, nearest kernel
    p.sample(p.h * o.factor, p.w * o.factor, kernel="nearest")


def plan_convert(p, o, channels):
    _require(o.type != "", "Missing required param: type")
    if image_type(o.type) is ImageType.UNKNOWN:
        raise new_error("Invalid image type: " + o.type, 400)
    _resolve_resize(p, o, force=o.force, crop=False, embed=o.embed, enlarge=False,
                    channels=channels)


def plan_blur(p, o, channels):
    _require(o.sigma != 0 or o.min_ampl != 0, "Missing required param: sigma or minampl")
    _resolve_resize(p, o, force=o.force, crop=False, embed=o.embed, enlarge=False,
                    channels=channels)
    # the blur itself is added by the postlude


def plan_watermark(p, o, channels):
    _require(o.text != "", "Missing required param: text")
    _resolve_resize(p, o, force=o.force, crop=False, embed=o.embed, enlarge=False,
                    channels=channels)
    from imaginary_tpu_torch.ops.text import rasterize_text

    block = rasterize_text(
        text=o.text,
        font=o.font,
        dpi=o.dpi,
        text_width=o.text_width or (p.w // 2),
        color=o.color,
        max_w=max(8, p.w),
        max_h=max(8, p.h),
    )
    bh, bw = block.shape[0], block.shape[1]
    margin = max(0, o.margin)
    opacity = o.opacity if o.opacity > 0 else 0.25  # bimg watermark default
    p.add(
        CompositeSpec(bucket_dim(bh), bucket_dim(bw), replicate=not o.no_replicate),
        overlay=_pad_block(block, bucket_dim(bh), bucket_dim(bw)),
        top=_i32(min(margin, max(0, p.h - 1))),
        left=_i32(min(margin, max(0, p.w - 1))),
        opacity=_f32(opacity),
        block_h=_i32(bh),
        block_w=_i32(bw),
    )


def plan_watermark_image(p, o, channels, watermark_rgba: Optional[np.ndarray] = None):
    _require(o.image != "", "Missing required param: image")
    _resolve_resize(p, o, force=o.force, crop=False, embed=o.embed, enlarge=False,
                    channels=channels)
    if watermark_rgba is None:
        raise new_error("Unable to retrieve watermark image: " + o.image, 400)
    bh = min(watermark_rgba.shape[0], p.h)
    bw = min(watermark_rgba.shape[1], p.w)
    block = watermark_rgba[:bh, :bw]
    opacity = o.opacity if o.opacity > 0 else 1.0
    p.add(
        CompositeSpec(bucket_dim(bh), bucket_dim(bw), replicate=False),
        overlay=_pad_block(block, bucket_dim(bh), bucket_dim(bw)),
        top=_i32(max(0, min(o.top, p.h - bh))),
        left=_i32(max(0, min(o.left, p.w - bw))),
        opacity=_f32(opacity),
        block_h=_i32(bh),
        block_w=_i32(bw),
    )


def _pad_block(block: np.ndarray, hb: int, wb: int) -> np.ndarray:
    out = np.zeros((hb, wb, 4), dtype=_f32)
    out[: block.shape[0], : block.shape[1], :] = block.astype(_f32)
    return out


_PLANNERS = {
    "resize": plan_resize,
    "fit": plan_fit,
    "enlarge": plan_enlarge,
    "extract": plan_extract,
    "crop": plan_crop,
    "smartcrop": plan_smartcrop,
    "rotate": plan_rotate,
    "autorotate": plan_autorotate,
    "flip": plan_flip,
    "flop": plan_flop,
    "thumbnail": plan_thumbnail,
    "zoom": plan_zoom,
    "convert": plan_convert,
    "blur": plan_blur,
    "watermark": plan_watermark,
    "watermarkImage": plan_watermark_image,
}

OPERATION_NAMES = tuple(_PLANNERS)


def plan_operation(name: str, o: ImageOptions, src_h: int, src_w: int,
                   orientation: int, channels: int,
                   watermark_rgba: Optional[np.ndarray] = None) -> ImagePlan:
    """Build the device plan for one operation (ref: OperationsMap,
    image.go:15-32). Raises ImageError(400) for validation failures,
    matching each op's required-param checks."""
    if name not in _PLANNERS:
        raise new_error(f"Unsupported operation: {name}", 400)
    if src_h <= 0 or src_w <= 0:
        raise new_error("Width or height of requested image is zero", 406)
    p = _Planner(src_h, src_w)
    _common_prelude(p, o, orientation)
    if name == "watermarkImage":
        plan_watermark_image(p, o, channels, watermark_rgba)
    else:
        _PLANNERS[name](p, o, channels)
    _common_postlude(p, o, channels)
    _tighten_output_bucket(p, src_h, src_w)
    return ImagePlan(stages=p.stages, out_h=p.h, out_w=p.w)


_SHRINK_SAFE_OPS = frozenset({"resize", "fit", "thumbnail", "crop", "smartcrop"})


_SHRINK_MEMO: dict = {}
_SHRINK_MEMO_CAP = 4096


def _opts_memo_key(o: ImageOptions):
    """Hashable fingerprint of EVERY scalar option field (not just the ones
    the planner is known to consume today — completeness is what makes the
    memo safe against future planner changes). Unhashable fields are
    canonicalized; returns None when a field can't be fingerprinted."""
    import dataclasses as _dc

    parts = []
    for f in _dc.fields(o):
        v = getattr(o, f.name)
        if isinstance(v, set):
            v = frozenset(v)
        elif isinstance(v, list):
            if v:  # non-empty pipeline sub-operations: don't memo
                return None
            v = ()
        try:
            hash(v)
        except TypeError:
            return None
        parts.append((f.name, v))
    return tuple(parts)


def choose_decode_shrink(name: str, o: ImageOptions, src_h: int, src_w: int,
                         orientation: int, channels: int) -> int:
    """Largest JPEG shrink-on-load denominator in {8,4,2} that provably
    preserves the operation's output, else 1. Memoized on the full option
    fingerprint + source facts (the proof re-plans the op several times,
    ~0.5 ms — pure win for repeated traffic shapes).

    The gate is by *construction*, not heuristics: re-plan the operation on
    the shrunk source dims (ceil(dim/N), libjpeg's scaled-decode size) and
    accept N only when (a) the plan produces identical output dims, and
    (b) its first resample is still a pure downscale — i.e. the chain never
    has to invent detail the scaled decode threw away. Ops that address
    source pixels by absolute coordinates (extract/zoom/watermark placement)
    are excluded up front. This mirrors libvips' shrink-on-load, the single
    biggest decode-side win on large JPEGs (SURVEY.md section 3.2 hot loop).
    """
    if name not in _SHRINK_SAFE_OPS or src_h <= 0 or src_w <= 0:
        return 1
    okey = _opts_memo_key(o)
    key = (name, okey, src_h, src_w, orientation, channels) if okey else None
    if key is not None:
        hit = _SHRINK_MEMO.get(key)
        if hit is not None:
            return hit
    result = _choose_decode_shrink_uncached(name, o, src_h, src_w,
                                            orientation, channels)
    if key is not None:
        if len(_SHRINK_MEMO) >= _SHRINK_MEMO_CAP:
            _SHRINK_MEMO.clear()
        _SHRINK_MEMO[key] = result
    return result


def _choose_decode_shrink_uncached(name, o, src_h, src_w, orientation,
                                   channels) -> int:
    try:
        full = plan_operation(name, o, src_h, src_w, orientation, channels)
    except ImageError:
        return 1
    if not full.stages:
        return 1
    for denom in (8, 4, 2):
        sh = -(-src_h // denom)
        sw = -(-src_w // denom)
        if sh < 8 or sw < 8:
            continue
        try:
            p = plan_operation(name, o, sh, sw, orientation, channels)
        except ImageError:
            continue
        if (p.out_h, p.out_w) != (full.out_h, full.out_w):
            continue
        if not _plans_equivalent(full, p):
            # e.g. an enlarge-clamp kicked in on the shrunk dims and the
            # plan degenerated (same output dims, different content)
            continue
        if _chain_upscales(p, sh, sw):
            continue
        return denom
    return 1


def _plans_equivalent(a: ImagePlan, b: ImagePlan) -> bool:
    """Stage-for-stage identical: same specs AND same dynamic params.

    Every dyn value (resample targets, crop windows, canvas offsets, fills)
    lives in *output* space, so a source-resolution change that is truly
    transparent leaves all of them untouched; any difference means the
    operation actually depends on source resolution and must not shrink.
    The specs themselves may differ only in bucket dims (tight_dim of equal
    valid dims is equal, so they won't)."""
    if len(a.stages) != len(b.stages):
        return False
    for sa, sb in zip(a.stages, b.stages):
        if sa.spec != sb.spec:
            return False
        if sa.dyn.keys() != sb.dyn.keys():
            return False
        for k in sa.dyn:
            if not np.array_equal(sa.dyn[k], sb.dyn[k]):
                return False
    return True


def _advance_dims(st: StageInstance, cur: tuple) -> tuple:
    """Image dims after one stage (the _chain_upscales walk, shared)."""
    spec = st.spec
    if isinstance(spec, TransposeSpec):
        return cur[1], cur[0]
    if isinstance(spec, SampleSpec):
        return int(st.dyn["dst_h"]), int(st.dyn["dst_w"])
    if isinstance(spec, (ExtractSpec, SmartExtractSpec)):
        return int(st.dyn["new_h"]), int(st.dyn["new_w"])
    if isinstance(spec, EmbedSpec):
        return int(st.dyn["canvas_h"]), int(st.dyn["canvas_w"])
    return cur


def fuse_adjacent_shrinking_samples(stages: list, src_h: int, src_w: int) -> list:
    """Collapse back-to-back SampleSpec stages into one direct resample.

    A pipeline like crop(1600x900) -> resize(640) plans two full lanczos
    resamples, and the first one runs at near-source resolution — measured
    as ~5 ms of the /pipeline route's 12.7 ms host chain, for an
    intermediate image no one ever sees. Sampling is linear, so the
    composite MAP of two resamples equals the direct resample to the final
    dims; restricted to pure minification with matching kernels, the
    one-step stretched kernel also antialiases at least as well as the
    two-step (each step already band-limits before the next), so output
    quality can only improve. Enlarge steps, kernel switches, and any
    intervening stage (extract windows, embeds, transposes) block fusion.
    """
    out: list = []
    prev_entry = None  # dims entering the most recently KEPT stage
    cur = (src_h, src_w)
    for st in stages:
        entry = cur
        cur = _advance_dims(st, cur)
        if (
            out
            and isinstance(st.spec, SampleSpec)
            and isinstance(out[-1].spec, SampleSpec)
            and out[-1].spec.kernel == st.spec.kernel
        ):
            p_dst = (int(out[-1].dyn["dst_h"]), int(out[-1].dyn["dst_w"]))
            dst = (int(st.dyn["dst_h"]), int(st.dyn["dst_w"]))
            if (
                p_dst[0] <= prev_entry[0] and p_dst[1] <= prev_entry[1]
                and dst[0] <= p_dst[0] and dst[1] <= p_dst[1]
            ):
                out[-1] = st  # later stage already targets the final dims;
                continue      # prev_entry stays: the fused stage's entry
        out.append(st)
        prev_entry = entry
    return out


def _chain_upscales(plan: ImagePlan, src_h: int, src_w: int) -> bool:
    """True if any resample stage enlarges relative to its input dims."""
    cur = (src_h, src_w)
    for st in plan.stages:
        if isinstance(st.spec, SampleSpec):
            dh, dw = int(st.dyn["dst_h"]), int(st.dyn["dst_w"])
            if dh > cur[0] or dw > cur[1]:
                return True
        cur = _advance_dims(st, cur)
    return False


def _final_bucket(stages: list, src_h: int, src_w: int) -> tuple:
    """Track the padded-buffer dims through the chain (host-side mirror of
    what the device program will produce)."""
    hb, wb = bucket_shape(src_h, src_w)
    for st in stages:
        spec = st.spec
        if isinstance(spec, TransposeSpec):
            hb, wb = wb, hb
        elif hasattr(spec, "out_hb"):
            hb, wb = spec.out_hb, spec.out_wb
    return hb, wb


def _tighten_output_bucket(p: _Planner, src_h: int, src_w: int) -> None:
    """Shrink the chain's FINAL bucket to a snug multiple-of-16 one.

    Device->host readback has a large fixed cost and low bandwidth on the
    host<->TPU link (the opposite of host->device, which is cheap), so the
    bytes the final stage emits dominate end-to-end throughput. Walk back
    past bucket-preserving stages and retarget the last shape-bearing spec;
    if the chain has none (flip/rotate-only chains), append a static slice.
    """
    if not p.stages:
        # an empty chain is an identity: the executor short-circuits it
        # host-side, so appending a bucket-shrink would turn a no-op into
        # a device round-trip that returns the same pixels
        return
    th, tw = tight_dim(p.h), tight_dim(p.w)
    hb, wb = _final_bucket(p.stages, src_h, src_w)
    if (th, tw) == (hb, wb):
        return
    want_h, want_w = th, tw
    for st in reversed(p.stages):
        spec = st.spec
        if isinstance(spec, TransposeSpec):
            want_h, want_w = want_w, want_h
            continue
        if isinstance(spec, (SampleSpec, ExtractSpec, EmbedSpec, SmartExtractSpec)):
            if (spec.out_hb, spec.out_wb) != (want_h, want_w):
                st.spec = dataclasses.replace(spec, out_hb=want_h, out_wb=want_w)
            return
        if isinstance(spec, (FlipSpec, FlopSpec, BlurSpec, GraySpec, CompositeSpec, ShrinkBucketSpec)):
            continue
        break  # unknown spec: don't reason past it
    p.add(ShrinkBucketSpec(th, tw))


def plan_from_dict(d: dict) -> ImagePlan:
    """Build a port ImagePlan from a plain description of a plan.

    The description is what carries a reference plan across packages
    without importing the reference: {"stages": [{"spec": class name,
    "fields": {name: value}, "dyn": {name: numpy array}}, ...], plus the
    ImagePlan fields (out_h, out_w, transport, in_bucket, in_h, in_w,
    out_bucket, frame_key, egress, egress_quality). Enum-valued spec fields
    (EmbedSpec.mode) travel as their `.value`.
    """
    stages = []
    for st in d["stages"]:
        cls = getattr(stages_mod, st["spec"], None)
        if not (isinstance(cls, type) and dataclasses.is_dataclass(cls)):
            raise ValueError(f"unknown stage spec {st['spec']!r}")
        fields = {}
        for f in dataclasses.fields(cls):
            if f.name not in st["fields"]:
                continue
            v = st["fields"][f.name]
            if isinstance(f.default, enum.Enum):
                v = type(f.default)(v)
            fields[f.name] = v
        stages.append(StageInstance(cls(**fields),
                                    {k: np.asarray(v) for k, v in st["dyn"].items()}))

    def _tuple(v):
        return None if v is None else tuple(v)

    return ImagePlan(
        stages=stages,
        out_h=int(d["out_h"]),
        out_w=int(d["out_w"]),
        transport=d.get("transport", "rgb"),
        in_bucket=_tuple(d.get("in_bucket")),
        in_h=int(d.get("in_h", 0)),
        in_w=int(d.get("in_w", 0)),
        out_bucket=_tuple(d.get("out_bucket")),
        frame_key=_tuple(d.get("frame_key")),
        egress=d.get("egress", ""),
        egress_quality=int(d.get("egress_quality", 0)),
    )
