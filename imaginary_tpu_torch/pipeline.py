"""The synchronous processing path of the port: bytes -> plan -> kernels -> bytes.

The port's counterpart of `imaginary_tpu/pipeline.py:process_operation`
and `process_pipeline` for the `rgb`, `yuv420` and `dct` transports:
header probe, shrink-on-load choice, transport gate, decode, plan, chain
run on `device`, encode and metadata carry. A 4:2:0 JPEG in and JPEG out
rides the packed-YUV420 transport (half the link bytes; the color math
runs on the card); every other request (PNG, WEBP, GIF, TIFF sources or
targets) rides the RGB transport. With `--transport-dct` a baseline JPEG
in and JPEG out rides the compressed domain instead: the host only
entropy-decodes (codecs/jpeg_dct.py) and the card runs the IDCT (K11);
with `--transport-dct-egress` too, the card also runs the forward DCT and
quantization (K12) and the host only entropy-codes the coefficients. A
stream outside the entropy codec's scope (progressive and the like)
takes the yuv420/rgb path, counted in `dct_counts()`. A /pipeline fuses
every stage of every op into one chain: decode once, encode once.

`info` answers the /info JSON from a header probe. Each request's probe,
decode, encode and total times go to the TIMES ledger (engine/timing.py),
and with it to the request's trace; the device run is its "execute" span.
A `watermarkImage` takes its mark as a decoded RGBA array
(`watermark_rgba`): the web layer fetches and decodes the URL before the
pool dispatch, as the reference's handler does, so this module holds no
fetcher. The same mark serves every `watermarkImage` op of a pipeline,
and an op without it answers the reference's 400 "Unable to retrieve
watermark image: <url>" from the planner. Each decode, drained frame
and encoded body books its bytes in the COPIES ledger
(engine/timing.py), each decode and encode is a failpoint site
(`codec.decode`, `codec.encode`), and the encode checks the request's
deadline first (deadline.py).

The decoded-frame tier (cache.py, --cache-frame-mb): with a `frame_cache`
and the source's `source_digest`, each transport's decode is looked up
first, under (digest, shrink, "rgb"), (digest, shrink, "yuv", hb, wb) or
(digest, shrink, "dct"); a stored array is marked read-only before it is
shared. The dct key doubles as the plan's `frame_key`, under which
ops/chain.py keeps the staged coefficients resident on the card
(--cache-device-mb). As in the reference, the yuv420 transport's plan
carries no frame_key, so only the dct transport reaches the device tier.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Optional

import numpy as np

from imaginary_tpu_torch import codecs, failpoints
from imaginary_tpu_torch import deadline as deadline_mod
from imaginary_tpu_torch.codecs import EncodeOptions, YuvPlanes, jpeg_dct
from imaginary_tpu_torch.engine.timing import COPIES, TIMES
from imaginary_tpu_torch.errors import ImageError, new_error
from imaginary_tpu_torch.imgtype import ENCODABLE, ImageType, determine_image_type, get_image_mime_type, image_type
from imaginary_tpu_torch.obs import trace as obs_trace
from imaginary_tpu_torch.options import ImageOptions
from imaginary_tpu_torch.ops import chain as chain_mod
from imaginary_tpu_torch.ops.buckets import bucket_shape
from imaginary_tpu_torch.ops.plan import (
    OPERATION_NAMES,
    ImagePlan,
    choose_decode_shrink,
    fuse_adjacent_shrinking_samples,
    plan_operation,
    wrap_plan_dct,
    wrap_plan_yuv420,
)
from imaginary_tpu_torch.params import ParamError, build_params_from_operation

MAX_PIPELINE_OPERATIONS = 10  # ref: image.go:383-385

# Type values under which a request's output stays JPEG ("" and "auto"
# inherit a JPEG source) — the packed-YUV420 and dct transport gate.
_JPEG_TYPE_NAMES = ("", "jpeg", "jpg", "auto")

# Compressed-domain ingest (--transport-dct): the host entropy-decodes and
# ships dequantized DCT coefficients; the card runs the IDCT and color
# convert (FromDctSpec, K11). OFF by default.
_TRANSPORT_DCT = False

# Compressed-domain egress (--transport-dct-egress): the chain ends in the
# forward DCT + quantization (ToDctSpec, K12) and the host entropy-codes
# the drained int16 coefficients. Rides on the dct transport; OFF by
# default.
_TRANSPORT_DCT_EGRESS = False

# Requests the dct transport served, and JPEGs it handed to the yuv420/rgb
# path because the entropy codec's scope check refused them (progressive,
# arithmetic coding, odd sampling) or their frame dims disagreed with the
# probe: a host codec scope gate, not a device fallback.
_DCT_COUNTS = {"served": 0, "out_of_scope": 0}
_DCT_LOCK = threading.Lock()


def set_transport_dct(on: bool) -> None:
    """Flip the dct transport on/off (wired from --transport-dct)."""
    global _TRANSPORT_DCT
    _TRANSPORT_DCT = bool(on)


def transport_dct_enabled() -> bool:
    return _TRANSPORT_DCT


def set_transport_dct_egress(on: bool) -> None:
    """Flip dct egress on/off (wired from --transport-dct-egress)."""
    global _TRANSPORT_DCT_EGRESS
    _TRANSPORT_DCT_EGRESS = bool(on)


def transport_dct_egress_enabled() -> bool:
    return _TRANSPORT_DCT_EGRESS


def dct_counts() -> dict:
    """A copy of the dct transport's counters."""
    with _DCT_LOCK:
        return dict(_DCT_COUNTS)


def _count_dct(key: str) -> None:
    with _DCT_LOCK:
        _DCT_COUNTS[key] += 1


def _pick_egress(o: ImageOptions, target: ImageType) -> str:
    """"dct" when this request should drain quantized coefficients.

    Baseline-JPEG output only: encode_quantized writes baseline 4:2:0
    scans, so progressive (interlace) requests keep the pixel readback
    and the normal encoder."""
    if not _TRANSPORT_DCT_EGRESS:
        return ""
    if target is not ImageType.JPEG or o.interlace:
        return ""
    return "dct"


@dataclasses.dataclass
class ProcessedImage:
    body: bytes
    mime: str
    width: int = 0
    height: int = 0


def _encode_type(o: ImageOptions, source: ImageType) -> ImageType:
    """Output format resolution (ref: Process type handling + type.go)."""
    if o.type and o.type != "auto":
        t = image_type(o.type)
        if t is ImageType.UNKNOWN:
            raise new_error("Unsupported output image format", 400)
        return t
    return source if source in ENCODABLE else ImageType.JPEG


# Targets whose failed encode the reference retries as JPEG (image.go:99-103)
_JPEG_FALLBACK = (ImageType.WEBP, ImageType.HEIF, ImageType.AVIF)


def _encode(arr, o: ImageOptions, target: ImageType) -> ProcessedImage:
    """Encode an HWC uint8 array, YuvPlanes from the packed transports
    (raw-plane JPEG path, no host color math), or QuantizedBlocks from the
    dct egress (entropy-coded as they are: `_pick_egress` chose the egress
    only for a baseline JPEG target).

    The reference's fallbacks (pipeline.py:159-192): blocks whose entropy
    encode fails are rebuilt into planes, planes whose raw encode fails
    into RGB, and a WEBP, HEIF or AVIF encode that fails is retried as
    JPEG and reported so."""
    # the last stage boundary: a request whose budget expired on the
    # device pays for no encode
    deadline_mod.check("encode")
    failpoints.hit("codec.encode")
    opts = EncodeOptions(
        type=target,
        quality=o.quality,
        compression=o.compression,
        interlace=o.interlace,
        palette=o.palette,
        speed=o.speed,
        strip_metadata=o.strip_metadata,
    )
    t0 = time.monotonic()
    if isinstance(arr, jpeg_dct.QuantizedBlocks):
        if target is ImageType.JPEG and not o.interlace:
            try:
                body = jpeg_dct.encode_quantized(arr)
                TIMES.record("encode", (time.monotonic() - t0) * 1000.0)
                COPIES.add("encode", len(body))
                return ProcessedImage(body=body, mime=get_image_mime_type(target))
            except ImageError:
                pass
        arr = YuvPlanes(*jpeg_dct.blocks_to_planes(arr))
    if isinstance(arr, YuvPlanes):
        if target is ImageType.JPEG:
            try:
                body = codecs.encode_yuv(arr, opts)
                TIMES.record("encode", (time.monotonic() - t0) * 1000.0)
                COPIES.add("encode", len(body))
                return ProcessedImage(body=body, mime=get_image_mime_type(target))
            except ImageError:
                pass
        arr = codecs.yuv_planes_to_rgb(arr)
    try:
        body, actual = codecs.encode(arr, opts), target
    except ImageError as e:
        if target not in _JPEG_FALLBACK:
            raise
        opts.type = ImageType.JPEG
        body, actual = codecs.encode(arr, opts), ImageType.JPEG
    TIMES.record("encode", (time.monotonic() - t0) * 1000.0)
    COPIES.add("encode", len(body))
    return ProcessedImage(body=body, mime=get_image_mime_type(actual))


def _carry_metadata(src_buf: bytes, strip: bool, out: ProcessedImage,
                    orientation_applied: bool, out_w: int = 0,
                    out_h: int = 0) -> ProcessedImage:
    """Preserve source EXIF/ICC on JPEG output unless stripmeta is set;
    Orientation resets to 1 when the chain applied the EXIF rotation and
    PixelX/YDimension re-sync to the output geometry (as libvips does)."""
    out.width = out_w
    out.height = out_h
    if strip or out.mime != "image/jpeg":
        return out
    segs = codecs.jpeg_metadata_segments(src_buf)
    if not segs:
        return out
    segs = [
        codecs.patch_exif_segment(
            s,
            orientation=1 if orientation_applied else None,
            pixel_w=out_w or None,
            pixel_h=out_h or None,
        )
        if s[4:10] == b"Exif\x00\x00" else s
        for s in segs
    ]
    body = codecs.insert_jpeg_segments(out.body, segs)
    COPIES.add("encode", len(body))  # the splice copies the body again
    return ProcessedImage(body=body, mime=out.mime, width=out_w, height=out_h)


def _run_stages(arr, plan: ImagePlan, device, runner=None):
    """Device execution; device failures surface as 400 (ref: Process
    recover(), image.go:82-94).

    runner: (arr, plan) -> output; defaults to `chain.run_single` on
    `device`, and the web layer passes `Executor.process` for
    micro-batched dispatch."""
    if not plan.stages:
        return arr
    try:
        # the "execute" span covers submit -> result: the executor's
        # queue, launch and drain
        with obs_trace.span("execute"):
            if runner is None:
                out = chain_mod.run_single(arr, plan, device=device)
            else:
                out = runner(arr, plan)
            # the drained frame; YuvPlanes and QuantizedBlocks book at
            # their encode instead
            nb = getattr(out, "nbytes", 0)
            if nb:
                COPIES.add("transform", int(nb))
            return out
    except (RuntimeError, ValueError, TypeError) as e:
        raise new_error(f"image processing error: {e}", 400) from None


def info(buf: bytes, o: ImageOptions) -> ProcessedImage:
    """The /info JSON from a header probe (ref: Info, image.go:56-79)."""
    try:
        meta = codecs.probe(buf)
    except ImageError as e:
        raise new_error("Cannot retrieve image metadata: " + e.message, 400) from None
    return ProcessedImage(body=json.dumps(meta.to_dict()).encode(),
                          mime="application/json")


def process_operation(name: str, buf: bytes, o: ImageOptions, device="cuda",
                      meta=None, runner=None,
                      watermark_rgba: Optional[np.ndarray] = None,
                      frame_cache=None, source_digest=None) -> ProcessedImage:
    """Run one named operation end to end (decode -> device -> encode).

    meta: an ImageMetadata the caller already probed, so the hot path
    parses headers once. runner: see `_run_stages`. watermark_rgba: the
    HxWx4 uint8 mark of `watermarkImage` (and of every `watermarkImage`
    op of a pipeline). frame_cache, source_digest: the decoded-frame tier
    (cache.FrameCache) and the source's sha256 (module docstring)."""
    if name == "info":
        return info(buf, o)
    if name == "pipeline":
        return process_pipeline(buf, o, device=device, meta=meta, runner=runner,
                                watermark_rgba=watermark_rgba,
                                frame_cache=frame_cache, source_digest=source_digest)
    if name not in OPERATION_NAMES:
        raise new_error(f"Unsupported operation: {name}", 400)
    t_start = time.monotonic()
    src_type = determine_image_type(buf)
    if meta is None and src_type in _SHRINK_TYPES:
        try:
            meta = codecs.probe_fast(buf)
        except ImageError:
            meta = None  # the decode below raises the user-facing error
    shrink = _pick_shrink(name, src_type, o, meta)
    TIMES.record("probe", (time.monotonic() - t_start) * 1000.0)

    if _dct_eligible(src_type, meta, o):
        out = _process_dct(name, buf, o, meta, shrink, device, runner, watermark_rgba,
                           frame_cache, source_digest)
        if out is not None:
            TIMES.record("total", (time.monotonic() - t_start) * 1000.0)
            return out

    if _yuv_eligible(src_type, meta, o):
        out = _process_yuv420(name, buf, o, meta, shrink, device, runner, watermark_rgba,
                              frame_cache, source_digest)
        if out is not None:
            TIMES.record("total", (time.monotonic() - t_start) * 1000.0)
            return out

    d = _decode_cached(buf, shrink, frame_cache, source_digest)
    plan = plan_operation(name, o, d.array.shape[0], d.array.shape[1], d.orientation,
                          d.array.shape[2], watermark_rgba=watermark_rgba)
    arr = _run_stages(d.array, plan, device, runner)
    out = _encode(arr, o, _encode_type(o, d.type))
    out = _carry_metadata(buf, o.strip_metadata, out, not o.no_rotation,
                          plan.out_w, plan.out_h)
    TIMES.record("total", (time.monotonic() - t_start) * 1000.0)
    return out


def _decode_cached(buf: bytes, shrink: int, frame_cache=None, digest=None):
    """The rgb transport's host decode, fronted by the decoded-frame tier
    and timed into TIMES. A stored array is marked read-only before it is
    shared: every consumer (the launch's staging copy, the host
    interpreter, the encoders) only reads its input."""
    t0 = time.monotonic()
    key = None
    if frame_cache is not None and digest is not None:
        key = (digest, shrink, "rgb")
        d = frame_cache.get(key)
        if d is not None:
            TIMES.record("decode", (time.monotonic() - t0) * 1000.0)
            return d
    failpoints.hit("codec.decode")
    d = codecs.decode(buf, shrink)
    COPIES.add("decode", d.array.nbytes)
    if key is not None:
        d.array.setflags(write=False)
        frame_cache.put(key, d, d.array.nbytes)
    TIMES.record("decode", (time.monotonic() - t0) * 1000.0)
    return d


def _dct_eligible(src_type, meta, o: ImageOptions) -> bool:
    """Gate for the compressed-domain transport: the switch on, a JPEG in
    (4:2:0, 4:2:2, 4:4:4 or grayscale by its header), JPEG out. Coarser
    than the entropy codec's own scope check, which decode_packed runs."""
    if not _TRANSPORT_DCT:
        return False
    if src_type is not ImageType.JPEG or meta is None:
        return False
    if meta.subsampling not in ("420", "422", "444", "gray"):
        return False
    return o.type in _JPEG_TYPE_NAMES


def _decode_dct_packed(buf, shrink, sh, sw, frame_cache=None, digest=None):
    """Entropy-decode + dequantize + fold + pack the coefficients for the
    card's IDCT. Returns (packed, layout, frame_key), or None (counted)
    when the stream is outside the codec's scope or its frame dims
    disagree with the probe's: the request then takes the yuv420/rgb
    path. The packed buffer caches under its own kind tag, and the same
    key is the plan's frame_key for the device tier (None without a
    digest)."""
    fkey = (digest, shrink, "dct") if digest is not None else None
    if frame_cache is not None and fkey is not None:
        hit = frame_cache.get(fkey)
        if hit is not None:
            return hit + (fkey,)
    t0 = time.monotonic()
    failpoints.hit("codec.decode")
    got = jpeg_dct.decode_packed(buf, shrink)
    if got is None or (got[1], got[2]) != (sh, sw):
        _count_dct("out_of_scope")
        return None
    TIMES.record("decode", (time.monotonic() - t0) * 1000.0)
    packed, layout = got[0], got[3]
    COPIES.add("decode", packed.nbytes)
    if frame_cache is not None and fkey is not None:
        packed.setflags(write=False)
        frame_cache.put(fkey, (packed, layout), packed.nbytes)
    return packed, layout, fkey


def _process_dct(name, buf, o, meta, shrink, device, runner, watermark_rgba,
                 frame_cache=None, source_digest=None) -> Optional[ProcessedImage]:
    """Serve a JPEG->JPEG request over the compressed-domain transport;
    None hands it to the yuv420/rgb paths: an identity chain (which the
    yuv420 path serves from raw planes with no device work, so it is
    planned before any entropy decode) or an out-of-scope stream.
    Parameter errors raise exactly as the other paths would."""
    sh = -(-meta.height // shrink)
    sw = -(-meta.width // shrink)
    plan = plan_operation(name, o, sh, sw, meta.orientation, 3,
                          watermark_rgba=watermark_rgba)
    if not plan.stages:
        return None
    got = _decode_dct_packed(buf, shrink, sh, sw, frame_cache, source_digest)
    if got is None:
        return None
    packed, layout, fkey = got
    target = _encode_type(o, ImageType.JPEG)
    wrapped = wrap_plan_dct(plan, meta.height, meta.width, shrink, frame_key=fkey,
                            layout=layout, egress=_pick_egress(o, target),
                            egress_quality=o.quality if o.quality > 0 else 80)
    out = _encode(_run_stages(packed, wrapped, device, runner), o, target)
    _count_dct("served")
    return _carry_metadata(buf, o.strip_metadata, out, not o.no_rotation,
                           plan.out_w, plan.out_h)


def _yuv_eligible(src_type, meta, o: ImageOptions) -> bool:
    """Gate for the packed-YUV420 transport: plain 4:2:0 JPEG in, JPEG out,
    raw codec entry points present (a codec that fails to build raises)."""
    if src_type is not ImageType.JPEG or meta is None:
        return False
    if meta.subsampling != "420":
        return False
    return o.type in _JPEG_TYPE_NAMES and codecs.yuv420_supported()


def _decode_yuv_packed(buf, shrink, sh, sw, frame_cache=None, digest=None):
    """Raw-decode into the packed layout; None means 'use the RGB path'
    (non-420 surprise or probe/decode disagreement — the RGB decode then
    raises any user-facing error itself). The packed buffer caches under
    its own kind tag: it is another pixel layout than the RGB decode of
    the same digest."""
    hb, wb = bucket_shape(sh, sw)
    key = None
    if frame_cache is not None and digest is not None:
        key = (digest, shrink, "yuv", hb, wb)
        hit = frame_cache.get(key)
        if hit is not None:
            return hit
    t0 = time.monotonic()
    failpoints.hit("codec.decode")
    try:
        packed, h, w, _orient = codecs.decode_yuv420(buf, shrink, hb, wb)
    except ImageError:
        return None
    if (h, w) != (sh, sw):
        return None
    TIMES.record("decode", (time.monotonic() - t0) * 1000.0)
    COPIES.add("decode", packed.nbytes)
    if key is not None:
        packed.setflags(write=False)
        frame_cache.put(key, (packed, hb, wb), packed.nbytes)
    return packed, hb, wb


def _process_yuv420(name, buf, o, meta, shrink, device, runner, watermark_rgba,
                    frame_cache=None, source_digest=None) -> Optional[ProcessedImage]:
    """Serve a JPEG->JPEG request over the packed-plane transport; None
    falls back to the RGB path. Parameter errors raise exactly as the RGB
    path would, since the plan math is identical."""
    sh = -(-meta.height // shrink)
    sw = -(-meta.width // shrink)
    got = _decode_yuv_packed(buf, shrink, sh, sw, frame_cache, source_digest)
    if got is None:
        return None
    packed, hb, wb = got
    plan = plan_operation(name, o, sh, sw, meta.orientation, 3,
                          watermark_rgba=watermark_rgba)
    target = _encode_type(o, ImageType.JPEG)
    if not plan.stages:
        # identity chain: planes go straight back to the raw encoder
        out = _encode(codecs.unpack_planes(packed, sh, sw, hb, wb), o, target)
    else:
        wrapped = wrap_plan_yuv420(plan, sh, sw)
        out = _encode(_run_stages(packed, wrapped, device, runner), o, target)
    return _carry_metadata(buf, o.strip_metadata, out, not o.no_rotation,
                           plan.out_w, plan.out_h)


# Sources with shrink-on-load: JPEG (DCT scaling) and SVG (rendered
# straight into the 1/N box), as the reference's `_pick_shrink`
_SHRINK_TYPES = (ImageType.JPEG, ImageType.SVG)


def _pick_shrink(name: str, src_type: ImageType, o: ImageOptions, meta) -> int:
    """Shrink-on-load denominator for this request (1 = full decode) of a
    JPEG or SVG source: the planner proves by re-planning that decoding at
    1/N preserves the output."""
    if src_type not in _SHRINK_TYPES or meta is None:
        return 1
    try:
        return choose_decode_shrink(name, o, meta.height, meta.width,
                                    meta.orientation, max(3, meta.channels))
    except ImageError:
        return 1



def process_pipeline(buf: bytes, o: ImageOptions, device="cuda", meta=None,
                     runner=None,
                     watermark_rgba: Optional[np.ndarray] = None,
                     frame_cache=None, source_digest=None) -> ProcessedImage:
    """Fused multi-op pipeline (ref: Pipeline, image.go:379-410).

    All ops' stages concatenate into ONE chain; `ignore_failure` skips an
    op whose planning fails (the reference skips ops whose execution
    fails; planning is where the validation happens)."""
    if not o.operations:
        raise new_error("Missing pipeline operations", 400)
    if len(o.operations) > MAX_PIPELINE_OPERATIONS:
        raise new_error(f"Maximum pipeline operations ({MAX_PIPELINE_OPERATIONS}) exceeded", 400)
    src_type = determine_image_type(buf)
    if meta is None and src_type in _SHRINK_TYPES:
        try:
            meta = codecs.probe_fast(buf)
        except ImageError:
            meta = None  # the decode below raises the user-facing error

    # Shrink-on-load keyed to the FIRST op: its planner proof keeps that
    # op's output dims at 1/N decode, and every later op sees only them.
    shrink = 1
    first = o.operations[0]
    if first.name in OPERATION_NAMES:
        try:
            shrink = _pick_shrink(first.name, src_type, build_params_from_operation(first), meta)
        except ParamError:
            shrink = 1

    # The packed transport only pays off when the OUTPUT is JPEG too: any
    # op requesting another type keeps the whole request on the RGB path.
    ops_keep_jpeg = all(
        (op.params or {}).get("type") in (None,) + _JPEG_TYPE_NAMES
        for op in o.operations
    )
    if ops_keep_jpeg and _dct_eligible(src_type, meta, o):
        sh = -(-meta.height // shrink)
        sw = -(-meta.width // shrink)
        combined, final_o, target, rotated, strip = _build_pipeline_plan(
            o, sh, sw, meta.orientation, 3, ImageType.JPEG, watermark_rgba)
        # identity chains go on to the yuv path, which serves them
        # straight from raw planes with no device round trip at all
        got = (_decode_dct_packed(buf, shrink, sh, sw, frame_cache, source_digest)
               if combined.stages else None)
        if got is not None:
            packed, layout, fkey = got
            q = final_o.quality if final_o.quality > 0 else 80
            wrapped = wrap_plan_dct(combined, meta.height, meta.width, shrink,
                                    frame_key=fkey, layout=layout,
                                    egress=_pick_egress(final_o, target),
                                    egress_quality=q)
            out = _encode(_run_stages(packed, wrapped, device, runner), final_o, target)
            _count_dct("served")
            return _carry_metadata(buf, strip, out, rotated, combined.out_w, combined.out_h)

    if ops_keep_jpeg and _yuv_eligible(src_type, meta, o):
        sh = -(-meta.height // shrink)
        sw = -(-meta.width // shrink)
        got = _decode_yuv_packed(buf, shrink, sh, sw, frame_cache, source_digest)
        if got is not None:
            packed, hb, wb = got
            combined, final_o, target, rotated, strip = _build_pipeline_plan(
                o, sh, sw, meta.orientation, 3, ImageType.JPEG, watermark_rgba)
            if not combined.stages:
                planes = codecs.unpack_planes(packed, sh, sw, hb, wb)
                out = _encode(planes, final_o, target)
            else:
                wrapped = wrap_plan_yuv420(combined, sh, sw)
                out = _encode(_run_stages(packed, wrapped, device, runner), final_o, target)
            return _carry_metadata(buf, strip, out, rotated, combined.out_w, combined.out_h)

    d = _decode_cached(buf, shrink, frame_cache, source_digest)
    combined, final_o, target, rotated, strip = _build_pipeline_plan(
        o, d.array.shape[0], d.array.shape[1], d.orientation, d.array.shape[2], d.type,
        watermark_rgba)
    arr = _run_stages(d.array, combined, device, runner)
    out = _encode(arr, final_o, target)
    return _carry_metadata(buf, strip, out, rotated, combined.out_w, combined.out_h)


def _build_pipeline_plan(o, cur_h, cur_w, orientation, channels, src_type,
                         watermark_rgba=None):
    """Concatenate every op's stages into one combined plan (host math
    only, so both transports share it); every `watermarkImage` op takes
    `watermark_rgba`. Returns (plan, the last op's
    options, the output type, whether the EXIF rotation was applied, and
    whether any op strips metadata)."""
    src_h0, src_w0 = cur_h, cur_w
    stages: list = []
    final_o = o
    target = _encode_type(o, src_type)
    orientation_applied = False
    # stripmeta on ANY op (or top-level) strips: the reference re-encodes
    # per op, so a mid-chain StripMetadata removes metadata for good
    strip = o.strip_metadata
    for i, op in enumerate(o.operations):
        if op.name not in OPERATION_NAMES:  # info/pipeline are not nestable
            raise new_error(f"Unsupported operation: {op.name}", 400)
        try:
            op_opts = build_params_from_operation(op)
        except ParamError as e:
            raise new_error(f"pipeline operation {i+1} failed: {e}", 400) from None
        try:
            plan = plan_operation(op.name, op_opts, cur_h, cur_w, orientation, channels,
                                  watermark_rgba=watermark_rgba)
        except ImageError:
            if op.ignore_failure:
                continue
            raise
        if orientation > 1 and not op_opts.no_rotation:
            orientation_applied = True
        strip = strip or op_opts.strip_metadata
        stages.extend(plan.stages)
        cur_h, cur_w = plan.out_h, plan.out_w
        orientation = 0  # EXIF applies once; later ops see upright pixels
        final_o = op_opts
        if op_opts.type:
            target = _encode_type(op_opts, src_type)
    stages = fuse_adjacent_shrinking_samples(stages, src_h0, src_w0)
    return (ImagePlan(stages=stages, out_h=cur_h, out_w=cur_w), final_o,
            target, orientation_applied, strip)

