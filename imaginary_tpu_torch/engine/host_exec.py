"""Host interpreter of an ImagePlan: the port's copy of
`imaginary_tpu/engine/host_exec.py`, with the reference's names.

The executor places work on the host on purpose, and counts it:
`--force-host`, the cost model's spill (`--host-spill`), the breaker's
host serving while every device is quarantined, a hedge's host twin,
an OOM bisection's item that still does not fit alone, the poison
quarantine's convicts, sampled verification's reference and the golden
probe's reference (engine/executor.py, engine/integrity.py). It is never
a stand-in for a kernel: a kernel that fails to build or launch raises.

The interpreter executes the same stage chain the card would run, one
image at a time with exact dims (no bucket padding). Resampling kernels
are the host library's nearest equivalent (cv2 -> the native separable
resampler of native/resample.cpp -> numpy taps), so outputs may differ
from the card's at the level of filter choice: dimensions exact, content
within the integrity bars (engine/integrity.py).
"""

from __future__ import annotations

import functools

import numpy as np

from imaginary_tpu_torch.options import Extend
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
    ToYuv420Spec,
    TransposeSpec,
)

try:  # OpenCV releases the GIL inside its SIMD loops — ideal for the spill path
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False


_HOST_SPECS = (
    SampleSpec,
    ExtractSpec,
    EmbedSpec,
    FlipSpec,
    FlopSpec,
    TransposeSpec,
    BlurSpec,
    CompositeSpec,
    ShrinkBucketSpec,
    GraySpec,
    SmartExtractSpec,
    FromYuv420Spec,
    ToYuv420Spec,
)


# Host-side DCT-domain shrink-on-load for compressed-domain work placed on
# the host (--host-dct-spill; set by the service like
# pipeline.set_transport_dct).
# Off restores the pre-dct spill behavior: dct plans never place on the
# host and spill falls back to the full-decode path upstream.
_DCT_SPILL = True


def set_dct_spill(on: bool) -> None:
    global _DCT_SPILL
    _DCT_SPILL = bool(on)


def dct_spill_enabled() -> bool:
    return _DCT_SPILL


def can_execute(plan, for_spill: bool = True) -> bool:
    """True when every stage of the plan has a host interpretation.

    With for_spill (the executor's placement check), smartcrop chains are
    excluded: the host and device saliency maps can legitimately pick
    different windows, and a request's crop must not depend on link load.

    Compressed-domain (dct-transport) plans qualify when --host-dct-spill
    is on and the plan drains through ToYuv420 — _run_dct reconstructs the
    planes with the same scaled IDCT the device runs. Egress plans
    (ToDctSpec drain) stay on the device: the host has no quantizer.
    """
    stages = plan.stages
    if getattr(plan, "transport", "") == "dct":
        if not _DCT_SPILL:
            return False
        if (not stages or not isinstance(stages[0].spec, FromDctSpec)
                or not isinstance(stages[-1].spec, ToYuv420Spec)):
            return False
        stages = stages[1:-1]
    for st in stages:
        if not isinstance(st.spec, _HOST_SPECS):
            return False
        if for_spill and isinstance(st.spec, SmartExtractSpec):
            return False
    return True


def run(arr: np.ndarray, plan):
    """Execute a plan on one HWC uint8 image; returns HWC uint8 (or
    YuvPlanes for packed-transport plans)."""
    if plan.transport == "dct":
        return _run_dct(arr, plan)
    if plan.transport == "yuv420":
        return _run_yuv(arr, plan)
    x = arr
    for st in plan.stages:
        x = _apply(st.spec, x, st.dyn)
    if x.dtype != np.uint8:
        x = np.clip(x + 0.5, 0.0, 255.0).astype(np.uint8)  # device rounding
    return np.ascontiguousarray(x)


def _round_u8(x):
    if x.dtype != np.uint8:
        x = np.clip(x + 0.5, 0.0, 255.0).astype(np.uint8)
    return np.ascontiguousarray(x)


def _run_yuv(arr: np.ndarray, plan):
    """Spill execution for packed-YUV420 plans.

    The hot shape — [FromYuv420, Sample..., ToYuv420] — resizes each plane
    directly (Y at full dims, chroma at ceil/2), skipping the RGB round
    trip entirely; that keeps a spilled resize ~3x cheaper than the RGB
    interpreter, which matters because spill exists to absorb load the
    link can't. Chains with non-resample stages take the general route:
    planes -> RGB -> stage loop -> planes.
    """
    from imaginary_tpu_torch.codecs import YuvPlanes, unpack_planes

    ph, wb = plan.in_bucket
    hb = (ph * 2) // 3
    h, w = plan.in_h, plan.in_w
    planes = unpack_planes(arr, h, w, hb, wb)
    inner = plan.stages[1:-1]

    _PLANE_SPECS = (SampleSpec, ExtractSpec, ShrinkBucketSpec, FlipSpec,
                    FlopSpec, TransposeSpec, BlurSpec)
    if all(isinstance(st.spec, _PLANE_SPECS) for st in inner):
        return _planewise(planes, inner)

    x = _i420_to_rgb(planes)
    for st in inner:
        x = _apply(st.spec, x, st.dyn)
    return _rgb_to_i420(x)


@functools.lru_cache(maxsize=8)
def _np_idct_basis(k: int) -> np.ndarray:
    """Host port of ops/stages._idct_basis: the scaled k-point IDCT basis
    (orthonormal cosines times JPEG's sqrt(k/8) reduced-decode energy
    factor), so a spilled dct plan reconstructs the SAME pixels the device
    program would up to f32 contraction order."""
    u = np.arange(k, dtype=np.float64)[:, None]
    x = np.arange(k, dtype=np.float64)[None, :]
    beta = np.where(u == 0, np.sqrt(1.0 / k), np.sqrt(2.0 / k))
    basis = beta * np.cos((2.0 * x + 1.0) * u * np.pi / (2.0 * k))
    return (basis * np.sqrt(k / 8.0)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _np_idct_kernel(kv: int, kh: int) -> np.ndarray:
    """The separable kv x kh IDCT as one fused (kv*kh, kv*kh) float32
    matrix K[(u,v),(x,z)] = bv[u,x] * bh[v,z], so the blockwise IDCT is a
    single GEMM over the flattened block grid."""
    bv = _np_idct_basis(kv).astype(np.float64)
    bh = _np_idct_basis(kh).astype(np.float64)
    K = np.einsum("ux,vz->uvxz", bv, bh).reshape(kv * kh, kv * kh)
    return np.ascontiguousarray(K.astype(np.float32))


def _idct_plane(plane: np.ndarray, kv: int, kh: int) -> np.ndarray:
    """Blockwise kv x kh scaled IDCT of one folded-coefficient plane
    (+128 level restore), same contraction as FromDctSpec.apply up to
    f32 contraction order — one GEMM against the fused kernel."""
    ph, pw = plane.shape
    rows, cols = ph // kv, pw // kh
    blk = plane.reshape(rows, kv, cols, kh).transpose(0, 2, 1, 3)
    flat = blk.reshape(rows * cols, kv * kh).astype(np.float32)
    out = flat @ _np_idct_kernel(kv, kh)
    out = out.reshape(rows, cols, kv, kh).transpose(0, 2, 1, 3)
    return out.reshape(ph, pw) + np.float32(128.0)


def _halve(c: np.ndarray) -> np.ndarray:
    """2x2 box average with edge replication on odd trailing dims — the
    chroma downsample ToYuv420Spec would run at the drain. Four strided
    adds, not a reshape+mean reduction (the strided reduce was ~1 ms per
    chroma plane at 1080p)."""
    h, w = c.shape
    if h % 2 or w % 2:
        c = np.pad(c, ((0, h % 2), (0, w % 2)), mode="edge")
    q = np.float32(0.25)
    return (c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2] + c[1::2, 1::2]) * q


def _halve_v(c: np.ndarray) -> np.ndarray:
    """Vertical 2x box average (4:2:2 chroma is already half-width)."""
    if c.shape[0] % 2:
        c = np.pad(c, ((0, 1), (0, 0)), mode="edge")
    return (c[0::2, :] + c[1::2, :]) * np.float32(0.5)


def _run_dct(arr: np.ndarray, plan):
    """Spill execution for compressed-domain (dct-transport) plans:
    DCT-domain shrink-on-load, entirely on the host.

    The packed buffer already carries frequency-FOLDED coefficients
    (codecs/jpeg_dct.pack_dct), so for shrink > 1 the k-point scaled IDCT
    lands every plane directly at the shrunk size — the host never
    materializes full-resolution pixels, which is the whole ns/byte win
    over decode-then-resample. Chroma normalizes to 4:2:0 geometry right
    after the IDCT (the drain is ToYuv420 anyway), then the inner stages
    run planewise exactly like the yuv420 spill path.
    """
    from imaginary_tpu_torch.codecs import YuvPlanes

    spec = plan.stages[0].spec
    hb, wb, k, layout = spec.hb, spec.wb, spec.k, spec.layout
    h, w = plan.in_h, plan.in_w
    x = np.asarray(arr)
    ch, cw = (h + 1) // 2, (w + 1) // 2
    if layout == "gray":
        y = _idct_plane(x[:, :, 0], k, k)[:h, :w]
        u = np.full((ch, cw), 128.0, dtype=np.float32)
        v = np.full((ch, cw), 128.0, dtype=np.float32)
    elif layout == "444":
        y = _idct_plane(x[:, :, 0], k, k)[:h, :w]
        u = _halve(_idct_plane(x[:, :, 1], k, k)[:h, :w])
        v = _halve(_idct_plane(x[:, :, 2], k, k)[:h, :w])
    elif layout == "422":
        if k == 8:
            y = _idct_plane(x[:hb, :, 0], 8, 8)[:h, :w]
            u = _halve_v(_idct_plane(x[hb:, : wb // 2, 0], 8, 8)[:h, :cw])
            v = _halve_v(_idct_plane(x[hb:, wb // 2 :, 0], 8, 8)[:h, :cw])
        else:
            y = _idct_plane(x[:, :, 0], k, k)[:h, :w]
            u = _halve(_idct_plane(x[:, :, 1], k, 2 * k)[:h, :w])
            v = _halve(_idct_plane(x[:, :, 2], k, 2 * k)[:h, :w])
    else:  # 420
        if k == 8:
            y = _idct_plane(x[:hb, :, 0], 8, 8)[:h, :w]
            u = _idct_plane(x[hb:, : wb // 2, 0], 8, 8)[:ch, :cw]
            v = _idct_plane(x[hb:, wb // 2 :, 0], 8, 8)[:ch, :cw]
        else:
            y = _idct_plane(x[:, :, 0], k, k)[:h, :w]
            u = _halve(_idct_plane(x[:, :, 1], 2 * k, 2 * k)[:h, :w])
            v = _halve(_idct_plane(x[:, :, 2], 2 * k, 2 * k)[:h, :w])
    planes = YuvPlanes(y=_round_u8(y[:, :, None])[:, :, 0],
                       u=_round_u8(u[:, :, None])[:, :, 0],
                       v=_round_u8(v[:, :, None])[:, :, 0])
    inner = plan.stages[1:-1]
    _PLANE_SPECS = (SampleSpec, ExtractSpec, ShrinkBucketSpec, FlipSpec,
                    FlopSpec, TransposeSpec, BlurSpec)
    if all(isinstance(st.spec, _PLANE_SPECS) for st in inner):
        return _planewise(planes, inner)
    rgb = _i420_to_rgb(planes)
    for st in inner:
        rgb = _apply(st.spec, rgb, st.dyn)
    return _rgb_to_i420(rgb)


def _planewise(planes, inner):
    """Geometry/blur chains run on the subsampled planes directly — no
    color-space round trip at all. Chroma windows/mirrors land on halved
    coordinates (a <=1 luma-pixel chroma-siting shift on odd offsets and
    odd-dim mirrors), and chroma blurs at sigma/2 — all within this path's
    documented PSNR-equivalence to the device output."""
    from imaginary_tpu_torch.codecs import YuvPlanes

    y3 = planes.y[:, :, None]
    u3 = planes.u[:, :, None]
    v3 = planes.v[:, :, None]
    for st in inner:
        spec = st.spec
        if isinstance(spec, ShrinkBucketSpec):
            continue  # host buffers are never bucket-padded
        if isinstance(spec, SampleSpec):
            dh, dw = int(st.dyn["dst_h"]), int(st.dyn["dst_w"])
            y3 = _apply(spec, y3, st.dyn)
            cdyn = {"dst_h": np.float32((dh + 1) // 2), "dst_w": np.float32((dw + 1) // 2)}
            u3 = _apply(spec, u3, cdyn)
            v3 = _apply(spec, v3, cdyn)
        elif isinstance(spec, ExtractSpec):
            top, left = int(st.dyn["top"]), int(st.dyn["left"])
            nh, nw = int(st.dyn["new_h"]), int(st.dyn["new_w"])
            y3 = y3[top : top + nh, left : left + nw]
            ct, cl = top // 2, left // 2
            ch, cw = (nh + 1) // 2, (nw + 1) // 2
            u3 = u3[ct : ct + ch, cl : cl + cw]
            v3 = v3[ct : ct + ch, cl : cl + cw]
        elif isinstance(spec, BlurSpec):
            half = {"sigma": np.float32(float(st.dyn["sigma"]) / 2.0)}
            y3 = _apply(spec, y3, st.dyn)
            u3 = _apply(spec, u3, half)
            v3 = _apply(spec, v3, half)
        else:  # Flip / Flop / Transpose apply identically per plane
            y3 = _apply(spec, y3, st.dyn)
            u3 = _apply(spec, u3, st.dyn)
            v3 = _apply(spec, v3, st.dyn)
    return YuvPlanes(y=_round_u8(y3)[:, :, 0], u=_round_u8(u3)[:, :, 0],
                     v=_round_u8(v3)[:, :, 0])


def _i420_to_rgb(planes) -> np.ndarray:
    """Planes -> RGB for the general spill path. cv2's SIMD full-range
    YCrCb converter (the JPEG convention — its *_I420 variants are
    video-range and would shift every pixel) runs ~10x the numpy fallback
    on megapixel images."""
    from imaginary_tpu_torch.codecs import yuv_planes_to_rgb

    h, w = planes.y.shape
    if _HAS_CV2:
        uu = cv2.resize(planes.u, (w, h), interpolation=cv2.INTER_LINEAR)
        vv = cv2.resize(planes.v, (w, h), interpolation=cv2.INTER_LINEAR)
        return cv2.cvtColor(cv2.merge([planes.y, vv, uu]), cv2.COLOR_YCrCb2RGB)
    return yuv_planes_to_rgb(planes)


def _rgb_to_i420(x: np.ndarray):
    """RGB (float or uint8) -> 4:2:0 planes for the general spill path."""
    from imaginary_tpu_torch.codecs import YuvPlanes

    out_h, out_w = x.shape[:2]
    if _HAS_CV2:
        ycc = cv2.cvtColor(_round_u8(x), cv2.COLOR_RGB2YCrCb)
        yy, cr, cb = cv2.split(ycc)
        ch, cw = (out_h + 1) // 2, (out_w + 1) // 2
        u = cv2.resize(cb, (cw, ch), interpolation=cv2.INTER_AREA)
        v = cv2.resize(cr, (cw, ch), interpolation=cv2.INTER_AREA)
        return YuvPlanes(y=yy, u=u, v=v)
    x = np.clip(np.asarray(x, np.float32), 0.0, 255.0)
    yy = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    cb = -0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2] + 128.0
    cr = 0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2] + 128.0
    # pad odd dims by edge replication, then 2x2 box average
    if out_h % 2 or out_w % 2:
        cb = np.pad(cb, ((0, out_h % 2), (0, out_w % 2)), mode="edge")
        cr = np.pad(cr, ((0, out_h % 2), (0, out_w % 2)), mode="edge")
    cb = cb.reshape(cb.shape[0] // 2, 2, cb.shape[1] // 2, 2).mean(axis=(1, 3))
    cr = cr.reshape(cr.shape[0] // 2, 2, cr.shape[1] // 2, 2).mean(axis=(1, 3))
    return YuvPlanes(y=_round_u8(yy), u=_round_u8(cb), v=_round_u8(cr))


# --- per-spec interpreters ----------------------------------------------------


def _apply(spec, x, dyn):
    if isinstance(spec, SampleSpec):
        dh, dw = int(dyn["dst_h"]), int(dyn["dst_w"])
        if (dh, dw) == x.shape[:2]:
            return x
        shrink_h = dh < x.shape[0]
        shrink_w = dw < x.shape[1]
        if _HAS_CV2 and (spec.kernel == "nearest" or (shrink_h and shrink_w)):
            if spec.kernel == "nearest":
                interp = cv2.INTER_NEAREST
            else:
                # minification: area averaging is the host analogue of the
                # device's stretched-kernel (antialiased) resample
                interp = cv2.INTER_AREA
            out = cv2.resize(x, (dw, dh), interpolation=interp)
            if out.ndim == 2:  # cv2 drops a trailing singleton channel
                out = out[:, :, None]
            return out
        # Mixed shrink/enlarge and pure-enlarge: separable two-pass resample
        # with precomputed per-axis taps — the device's sampling-matrix
        # scheme, so each axis antialiases independently and the kernel
        # matches the device's (cv2 has neither: no per-axis antialiasing,
        # and its LANCZOS4 is an 8-tap kernel the device never runs; its
        # enlarge path measured 75 ms vs 46 ms native lanczos3 on 1080p ->
        # 1440p). Native SIMD when the extension is built, vectorized
        # numpy taps otherwise — never the dense stretched-kernel matmul
        # (measured 59 SECONDS on that same enlarge).
        if x.dtype == np.uint8:
            out = _native_resize(x, dh, dw, spec.kernel)
            if out is not None:
                return out
        return _np_resize(x, dh, dw, spec.kernel)

    if isinstance(spec, ExtractSpec):
        top, left = int(dyn["top"]), int(dyn["left"])
        nh, nw = int(dyn["new_h"]), int(dyn["new_w"])
        return x[top : top + nh, left : left + nw]

    if isinstance(spec, EmbedSpec):
        return _embed(spec, x, dyn)

    if isinstance(spec, FlipSpec):
        return x[::-1]

    if isinstance(spec, FlopSpec):
        return x[:, ::-1]

    if isinstance(spec, TransposeSpec):
        return np.transpose(x, (1, 0, 2))

    if isinstance(spec, BlurSpec):
        sigma = float(dyn["sigma"])
        if sigma <= 0:
            return x
        k = 2 * spec.radius + 1
        if _HAS_CV2:
            out = cv2.GaussianBlur(x, (k, k), sigmaX=sigma, sigmaY=sigma,
                                   borderType=cv2.BORDER_REPLICATE)
            if out.ndim == 2:
                out = out[:, :, None]
            return out
        return _np_blur(x, spec.radius, sigma)

    if isinstance(spec, CompositeSpec):
        return _composite(spec, x, dyn)

    if isinstance(spec, ShrinkBucketSpec):
        return x  # host buffers are never bucket-padded

    if isinstance(spec, GraySpec):
        f = x.astype(np.float32)
        lum = 0.2126 * f[..., 0:1] + 0.7152 * f[..., 1:2] + 0.0722 * f[..., 2:3]
        out = np.concatenate([lum, lum, lum], axis=-1)
        if x.shape[2] == 4:
            out = np.concatenate([out, f[..., 3:]], axis=-1)
        return out

    if isinstance(spec, SmartExtractSpec):
        nh, nw = int(dyn["new_h"]), int(dyn["new_w"])
        top, left = _smart_offsets_host(x, nh, nw)
        return x[top : top + nh, left : left + nw]

    raise NotImplementedError(f"no host interpreter for {type(spec).__name__}")


def _embed(spec, x, dyn):
    ch, cw = int(dyn["canvas_h"]), int(dyn["canvas_w"])
    oy, ox = int(dyn["off_y"]), int(dyn["off_x"])
    h, w = x.shape[:2]
    pads = ((oy, max(0, ch - oy - h)), (ox, max(0, cw - ox - w)), (0, 0))
    if spec.mode is Extend.MIRROR:
        out = np.pad(x, pads, mode="symmetric")
    elif spec.mode in (Extend.COPY, Extend.LAST):
        out = np.pad(x, pads, mode="edge")
    else:
        fill = np.asarray(dyn["fill"], dtype=np.float32)
        if spec.mode is Extend.WHITE:
            pass  # fill already carries 255s from the planner
        out = np.empty((h + pads[0][0] + pads[0][1], w + pads[1][0] + pads[1][1], x.shape[2]),
                       dtype=np.float32)
        out[:] = fill[None, None, : x.shape[2]]
        out[oy : oy + h, ox : ox + w] = x
    return out[:ch, :cw]


def _composite(spec, x, dyn):
    f = x.astype(np.float32)
    h, w = f.shape[:2]
    bh, bw = int(dyn["block_h"]), int(dyn["block_w"])
    top, left = int(dyn["top"]), int(dyn["left"])
    ovl = np.asarray(dyn["overlay"], dtype=np.float32)[:bh, :bw]
    opacity = float(np.clip(dyn["opacity"], 0.0, 1.0))
    canvas = np.zeros((h, w, 4), dtype=np.float32)
    if spec.replicate:
        py = np.remainder(np.arange(h) - top, max(bh, 1))
        px = np.remainder(np.arange(w) - left, max(bw, 1))
        canvas = ovl[py][:, px]
    else:
        y0, x0 = max(0, top), max(0, left)
        y1, x1 = min(h, top + bh), min(w, left + bw)
        if y1 > y0 and x1 > x0:
            canvas[y0:y1, x0:x1] = ovl[y0 - top : y1 - top, x0 - left : x1 - left]
    alpha = canvas[..., 3:4] / 255.0 * opacity
    rgb = f[..., :3] * (1.0 - alpha) + canvas[..., :3] * alpha
    if f.shape[2] == 4:
        return np.concatenate([rgb, f[..., 3:]], axis=-1)
    return rgb


# Native separable resampler: resolved on first use (the codecs package
# imports lazily everywhere in this module — same cycle-avoidance idiom).
# None = not yet probed, False = unavailable, else the binding callable.
_NATIVE_RESAMPLE = None


def _native_resize(x, dh, dw, kernel):
    """Native separable resize of an HWC uint8 array, or None when the
    extension (full codecs or the resample-only build) isn't present."""
    global _NATIVE_RESAMPLE
    if _NATIVE_RESAMPLE is None:
        try:
            from imaginary_tpu_torch.codecs import native_backend

            _NATIVE_RESAMPLE = (
                native_backend.resize_separable
                if native_backend.resample_available() else False
            )
        except Exception:  # pragma: no cover - codecs package unimportable
            _NATIVE_RESAMPLE = False
    if not _NATIVE_RESAMPLE:
        return None
    try:
        return _NATIVE_RESAMPLE(x, dh, dw, kernel)
    except Exception:
        return None  # numpy taps serve; a native edge case must not 500


def _np_resize(x, dh, dw, kernel):
    """Separable precomputed-tap port of the device's sampling-matrix
    resample. Same weights as the device (per-axis stretch, edge-clamp
    renormalization) but evaluated over each output coordinate's ~2*radius*
    stretch contiguous taps instead of a dense [out, in] matmul — the
    dense port measured 59 s on a 1080p->1440p lanczos3; this runs it in
    tens of ms and the taps amortize across calls via _tap_table's LRU."""
    f = x.astype(np.float32)
    if dh != f.shape[0]:
        f = _resize_axis(f, dh, kernel, 0)
    if dw != f.shape[1]:
        f = _resize_axis(f, dw, kernel, 1)
    return f


_KERNEL_RADIUS = {"lanczos3": 3.0, "lanczos2": 2.0, "cubic": 2.0,
                  "linear": 1.0, "nearest": 0.5}


@functools.lru_cache(maxsize=128)
def _tap_table(out_n, in_n, kind):
    """(idx [out_n, taps] int64, wts [out_n, taps] f32) for one axis.

    Row y's taps cover the contiguous integer window around centre =
    (y+0.5)/scale - 0.5 within the stretched kernel's support; taps
    falling outside the source get zero weight and the row renormalizes
    over the rest (the sample_matrix edge-clamp scheme). Indices are
    clipped so gathers stay in-bounds. Keyed per (src, dst, kernel) —
    a small LRU because serving traffic concentrates on few geometries."""
    scale = out_n / in_n
    stretch = max(1.0, 1.0 / scale)
    support = _KERNEL_RADIUS.get(kind, 1.0) * stretch
    ntaps = int(np.ceil(2.0 * support)) + 1
    centre = (np.arange(out_n, dtype=np.float64) + 0.5) / scale - 0.5
    k0 = np.floor(centre - support).astype(np.int64) + 1
    idx = k0[:, None] + np.arange(ntaps)[None, :]
    d = ((idx - centre[:, None]) / stretch).astype(np.float32)
    wts = np.asarray(_np_kernel(kind, d), dtype=np.float32)
    wts = np.where((idx >= 0) & (idx < in_n), wts, np.float32(0.0))
    norm = wts.sum(axis=1, keepdims=True)
    wts = np.where(norm > 1e-6, wts / np.maximum(norm, 1e-6),
                   np.float32(0.0)).astype(np.float32)
    idx = np.clip(idx, 0, in_n - 1)
    idx.setflags(write=False)
    wts.setflags(write=False)
    return idx, wts


def _resize_axis(f, out_n, kind, axis):
    """One separable pass: gather + weighted-sum over the tap window,
    vectorized across the other axis and channels (a python loop only
    over the handful of taps)."""
    idx, wts = _tap_table(out_n, f.shape[axis], kind)
    out = None
    for t in range(wts.shape[1]):
        w = wts[:, t]
        if not w.any():
            continue
        if axis == 0:
            term = w[:, None, None] * f[idx[:, t]]
        else:
            term = w[None, :, None] * f[:, idx[:, t]]
        out = term if out is None else out + term
    if out is None:  # degenerate: all-zero rows (cannot happen for n>=1)
        shape = list(f.shape)
        shape[axis] = out_n
        out = np.zeros(shape, np.float32)
    return out


def _np_kernel(kind, d):
    ad = np.abs(d)
    if kind in ("lanczos3", "lanczos2"):
        a = 3.0 if kind == "lanczos3" else 2.0
        return np.where(ad < a, np.sinc(d) * np.sinc(d / a), 0.0)
    if kind == "cubic":
        a = -0.5
        w1 = (a + 2) * ad**3 - (a + 3) * ad**2 + 1
        w2 = a * ad**3 - 5 * a * ad**2 + 8 * a * ad - 4 * a
        return np.where(ad <= 1, w1, np.where(ad < 2, w2, 0.0))
    if kind == "linear":
        return np.maximum(0.0, 1.0 - ad)
    return np.where((d >= -0.5) & (d < 0.5), 1.0, 0.0)  # nearest


def _np_blur(x, radius, sigma):
    taps = np.arange(-radius, radius + 1, dtype=np.float32)
    kern = np.exp(-0.5 * (taps / max(sigma, 1e-3)) ** 2)
    kern /= kern.sum()
    f = x.astype(np.float32)
    pad = np.pad(f, ((radius, radius), (0, 0), (0, 0)), mode="edge")
    f = sum(kern[i] * pad[i : i + f.shape[0]] for i in range(2 * radius + 1))
    pad = np.pad(f, ((0, 0), (radius, radius), (0, 0)), mode="edge")
    return sum(kern[i] * pad[:, i : i + f.shape[1]] for i in range(2 * radius + 1))


def _smart_offsets_host(x, nh, nw):
    """Host analogue of ops/saliency.smart_offsets: gradient-magnitude
    saliency, integral image, best window by summed attention."""
    f = x[..., :3].astype(np.float32).mean(axis=-1)
    gy = np.abs(np.diff(f, axis=0, prepend=f[:1]))
    gx = np.abs(np.diff(f, axis=1, prepend=f[:, :1]))
    sal = gy + gx
    ii = np.zeros((sal.shape[0] + 1, sal.shape[1] + 1), dtype=np.float64)
    ii[1:, 1:] = sal.cumsum(0).cumsum(1)
    h, w = sal.shape
    nh, nw = min(nh, h), min(nw, w)
    ys = np.arange(0, h - nh + 1)
    xs = np.arange(0, w - nw + 1)
    # coarse stride keeps this O(few hundred) windows like the device kernel
    sy = max(1, len(ys) // 64)
    sx = max(1, len(xs) // 64)
    ys, xs = ys[::sy], xs[::sx]
    sums = (ii[ys[:, None] + nh, xs[None, :] + nw] - ii[ys[:, None], xs[None, :] + nw]
            - ii[ys[:, None] + nh, xs[None, :]] + ii[ys[:, None], xs[None, :]])
    iy, ix = np.unravel_index(np.argmax(sums), sums.shape)
    return int(ys[iy]), int(xs[ix])
