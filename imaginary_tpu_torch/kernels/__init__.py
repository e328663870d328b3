"""The port's device kernels: thirteen CUDA C++ kernels for Hopper (sm_90a).

| kernel          | source                 | replaces (imaginary_tpu/...)                     |
| --------------- | ---------------------- | ------------------------------------------------ |
| resample        | csrc/resample.cu       | ops/stages.py:46-116 sample_matrix + SampleSpec  |
| yuv420_unpack   | csrc/yuv420_unpack.cu  | ops/stages.py:344-423 FromYuv420Spec (+ cast)    |
| yuv420_pack     | csrc/yuv420_pack.cu    | ops/stages.py:521-552 ToYuv420Spec + epilogue, + GraySpec |
| gather          | csrc/gather.cu         | ops/stages.py:119-198, 330-341 Extract/Embed/Shrink |
| orient          | csrc/orient.cu         | ops/stages.py:201-234 Flip/Flop/Transpose (a run of them, one launch) |
| blur            | csrc/blur.cu           | ops/stages.py:237-280 BlurSpec                   |
| composite       | csrc/composite.cu      | ops/stages.py:283-327 CompositeSpec              |
| gray            | csrc/gray.cu           | ops/stages.py:625-635 GraySpec                   |
| saliency        | csrc/saliency.cu       | ops/saliency.py:20-53 saliency map + integral image |
| window_argmax   | csrc/saliency.cu       | ops/saliency.py:55-69 smart_offsets' argmax      |
| from_dct        | csrc/from_dct.cu       | ops/stages.py:425-518 FromDctSpec (+ int16 cast) |
| to_dct          | csrc/to_dct.cu         | ops/stages.py:555-622 ToDctSpec + int16 drain    |
| blur_halo       | csrc/blur_halo.cu      | parallel/spatial.py:56-124 sharded_blur (K6 on a W-shard) |

W-shard forms (the spatial route, `ops/stages.py`): K1 (`cols`), K2
(`yuv420_to_rgb_shard`), K3 (`rgb_to_yuv420_shard`) and K13 take a shard's
columns through their own entry's extra parameters; K4 (`gather_shard`:
every index map, and the smartcrop's gather from K10's keys), K5's flop
(`flop_shard`), K9 (`saliency_rows_shard`, `saliency_scan_shard`), K10
(`window_argmax_shard`), K11 (`from_dct_shard`) and K12 (`to_dct_shard`)
are kernels of their own in the same sources, so the whole-image
launches do not change; each counts under its kernel's name. K5's flip
and transpose, K7 and K8 run their whole-image kernel on the shard.

Each wrapper below takes tensors on one device. On a CPU tensor it runs
the kernel's plain version (`reference.py`). On a CUDA tensor it checks
dtype, shape and contiguity, allocates outputs with `torch.empty` (the
wrappers of the stages that can end a chain, K1, K3, K4, K5, K6, K7, K8
and K12, take an optional `out=` instead, checked the same way: the
chain runner's buffer donation, ops/chain.py; on the CPU the plain
version's result is copied into it),
launches on the calling thread's current stream of that device, raises
if the launch reports a CUDA error, and adds one to `LAUNCHES[name]` per
kernel launch. There is no fallback from CUDA to the plain version. The
counts and the lazy load are safe under concurrent launching threads (the
executor's lanes): both happen under a lock.

The libraries are built by nvcc at first CUDA use (`build.py`) and loaded
with ctypes; importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from imaginary_tpu_torch.kernels import reference

_P = ctypes.c_void_p
_I = ctypes.c_int

# name -> (source, C symbol, argtypes); every function ends with the stream.
_SIGNATURES = {
    "resample": ("resample", "itpu_resample",
                 [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                  _I, _I, _I, _I, _I, _P]),
    "yuv420_unpack": ("yuv420_unpack", "itpu_yuv420_to_rgb",
                      [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "yuv420_pack": ("yuv420_pack", "itpu_rgb_to_yuv420",
                    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "gather": ("gather", "itpu_gather",
               [_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                _I, _P]),
    "orient": ("orient", "itpu_orient",
               [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "blur": ("blur", "itpu_blur",
             [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "composite": ("composite", "itpu_composite",
                  [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   _I, _I, _P]),
    "gray": ("gray", "itpu_gray", [_P, _I, _P, _I, ctypes.c_longlong, _I, _P]),
    "saliency": ("saliency", "itpu_saliency_ii",
                 [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P]),
    "window_argmax": ("saliency", "itpu_window_argmax",
                      [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "from_dct": ("from_dct", "itpu_from_dct",
                 [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "to_dct": ("to_dct", "itpu_to_dct", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "blur_halo": ("blur_halo", "itpu_blur_halo",
                  [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _I, _P]),
    # the W-shard forms with kernels of their own (the spatial route),
    # each counted under its kernel's name (`_COUNT_AS`)
    "gather_shard": ("gather", "itpu_gather_shard",
                     [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _I, _I, _I, _I, _I, _P]),
    "flop_shard": ("orient", "itpu_flop_shard",
                   [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "saliency_rows_shard": ("saliency", "itpu_saliency_rows_shard",
                            [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _P]),
    "saliency_scan_shard": ("saliency", "itpu_saliency_scan_shard",
                            [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "window_argmax_shard": ("saliency", "itpu_window_argmax_shard",
                            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _P]),
    "from_dct_shard": ("from_dct", "itpu_from_dct_shard",
                       [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P]),
    "to_dct_shard": ("to_dct", "itpu_to_dct_shard",
                     [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
}
_COUNT_AS = {"gather_shard": "gather", "flop_shard": "orient",
             "saliency_rows_shard": "saliency", "saliency_scan_shard": "saliency",
             "window_argmax_shard": "window_argmax", "from_dct_shard": "from_dct",
             "to_dct_shard": "to_dct"}

# Kernel launches since the last reset, per kernel (saliency counts its
# two passes as two launches; a W-shard form counts under its kernel's
# name). Written under _COUNT_LOCK only.
LAUNCHES = {name: 0 for name in _SIGNATURES if name not in _COUNT_AS}

_FNS: dict = {}
_LOCK = threading.Lock()  # the build and load
_COUNT_LOCK = threading.Lock()
_RESAMPLE_KIND = {k: i for i, k in enumerate(reference.RESAMPLE_KINDS)}
_GATHER_MODE = {m: i for i, m in enumerate(reference.GATHER_MODES)}


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> dict:
    """A consistent copy of LAUNCHES."""
    with _COUNT_LOCK:
        return dict(LAUNCHES)


def _count(name: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += n


def load_all() -> dict:
    """Build (if needed) and load every kernel library; returns the build
    report of `build.build_all` for the libraries this call loaded."""
    with _LOCK:
        if _FNS:
            return {}
        from imaginary_tpu_torch.kernels.build import build_all

        built = build_all()
        libs = {src: ctypes.CDLL(info["path"]) for src, info in built.items()}
        fns = {}
        for name, (src, symbol, argtypes) in _SIGNATURES.items():
            fn = getattr(libs[src], symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        # filled at once, so a thread that finds a name here finds them all
        _FNS.update(fns)
        return built


def _launch(name: str, device: torch.device, *args, passes: int = 1) -> None:
    """Launch C function `name` on the current stream of `device` and count
    `passes` launches of its kernel (a C function may launch two)."""
    fn = _FNS.get(name)
    if fn is None:
        load_all()
        fn = _FNS[name]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _count(_COUNT_AS.get(name, name), passes)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _require(t: torch.Tensor, what: str, dtypes: tuple, shape: tuple,
             device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _out(out, shape: tuple, dtype, device: torch.device):
    """A chain-ending kernel's output: `out` checked against the dtype,
    shape, contiguity and device the kernel writes, else a new tensor."""
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    _require(out, "out", (dtype,), shape, device)
    return out


def _into(out, res: torch.Tensor) -> torch.Tensor:
    """The plain version's result `res`, copied into `out` once `out`
    passes the same checks (the CPU side of `out=`)."""
    if out is None:
        return res
    _require(out, "out", (res.dtype,), tuple(res.shape), res.device)
    out.copy_(res)
    return out


_IMG = (torch.uint8, torch.float32)
_I32 = (torch.int32,)
_F32 = (torch.float32,)


def resample(x, h, w, dst_h, dst_w, out_hb: int, out_wb: int, kind: str,
             out_u8: bool = False, cols=None, in_col0: int = 0, in_wb=None,
             out=None):
    """K1: separable resample of x [B, Hb, Wb, C] (uint8 or f32, C 1 to 4)
    to [B, out_hb, out_wb, C] (f32, or uint8 with the epilogue), both axes
    in one launch.

    h, w: int32 [B] valid input dims; dst_h, dst_w: f32 [B] target dims.
    Returns (out, int32 dst_h, int32 dst_w).

    W-shard form: with `cols` = (c0, c1) the output holds only columns
    [c0, c1) of the out_wb-wide bucket, and x holds only input columns
    [in_col0, in_col0 + x.shape[2]) of an input bucket `in_wb` wide. The
    caller makes those cover `resample_window`'s columns of every image
    (the kernel reads them unchecked). The shard's columns equal the
    whole image's."""
    in_wb = x.shape[2] if in_wb is None else in_wb
    c0, c1 = (0, out_wb) if cols is None else cols
    if not (0 <= c0 < c1 <= out_wb and 0 <= in_col0
            and in_col0 + x.shape[2] <= in_wb):
        raise ValueError(f"shard columns [{c0}, {c1}) of {out_wb} from input "
                         f"columns [{in_col0}, {in_col0 + x.shape[2]}) of {in_wb}")
    if x.device.type == "cpu":
        res, h_out, w_out = reference.resample(x, h, w, dst_h, dst_w, out_hb, out_wb,
                                               kind, out_u8, cols=(c0, c1),
                                               in_col0=in_col0, in_wb=in_wb)
        return _into(out, res), h_out, w_out
    if kind not in _RESAMPLE_KIND:
        raise ValueError(f"unknown kernel {kind!r}")
    dev = x.device
    if x.dim() != 4 or not 1 <= x.shape[3] <= 4:
        raise ValueError(f"x must be [B, H, W, C] with C 1 to 4, got {tuple(x.shape)}")
    bsz, in_h, in_w, c = x.shape
    _require(x, "x", _IMG, (bsz, in_h, in_w, c), dev)
    for t, n, dts in ((h, "h", _I32), (w, "w", _I32), (dst_h, "dst_h", _F32),
                      (dst_w, "dst_w", _F32)):
        _require(t, n, dts, (bsz,), dev)
    out = _out(out, (bsz, out_hb, c1 - c0, c),
               torch.uint8 if out_u8 else torch.float32, dev)
    h_out = torch.empty((bsz,), dtype=torch.int32, device=dev)
    w_out = torch.empty((bsz,), dtype=torch.int32, device=dev)
    _launch("resample", dev, x.data_ptr(), int(x.dtype == torch.uint8),
            out.data_ptr(), int(out_u8), h.data_ptr(), w.data_ptr(),
            dst_h.data_ptr(), dst_w.data_ptr(), h_out.data_ptr(), w_out.data_ptr(),
            bsz, in_h, in_w, out_hb, c1 - c0, c, _RESAMPLE_KIND[kind], in_col0,
            in_wb, c0, out_wb)
    return out, h_out, w_out


# Columns of margin `resample_window` adds on each side: the kernel's
# f32 tap ranges may round one column wider than numpy's (contracted
# multiply-adds).
RESAMPLE_WINDOW_MARGIN = 2
_SUPPORT = {"lanczos3": 3.0, "lanczos2": 2.0, "cubic": 2.0, "linear": 1.0,
            "nearest": 0.5}


def resample_window(kind: str, src: int, dst: float, in_b: int, out_b: int,
                    c0: int, c1: int) -> tuple:
    """The input columns [k0, k1) that K1 reads for output columns [c0, c1)
    of an image `src` columns wide (bucket in_b) resampled to `dst` columns
    (bucket out_b): the union of those columns' tap ranges, in the kernel's
    f32 arithmetic (csrc/resample.cu `axis_taps`), widened by
    RESAMPLE_WINDOW_MARGIN and clipped to the bucket. At least one column."""
    f32 = np.float32
    srcf = f32(max(src, 1))
    dstf = f32(max(dst, 1.0))
    scale = dstf / srcf
    stretch = max(f32(1.0), f32(1.0) / scale)
    reach = f32(_SUPPORT[kind]) * stretch
    last = min(in_b, int(srcf)) - 1
    o = np.arange(c0, c1)
    o = o[(o.astype(f32) < dstf) & (o < out_b)]
    if o.size == 0 or last < 0:
        return 0, 1
    centre = (o.astype(f32) + f32(0.5)) / scale - f32(0.5)
    lo = max(int(np.floor(centre[0] - reach)) - 1, 0)
    hi = min(int(np.ceil(centre[-1] + reach)) + 1, last)
    k0 = max(lo - RESAMPLE_WINDOW_MARGIN, 0)
    k1 = min(max(hi, lo) + 1 + RESAMPLE_WINDOW_MARGIN, in_b)
    return k0, max(k1, k0 + 1)


def yuv420_to_rgb(x, h, w, hb: int, wb: int):
    """K2: uint8 packed planes [B, hb + hb/2, wb, 1] -> f32 RGB [B, hb, wb, 3]."""
    if x.device.type == "cpu":
        return reference.yuv420_to_rgb(x, h, w, hb, wb)
    dev = x.device
    bsz = x.shape[0]
    if hb % 2 or wb % 2:
        raise ValueError(f"bucket ({hb}, {wb}) must be even")
    _require(x, "x", (torch.uint8,), (bsz, hb + hb // 2, wb, 1), dev)
    _require(h, "h", _I32, (bsz,), dev)
    _require(w, "w", _I32, (bsz,), dev)
    out = torch.empty((bsz, hb, wb, 3), dtype=torch.float32, device=dev)
    _launch("yuv420_unpack", dev, x.data_ptr(), None, None, out.data_ptr(), h.data_ptr(),
            w.data_ptr(), bsz, hb, wb)
    return out


def yuv420_to_rgb_shard(x, left, right, h, w, hb: int, lw: int):
    """K2's W-shard form: one shard's packed buffer uint8 [B, hb + hb/2, lw,
    1] (its Y columns [col0, col0 + lw), col0 even, then lw/2 chroma
    columns of U and of V) and its chroma halos `left` and `right` uint8
    [B, hb/2, 2, 1] (U then V a row), every chroma column taken by the
    clamped index the whole image's pixels read (`stages.FromYuv420Spec.
    shard_input`) -> f32 RGB [B, hb, lw, 3], equal to the whole image's
    K2 at those columns. h, w: int32 [B], the whole image's valid dims."""
    if x.device.type == "cpu":
        return reference.yuv420_to_rgb_shard(x, left, right, h, w, hb, lw)
    dev = x.device
    bsz = x.shape[0]
    if hb % 2 or lw % 2:
        raise ValueError(f"shard ({hb}, {lw}) must be even")
    _require(x, "x", (torch.uint8,), (bsz, hb + hb // 2, lw, 1), dev)
    _require(left, "left", (torch.uint8,), (bsz, hb // 2, 2, 1), dev)
    _require(right, "right", (torch.uint8,), (bsz, hb // 2, 2, 1), dev)
    _require(h, "h", _I32, (bsz,), dev)
    _require(w, "w", _I32, (bsz,), dev)
    out = torch.empty((bsz, hb, lw, 3), dtype=torch.float32, device=dev)
    _launch("yuv420_unpack", dev, x.data_ptr(), left.data_ptr(), right.data_ptr(),
            out.data_ptr(), h.data_ptr(), w.data_ptr(), bsz, hb, lw)
    return out


def rgb_to_yuv420(x, h, w, hb: int, wb: int, luma: bool = False, out=None):
    """K3: f32 RGB [B, hb, wb, 3] -> uint8 packed planes [B, hb + hb/2, wb, 1]
    (chroma pooled over valid pixels; epilogue fused). With `luma`, K8's
    luma is applied to each pixel as it is loaded: one launch, equal to
    `gray` then `rgb_to_yuv420`, counted as one `yuv420_pack`."""
    return _rgb_to_yuv420(x, h, w, hb, wb, luma, 0, out)


def rgb_to_yuv420_shard(x, h, w, hb: int, lw: int, col0: int, luma: bool = False):
    """K3's W-shard form: x f32 [B, hb, lw, 3] holds the image's columns
    [col0, col0 + lw) (col0 and lw even) -> the shard's own packed planes
    uint8 [B, hb + hb/2, lw, 1]: Y over lw columns, then U and V over lw/2
    each, equal to the whole image's K3 at those columns (the valid mask
    on global columns). h, w: int32 [B], the whole image's valid dims;
    `luma` as in `rgb_to_yuv420`."""
    if col0 % 2 or col0 < 0:
        raise ValueError(f"shard column {col0} must be even and >= 0")
    return _rgb_to_yuv420(x, h, w, hb, lw, luma, col0)


def _rgb_to_yuv420(x, h, w, hb: int, wb: int, luma: bool, col0: int, out=None):
    if x.device.type == "cpu":
        return _into(out, reference.rgb_to_yuv420(x, h, w, hb, wb, luma, col0))
    dev = x.device
    bsz = x.shape[0]
    if hb % 2 or wb % 2:
        raise ValueError(f"bucket ({hb}, {wb}) must be even")
    _require(x, "x", _F32, (bsz, hb, wb, 3), dev)
    _require(h, "h", _I32, (bsz,), dev)
    _require(w, "w", _I32, (bsz,), dev)
    out = _out(out, (bsz, hb + hb // 2, wb, 1), torch.uint8, dev)
    _launch("yuv420_pack", dev, x.data_ptr(), out.data_ptr(), h.data_ptr(),
            w.data_ptr(), bsz, hb, wb, int(bool(luma)), col0)
    return out


def gather(x, out_hb: int, out_wb: int, off_y=None, off_x=None, size_h=None,
           size_w=None, mode: str = "window", fill=None, out_u8: bool = False,
           out=None):
    """K4: index-map gather of x [B, Hb, Wb, C] (uint8 or f32) into
    [B, out_hb, out_wb, C] (f32, or uint8 with the epilogue).

    mode "window": source index pos + off, each clamped into the bucket
    (offsets None means identity); "clamp" / "mirror": canvas placement at
    off with the image's valid size, edge-clamped or mirrored; a fill
    f32 [B, C] paints canvas pixels outside the image."""
    if mode not in _GATHER_MODE:
        raise ValueError(f"unknown gather mode {mode!r}")
    if mode != "window" and (size_h is None or size_w is None or off_y is None
                             or off_x is None):
        raise ValueError(f"gather mode {mode!r} needs offsets and sizes")
    if x.device.type == "cpu":
        return _into(out, reference.gather(x, out_hb, out_wb, off_y, off_x, size_h,
                                           size_w, mode, fill, out_u8))
    dev = x.device
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    bsz, in_hb, in_wb, c = x.shape
    _require(x, "x", _IMG, (bsz, in_hb, in_wb, c), dev)
    for t, n in ((off_y, "off_y"), (off_x, "off_x"), (size_h, "size_h"),
                 (size_w, "size_w")):
        if t is not None:
            _require(t, n, _I32, (bsz,), dev)
    if fill is not None:
        _require(fill, "fill", _F32, (bsz, c), dev)
    out = _out(out, (bsz, out_hb, out_wb, c),
               torch.uint8 if out_u8 else torch.float32, dev)
    _launch("gather", dev, x.data_ptr(), int(x.dtype == torch.uint8),
            out.data_ptr(), int(out_u8), _ptr(off_y), _ptr(off_x), _ptr(size_h),
            _ptr(size_w), _ptr(fill), _GATHER_MODE[mode], bsz, in_hb, in_wb, c,
            out_hb, out_wb)
    return out


def gather_shard(x, out_hb: int, lw: int, col0: int, in_col0: int, in_wb: int,
                 off_y=None, off_x=None, size_h=None, size_w=None,
                 mode: str = "window", fill=None, keys=None, key_wb: int = 0,
                 out_u8: bool = False):
    """K4's W-shard form: output columns [col0, col0 + lw) of `gather`'s
    output, from x [B, Hb, kw, C] holding input columns [in_col0, in_col0 +
    kw) of a bucket in_wb wide (the caller makes them cover every column
    the shard reads: `stages.ExtractSpec.shard_window` and its kin). The
    index maps are `gather`'s on global columns. keys (int64 [B, n], K10's
    shard keys, or None): the window's offsets, decoded on the card from
    the best key (an index over a bucket key_wb wide), in place of
    off_y/off_x. One launch."""
    if mode not in _GATHER_MODE:
        raise ValueError(f"unknown gather mode {mode!r}")
    if mode != "window" and (size_h is None or size_w is None or off_y is None
                             or off_x is None):
        raise ValueError(f"gather mode {mode!r} needs offsets and sizes")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    bsz, in_hb, kw, c = x.shape
    if not (0 <= in_col0 and in_col0 + kw <= in_wb and 0 <= col0 and lw >= 1):
        raise ValueError(f"shard columns [{col0}, {col0 + lw}) from input columns "
                         f"[{in_col0}, {in_col0 + kw}) of {in_wb}")
    if keys is not None and key_wb < 1:
        raise ValueError("keys need the bucket width their indices run over")
    if x.device.type == "cpu":
        return reference.gather_shard(x, out_hb, lw, col0, in_col0, in_wb, off_y, off_x,
                                      size_h, size_w, mode, fill, keys, key_wb, out_u8)
    dev = x.device
    _require(x, "x", _IMG, (bsz, in_hb, kw, c), dev)
    for t, n in ((off_y, "off_y"), (off_x, "off_x"), (size_h, "size_h"),
                 (size_w, "size_w")):
        if t is not None:
            _require(t, n, _I32, (bsz,), dev)
    if fill is not None:
        _require(fill, "fill", _F32, (bsz, c), dev)
    nkeys = 0
    if keys is not None:
        nkeys = keys.shape[-1]
        _require(keys, "keys", (torch.int64,), (bsz, nkeys), dev)
    out = torch.empty((bsz, out_hb, lw, c), dtype=torch.uint8 if out_u8 else torch.float32,
                      device=dev)
    _launch("gather_shard", dev, x.data_ptr(), int(x.dtype == torch.uint8),
            out.data_ptr(), int(out_u8), _ptr(off_y), _ptr(off_x), _ptr(size_h),
            _ptr(size_w), _ptr(fill), _ptr(keys), nkeys, key_wb, _GATHER_MODE[mode],
            bsz, in_hb, in_wb, in_col0, kw, c, out_hb, lw, col0)
    return out


def orient(x, h, w, mode: str, out_u8: bool = False, out=None):
    """K5: "flip" or "flop" x [B, Hb, Wb, C] (uint8 or f32, C 1 to 4)
    inside each image's valid h or w (padding copied as it is), or
    "transpose" it to [B, Wb, Hb, C]; f32 out, or uint8 with the epilogue.

    h, w: int32 [B] valid dims. The caller swaps h and w after a
    transpose."""
    if mode not in reference.ORIENT_MODES:
        raise ValueError(f"unknown orient mode {mode!r}")
    if x.device.type == "cpu":
        return _into(out, reference.orient(x, h, w, mode, out_u8))
    return _orient(x, h, w, reference.compose_orient((mode,)), out_u8, out)


def orient_run(x, h, w, names, out_u8: bool = False, out=None):
    """K5 for a run of orientation stages ("flip", "flop", "transpose",
    applied in order) in one launch of their composed mode
    (`reference.compose_orient`): [B, Hb, Wb, C] to [B, Hb, Wb, C], or
    [B, Wb, Hb, C] when the run transposes an odd number of times. h, w:
    int32 [B] valid dims of x; the caller swaps them when it transposes."""
    mode = reference.compose_orient(names)
    if x.device.type == "cpu":
        return _into(out, reference.orient_run(x, h, w, names, out_u8))
    return _orient(x, h, w, mode, out_u8, out)


def _orient(x, h, w, mode: tuple, out_u8: bool, out):
    dev = x.device
    if x.dim() != 4 or not 1 <= x.shape[3] <= 4:
        raise ValueError(f"x must be [B, H, W, C] with C 1 to 4, got {tuple(x.shape)}")
    bsz, hb, wb, c = x.shape
    _require(x, "x", _IMG, (bsz, hb, wb, c), dev)
    _require(h, "h", _I32, (bsz,), dev)
    _require(w, "w", _I32, (bsz,), dev)
    t, fy, fx = mode
    shape = (bsz, wb, hb, c) if t else (bsz, hb, wb, c)
    out = _out(out, shape, torch.uint8 if out_u8 else torch.float32, dev)
    _launch("orient", dev, x.data_ptr(), int(x.dtype == torch.uint8),
            out.data_ptr(), int(out_u8), h.data_ptr(), w.data_ptr(), t, fy, fx,
            bsz, hb, wb, c)
    return out


def flop_shard(x, h, w, col0: int, lw: int, in_col0: int, out_u8: bool = False):
    """K5's flop on a W-shard: output columns [col0, col0 + lw) of
    `orient(..., "flop")`, from x [B, Hb, kw, C] holding the mirrored input
    columns from in_col0, then the shard's own padding columns, which end
    the window (`stages.FlopSpec.shard_window`). h, w: int32 [B], the whole
    image's valid dims. One launch."""
    if x.dim() != 4 or not 1 <= x.shape[3] <= 4:
        raise ValueError(f"x must be [B, H, W, C] with C 1 to 4, got {tuple(x.shape)}")
    if in_col0 < 0 or col0 < 0 or lw < 1:
        raise ValueError(f"shard columns [{col0}, {col0 + lw}) from {in_col0}")
    if x.device.type == "cpu":
        return reference.flop_shard(x, h, w, col0, lw, in_col0, out_u8)
    dev = x.device
    bsz, hb, kw, c = x.shape
    _require(x, "x", _IMG, (bsz, hb, kw, c), dev)
    _require(w, "w", _I32, (bsz,), dev)
    out = torch.empty((bsz, hb, lw, c), dtype=torch.uint8 if out_u8 else torch.float32,
                      device=dev)
    _launch("flop_shard", dev, x.data_ptr(), int(x.dtype == torch.uint8), out.data_ptr(),
            int(out_u8), w.data_ptr(), bsz, hb, kw, lw, c, col0, in_col0)
    return out


MAX_BLUR_RADIUS = 64
# K6's shared rows of vertical sums hold this many elements, by C (two to
# four per thread of the block's 256)
BLUR_EXT = {1: 512, 2: 512, 3: 768, 4: 1024}
BLUR_ROW_GROUP = 8  # the output rows of one block


def blur_strip(c: int, radius: int) -> int:
    """K6's strip width: the shared rows' elements less the 2r halo
    columns (at least 128 columns at r = 64)."""
    return BLUR_EXT[c] // c - 2 * radius


def blur(x, h, w, sigma, radius: int, out_u8: bool = False, out=None):
    """K6: separable Gaussian of x [B, Hb, Wb, C] (uint8 or f32, C 1 to 4)
    with a static radius (0 to 64) and per-image sigma (f32 [B]),
    normalised against the valid mask and zero outside each image's valid
    h, w (int32 [B]); f32 out, or uint8 with the epilogue. One launch,
    blocks of BLUR_ROW_GROUP rows by `blur_strip(c, radius)` columns."""
    if not 0 <= radius <= MAX_BLUR_RADIUS:
        raise ValueError(f"blur radius {radius} outside 0..{MAX_BLUR_RADIUS}")
    if x.device.type == "cpu":
        return _into(out, reference.blur(x, h, w, sigma, radius, out_u8))
    dev = x.device
    if x.dim() != 4 or not 1 <= x.shape[3] <= 4:
        raise ValueError(f"x must be [B, H, W, C] with C 1 to 4, got {tuple(x.shape)}")
    bsz, hb, wb, c = x.shape
    _require(x, "x", _IMG, (bsz, hb, wb, c), dev)
    _require(h, "h", _I32, (bsz,), dev)
    _require(w, "w", _I32, (bsz,), dev)
    _require(sigma, "sigma", _F32, (bsz,), dev)
    out = _out(out, (bsz, hb, wb, c), torch.uint8 if out_u8 else torch.float32, dev)
    _launch("blur", dev, x.data_ptr(), int(x.dtype == torch.uint8), out.data_ptr(),
            int(out_u8), h.data_ptr(), w.data_ptr(), sigma.data_ptr(), radius, bsz,
            hb, wb, c, blur_strip(c, radius))
    return out


def composite(x, overlay, top, left, opacity, block_h, block_w,
              replicate: bool, out_u8: bool = False, out=None):
    """K7: alpha-blend the RGBA overlay f32 [B, BHb, BWb, 4] over every
    pixel of x [B, Hb, Wb, C] (uint8 or f32, C 3 or 4), tiled from
    (top, left) when `replicate`, else placed once there; top, left,
    block_h, block_w int32 [B], opacity f32 [B]. f32 out, or uint8 with
    the epilogue."""
    if x.device.type == "cpu":
        return _into(out, reference.composite(x, overlay, top, left, opacity, block_h,
                                              block_w, replicate, out_u8))
    dev = x.device
    if x.dim() != 4 or x.shape[3] not in (3, 4):
        raise ValueError(f"x must be [B, H, W, C] with C 3 or 4, got {tuple(x.shape)}")
    bsz, hb, wb, c = x.shape
    _require(x, "x", _IMG, (bsz, hb, wb, c), dev)
    if overlay.dim() != 4 or overlay.shape[3] != 4 or 0 in overlay.shape[1:3]:
        raise ValueError(f"overlay must be [B, BHb, BWb, 4], got {tuple(overlay.shape)}")
    bhb, bwb = overlay.shape[1], overlay.shape[2]
    _require(overlay, "overlay", _F32, (bsz, bhb, bwb, 4), dev)
    for t, n in ((top, "top"), (left, "left"), (block_h, "block_h"),
                 (block_w, "block_w")):
        _require(t, n, _I32, (bsz,), dev)
    _require(opacity, "opacity", _F32, (bsz,), dev)
    out = _out(out, (bsz, hb, wb, c), torch.uint8 if out_u8 else torch.float32, dev)
    _launch("composite", dev, x.data_ptr(), int(x.dtype == torch.uint8),
            out.data_ptr(), int(out_u8), overlay.data_ptr(), top.data_ptr(),
            left.data_ptr(), opacity.data_ptr(), block_h.data_ptr(),
            block_w.data_ptr(), int(bool(replicate)), bsz, hb, wb, c, bhb, bwb)
    return out


def gray(x, out_u8: bool = False, out=None):
    """K8: Rec.709 luma of x [B, Hb, Wb, C] (uint8 or f32, C 3 or 4)
    broadcast over RGB, alpha kept; f32 out, or uint8 with the epilogue.
    16-byte vector loads and stores where x starts on a 16-byte boundary,
    the scalar form where it does not (a view into a larger buffer)."""
    if x.device.type == "cpu":
        return _into(out, reference.gray(x, out_u8))
    dev = x.device
    if x.dim() != 4 or x.shape[3] not in (3, 4):
        raise ValueError(f"x must be [B, H, W, C] with C 3 or 4, got {tuple(x.shape)}")
    bsz, hb, wb, c = x.shape
    _require(x, "x", _IMG, (bsz, hb, wb, c), dev)
    out = _out(out, (bsz, hb, wb, c), torch.uint8 if out_u8 else torch.float32, dev)
    _launch("gray", dev, x.data_ptr(), int(x.dtype == torch.uint8),
            out.data_ptr(), int(out_u8), bsz * hb * wb, c)
    return out


def saliency_ii(x, h, w):
    """K9: f32 [B, Hb + 1, Wb + 1] integral image of the smartcrop saliency
    of x [B, Hb, Wb, C] (uint8 or f32, C 3 or 4), zero outside each
    image's valid h, w (int32 [B]). Two launches: the rows (saliency and
    row prefix sums, a band of rows a block), then the columns."""
    if x.device.type == "cpu":
        return reference.saliency_ii(x, h, w)
    dev = x.device
    if x.dim() != 4 or x.shape[3] not in (3, 4):
        raise ValueError(f"x must be [B, H, W, C] with C 3 or 4, got {tuple(x.shape)}")
    bsz, hb, wb, c = x.shape
    _require(x, "x", _IMG, (bsz, hb, wb, c), dev)
    _require(h, "h", _I32, (bsz,), dev)
    _require(w, "w", _I32, (bsz,), dev)
    ii = torch.empty((bsz, hb + 1, wb + 1), dtype=torch.float32, device=dev)
    # the row pass and the column pass, both launched by the one call
    _launch("saliency", dev, x.data_ptr(), int(x.dtype == torch.uint8),
            ii.data_ptr(), h.data_ptr(), w.data_ptr(), bsz, hb, wb, c, passes=2)
    return ii


def saliency_segment(wb: int) -> int:
    """The columns of one segment of K9's row scan on a bucket wb wide
    (csrc/saliency.cu: `reference.SAL_LANES` lanes a row)."""
    return -(-wb // reference.SAL_LANES)


def saliency_rows_shard(x, left, right, h, w, col0: int, wb: int):
    """K9's row pass on a W-shard: x [B, Hb, lw, C] (uint8 or f32, C 3 or
    4) holds global columns [col0, col0 + lw) of a bucket wb wide; left and
    right [B, Hb, per, C] (x's dtype, per = `saliency_segment(wb)`) the
    per columns past each edge (None outside the bucket). Returns (sal f32
    [B, Hb, lw + 2 (per - 1)]: the saliency over global columns [col0 - per
    + 1, col0 + lw + per - 1), 0 outside the bucket; totals f32 [B, Hb,
    nt]: the row scan's segments that start in [col0, col0 + lw)), equal to
    the whole image's. h, w: int32 [B], the whole image's valid dims. One
    launch."""
    per = saliency_segment(wb)
    if x.dim() != 4 or x.shape[3] not in (3, 4):
        raise ValueError(f"x must be [B, H, W, C] with C 3 or 4, got {tuple(x.shape)}")
    bsz, hb, lw, c = x.shape
    if col0 < 0 or col0 + lw > wb or lw < per:
        raise ValueError(f"shard columns [{col0}, {col0 + lw}) of {wb} (segment {per})")
    for halo, name, needed in ((left, "left", col0 > 0), (right, "right", col0 + lw < wb)):
        if halo is None and needed:
            raise ValueError(f"the {name} halo of columns [{col0}, {col0 + lw}) is missing")
    if x.device.type == "cpu":
        return reference.saliency_rows_shard(x, left, right, h, w, col0, wb)
    dev = x.device
    _require(x, "x", _IMG, (bsz, hb, lw, c), dev)
    for halo, name in ((left, "left"), (right, "right")):
        if halo is not None:
            _require(halo, name, (x.dtype,), (bsz, hb, per, c), dev)
    _require(h, "h", _I32, (bsz,), dev)
    _require(w, "w", _I32, (bsz,), dev)
    nt = -(-(col0 + lw) // per) - -(-col0 // per)
    sal = torch.empty((bsz, hb, lw + 2 * (per - 1)), dtype=torch.float32, device=dev)
    totals = torch.empty((bsz, hb, nt), dtype=torch.float32, device=dev)
    _launch("saliency_rows_shard", dev, x.data_ptr(), int(x.dtype == torch.uint8),
            _ptr(left), _ptr(right), sal.data_ptr(), totals.data_ptr(), h.data_ptr(),
            w.data_ptr(), bsz, hb, lw, c, col0, wb, per)
    return sal, totals


def saliency_scan_shard(sal, totals, col0: int, lw: int, wb: int):
    """K9's scan and column pass on a W-shard: sal from
    `saliency_rows_shard`, totals f32 [B, Hb, nt], every shard's segment
    totals side by side (nt = ceil(wb / per)) -> f32 [B, Hb + 1, lw], the
    whole image's integral image columns [col0 + 1, col0 + lw + 1). Two
    launches: the scan, then the columns."""
    per = saliency_segment(wb)
    bsz, hb, ew = sal.shape
    if ew != lw + 2 * (per - 1) or tuple(totals.shape[:2]) != (bsz, hb):
        raise ValueError(f"sal {tuple(sal.shape)} and totals {tuple(totals.shape)} do not "
                         f"fit {lw} columns of {wb}")
    nt = totals.shape[2]
    if nt > reference.SAL_LANES:
        raise ValueError(f"{nt} segment totals, more than {reference.SAL_LANES}")
    if sal.device.type == "cpu":
        return reference.saliency_scan_shard(sal, totals, col0, lw, wb)
    dev = sal.device
    _require(sal, "sal", _F32, (bsz, hb, ew), dev)
    _require(totals, "totals", _F32, (bsz, hb, nt), dev)
    ii = torch.empty((bsz, hb + 1, lw), dtype=torch.float32, device=dev)
    _launch("saliency_scan_shard", dev, sal.data_ptr(), totals.data_ptr(), ii.data_ptr(),
            bsz, hb, lw, col0, wb, per, nt, passes=2)
    return ii


def window_argmax_shard(ii, h, w, win_h, win_w, k0: int, c0: int, c1: int, hb: int,
                        wb: int):
    """K10 on a W-shard: ii f32 [B, 2 nr, kw] holds integral image columns
    [k0, k0 + kw) (k0 >= 1; column 0 is zeros) of an image bucket hb x wb,
    covering its candidates' windows, and of those columns only the rows
    K10 reads: [0, nr), then [win_h, win_h + nr) (nr at least the rows of
    candidates, h - win_h + 1); the candidates are those whose left lies
    in [c0, c1). Returns int64 [B], the shard's best key
    (`reference.score_keys`: the score's order-preserving bits above the
    complement of its global index), the whole image's first masked
    candidate's key included. One launch: a thread-block cluster an
    image, as K10."""
    if ii.dim() != 3 or k0 < 1 or ii.shape[1] < 2 or ii.shape[1] % 2:
        raise ValueError(f"ii must be [B, 2 nr, kw] from column k0 >= 1, got "
                         f"{tuple(ii.shape)} from {k0}")
    if ii.device.type == "cpu":
        return reference.window_argmax_shard(ii, h, w, win_h, win_w, k0, c0, c1, hb, wb)
    dev = ii.device
    bsz, rows, kw = ii.shape
    _require(ii, "ii", _F32, (bsz, rows, kw), dev)
    for t, n in ((h, "h"), (w, "w"), (win_h, "win_h"), (win_w, "win_w")):
        _require(t, n, _I32, (bsz,), dev)
    keys = torch.empty((bsz,), dtype=torch.int64, device=dev)
    _launch("window_argmax_shard", dev, ii.data_ptr(), h.data_ptr(), w.data_ptr(),
            win_h.data_ptr(), win_w.data_ptr(), keys.data_ptr(), bsz, hb, wb, rows // 2,
            k0, kw, c0, c1)
    return keys


def window_argmax(ii, h, w, win_h, win_w):
    """K10: the best (top, left), int32 [B] each on ii's device, of a
    (win_h, win_w) window over the integral image ii f32
    [B, Hb + 1, Wb + 1], for images of valid h, w (all int32 [B]). One
    launch: a thread-block cluster per image, reduced in distributed
    shared memory; it raises when a cluster cannot be resident."""
    if ii.device.type == "cpu":
        return reference.window_argmax(ii, h, w, win_h, win_w)
    dev = ii.device
    if ii.dim() != 3:
        raise ValueError(f"ii must be [B, H + 1, W + 1], got {tuple(ii.shape)}")
    bsz, hb1, wb1 = ii.shape
    _require(ii, "ii", _F32, (bsz, hb1, wb1), dev)
    for t, n in ((h, "h"), (w, "w"), (win_h, "win_h"), (win_w, "win_w")):
        _require(t, n, _I32, (bsz,), dev)
    top = torch.empty((bsz,), dtype=torch.int32, device=dev)
    left = torch.empty((bsz,), dtype=torch.int32, device=dev)
    _launch("window_argmax", dev, ii.data_ptr(), h.data_ptr(), w.data_ptr(),
            win_h.data_ptr(), win_w.data_ptr(), top.data_ptr(), left.data_ptr(),
            bsz, hb1 - 1, wb1 - 1)
    return top, left


def dct_regions(layout: str, k: int, hb: int, wb: int) -> list:
    """The coefficient planes of FromDctSpec's packed input as
    (row0, rows, col0, cols, channel, kv, kh) regions, in the order Y, U, V."""
    if layout == "gray":
        return [(0, hb, 0, wb, 0, k, k)]
    if k == 8 and layout in ("420", "422"):
        ch = hb // 2 if layout == "420" else hb
        return [(0, hb, 0, wb, 0, 8, 8), (hb, ch, 0, wb // 2, 0, 8, 8),
                (hb, ch, wb // 2, wb // 2, 0, 8, 8)]
    kv, kh = {"420": (2 * k, 2 * k), "422": (k, 2 * k), "444": (k, k)}[layout]
    return [(0, hb, 0, wb, 0, k, k), (0, hb, 0, wb, 1, kv, kh),
            (0, hb, 0, wb, 2, kv, kh)]


def dct_in_shape(layout: str, k: int, hb: int, wb: int) -> tuple:
    """(rows, cols, channels) of FromDctSpec's packed input."""
    if k == 8 and layout == "420":
        return hb + hb // 2, wb, 1
    if k == 8 and layout == "422":
        return 2 * hb, wb, 1
    return hb, wb, 1 if layout == "gray" else 3


def from_dct(x, h, w, hb: int, wb: int, k: int, layout: str):
    """K11: int16 packed, dequantized and folded coefficients (the shape
    `dct_in_shape` gives) -> f32 RGB [B, hb, wb, 3]: the k-point IDCT of
    every plane, then the 4:2:0 / 4:2:2 chroma upsample at k = 8, and
    BT.601 (gray: luma broadcast). One launch; the IDCT's samples stay in
    shared memory."""
    if layout not in reference.DCT_LAYOUTS or k not in (1, 2, 4, 8):
        raise ValueError(f"unsupported dct layout {layout!r} / k {k}")
    if x.device.type == "cpu":
        return reference.from_dct(x, h, w, hb, wb, k, layout)
    dev = x.device
    bsz = x.shape[0]
    rows, cols, c = dct_in_shape(layout, k, hb, wb)
    _require(x, "x", (torch.int16,), (bsz, rows, cols, c), dev)
    _require(h, "h", _I32, (bsz,), dev)
    _require(w, "w", _I32, (bsz,), dev)
    regions = dct_regions(layout, k, hb, wb)
    for r0, nr, c0, nc, _, kv, kh in regions:
        if nr % kv or nc % kh or c0 % kh:
            raise ValueError(f"bucket ({hb}, {wb}) does not tile into {kv}x{kh} blocks")
    if wb % 8:  # the kernel reads 8-coefficient runs (every ladder bucket is)
        raise ValueError(f"K11 needs a bucket width that is a multiple of 8, got {wb}")
    out = torch.empty((bsz, hb, wb, 3), dtype=torch.float32, device=dev)
    mode = 3 if layout == "gray" else (
        0 if (k, layout) == (8, "420") else 1 if (k, layout) == (8, "422") else 2)
    # the chroma planes' blocks (mode 2; the other modes take k only)
    kcv, kch = regions[-1][5:]
    _launch("from_dct", dev, x.data_ptr(), out.data_ptr(), h.data_ptr(), w.data_ptr(),
            mode, k, kcv, kch, bsz, hb, wb)
    return out


def dct_shard_step(layout: str, k: int) -> int:
    """The output columns a K11 W-shard's width and first column must be a
    multiple of: 16 where the chroma is upsampled (4:2:0 and 4:2:2 at k =
    8: an MCU), else 8 (the kernel's 8-coefficient runs, which hold whole
    blocks of every plane: k x k, 2k x 2k and k x 2k, k <= 4)."""
    return 16 if k == 8 and layout in ("420", "422") else 8


dct_halo_blocks = reference.dct_halo_blocks


def from_dct_shard(x, left, right, h, w, hb: int, lw: int, k: int, layout: str,
                   col0: int, wb: int):
    """K11's W-shard form: x int16, `from_dct`'s packed layout at width lw
    (`dct_in_shape(layout, k, hb, lw)`), holding output columns [col0,
    col0 + lw) of a bucket wb wide; at 4:2:0 and 4:2:2 with k = 8, its
    Y's lw columns, then U's and V's lw/2 chroma columns, and `left`,
    `right` int16 [B, chroma rows, 16, 1]: the chroma blocks
    `dct_halo_blocks` names for each image's w (U's 8 columns, then V's);
    None in the other layouts. -> f32 RGB [B, hb, lw, 3], equal to
    `from_dct`'s columns [col0, col0 + lw) bit for bit, padding included.
    col0 and lw are multiples of `dct_shard_step`. h, w: int32 [B], the
    whole image's valid dims. One launch, counted as from_dct."""
    if layout not in reference.DCT_LAYOUTS or k not in (1, 2, 4, 8):
        raise ValueError(f"unsupported dct layout {layout!r} / k {k}")
    step = dct_shard_step(layout, k)
    if lw <= 0 or lw % step or col0 % step or col0 < 0 or col0 + lw > wb:
        raise ValueError(f"K11 shard columns [{col0}, {col0 + lw}) of {wb} are not "
                         f"multiples of {step} inside the bucket")
    chroma = step == 16
    if chroma and (left is None or right is None):
        raise ValueError("K11's shard form at 4:2:0 / 4:2:2, k = 8 needs both halos")
    if x.device.type == "cpu":
        return reference.from_dct_shard(x, left, right, h, w, hb, lw, k, layout, col0, wb)
    dev = x.device
    bsz = x.shape[0]
    rows, cols, c = dct_in_shape(layout, k, hb, lw)
    _require(x, "x", (torch.int16,), (bsz, rows, cols, c), dev)
    if chroma:
        for t, name in ((left, "left"), (right, "right")):
            _require(t, name, (torch.int16,), (bsz, rows - hb, 16, 1), dev)
    _require(h, "h", _I32, (bsz,), dev)
    _require(w, "w", _I32, (bsz,), dev)
    regions = dct_regions(layout, k, hb, lw)
    for r0, nr, c0, nc, _, kv, kh in regions:
        if nr % kv or nc % kh or c0 % kh:
            raise ValueError(f"shard ({hb}, {lw}) does not tile into {kv}x{kh} blocks")
    out = torch.empty((bsz, hb, lw, 3), dtype=torch.float32, device=dev)
    mode = 3 if layout == "gray" else (
        0 if (k, layout) == (8, "420") else 1 if (k, layout) == (8, "422") else 2)
    kcv, kch = regions[-1][5:]
    _launch("from_dct_shard", dev, x.data_ptr(), _ptr(left if chroma else None),
            _ptr(right if chroma else None), out.data_ptr(), h.data_ptr(), w.data_ptr(),
            mode, k, kcv, kch, bsz, hb, lw, col0, wb)
    return out


def to_dct(x, h, w, qy, qc, hb: int, wb: int, out=None):
    """K12: f32 RGB [B, hb, wb, 3] (hb, wb multiples of 16) -> int16
    [B, hb + hb/2, wb, 1] quantized coefficients, with qy, qc f32
    [B, 8, 8] per-image steps and valid h, w (int32 [B])."""
    if hb % 16 or wb % 16:
        raise ValueError(f"ToDctSpec bucket ({hb}, {wb}) must be multiples of 16")
    if x.device.type == "cpu":
        return _into(out, reference.to_dct(x, h, w, qy, qc, hb, wb))
    dev = x.device
    bsz = x.shape[0]
    _require(x, "x", _F32, (bsz, hb, wb, 3), dev)
    _require(h, "h", _I32, (bsz,), dev)
    _require(w, "w", _I32, (bsz,), dev)
    _require(qy, "qy", _F32, (bsz, 8, 8), dev)
    _require(qc, "qc", _F32, (bsz, 8, 8), dev)
    out = _out(out, (bsz, hb + hb // 2, wb, 1), torch.int16, dev)
    _launch("to_dct", dev, x.data_ptr(), out.data_ptr(), h.data_ptr(), w.data_ptr(),
            qy.data_ptr(), qc.data_ptr(), bsz, hb, wb)
    return out


def to_dct_shard(x, h, w, qy, qc, hb: int, lw: int, col0: int, k0: int, wb: int):
    """K12's W-shard form: x f32 [B, hb, kw, 3] holds the input's global
    columns [k0, k0 + kw) (`stages.ToDctSpec.shard_window`: every column
    the whole MCUs over [col0, col0 + lw) read after the clamp to each
    image's w - 1) -> int16 [B, hb + hb/2, lw, 1], the shard's own
    coefficient columns: Y's [col0, col0 + lw), then U's and V's [col0/2,
    (col0 + lw)/2) side by side (K3's shard packing, which
    `ToYuv420Spec.shard_assemble` puts together), equal to `to_dct`'s bit
    for bit. An MCU that straddles the shard's edge is computed whole and
    stored in part. col0 and lw even; hb and the bucket width wb
    multiples of 16. One launch, counted as to_dct."""
    if hb % 16 or wb % 16:
        raise ValueError(f"ToDctSpec bucket ({hb}, {wb}) must be multiples of 16")
    if lw <= 0 or lw % 2 or col0 % 2 or col0 < 0 or col0 + lw > wb:
        raise ValueError(f"K12 shard columns [{col0}, {col0 + lw}) of {wb} must be even "
                         f"and inside the bucket")
    kw = x.shape[2]
    if k0 < 0 or k0 + kw > wb:
        raise ValueError(f"K12 shard window [{k0}, {k0 + kw}) outside the bucket width {wb}")
    if x.device.type == "cpu":
        return reference.to_dct_shard(x, h, w, qy, qc, hb, lw, col0, k0, wb)
    dev = x.device
    bsz = x.shape[0]
    _require(x, "x", _F32, (bsz, hb, kw, 3), dev)
    _require(h, "h", _I32, (bsz,), dev)
    _require(w, "w", _I32, (bsz,), dev)
    _require(qy, "qy", _F32, (bsz, 8, 8), dev)
    _require(qc, "qc", _F32, (bsz, 8, 8), dev)
    out = torch.empty((bsz, hb + hb // 2, lw, 1), dtype=torch.int16, device=dev)
    _launch("to_dct_shard", dev, x.data_ptr(), out.data_ptr(), h.data_ptr(), w.data_ptr(),
            qy.data_ptr(), qc.data_ptr(), bsz, hb, wb, col0, lw, k0, kw)
    return out


def blur_halo(x, left, right, h, w, sigma, radius: int, col0: int, wb: int,
              out_u8: bool = False):
    """K13: K6 on one W-shard in one launch. x [B, Hb, lw, C] (uint8 or
    f32, C 1 to 4) holds global columns [col0, col0 + lw) of a bucket wb
    wide; left and right [B, Hb, radius, C] (x's dtype) hold the
    neighbouring columns [col0 - radius, col0) and [col0 + lw, col0 + lw +
    radius), copied from the neighbouring shards. A halo that lies outside
    the bucket (the first shard's left, the last shard's right) may be
    None; it is never read. h, w: int32 [B] valid dims of the whole image;
    sigma f32 [B]. Returns f32 [B, Hb, lw, C] (uint8 with the epilogue),
    equal to K6's output at those columns."""
    if not 0 <= radius <= MAX_BLUR_RADIUS:
        raise ValueError(f"blur radius {radius} outside 0..{MAX_BLUR_RADIUS}")
    if x.dim() != 4 or not 1 <= x.shape[3] <= 4:
        raise ValueError(f"x must be [B, H, W, C] with C 1 to 4, got {tuple(x.shape)}")
    bsz, hb, lw, c = x.shape
    if lw < 1 or col0 < 0 or col0 + lw > wb:
        raise ValueError(f"shard columns [{col0}, {col0 + lw}) outside the bucket "
                         f"width {wb}")
    for halo, name, needed in ((left, "left", col0 > 0),
                               (right, "right", col0 + lw < wb)):
        if halo is None and needed and radius > 0:
            raise ValueError(f"the {name} halo of columns [{col0}, {col0 + lw}) "
                             f"lies inside the bucket and is missing")
    if x.device.type == "cpu":
        return reference.blur_halo(x, left, right, h, w, sigma, radius, col0, wb,
                                   out_u8)
    dev = x.device
    _require(x, "x", _IMG, (bsz, hb, lw, c), dev)
    for halo, name in ((left, "left"), (right, "right")):
        if halo is not None:
            _require(halo, name, (x.dtype,), (bsz, hb, radius, c), dev)
    _require(h, "h", _I32, (bsz,), dev)
    _require(w, "w", _I32, (bsz,), dev)
    _require(sigma, "sigma", _F32, (bsz,), dev)
    out = torch.empty((bsz, hb, lw, c),
                      dtype=torch.uint8 if out_u8 else torch.float32, device=dev)
    _launch("blur_halo", dev, x.data_ptr(), _ptr(left), _ptr(right),
            int(x.dtype == torch.uint8), out.data_ptr(), int(out_u8), h.data_ptr(),
            w.data_ptr(), sigma.data_ptr(), radius, bsz, hb, lw, c, col0, wb,
            blur_strip(c, radius))
    return out
