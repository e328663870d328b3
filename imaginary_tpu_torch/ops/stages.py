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

Every stage has a W-shard form: it also carries the spatial route's side
of it (`_ShardForm`), and `ops/chain.launch_spatial` drives it through
that alone. A form reads its own columns (K8, K7, K3, K5's flip, K11 in
its three-plane and gray layouts), the host's packed columns with chroma
halos (K2; K11 at 4:2:0 and 4:2:2, k = 8, whose halos are whole 8x8
chroma blocks), a halo (K13), a window exchanged from the shards that
hold it (K1, K4 in every mode, K5's flop, K12's whole MCUs), a row band
from every shard (K5's transpose), or, for the smartcrop (K9 -> K10 ->
K4), halos, every shard's segment totals, an integral-image window,
every shard's best key and an image window in turn
(`SmartExtractSpec.run_shards`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from imaginary_tpu_torch import kernels
from imaginary_tpu_torch.options import Extend
from imaginary_tpu_torch.parallel import spatial


def _out_kw(out) -> dict:
    """`out=` for a chain-ending kernel when the chain donates its staged
    buffer (ops/chain.py); nothing otherwise, so the stages also run over
    the plain versions (`kernels.reference`), which take no `out`."""
    return {} if out is None else {"out": out}


@dataclasses.dataclass(frozen=True)
class ShardLaunch:
    """One launch of a W-shard form that takes several (the smartcrop's),
    as `launch_spatial`'s trace records it: `apply_shard(*args, impl=)`
    calls `impl.<fn>(*args)` (`kernels`, or `kernels.reference` for the
    plain version)."""

    fn: str

    def apply_shard(self, *args, impl=kernels):
        return getattr(impl, self.fn)(*args), None, None


def _launch(sh, launch: ShardLaunch, args: tuple, trace, stage: int, j: int):
    """Run one ShardLaunch on shard sh's stream, record its `ready` event
    and the trace entry; returns its output."""
    with spatial.on(sh.stream):
        out = getattr(kernels, launch.fn)(*args)
        sh.ready = spatial.record(sh.stream)
    if trace is not None:
        trace.append((stage, j, launch, args, out))
    return out


class _ShardForm:
    """A stage's W-shard form (the spatial route): shard j of n runs the
    stage on its own columns [col0, col0 + lw) of the stage's output
    bucket. These defaults are a column-local stage's (output column x
    reads input column x only)."""

    # input columns a shard reads past each of its edges, from its
    # neighbours (the exchange fills `left` and `right` that wide)
    shard_halo = 0

    def shard_ok(self, lw: int, first: bool, in_wb: int, n: int) -> bool:
        """Whether the stage runs W-sharded at local output width lw over
        n shards of an input bucket in_wb wide; `first`: it would be the
        first sharded stage, whose input is staged from the host."""
        return True

    def shard_window(self, c0: int, c1: int, in_w: int, in_wb: int, dyn: dict):
        """The input columns (k0, k1) the stage reads for output columns
        [c0, c1), of an input bucket in_wb wide whose valid width is in_w
        (host params dyn), or a tuple of such ranges side by side
        (`spatial.window_spans`); None: its own columns. A later sharded
        stage with a window gets it from the shards that hold those
        columns (`parallel/spatial.exchange_window`)."""
        return None

    def shard_input(self, img: np.ndarray, c0: int, c1: int, w: int, dyn: dict) -> tuple:
        """The first sharded stage's host input for output columns [c0,
        c1) of the bucket-padded HWC image `img` (valid width w, host
        params dyn): (x, left, right, in_col0), x's first column in the
        bucket and the halos (None where there are none)."""
        win = self.shard_window(c0, c1, w, img.shape[1], dyn)
        if win is not None:
            parts = [img[:, k0:k1] for k0, k1 in spatial.window_spans(win)]
            x = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
            return x, None, None, spatial.window_spans(win)[0][0]
        wb, r = img.shape[1], self.shard_halo
        left = img[:, c0 - r:c0] if r and c0 > 0 else None
        right = img[:, c1:c1 + r] if r and c1 < wb else None
        return img[:, c0:c1], left, right, c0

    def shard_dyn(self, dyn: dict, col0: int) -> dict:
        """The host params of the shard whose output starts at col0."""
        return dyn

    def shard_valid(self, hw: tuple, dyn: dict) -> tuple:
        """The valid (h, w) the stage leaves, from its input's (the host's
        copy of what the kernels carry on the device)."""
        return hw

    def shard_exchange(self, row: list, lw: int, in_hw: tuple, in_wb: int, dyn: dict,
                       tally=None) -> tuple:
        """A later sharded stage's input, brought to each shard of `row`
        from the others: its window (`shard_window`) through
        `exchange_window`, else its halos. Returns (each shard's first input
        column in the bucket, the windows taken as (k0, k1, parts) or
        None: k0 the first range's start, k1 the last's end)."""
        for sh in row:
            sh.left = sh.right = None
        wins = [self.shard_window(j * lw, (j + 1) * lw, in_hw[1], in_wb, dyn)
                for j in range(len(row))]
        if wins[0] is not None:
            parts = spatial.exchange_window(row, wins, tally)
            spans = [spatial.window_spans(win) for win in wins]
            return ([s[0][0] for s in spans],
                    [(s[0][0], s[-1][1], p) for s, p in zip(spans, parts)])
        if self.shard_halo:
            spatial.exchange_halos([row], self.shard_halo, tally)
        return [sh.col0 for sh in row], None

    def run_shards(self, row: list, dyns: list, lw: int, in_col0, in_hw: tuple,
                   in_wb: int, dyn: dict, out_u8: bool, trace=None, stage: int = 0,
                   tally=None):
        """The stage on every shard of `row`: the exchange (`shard_exchange`;
        none for the first sharded stage, whose inputs the host staged,
        `in_col0` their first columns), then `apply_shard` on each shard's
        stream with its device params dyns[j], after which the shard holds
        output columns [j lw, (j + 1) lw) and its `ready` event. in_hw: the
        input's valid (h, w) as the host follows them (`shard_valid`).
        Returns the windows taken, or None."""
        rec = None
        if in_col0 is None:
            in_col0, rec = self.shard_exchange(row, lw, in_hw, in_wb, dyn, tally)
        for j, sh in enumerate(row):
            sh.col0 = j * lw
            args = (sh.x, sh.left, sh.right, sh.h, sh.w, dyns[j], sh.col0, lw,
                    in_col0[j], in_wb, out_u8)
            with spatial.on(sh.stream):
                out = self.apply_shard(*args)
                sh.x, sh.h, sh.w = out
                sh.ready = spatial.record(sh.stream)
            if trace is not None:
                trace.append((stage, j, self, args, out[0]))
        return rec

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

    def shard_valid(self, hw, dyn):
        return int(dyn["dst_h"][0]), int(dyn["dst_w"][0])

    def apply_shard(self, x, left, right, h, w, dyn, col0, lw, in_col0, in_wb,
                    out_u8, impl=kernels):
        return impl.resample(x, h, w, dyn["dst_h"], dyn["dst_w"], self.out_hb,
                             self.out_wb, self.kernel, out_u8, cols=(col0, col0 + lw),
                             in_col0=in_col0, in_wb=in_wb)


def _span(idx: np.ndarray) -> tuple:
    """The input columns [k0, k1) an index map's columns fall in."""
    return int(idx.min()), int(idx.max()) + 1


@dataclasses.dataclass(frozen=True)
class ExtractSpec(_ShardForm):
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

    def shard_window(self, c0, c1, in_w, in_wb, dyn):
        # output column x reads clamp(left + x) of the input bucket
        left = int(dyn["left"][0])
        return _span(np.clip(left + np.array([c0, c1 - 1]), 0, in_wb - 1))

    def shard_valid(self, hw, dyn):
        return int(dyn["new_h"][0]), int(dyn["new_w"][0])

    def apply_shard(self, x, left, right, h, w, dyn, col0, lw, in_col0, in_wb,
                    out_u8, impl=kernels):
        out = impl.gather_shard(x, self.out_hb, lw, col0, in_col0, in_wb, dyn["top"],
                                dyn["left"], out_u8=out_u8)
        return out, dyn["new_h"], dyn["new_w"]


_FILL_MODES = (Extend.BLACK, Extend.WHITE, Extend.BACKGROUND)


@dataclasses.dataclass(frozen=True)
class EmbedSpec(_ShardForm):
    """Place the image on a (canvas_h, canvas_w) canvas with an extend mode
    (kernel K4: mirror, or clamp with an optional fill).
    dyn: off_y, off_x, canvas_h, canvas_w (i32 [B]), fill (f32 [B, C])."""

    out_hb: int
    out_wb: int
    mode: Extend = Extend.MIRROR

    donates = True

    @property
    def _gather_mode(self) -> str:
        return "mirror" if self.mode is Extend.MIRROR else "clamp"

    def apply(self, x, h, w, dyn, out_u8: bool = False, out=None):
        fill = dyn["fill"] if self.mode in _FILL_MODES else None
        out = kernels.gather(x, self.out_hb, self.out_wb, dyn["off_y"],
                             dyn["off_x"], h, w, mode=self._gather_mode, fill=fill,
                             out_u8=out_u8, **_out_kw(out))
        return out, dyn["canvas_h"], dyn["canvas_w"]

    def shard_window(self, c0, c1, in_w, in_wb, dyn):
        """The min..max of the columns' index map: a mirror folds back, so
        the map itself, not its ends; columns in the fill keep their
        clamped index (a shard wholly in the fill still reads one)."""
        size = max(in_w, 1)
        rel = np.arange(c0, c1) - int(dyn["off_x"][0])
        if self.mode is Extend.MIRROR:
            m = np.mod(rel, 2 * size)
            idx = np.where(m < size, m, 2 * size - 1 - m)
        else:
            idx = np.clip(rel, 0, size - 1)
        return _span(np.clip(idx, 0, in_wb - 1))

    def shard_valid(self, hw, dyn):
        return int(dyn["canvas_h"][0]), int(dyn["canvas_w"][0])

    def apply_shard(self, x, left, right, h, w, dyn, col0, lw, in_col0, in_wb,
                    out_u8, impl=kernels):
        fill = dyn["fill"] if self.mode in _FILL_MODES else None
        out = impl.gather_shard(x, self.out_hb, lw, col0, in_col0, in_wb, dyn["off_y"],
                                dyn["off_x"], h, w, self._gather_mode, fill,
                                out_u8=out_u8)
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
class FlopSpec(_ShardForm):
    """Horizontal flip of the valid region; padding columns stay as they
    are (kernel K5, flop)."""

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = False, out=None):
        return kernels.orient(x, h, w, "flop", out_u8, **_out_kw(out)), h, w

    def shard_window(self, c0, c1, in_w, in_wb, dyn):
        """The mirror map's columns: [w - c1, w - c0) inside the valid
        width, the shard's own columns in the padding, and for the shard
        that straddles w two ranges, the mirrored [0, w - c0) and its own
        padding [w, c1), side by side (`flop_shard` reads the padding
        columns from the window's end)."""
        if c1 <= in_w:
            return in_w - c1, in_w - c0
        if c0 >= in_w or c0 == 0:
            return c0, c1
        return (0, in_w - c0), (in_w, c1)

    def apply_shard(self, x, left, right, h, w, dyn, col0, lw, in_col0, in_wb,
                    out_u8, impl=kernels):
        return impl.flop_shard(x, h, w, col0, lw, in_col0, out_u8), h, w


@dataclasses.dataclass(frozen=True)
class TransposeSpec(_ShardForm):
    """Swap H and W of the whole bucket, valid dims swapped with it
    (kernel K5, transpose). W-shard form: output shard j is input rows [j
    lw, (j + 1) lw) of every shard, transposed: an all-to-all
    (`parallel/spatial.exchange_bands`), then K5 on the assembled band."""

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = False, out=None):
        return kernels.orient(x, h, w, "transpose", out_u8, **_out_kw(out)), w, h

    def shard_input(self, img, c0, c1, w, dyn):
        # output columns [c0, c1) are the input's rows [c0, c1)
        return img[c0:c1], None, None, 0

    def shard_valid(self, hw, dyn):
        return hw[1], hw[0]

    def shard_exchange(self, row, lw, in_hw, in_wb, dyn, tally=None):
        for sh in row:
            sh.left = sh.right = None
        parts = spatial.exchange_bands(row, lw, tally)
        return [0] * len(row), [(j * lw, (j + 1) * lw, p) for j, p in enumerate(parts)]

    def apply_shard(self, x, left, right, h, w, dyn, col0, lw, in_col0, in_wb,
                    out_u8, impl=kernels):
        # the band [B, lw, Wb, C] -> the shard's columns [B, Wb, lw, C]
        return impl.orient(x, h, w, "transpose", out_u8), w, h


# The orientation stages, by the names K5 composes (`kernels.orient_run`).
ORIENT_STAGES = {FlipSpec: "flip", FlopSpec: "flop", TransposeSpec: "transpose"}


def apply_orient_run(specs, x, h, w, out_u8: bool = False, out=None):
    """A run of consecutive orientation stages (ORIENT_STAGES) as ONE K5
    launch of their composed mode, bit-equal to applying them one by one
    (the chain runner's fold, ops/chain.py). Returns (x, h, w), h and w
    swapped when the run transposes an odd number of times."""
    names = [ORIENT_STAGES[type(s)] for s in specs]
    x = kernels.orient_run(x, h, w, names, out_u8, **_out_kw(out))
    return (x, w, h) if names.count("transpose") % 2 else (x, h, w)


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

    def shard_ok(self, lw, first, in_wb, n):
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

    def shard_ok(self, lw, first, in_wb, n):
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
class FromDctSpec(_ShardForm):
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

    @property
    def _upsampled(self) -> bool:
        return self.k == 8 and self.layout in ("420", "422")

    def shard_ok(self, lw, first, in_wb, n):
        # it reads the packed host buffer; a shard holds whole MCUs
        return first and lw % kernels.dct_shard_step(self.layout, self.k) == 0

    def shard_input(self, img, c0, c1, w, dyn):
        """The shard's packed coefficients in `from_dct`'s layout at width
        lw (the three-plane and gray layouts: its own columns) and, at
        4:2:0 and 4:2:2 with k = 8, its Y columns, then U's and V's chroma
        columns [c0/2, c1/2), with halos of one whole chroma block of U and
        of V on each side ([chroma rows, 16, 1]): a chroma sample next to
        the shard needs its block's whole IDCT row. Each halo block is the
        neighbour clamped to the block that holds the valid chroma edge
        (`kernels.dct_halo_blocks`), so a shard past the valid width gets
        the columns the clamp reaches."""
        if not self._upsampled:
            return img[:, c0:c1], None, None, c0
        hb, cwb, lw = self.hb, self.wb // 2, c1 - c0
        lo, hi = kernels.dct_halo_blocks(c0, lw, w, self.wb)
        img = img[..., 0]  # row copies of a 2-D view run as block copies
        ch = img.shape[0] - hb
        x = np.empty((hb + ch, lw), dtype=img.dtype)
        x[:hb] = img[:hb, c0:c1]
        left = np.empty((ch, 16), dtype=img.dtype)
        right = np.empty((ch, 16), dtype=img.dtype)
        for p, base in enumerate((0, cwb)):
            x[hb:, p * lw // 2:(p + 1) * lw // 2] = img[hb:, base + c0 // 2:base + c1 // 2]
            left[:, p * 8:(p + 1) * 8] = img[hb:, base + 8 * lo:base + 8 * lo + 8]
            right[:, p * 8:(p + 1) * 8] = img[hb:, base + 8 * hi:base + 8 * hi + 8]
        return x[..., None], left[..., None], right[..., None], c0

    def apply_shard(self, x, left, right, h, w, dyn, col0, lw, in_col0, in_wb,
                    out_u8, impl=kernels):
        if out_u8:
            raise ValueError("FromDctSpec cannot end a chain")
        return impl.from_dct_shard(x, left, right, h, w, self.hb, lw, self.k, self.layout,
                                   col0, self.wb), h, w


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

    def shard_ok(self, lw, first, in_wb, n):
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
class ToDctSpec(_ShardForm):
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

    def shard_ok(self, lw, first, in_wb, n):
        # a chroma column covers two pixels; an MCU may straddle two shards
        return not first and lw % 2 == 0

    def shard_window(self, c0, c1, in_w, in_wb, dyn):
        """The whole MCUs [16 floor(c0/16), 16 ceil(c1/16)) that hold the
        shard's coefficients, each column clamped to in_w - 1 as K12
        replicates the valid edge outward: a shard wholly past the valid
        width reads column in_w - 1 alone."""
        m0, m1 = c0 // 16 * 16, -(-c1 // 16) * 16
        return min(m0, in_w - 1), min(m1, in_w)

    def apply_shard(self, x, left, right, h, w, dyn, col0, lw, in_col0, in_wb,
                    out_u8, impl=kernels):
        if not out_u8:
            raise ValueError("ToDctSpec must end its chain")
        return impl.to_dct_shard(x, h, w, dyn["qy"], dyn["qc"], self.hb, lw, col0,
                                 in_col0, self.wb), h, w

    # its shards hold K3's packing of their own columns
    shard_assemble = ToYuv420Spec.shard_assemble


@dataclasses.dataclass(frozen=True)
class GraySpec(_ShardForm):
    """Rec.709 luma broadcast over RGB, alpha kept (kernel K8)."""

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = False, out=None):
        return kernels.gray(x, out_u8, **_out_kw(out)), h, w

    def apply_shard(self, x, left, right, h, w, dyn, col0, lw, in_col0, in_wb,
                    out_u8, impl=kernels):
        return impl.gray(x, out_u8), h, w


_SAL_ROWS = ShardLaunch("saliency_rows_shard")
_SAL_SCAN = ShardLaunch("saliency_scan_shard")
_ARGMAX = ShardLaunch("window_argmax_shard")
_SMART_GATHER = ShardLaunch("gather_shard")


def _holding(row: list, xs: list, col0s: list) -> list:
    """Shards of `row` (their devices, streams and `ready` events) holding
    xs[j] at global columns from col0s[j]: the operands of an exchange of
    something other than the row's images."""
    out = []
    for sh, x, c0 in zip(row, xs, col0s):
        part = spatial.Shard(sh.device, sh.stream, 0, 1, c0)
        part.x, part.ready = x, sh.ready
        out.append(part)
    return out


@dataclasses.dataclass(frozen=True)
class SmartExtractSpec(_ShardForm):
    """Saliency-guided crop (ref: bimg GravitySmart): the saliency integral
    image (kernel K9), the best window's offsets, chosen on the device
    (K10), and the window gather at those offsets (K4), with no host
    round trip between them. dyn: new_h, new_w (i32 [B]).

    W-shard form (`run_shards`): input shard j holds columns [j in_lw, (j
    + 1) in_lw). K9's rows on each shard over its columns and per - 1 past
    each edge (per = ceil(in_wb / 256), the row scan's segment; input
    halos of per columns), then every shard's segment totals to every
    shard, K9's scan and columns (each shard's ii columns); K10 on the
    candidates whose left lies in the shard's columns over an ii window up
    to their windows' right edges, of only the rows K10 reads (its
    candidates' tops and bottoms: two bands of nr = h - new_h + 1 rows),
    then every shard's best key to every shard; K4 reduces the keys and
    gathers from an image window that covers every offset K10 may choose
    (left <= w - new_w)."""

    out_hb: int
    out_wb: int

    donates = True

    def apply(self, x, h, w, dyn, out_u8: bool = False, out=None):
        ii = kernels.saliency_ii(x, h, w)
        top, left = kernels.window_argmax(ii, h, w, dyn["new_h"], dyn["new_w"])
        out = kernels.gather(x, self.out_hb, self.out_wb, top, left,
                             mode="window", out_u8=out_u8, **_out_kw(out))
        return out, dyn["new_h"], dyn["new_w"]

    def shard_ok(self, lw, first, in_wb, n):
        # whole segments of the row scan a shard, and halos of one segment
        return in_wb % n == 0 and in_wb // n >= kernels.saliency_segment(in_wb)

    def shard_input(self, img, c0, c1, w, dyn):
        """The shard's input columns (of the input bucket, which its output
        columns do not index) and halos of one segment."""
        n = self.out_wb // (c1 - c0)
        in_lw = img.shape[1] // n
        k0 = c0 // (c1 - c0) * in_lw
        k1, r = k0 + in_lw, kernels.saliency_segment(img.shape[1])
        left = img[:, k0 - r:k0] if k0 > 0 else None
        right = img[:, k1:k1 + r] if k1 < img.shape[1] else None
        return img[:, k0:k1], left, right, k0

    def shard_valid(self, hw, dyn):
        return int(dyn["new_h"][0]), int(dyn["new_w"][0])

    def run_shards(self, row, dyns, lw, in_col0, in_hw, in_wb, dyn, out_u8, trace=None,
                   stage=0, tally=None):
        n = len(row)
        in_h, in_w = in_hw
        in_lw, per = in_wb // n, kernels.saliency_segment(in_wb)
        cols = [j * in_lw for j in range(n)]
        if in_col0 is None:
            for sh in row:
                sh.left = sh.right = None
            spatial.exchange_halos([row], per, tally)
        for sh, c0 in zip(row, cols):
            sh.col0 = c0
        # K9: each shard's rows, then every shard's totals, then its scan
        sals, tots = [], []
        for j, sh in enumerate(row):
            sal, tot = _launch(sh, _SAL_ROWS, (sh.x, sh.left, sh.right, sh.h, sh.w,
                                               cols[j], in_wb), trace, stage, j)
            sals.append(sal)
            tots.append(tot)
        firsts = [-(-c0 // per) for c0 in cols]
        parts = _holding(row, tots, firsts)
        spatial.exchange_window(parts, [(0, -(-in_wb // per))] * n, tally)
        iis = [_launch(sh, _SAL_SCAN, (sals[j], parts[j].x, cols[j], in_lw, in_wb),
                       trace, stage, j) for j, sh in enumerate(row)]
        # K10: each shard's candidates over the ii rows and columns they
        # read (rows [0, nr) and [new_h, new_h + nr), columns from the
        # first candidate's left to the last one's right), then every key
        in_hb = row[0].x.shape[1]
        new_h, new_w = int(dyn["new_h"][0]), int(dyn["new_w"][0])
        lim_t, lim_l = in_h - new_h, in_w - new_w
        nr = 0 if lim_t < 0 else min(lim_t, in_hb - 1) + 1
        ncols = 0 if lim_l < 0 or nr == 0 else min(lim_l, in_wb - 1) + 1
        bands = [(0, nr), (new_h, new_h + nr)] if nr else [(0, 1), (0, 1)]
        ii_wins = []
        for c0 in cols:
            last = min(c0 + in_lw, ncols) - 1  # the shard's last candidate
            k0 = max(c0, 1)
            hi = min(last + new_w, in_wb) if last >= c0 else k0
            ii_wins.append((k0, max(hi, k0) + 1))
        parts = _holding(row, iis, [c0 + 1 for c0 in cols])
        spatial.exchange_window(parts, ii_wins, tally, rows=bands)
        keys = []
        for j, sh in enumerate(row):
            k = _launch(sh, _ARGMAX, (parts[j].x, sh.h, sh.w, dyns[j]["new_h"],
                                      dyns[j]["new_w"], ii_wins[j][0], cols[j],
                                      cols[j] + in_lw, in_hb, in_wb), trace, stage, j)
            keys.append(k.reshape(-1, 1, 1))
        parts = _holding(row, keys, list(range(n)))
        spatial.exchange_window(parts, [(0, n)] * n, tally)
        # K4: the image window every offset K10 may choose reads
        reach = max(lim_l + 1, 0)
        wins = [(min(j * lw, in_wb - 1), min((j + 1) * lw - 1 + reach, in_wb - 1) + 1)
                for j in range(n)]
        sources = spatial.exchange_window(row, wins, tally)
        for j, sh in enumerate(row):
            args = (sh.x, self.out_hb, lw, j * lw, wins[j][0], in_wb, None, None, None,
                    None, "window", None, parts[j].x.reshape(-1, n), in_wb, out_u8)
            sh.x = _launch(sh, _SMART_GATHER, args, trace, stage, j)
            sh.h, sh.w = dyns[j]["new_h"], dyns[j]["new_w"]
            sh.col0, sh.left, sh.right = j * lw, None, None
        return [(k0, k1, p) for (k0, k1), p in zip(wins, sources)]
