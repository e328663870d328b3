"""Hold the port's K6 (blur), K2 (yuv420_unpack), K11 (from_dct), K12
(to_dct), K9 (saliency), K10 (window_argmax), K1 (resample), K13
(blur_halo), K3 (yuv420_pack), K8 (gray) and K5 (orient) against an
earlier tree's on one card: outputs bit for bit, and device times in
turns; and three chains of kernels launched back to back as the chain
runner launches them.

Run from the repository root on a machine with the card:

    python3 scripts/kernel_ab.py --parent DIR [--only orient]

DIR is a checkout of the earlier tree. Its own `imaginary_tpu_torch.kernels`
is imported first (its libraries built by its own `load_all` into DIR's
`_build/`) and then taken out of `sys.modules`, so this tree's package
imports as usual and the earlier module keeps its own globals: its `blur`,
`yuv420_to_rgb`, `from_dct`, `to_dct`, `saliency_ii`, `window_argmax` and
`resample` wrappers, and its `parallel.spatial` (K13's shards, exchange
and passes), launch its kernels through its own ABI, whatever that is. For
each case at the main paths' shapes and at the seams of the new designs,
the script checks this tree's kernel against its plain version
(`F32_TOL`, or `U8_TOL` on uint8 output; K12's coefficients within
`COEF_TOL`, at most `COEF_SHARE` of them differing; K9's integral image
within `II_RTOL`; K10's offsets equal), compares it with the earlier
kernel (max |diff| and whether the two are bit-equal; K10 is fed this
tree's K9 output on both sides; K13 on chip_smoke's phase 10(a) frames
and meshes, the shards' K13 launches of either tree after its own
exchange, with K6 on the whole frames), and times both with
`chip_smoke.device_ms` in turns (earlier, this, this, earlier). K3 runs at
config 1's [1, 208, 304, 3], /rotate's [32, 1920, 1088, 3], the bw
/resize's [1, 368, 640, 3] and chip_smoke's PACK_SEAM_CASES; K8 at the bw
frame, config 3's uint8 C = 4 frame and chip_smoke's GRAY_CASES (W-shard
views at an unaligned offset among them); K3's fused luma form against
the earlier K8 then K3. The chain rows run this tree's chain runner
(`ops/chain._run_steps`) on config 1's plan (K2 -> K1 -> K4 -> K3) and
the colorspace=bw /resize's (K2 -> K1 -> K8 -> K3) staged on the card,
the earlier tree's kernels under its stages with every live stage its
own launch, this tree's with its `launch_steps` (the bw chain then
K2 -> K1 -> fused K3): what programmatic dependent launch and the fusion
save on the card between launches, which single-kernel times cannot see.
K5 (`orient_rows`; alone with `--only orient`): each single mode and
chip_smoke's ORIENT_RUNS at B = 1 and 32 on the /rotate chain's bucket,
a run of this tree's one launch against the earlier tree's stages
launched one by one, uint8 in and out, the flop's W-shard form on four
shards of the 4K frame (one straddling the valid width), and the
/rotate?rotate=90 chain at B = 1 and 32: the earlier kernels under this
tree's runner, a tree without K5's run form launching each orientation
stage on its own (K2 -> K5 -> K5 -> K4 -> K3, `EarlierUnderThisChain`),
against this tree's (K2 -> K5 -> K4 -> K3).
One JSON line per case on stdout; all of them in
chip_smoke_out/kernel_ab.json.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

PKG = "imaginary_tpu_torch"
# the CUDA sources whose build logs are printed
AB_SOURCES = ("blur", "yuv420_unpack", "from_dct", "to_dct", "saliency", "resample",
              "blur_halo", "yuv420_pack", "gray", "orient")


def _package_modules() -> dict:
    return {k: m for k, m in sys.modules.items() if k == PKG or k.startswith(PKG + ".")}


def load_tree_kernels(tree: str):
    """TREE's `imaginary_tpu_torch.kernels` and `parallel.spatial` modules,
    its libraries built and loaded; sys.modules and sys.path are left as
    they were."""
    saved = _package_modules()
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, tree)
    try:
        mod = importlib.import_module(PKG + ".kernels")
        spatial = importlib.import_module(PKG + ".parallel.spatial")
        where = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(mod.__file__))))
        if where != tree:
            raise RuntimeError(f"imported {mod.__file__}, not the package under {tree}")
        built = mod.load_all()
    finally:
        sys.path.remove(tree)
        for k in _package_modules():
            del sys.modules[k]
        sys.modules.update(saved)
    for src in ab_sources(mod):
        cs.log(f"  earlier {src}: built\n{built.get(src, {}).get('log', '')}")
    return mod, spatial


def ab_sources(mod) -> list:
    """The AB_SOURCES that module `mod` builds."""
    return sorted({src for src, _, _ in mod._SIGNATURES.values()} & set(AB_SOURCES))


def resample_cases(dev, gen):
    """(case, x, h, w, dst_h, dst_w, out_hb, out_wb): config 3's 4K uint8
    frame to 720x1280, and the 6.4x f32 downscale of 1080p at B=8."""
    import torch

    shb, swb = cs.CONFIG3_SRC_BUCKET
    xs = torch.zeros((1, shb, swb, 3), dtype=torch.uint8, device=dev)
    xs[:, :cs.CONFIG3_SRC[0], :cs.CONFIG3_SRC[1]] = torch.randint(
        0, 256, (1, *cs.CONFIG3_SRC, 3), generator=gen, device=dev, dtype=torch.uint8)
    one = torch.ones((1,), device=dev)
    x8 = torch.rand((8, 1088, 1920, 3), generator=gen, device=dev) * 255.0
    i8 = torch.ones((8,), dtype=torch.int32, device=dev)
    return [("config3-4K-u8", xs, (one * cs.CONFIG3_SRC[0]).int(),
             (one * cs.CONFIG3_SRC[1]).int(), one * cs.CONFIG3_VALID[0],
             one * cs.CONFIG3_VALID[1], *cs.CONFIG3_FRAME),
            ("1080p-B8-6.4x", x8, i8 * 1080, i8 * 1920, i8.float() * 169.0,
             i8.float() * 300.0, 176, 304)]


def parent_k13(old, old_spatial, grid, r: int, wb: int):
    """The earlier tree's K13 launches over its own shards after its own
    exchange: the fused kernel, or its two passes."""
    shards = [sh for row in grid for sh in row]
    if hasattr(old, "blur_halo"):
        old_spatial.exchange_halos(grid, r)
        return lambda: [old.blur_halo(sh.x, sh.left, sh.right, sh.h, sh.w, sh.sigma, r,
                                      sh.col0, wb) for sh in shards]
    old_spatial.blur_v(grid, r)
    old_spatial.exchange_halos(grid, r)
    # pass V, then pass H on the exchanged buffer, shard by shard
    return lambda: [(old.blur_halo_v(sh.x, sh.h, sh.w, sh.sigma, r, sh.col0),
                     old.blur_halo_h(sh.buf, sh.h, sh.w, sh.sigma, r, sh.col0, wb))
                    for sh in shards]


def blur_cases(dev, gen):
    """(case, x, h, w, sigma, radius, out_u8): config 3's shapes (chip_smoke
    phase 3's), then the seams of the strip-and-row-run design."""
    import torch

    def i32(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def frame(shape, u8=False):
        if u8:
            return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)
        return torch.rand(shape, generator=gen, device=dev) * 255.0

    hb, wb = cs.CONFIG3_FRAME
    out = []
    for bsz in cs.CONFIG3_BATCHES:
        h, w, s = cs.config3_dims(bsz, dev)
        out.append((f"B{bsz}-r4", frame((bsz, hb, wb, 3)), h, w, s, 4, False))
    h, w, _ = cs.config3_dims(1, dev)
    x = frame((1, hb, wb, 3))
    out.append(("B1-r64", x, h, w, torch.full((1,), 20.0, device=dev), 64, False))
    out.append(("B1-sigma0", x, h, w, torch.full((1,), 0.0, device=dev), 4, False))
    xu = frame((1, hb, wb, 4), True)
    s12 = torch.full((1,), 1.2, device=dev)
    out.append(("B1-u8-in-C4", xu, h, w, s12, 4, False))
    out.append(("B1-u8-in-out-C4", xu, h, w, s12, 4, True))
    for case, c, u8 in cs.BLUR_SEAM_CASES:
        shape, hh, ww, sig, r = cs.blur_seam_inputs(case, c)
        out.append((f"{case}-C{c}" + ("-u8" if u8 else ""), frame(shape, u8), i32(*hh),
                    i32(*ww), torch.tensor(sig, device=dev), r, u8))
    return out


def unpack_cases(dev, gen):
    """(case, x, h, w, hb, wb): K2 at config 1's and /rotate's shapes on
    seeded planes, then the seams (chip_smoke's YUV_SEAM_CASES)."""
    import torch

    out = []
    for case, bsz, (hb, wb), (h, w) in (("B1", 1, (320, 512), (270, 480)),
                                        ("B16", 16, (320, 512), (270, 480)),
                                        ("B32-rotate", 32, cs.ROTATE_IN_BUCKET, (1080, 1920))):
        x = torch.randint(0, 256, (bsz, hb + hb // 2, wb, 1), generator=gen, device=dev,
                          dtype=torch.uint8)
        out.append((case, x, torch.full((bsz,), h, dtype=torch.int32, device=dev),
                    torch.full((bsz,), w, dtype=torch.int32, device=dev), hb, wb))
    for case, (hb, wb), hw in cs.YUV_SEAM_CASES:
        bsz = len(hw)
        x = torch.randint(0, 256, (bsz, hb + hb // 2, wb, 1), generator=gen, device=dev,
                          dtype=torch.uint8)
        out.append((case, x, torch.tensor([a for a, _ in hw], dtype=torch.int32, device=dev),
                    torch.tensor([b for _, b in hw], dtype=torch.int32, device=dev), hb, wb))
    return out


def from_dct_cases(dev):
    """(case, x, h, w, hb, wb, k, layout): chip_smoke's dct_kernel_phase
    cases, 1080p 4:2:0 at B=4, then the seams (DCT_SEAM_CASES)."""
    import torch

    out = cs.from_dct_cases(dev)
    _, x, h, w, hb, wb, k, lay = out[0]
    out.append(("1080p-420-k8-B4", x.repeat(4, 1, 1, 1), h.repeat(4), w.repeat(4), hb, wb,
                k, lay))
    rng = np.random.default_rng(cs.SEED + 9)
    for kernel, case, lay, k, (hb, wb), hw in cs.DCT_SEAM_CASES:
        if kernel == "from_dct":
            x = cs.dct_seam_inputs(kernel, lay, k, (hb, wb), len(hw), rng)
            out.append(("seam-" + case, torch.from_numpy(x).to(dev),
                        torch.tensor([a for a, _ in hw], dtype=torch.int32, device=dev),
                        torch.tensor([b for _, b in hw], dtype=torch.int32, device=dev),
                        hb, wb, k, lay))
    return out


def to_dct_cases(dev, rgb_1080):
    """(case, x, h, w, qy, qc): chip_smoke's dct_kernel_phase cases (208x304,
    the /resize?width=1600 bucket, 1088x1920), then the seams."""
    import torch

    from imaginary_tpu_torch.codecs import jpeg_dct

    qy, qc = jpeg_dct.quality_tables(80)
    rng = np.random.default_rng(cs.SEED + 10)
    out = cs.to_dct_cases(dev, rgb_1080)
    for kernel, case, _, _, bucket, hw in cs.DCT_SEAM_CASES:
        if kernel == "to_dct":
            x = cs.dct_seam_inputs(kernel, None, None, bucket, len(hw), rng)
            out.append(("seam-" + case, torch.from_numpy(x).to(dev),
                        torch.tensor([a for a, _ in hw], dtype=torch.int32, device=dev),
                        torch.tensor([b for _, b in hw], dtype=torch.int32, device=dev)))
    tables = []
    for case, x, h, w in out:
        bsz = x.shape[0]
        tables.append((case, x, h, w,
                       torch.tensor(np.stack([qy] * bsz), dtype=torch.float32, device=dev),
                       torch.tensor(np.stack([qc] * bsz), dtype=torch.float32, device=dev)))
    return tables


def saliency_cases(dev, gen):
    """(case, x, h, w, win_h, win_w): config 4's f32 input at B=1 and B=8
    (chip_smoke's `config4_inputs`, windows 300x300), the same in uint8,
    then the seams (chip_smoke's SAL_SEAM_CASES)."""
    import torch

    out = []
    for bsz in cs.CONFIG4_BATCHES:
        x, h, w = cs.config4_inputs(bsz, dev, gen)
        win = torch.full((bsz,), cs.CONFIG4_WINDOW, dtype=torch.int32, device=dev)
        out.append((f"B{bsz}", x, h, w, win, win))
        out.append((f"B{bsz}-u8", x.to(torch.uint8), h, w, win, win))
    rng = np.random.default_rng(cs.SEED + 12)
    for case in cs.SAL_SEAM_CASES:
        out.append(("seam-" + case[0], *cs.sal_seam_tensors(case, rng, dev)))
    return out


def pack_cases(dev, gen):
    """(case, x, h, w, hb, wb): K3 at config 1's output bucket (B=1),
    /rotate's at B=32, the bw /resize's frame, then chip_smoke's
    PACK_SEAM_CASES."""
    import torch

    def i32(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    out = [("config1-B1", torch.rand((1, 208, 304, 3), generator=gen, device=dev) * 255.0,
            i32(200), i32(300), 208, 304),
           ("rotate-B32", torch.rand((32, 1920, 1088, 3), generator=gen, device=dev) * 255.0,
            i32(*[1920] * 32), i32(*[1080] * 32), 1920, 1088),
           ("bw-frame", torch.rand((1, *cs.BW_FRAME, 3), generator=gen, device=dev) * 255.0,
            i32(cs.BW_VALID[0]), i32(cs.BW_VALID[1]), *cs.BW_FRAME)]
    for case, (hb, wb), hw, off in cs.PACK_SEAM_CASES:
        x = cs.offset_view((len(hw), hb, wb, 3), torch.float32, off,
                           lambda n: torch.rand((n,), generator=gen, device=dev) * 295.0 - 20.0)
        out.append(("seam-" + case, x, i32(*[a for a, _ in hw]), i32(*[b for _, b in hw]),
                    hb, wb))
    return out


def gray_cases(dev, gen):
    """(case, x, out_u8): K8 at the bw /resize's f32 frame, config 3's
    uint8 C = 4 frame in and out, then chip_smoke's GRAY_CASES."""
    import torch

    def fill_u8(n):
        return torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=torch.uint8)

    def fill_f32(n):
        return torch.rand((n,), generator=gen, device=dev) * 255.0

    out = [("bw-frame", fill_f32(cs.BW_FRAME[0] * cs.BW_FRAME[1] * 3).view(1, *cs.BW_FRAME, 3),
            False),
           ("config3-u8-C4", fill_u8(cs.CONFIG3_FRAME[0] * cs.CONFIG3_FRAME[1] * 4).view(
               1, *cs.CONFIG3_FRAME, 4), True)]
    for case, shape, u8_in, u8_out, off in cs.GRAY_CASES:
        x = cs.offset_view(shape, torch.uint8 if u8_in else torch.float32, off,
                           fill_u8 if u8_in else fill_f32)
        out.append((case, x, u8_out))
    return out


class EarlierUnderThisChain:
    """The earlier tree's kernel wrappers, as this tree's stages call them
    (its K3 takes no `luma`: the earlier chain never fused)."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def rgb_to_yuv420(self, x, h, w, hb, wb, luma=False):
        if luma:
            raise ValueError("the earlier tree has no fused K3")
        return self._mod.rgb_to_yuv420(x, h, w, hb, wb)

    def orient_run(self, x, h, w, names, out_u8=False, out=None):
        """The earlier tree's K5 for a run of orientation stages: its own
        composed launch where it has one, else each stage on its own."""
        if hasattr(self._mod, "orient_run"):
            return self._mod.orient_run(x, h, w, names, out_u8, out=out)
        for k, name in enumerate(names):
            last = k == len(names) - 1
            x = self._mod.orient(x, h, w, name, out_u8 and last,
                                 **({"out": out} if last and out is not None else {}))
            if name == "transpose":
                h, w = w, h
        return x


def chain_inputs(dev, op: str, query, bsz: int = 1):
    """(specs, live stages, x, h, w, dyns) of chip_smoke's plan for `op` on
    large.jpg over the yuv420 transport, staged on the card (B copies)."""
    import torch

    from imaginary_tpu_torch.ops import chain

    arr, plan = cs.main_plan(op, "yuv420", query)
    specs = plan.spec_key()
    dyns = [{k: torch.from_numpy(np.stack([v[0]] * bsz)).to(dev) for k, v in d.items()}
            for d in chain._stack_dyns([plan])]
    x = torch.from_numpy(np.stack([arr] * bsz)).to(dev)
    h = torch.full((bsz,), plan.in_h, dtype=torch.int32, device=dev)
    w = torch.full((bsz,), plan.in_w, dtype=torch.int32, device=dev)
    return specs, chain.live_stages(specs, *arr.shape[:2]), x, h, w, dyns


def run_chain_with(mod, specs, steps, x, h, w, dyns):
    """This tree's chain runner over `steps` with the stages launching
    through kernels module `mod` (an earlier tree's under
    `EarlierUnderThisChain`)."""
    from imaginary_tpu_torch.ops import chain, stages

    saved = stages.kernels
    stages.kernels = mod
    try:
        return chain._run_steps(specs, steps, x, h, w, dyns)[0]
    finally:
        stages.kernels = saved


def orient_rows(old, dev, gen, emit) -> None:
    """K5 against the earlier tree's: each single mode and each run of
    chip_smoke's ORIENT_RUNS at B = 1 and 32 on the /rotate chain's bucket
    (a run against the earlier tree's stages launched one by one), uint8
    in and out, the flop's W-shard form on four shards of the 4K frame,
    then the /rotate chain: the earlier K2 -> K5 -> K5 -> K4 -> K3 against
    this tree's K2 -> K5 -> K4 -> K3 at B = 1 and 32."""
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference
    from imaginary_tpu_torch.ops import chain
    from imaginary_tpu_torch.ops.stages import FlopSpec
    from imaginary_tpu_torch.parallel import spatial

    prev = EarlierUnderThisChain(old)
    earlier = prev.orient_run
    folds = hasattr(old, "orient_run")  # the earlier tree launches a run once

    runs = [(m, (m,)) for m in reference.ORIENT_MODES] + list(cs.ORIENT_RUNS)
    for bsz in cs.ORIENT_BATCHES:
        x = torch.rand((bsz, *cs.ORIENT_RUN_SHAPE), generator=gen, device=dev) * 255.0
        h, w = cs.valid_dims(bsz, *cs.ORIENT_RUN_SHAPE[:2], dev)
        for name, names in runs:
            got = kernels.orient_run(x, h, w, names)
            err = cs.max_err(got, reference.orient_run(x, h, w, names))
            if err != 0.0:
                raise AssertionError(f"orient [B{bsz}-{name}]: max |err| {err}")
            d, eq = diff(got, earlier(x, h, w, names))
            ta, tb = turns(lambda: earlier(x, h, w, names),
                           lambda: kernels.orient_run(x, h, w, names))
            emit({"kernel": "orient", "case": f"B{bsz}-{name}", "shape": list(x.shape),
                  "parent_launches": 1 if folds else len(names), "launches": 1,
                  "err_vs_plain": err,
                  "diff_vs_parent": d, "bit_equal": eq, "parent_ms": ta, "ms": tb,
                  "bound_ms": cs.bound_ms(x.numel() * 8, 0.0)[0]})
            del got
        del x
    xu = torch.randint(0, 256, cs.ORIENT_U8, generator=gen, device=dev, dtype=torch.uint8)
    h, w = cs.valid_dims(*cs.ORIENT_U8[:3], dev)
    for name, names in runs:
        for out_u8 in (False, True):
            got = kernels.orient_run(xu, h, w, names, out_u8)
            if not torch.equal(got, reference.orient_run(xu, h, w, names, out_u8)):
                raise AssertionError(f"orient [u8-{name}]: differs from its plain version")
            d, eq = diff(got, earlier(xu, h, w, names, out_u8))
            emit({"kernel": "orient", "case": f"u8-{'u8' if out_u8 else 'f32'}-{name}",
                  "shape": list(xu.shape), "diff_vs_parent": d, "bit_equal": eq})
    del xu
    x = torch.rand(cs.ORIENT_4K, generator=gen, device=dev) * 255.0
    wb, n = cs.ORIENT_4K[2], cs.ORIENT_SHARDS
    lw = wb // n
    h = torch.tensor([2160], dtype=torch.int32, device=dev)
    w = torch.tensor([wb - 37], dtype=torch.int32, device=dev)  # a shard straddles w
    for j in range(n):
        spans = spatial.window_spans(FlopSpec().shard_window(j * lw, (j + 1) * lw, wb - 37,
                                                             wb, {}))
        xs = torch.cat([x[:, :, k0:k1] for k0, k1 in spans], dim=2).contiguous()
        args = (xs, h, w, j * lw, lw, spans[0][0])
        got = kernels.flop_shard(*args)
        if not torch.equal(got, reference.flop_shard(*args)):
            raise AssertionError(f"flop_shard [{j}]: differs from its plain version")
        d, eq = diff(got, old.flop_shard(*args))
        ta, tb = turns(lambda: old.flop_shard(*args), lambda: kernels.flop_shard(*args))
        emit({"kernel": "orient", "case": f"4K-flop-shard{j}", "shape": list(xs.shape),
              "diff_vs_parent": d, "bit_equal": eq, "parent_ms": ta, "ms": tb,
              "bound_ms": cs.bound_ms(xs.numel() * 4 + got.numel() * 4, 0.0)[0]})
    del x
    for bsz in (1, cs.CONFIG2_BATCH):
        specs, live, x, h, w, dyns = chain_inputs(dev, "rotate", {"rotate": "90"}, bsz)
        steps = chain.launch_steps(specs, live)
        got = run_chain_with(kernels, specs, steps, x, h, w, dyns)
        d, eq = diff(got, run_chain_with(prev, specs, steps, x, h, w, dyns))
        ta, tb = turns(lambda: run_chain_with(prev, specs, steps, x, h, w, dyns),
                       lambda: run_chain_with(kernels, specs, steps, x, h, w, dyns))
        emit({"kernel": "chain", "case": f"rotate90-B{bsz}",
              "stages": [type(specs[i]).__name__ for i in live],
              "parent_launches": len(chain.orient_runs(specs, steps)) if folds else len(steps),
              "launches": len(chain.orient_runs(specs, steps)),
              "diff_vs_parent": d, "bit_equal": eq, "parent_ms": ta, "ms": tb})
        del x, got


def pack_gray_rows(old, dev, gen, emit) -> None:
    """K3's and K8's rows (`pack_cases`, `gray_cases`, K3's fused form) and
    the two chain rows, against the earlier tree's kernels module `old`."""
    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference
    from imaginary_tpu_torch.ops import chain

    for case, x, h, w, hb, wb in pack_cases(dev, gen):
        got = kernels.rgb_to_yuv420(x, h, w, hb, wb)
        err = cs.max_err(got, reference.rgb_to_yuv420(x, h, w, hb, wb))
        if not err <= cs.U8_TOL:
            raise AssertionError(f"yuv420_pack [{case}]: max |err| {err} > {cs.U8_TOL}")
        d, eq = diff(got, old.rgb_to_yuv420(x, h, w, hb, wb))
        ta, tb = turns(lambda: old.rgb_to_yuv420(x, h, w, hb, wb),
                       lambda: kernels.rgb_to_yuv420(x, h, w, hb, wb))
        emit({"kernel": "yuv420_pack", "case": case, "shape": list(x.shape),
              "aligned": x.data_ptr() % 16 == 0, "err_vs_plain": err, "diff_vs_parent": d,
              "bit_equal": eq, "parent_ms": ta, "ms": tb})
        if case == "bw-frame":  # the fused form against the earlier K8 then K3
            got = kernels.rgb_to_yuv420(x, h, w, hb, wb, luma=True)
            err = cs.max_err(got, reference.rgb_to_yuv420(x, h, w, hb, wb, luma=True))
            if not err <= cs.U8_TOL:
                raise AssertionError(f"yuv420_pack [bw-fused]: max |err| {err} > {cs.U8_TOL}")
            d, eq = diff(got, old.rgb_to_yuv420(old.gray(x), h, w, hb, wb))
            ta, tb = turns(lambda: old.rgb_to_yuv420(old.gray(x), h, w, hb, wb),
                           lambda: kernels.rgb_to_yuv420(x, h, w, hb, wb, luma=True))
            emit({"kernel": "yuv420_pack", "case": "bw-fused", "shape": list(x.shape),
                  "parent": "gray then yuv420_pack", "err_vs_plain": err,
                  "diff_vs_parent": d, "bit_equal": eq, "parent_ms": ta, "ms": tb})
        del got
    for case, x, u8 in gray_cases(dev, gen):
        got = kernels.gray(x, u8)
        err = cs.max_err(got, reference.gray(x, u8))
        tol = cs.U8_TOL if u8 else cs.F32_TOL
        if not err <= tol:
            raise AssertionError(f"gray [{case}]: max |err| {err} > {tol}")
        d, eq = diff(got, old.gray(x, u8))
        ta, tb = turns(lambda: old.gray(x, u8), lambda: kernels.gray(x, u8))
        emit({"kernel": "gray", "case": case, "shape": list(x.shape), "dtype": str(x.dtype),
              "out_u8": u8, "aligned": x.data_ptr() % 16 == 0, "err_vs_plain": err,
              "diff_vs_parent": d, "bit_equal": eq, "parent_ms": ta, "ms": tb})
    earlier = EarlierUnderThisChain(old)
    for case, op, query in (("config1-K2-K1-K4-K3", "resize", None),
                            ("bw-K2-K1-K8-K3", "resize", cs.BW_QUERY)):
        specs, live, x, h, w, dyns = chain_inputs(dev, op, query)
        steps = chain.launch_steps(specs, live)
        unfused = [(i, False) for i in live]
        got = run_chain_with(kernels, specs, steps, x, h, w, dyns)
        d, eq = diff(got, run_chain_with(earlier, specs, unfused, x, h, w, dyns))
        ta, tb = turns(lambda: run_chain_with(earlier, specs, unfused, x, h, w, dyns),
                       lambda: run_chain_with(kernels, specs, steps, x, h, w, dyns))
        emit({"kernel": "chain", "case": case,
              "stages": [type(specs[i]).__name__ for i in live],
              "parent_launches": len(unfused), "launches": len(steps),
              "diff_vs_parent": d, "bit_equal": eq, "parent_ms": ta, "ms": tb})


def turns(fa, fb) -> tuple:
    """Device ms of fa and fb in turns a, b, b, a: (a's two, b's two)."""
    a1 = cs.device_ms(fa)
    b1 = cs.device_ms(fb)
    b2 = cs.device_ms(fb)
    a2 = cs.device_ms(fa)
    return [a1, a2], [b1, b2]


def diff(a, b) -> tuple:
    import torch

    return cs.max_err(a, b), bool(torch.equal(a, b))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--only", choices=("orient",),
                    help="run only these rows (K5's and the /rotate chain's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    cs.log(smi)
    old, old_spatial = load_tree_kernels(os.path.abspath(args.parent))
    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference
    from imaginary_tpu_torch.parallel import get_mesh, spatial

    built = kernels.load_all()
    for src in ab_sources(kernels):
        cs.log(f"  {src}: built\n{built[src]['log']}")
    dev = torch.device(cs.DEVICE)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    rows = []

    def emit(row):
        rows.append(row)
        cs.log(json.dumps(row))

    if args.only == "orient":
        orient_rows(old, dev, gen, emit)
        return finish(smi, rows)
    for case, x, h, w, s, r, u8 in blur_cases(dev, gen):
        got = kernels.blur(x, h, w, s, r, u8)
        err = cs.max_err(got, reference.blur(x, h, w, s, r, u8))
        tol = cs.U8_TOL if u8 else cs.F32_TOL
        if not err <= tol:
            raise AssertionError(f"blur [{case}]: max |err| {err} > {tol}")
        d, eq = diff(got, old.blur(x, h, w, s, r, u8))
        ta, tb = turns(lambda: old.blur(x, h, w, s, r, u8),
                       lambda: kernels.blur(x, h, w, s, r, u8))
        emit({"kernel": "blur", "case": case, "shape": list(x.shape), "r": r,
              "strip": kernels.blur_strip(x.shape[3], r),
              "err_vs_plain": err, "diff_vs_parent": d, "bit_equal": eq,
              "parent_ms": ta, "ms": tb})
    for case, x, h, w, hb, wb in unpack_cases(dev, gen):
        got = kernels.yuv420_to_rgb(x, h, w, hb, wb)
        err = cs.max_err(got, reference.yuv420_to_rgb(x, h, w, hb, wb))
        if not err <= cs.F32_TOL:
            raise AssertionError(f"yuv420_unpack [{case}]: max |err| {err} > {cs.F32_TOL}")
        d, eq = diff(got, old.yuv420_to_rgb(x, h, w, hb, wb))
        ta, tb = turns(lambda: old.yuv420_to_rgb(x, h, w, hb, wb),
                       lambda: kernels.yuv420_to_rgb(x, h, w, hb, wb))
        emit({"kernel": "yuv420_unpack", "case": case, "shape": list(x.shape),
              "err_vs_plain": err, "diff_vs_parent": d, "bit_equal": eq,
              "parent_ms": ta, "ms": tb})
    rgb_1080 = None
    for case, x, h, w, hb, wb, k, lay in from_dct_cases(dev):
        args = (x, h, w, hb, wb, k, lay)
        got = kernels.from_dct(*args)
        err = cs.max_err(got, reference.from_dct(*args))
        if not err <= cs.F32_TOL:
            raise AssertionError(f"from_dct [{case}]: max |err| {err} > {cs.F32_TOL}")
        d, eq = diff(got, old.from_dct(*args))
        ta, tb = turns(lambda: old.from_dct(*args), lambda: kernels.from_dct(*args))
        emit({"kernel": "from_dct", "case": case, "shape": list(x.shape), "layout": lay,
              "k": k, "err_vs_plain": err, "diff_vs_parent": d, "bit_equal": eq,
              "parent_ms": ta, "ms": tb})
        if case == "1080p-420-k8":
            rgb_1080 = got[:, :1088, :1920].contiguous()
    for case, x, h, w, qy, qc in to_dct_cases(dev, rgb_1080):
        hb, wb = x.shape[1:3]
        args = (x, h, w, qy, qc, hb, wb)
        got = kernels.to_dct(*args)
        scratch = {}
        err = cs.check_coef("to_dct", got, reference.to_dct(*args), scratch, case)
        d, eq = diff(got, old.to_dct(*args))
        ta, tb = turns(lambda: old.to_dct(*args), lambda: kernels.to_dct(*args))
        emit({"kernel": "to_dct", "case": case, "shape": list(x.shape), "err_vs_plain": err,
              "differing_share": scratch["to_dct"][case]["differing_share"],
              "diff_vs_parent": d, "bit_equal": eq, "parent_ms": ta, "ms": tb})
    for case, x, h, w, wh, ww in saliency_cases(dev, gen):
        got = kernels.saliency_ii(x, h, w)
        err = cs.check_rel("saliency", got, reference.saliency_ii(x, h, w), {}, case,
                           cs.II_RTOL)
        d, eq = diff(got, old.saliency_ii(x, h, w))
        ta, tb = turns(lambda: old.saliency_ii(x, h, w), lambda: kernels.saliency_ii(x, h, w))
        emit({"kernel": "saliency", "case": case, "shape": list(x.shape),
              "dtype": str(x.dtype), "err_vs_plain": err, "diff_vs_parent": d,
              "bit_equal": eq, "parent_ms": ta, "ms": tb})
        top, left = kernels.window_argmax(got, h, w, wh, ww)
        rt, rl = reference.window_argmax(got, h, w, wh, ww)
        if not (torch.equal(top, rt) and torch.equal(left, rl)):
            raise AssertionError(f"window_argmax [{case}]: {top.tolist()} {left.tolist()} "
                                 f"against the plain {rt.tolist()} {rl.tolist()}")
        ot, ol = old.window_argmax(got, h, w, wh, ww)
        ta, tb = turns(lambda: old.window_argmax(got, h, w, wh, ww),
                       lambda: kernels.window_argmax(got, h, w, wh, ww))
        emit({"kernel": "window_argmax", "case": case, "shape": list(got.shape),
              "top": top.tolist(), "left": left.tolist(),
              "bit_equal": bool(torch.equal(top, ot) and torch.equal(left, ol)),
              "parent_ms": ta, "ms": tb})
    for case, x, h, w, dh, dw, ohb, owb in resample_cases(dev, gen):
        got, _, _ = kernels.resample(x, h, w, dh, dw, ohb, owb, "lanczos3")
        err = cs.max_err(got, reference.resample(x, h, w, dh, dw, ohb, owb, "lanczos3")[0])
        if not err <= cs.F32_TOL:
            raise AssertionError(f"resample [{case}]: max |err| {err} > {cs.F32_TOL}")
        d, eq = diff(got, old.resample(x, h, w, dh, dw, ohb, owb, "lanczos3")[0])
        ta, tb = turns(lambda: old.resample(x, h, w, dh, dw, ohb, owb, "lanczos3"),
                       lambda: kernels.resample(x, h, w, dh, dw, ohb, owb, "lanczos3"))
        emit({"kernel": "resample", "case": case, "shape": list(x.shape),
              "err_vs_plain": err, "diff_vs_parent": d, "bit_equal": eq,
              "parent_ms": ta, "ms": tb})
        del got
    bsz, hb, wb, c = cs.SHARDED_X
    x = torch.rand(cs.SHARDED_X, generator=gen, device=dev) * 255.0
    h = torch.tensor([v[0] for v in cs.SHARDED_VALID[:bsz]], dtype=torch.int32, device=dev)
    w = torch.tensor([v[1] for v in cs.SHARDED_VALID[:bsz]], dtype=torch.int32, device=dev)
    for r, sig in cs.SHARDED_CASES:
        s = torch.full((bsz,), sig, device=dev)
        k6 = kernels.blur(x, h, w, s, r)
        for b, sp in cs.SHARDED_MESHES:
            mesh = get_mesh(devices=[dev] * (b * sp), spatial=sp)
            case = f"{b}x{sp}-r{r}"
            got = spatial.sharded_blur(x, h, w, s, r, mesh)
            if not torch.equal(got, k6):
                raise AssertionError(f"blur_halo [{case}]: not bit-equal to K6")
            d, eq = diff(got, old_spatial.sharded_blur(x, h, w, s, r, mesh))
            cur = [torch.cuda.current_stream(e) for e in mesh.flat]
            grid = spatial.shard_inputs(x, h, w, s, mesh, cur)
            spatial.exchange_halos(grid, r)
            shards = [sh for row in grid for sh in row]
            ograd = old_spatial.shard_inputs(x, h, w, s, mesh, cur)
            ta, tb = turns(parent_k13(old, old_spatial, ograd, r, wb),
                           lambda: [kernels.blur_halo(sh.x, sh.left, sh.right, sh.h, sh.w,
                                                      sh.sigma, r, sh.col0, wb)
                                    for sh in shards])
            k6_ms = cs.device_ms(lambda: kernels.blur(x, h, w, s, r))
            wa, wb_ = turns(lambda: old_spatial.sharded_blur(x, h, w, s, r, mesh),
                            lambda: spatial.sharded_blur(x, h, w, s, r, mesh))
            emit({"kernel": "blur_halo", "case": case, "shape": list(x.shape), "r": r,
                  "shards": len(shards), "bit_equal_k6": True, "diff_vs_parent": d,
                  "bit_equal": eq, "parent_ms": ta, "ms": tb, "k6_ms": k6_ms,
                  "parent_sharded_blur_ms": wa, "sharded_blur_ms": wb_})
            del grid, ograd, shards, got
        del k6
    pack_gray_rows(old, dev, gen, emit)
    orient_rows(old, dev, gen, emit)
    # the device time of one small PyTorch launch: the fill the earlier
    # window_argmax put before its kernel
    emit({"kernel": "floor", "case": "torch.zeros((16,), int64)",
          "ms": cs.device_ms(lambda: torch.zeros((16,), dtype=torch.int64, device=dev))})
    return finish(smi, rows)


def finish(smi: str, rows: list) -> int:
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "kernel_ab.json"), "w") as f:
        json.dump({"smi": smi, "rows": rows}, f, indent=1)
    cs.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
