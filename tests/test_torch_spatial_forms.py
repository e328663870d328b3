"""The W-shard forms of K4's extract and embed, K5's flop and transpose and
the smartcrop (K9 -> K10 -> K4) at the seams of their designs, on the CPU.

Each case runs a hand-made plan through `ops/chain.launch_spatial` over n
= 2 and 4 cpu entries, at an even and an odd valid width, and holds the
output bit-equal to the unsharded chain on the plain versions:

  * an extract whose window spans two and three input shards and reaches
    into the bucket padding;
  * an embed in mirror mode (the map folds back) and in the fill modes,
    with shards that lie wholly in the fill;
  * a flop whose shard straddles the valid width (its window two ranges:
    the mirrored part [0, w - c0) and its own padding [w, c1));
  * a transpose as the first stage (row bands from the host) and as a
    later one (the all-to-all of n^2 parts);
  * the smartcrop on a flat image (near ties), on a saliency map held
    flat (exact ties: the first window wins) and with its best window
    across a seam, on buckets whose row-scan segment
    (3 columns at 640) does not divide the shard;
  * K9's shard launches themselves: every shard's segment totals side by
    side equal the whole row scan's, and the scanned shards' columns the
    whole integral image's;
  * the rgb transport's forms of /rotate at 90, 180 and 270, EXIF
    orientations 2-8 before a /resize, and the embeds, as the planner
    builds them for a decoded 151x423 image.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from imaginary_tpu_torch.kernels import reference
from imaginary_tpu_torch.ops import chain
from imaginary_tpu_torch.ops import saliency as psal
from imaginary_tpu_torch.ops.plan import ImagePlan, StageInstance, plan_operation
from imaginary_tpu_torch.ops.stages import (
    EmbedSpec,
    ExtractSpec,
    FlipSpec,
    FlopSpec,
    SampleSpec,
    ShardLaunch,
    SmartExtractSpec,
    TransposeSpec,
)
from imaginary_tpu_torch.options import Extend, ImageOptions

CPU = torch.device("cpu")
NS = [2, 4]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i32(v):
    return np.int32(v)


def _img(h, w, seed, c=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def _plan(stages, out_h, out_w) -> ImagePlan:
    return ImagePlan(stages=[StageInstance(s, d) for s, d in stages], out_h=out_h,
                     out_w=out_w)


def _run(arr, plan, n):
    """(sharded output, its SpatialLaunch, trace) and the unsharded output."""
    trace = []
    y = chain.launch_spatial(arr, plan, [CPU] * n, trace=trace)
    got = chain.fetch_batch(y, [arr], [plan])[0]
    return got, y, trace, chain.run_batch([arr], [plan], device="cpu")[0]


def _sources(parts) -> set:
    return {s for s, _, _ in parts}


# -- K4: extract -----------------------------------------------------------------

# (name, input h, w in a 64-wide bucket, extract (top, left, new_h, new_w)
# into out_wb, the most input shards one output shard's window takes at n =
# 4): a 128-wide output of a 64-wide input reads three 16-column shards;
# a crop inside the image reads two; one that runs past the valid width
# clamps into the padding
EXTRACTS = [
    ("three-shards", 30, 63, (3, 8, 20, 120), 128, 3),
    ("two-shards", 30, 62, (5, 21, 20, 40), 64, 2),
    ("into-padding", 30, 57, (0, 36, 30, 24), 32, 2),
]


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("odd", [False, True], ids=["even-w", "odd-w"])
@pytest.mark.parametrize("name,h,w,ext,out_wb,most", EXTRACTS, ids=[e[0] for e in EXTRACTS])
def test_extract_window_across_shards(name, h, w, ext, out_wb, most, odd, n):
    w = w - (w % 2) + odd
    top, left, nh, nw = ext
    dyn = {"top": _i32(top), "left": _i32(left), "new_h": _i32(nh), "new_w": _i32(nw)}
    plan = _plan([(FlipSpec(), {}), (ExtractSpec(32, out_wb), dyn)], nh, nw)
    got, y, _, want = _run(_img(h, w, seed=n + odd), plan, n)
    assert y.gathered is None and np.array_equal(got, want)
    lw_in = 64 // n
    for j, (k0, k1, parts) in enumerate(y.windows[1]):
        c0 = j * (out_wb // n)
        assert k0 == min(max(left + c0, 0), 63)
        assert _sources(parts) == set(range(k0 // lw_in, (k1 - 1) // lw_in + 1))
    if n == 4:
        assert max(len(_sources(p)) for _, _, p in y.windows[1]) == most


def test_extract_as_the_first_stage_reads_its_window_from_the_host():
    dyn = {"top": _i32(2), "left": _i32(13), "new_h": _i32(20), "new_w": _i32(40)}
    plan = _plan([(ExtractSpec(32, 64), dyn)], 20, 40)
    for n in NS:
        got, y, trace, want = _run(_img(30, 61, seed=3), plan, n)
        assert y.gathered is None and y.windows == {} and np.array_equal(got, want)
        assert [a[8] for _, _, _, a, _ in trace] == [13 + j * 64 // n for j in range(n)]


# -- K4: embed -------------------------------------------------------------------

EMBED_MODES = [Extend.MIRROR, Extend.COPY, Extend.BLACK, Extend.WHITE, Extend.BACKGROUND]


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("odd", [False, True], ids=["even-w", "odd-w"])
@pytest.mark.parametrize("mode", EMBED_MODES, ids=[m.name.lower() for m in EMBED_MODES])
def test_embed_modes_with_shards_wholly_in_the_fill(mode, odd, n):
    """A 20x30 image at column 70 of a 24x120 canvas (bucket 32x128):
    the shards left of it lie wholly in the fill (or its mirror and edge
    copies) and still read their clamped columns, the others straddle
    the image's edges."""
    h, w = 20, 30 + odd
    fill = np.array([10.0, 200.0, 30.0], np.float32)
    off_x = 70
    dyn = {"off_y": _i32(2), "off_x": _i32(off_x), "canvas_h": _i32(24),
           "canvas_w": _i32(120), "fill": fill}
    plan = _plan([(FlipSpec(), {}), (EmbedSpec(32, 128, mode), dyn)], 24, 120)
    got, y, _, want = _run(_img(h, w, seed=7 + n), plan, n)
    assert y.gathered is None and np.array_equal(got, want)
    lw = 128 // n
    outside = [j for j in range(n) if (j + 1) * lw <= off_x or j * lw >= off_x + w]
    assert outside  # a shard wholly in the fill
    if mode in (Extend.BLACK, Extend.WHITE, Extend.BACKGROUND):
        for j in outside:
            assert (got[:, j * lw:min((j + 1) * lw, 120)] == fill.astype(np.uint8)).all()
    # every window lies in the image's columns, a fill shard's included
    assert all(0 <= k0 < k1 <= w for k0, k1, _ in y.windows[1])


# -- K5: flop --------------------------------------------------------------------

@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("w", [101, 100, 64], ids=["odd-w", "even-w", "w-on-a-seam"])
def test_flop_shard_straddling_the_valid_width(w, n):
    """K1 to w columns of a 128-wide bucket, then the flop: the shard
    holding column w mirrors [c0, w) from [0, w - c0) and copies its
    padding [w, c1): a window of those two ranges, lw columns, not the
    union [0, c1)."""
    sample = (SampleSpec(32, 128, "linear"), {"dst_h": np.float32(30),
                                               "dst_w": np.float32(w)})
    plan = _plan([sample, (FlopSpec(), {})], 30, w)
    got, y, trace, want = _run(_img(30, 120, seed=n), plan, n)
    assert y.gathered is None and np.array_equal(got, want)
    lw = 128 // n
    for j, (k0, k1, parts) in enumerate(y.windows[1]):
        c0, c1 = j * lw, (j + 1) * lw
        if c0 < w < c1:
            assert (k0, k1) == (0, c1)
            if c0:
                assert sum(b - a for _, a, b in parts) == lw
                assert all(b <= w - c0 or a >= w for _, a, b in parts)
        elif c1 <= w:
            assert (k0, k1) == (w - c1, w - c0)
        else:
            assert (k0, k1) == (c0, c1)
    flops = [(a, o) for _, _, sp, a, o in trace if isinstance(sp, FlopSpec)]
    for args, out in flops:
        assert torch.equal(out, FlopSpec().apply_shard(*args, impl=reference)[0])


# -- K5: transpose ---------------------------------------------------------------

@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("odd", [False, True], ids=["even-w", "odd-w"])
@pytest.mark.parametrize("later", [False, True], ids=["first", "after-a-flip"])
def test_transpose_all_to_all(later, odd, n):
    """Output shard j is input rows [j lw, (j + 1) lw) of every shard: n^2
    parts, each shard's band [lw, Wb] assembled from all n, then K5's
    transpose; the valid dims swap (37 x w in a 48 x 128 bucket)."""
    h, w = 37, 100 + odd
    stages = ([(FlipSpec(), {})] if later else []) + [(TransposeSpec(), {}),
                                                      (FlopSpec(), {})]
    plan = _plan(stages, w, h)
    got, y, trace, want = _run(_img(h, w, seed=n + 2 * odd), plan, n)
    assert y.gathered is None and np.array_equal(got, want) and got.shape[:2] == (w, h)
    t = int(later)
    if later:
        lw = 48 // n
        bands = y.windows[t]
        assert [(r0, r1) for r0, r1, _ in bands] == [(j * lw, (j + 1) * lw) for j in range(n)]
        for _, _, parts in bands:
            assert [s for s, _, _ in parts] == list(range(n))
            assert [(a, b) for _, a, b in parts] == [(s * 128 // n, (s + 1) * 128 // n)
                                                     for s in range(n)]
    else:
        assert t not in y.windows
    for i, _, sp, args, out in trace:
        if i == t:
            assert tuple(out.shape) == (1, 128, 48 // n, 3)
            assert torch.equal(out, sp.apply_shard(*args, impl=reference)[0])


# -- the smartcrop: K9 -> K10 -> K4 ------------------------------------------------

def _smart_plan(new_h, new_w, out_hb, out_wb, h, w):
    dyn = {"new_h": _i32(new_h), "new_w": _i32(new_w)}
    return _plan([(FlipSpec(), {}), (SmartExtractSpec(out_hb, out_wb), dyn)], new_h, new_w)


def _smart_choice(trace, n, wb):
    """(top, left) the shards' keys decode to."""
    keys = [o for _, _, sp, _, o in trace
            if isinstance(sp, ShardLaunch) and sp.fn == "window_argmax_shard"]
    assert len(keys) == n
    return tuple(int(v[0]) for v in reference.decode_keys(torch.stack(keys, 1), wb))


def _whole_choice(arr, new_h, new_w):
    """The whole image's K10 choice after the plan's flip (plain versions)."""
    h, w = arr.shape[:2]
    hh = torch.tensor([h], dtype=torch.int32)
    ww = torch.tensor([w], dtype=torch.int32)
    xf = reference.orient(torch.from_numpy(chain.pad_to_bucket(arr))[None], hh, ww, "flip")
    ii = reference.saliency_ii(xf, hh, ww)
    t, l = reference.window_argmax(ii, hh, ww, torch.tensor([new_h], dtype=torch.int32),
                                   torch.tensor([new_w], dtype=torch.int32))
    return int(t[0]), int(l[0])


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("w", [600, 601], ids=["even-w", "odd-w"])
def test_smartcrop_flat_image_ties_go_to_the_first_window(w, n):
    """A flat image: every window scores alike up to the sums' rounding
    (near ties, not exact ones); the shards' keys pick what the whole
    image's argmax picks."""
    arr = np.full((20, w, 3), 90, dtype=np.uint8)
    arr[..., 1] = 140
    plan = _smart_plan(16, 200, 16, 208, 20, w)
    got, y, trace, want = _run(arr, plan, n)
    assert y.gathered is None and np.array_equal(got, want)
    assert _smart_choice(trace, n, 640) == _whole_choice(arr, 16, 200)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("w", [600, 601], ids=["even-w", "odd-w"])
@pytest.mark.parametrize("level", [0.0, 1.0], ids=["zero", "one"])
def test_smartcrop_exact_ties_go_to_the_first_window(level, w, n, monkeypatch):
    """Every window ties exactly: no image has a saliency of whole numbers
    (its skin term never reaches 0), so the map itself is held at `level`
    inside the valid region, and every window's sum is exact. Each
    shard's best key is its own first candidate; the keys' maximum is the
    global first window, (0, 0), as the whole image's argmax answers."""
    real = psal.saliency_map

    def flat(x, h, w):
        return torch.where(real(x, h, w) > 0, level, 0.0)

    monkeypatch.setattr(psal, "saliency_map", flat)
    plan = _smart_plan(16, 200, 16, 208, 20, w)
    arr = _img(20, w, seed=w + n)
    got, y, trace, want = _run(arr, plan, n)
    assert y.gathered is None and np.array_equal(got, want)
    assert _smart_choice(trace, n, 640) == _whole_choice(arr, 16, 200) == (0, 0)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("w", [600, 601], ids=["even-w", "odd-w"])
def test_smartcrop_best_window_across_a_seam(w, n):
    """A saturated block centred on the seam at column 320 of a 640-wide
    bucket (the segment of 3 columns splits neither 320 nor 160): the
    best 24-column window straddles it, and the shards find it."""
    arr = np.full((20, w, 3), 120, dtype=np.uint8)
    arr[4:16, 312:328] = (250, 10, 10)
    plan = _smart_plan(12, 24, 16, 32, 20, w)
    got, y, trace, want = _run(arr, plan, n)
    assert y.gathered is None and np.array_equal(got, want)
    top, left = _smart_choice(trace, n, 640)
    assert (top, left) == _whole_choice(arr, 12, 24)
    assert left < 320 < left + 24
    # the gather's window covers every offset K10 may choose
    stage = 1
    for j, (k0, k1, _) in enumerate(y.windows[stage]):
        assert k0 <= j * 32 // n and k1 >= min((j + 1) * 32 // n + w - 24, 640)


@pytest.mark.parametrize("n", NS)
def test_smartcrop_as_the_first_stage(n):
    arr = _img(24, 601, seed=n)
    plan = _plan([(SmartExtractSpec(16, 64), {"new_h": _i32(16), "new_w": _i32(50)})],
                 16, 50)
    got, y, _, want = _run(arr, plan, n)
    assert y.gathered is None and np.array_equal(got, want)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("wb,w", [(640, 600), (640, 601), (512, 512), (768, 700)],
                         ids=["640-even", "640-odd", "512", "768"])
def test_k9_segment_totals_and_scan_per_shard(wb, w, n):
    """K9's shard launches on their own: every shard's segment totals side
    by side are the whole row scan's, and each shard's scanned columns the
    whole integral image's, at segments of 3 (640, 768) and 2 (512)
    columns, split by the shards or not."""
    rng = np.random.default_rng(wb + w + n)
    h, hb = 19, 24
    x = torch.from_numpy(rng.uniform(0, 255, (1, hb, wb, 3)).astype(np.float32))
    ht, wt = torch.tensor([h], dtype=torch.int32), torch.tensor([w], dtype=torch.int32)
    sal = psal.saliency_map(x, ht, wt)
    per = -(-wb // psal.LANES)
    whole_tot = psal.segment_totals(torch.nn.functional.pad(sal, (0, -wb % per)), per)
    ii = reference.saliency_ii(x, ht, wt)
    lw = wb // n
    rows, tots = [], []
    for j in range(n):
        c0 = j * lw
        left = x[:, :, c0 - per:c0] if c0 else None
        right = x[:, :, c0 + lw:c0 + lw + per] if c0 + lw < wb else None
        s, t = reference.saliency_rows_shard(x[:, :, c0:c0 + lw], left, right, ht, wt, c0, wb)
        assert s.shape == (1, hb, lw + 2 * (per - 1))
        assert t.shape[2] == -(-(c0 + lw) // per) - -(-c0 // per)
        rows.append(s)
        tots.append(t)
    totals = torch.cat(tots, dim=2)
    assert torch.equal(totals, whole_tot)
    for j in range(n):
        got = reference.saliency_scan_shard(rows[j], totals, j * lw, lw, wb)
        assert torch.equal(got, ii[:, :, 1 + j * lw:1 + (j + 1) * lw])


# -- the rgb transport's chains ------------------------------------------------

# (name, operation, options, EXIF orientation)
RGB_CHAINS = ([(f"rotate{a}", "rotate", {"rotate": a}, 1) for a in (90, 180, 270)]
              + [(f"exif{o}", "resize", {"width": 120}, o) for o in range(2, 9)]
              + [("embed-mirror", "resize", {"width": 400, "height": 300}, 1),
                 ("embed-fill", "resize", {"width": 400, "height": 300,
                                           "extend": Extend.WHITE}, 1)])


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name,op,kw,orientation", RGB_CHAINS, ids=[c[0] for c in RGB_CHAINS])
def test_rgb_chain_is_bit_equal_to_the_unsharded_chain(name, op, kw, orientation, n):
    arr = _img(151, 423, seed=orientation + n)
    plan = plan_operation(op, ImageOptions(**kw), 151, 423, orientation, 3)
    got, y, _, want = _run(arr, plan, n)
    assert y.gathered is None and y.shards == n
    assert np.array_equal(got, want)

