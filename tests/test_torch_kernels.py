"""Port kernels' plain versions held against the JAX reference on the CPU.

The same seeded numpy inputs go through each JAX stage `apply` (what XLA
runs for the TPU) and through the port's kernel wrapper on a CPU tensor,
which runs the kernel's plain PyTorch version (the CUDA kernels themselves
run only on the card: chip_smoke.py holds them against these same plain
versions there). K3's `luma` form (K8 folded into K3) is held against the
JAX GraySpec followed by ToYuv420Spec. Tolerances: f32 outputs 1e-3 absolute on the 0-255
scale (summation order differs); uint8 outputs at most 1 LSB (the
truncating epilogue can flip at an exact .5 after such a difference);
the orientation kernel (K5) moves data only, so it must be exact. The
blur (K6), composite (K7) and gray (K8) cases use images whose valid dims
differ inside one batch and are no multiple of the block or bucket.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginary_tpu.ops import stages as jst
from imaginary_tpu.options import Extend as JExtend
from imaginary_tpu_torch import kernels
from imaginary_tpu_torch.kernels import reference
from imaginary_tpu_torch.ops import stages as pst
from imaginary_tpu_torch.options import Extend as PExtend

F32_TOL = 1e-3
U8_TOL = 1

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(rng, b, hb, wb, c=3):
    return rng.uniform(0.0, 255.0, size=(b, hb, wb, c)).astype(np.float32)


def _i32(*v):
    return np.array(v, dtype=np.int32)


def _f32(*v):
    return np.array(v, dtype=np.float32)


@functools.partial(jax.jit, static_argnums=0)
def _japply(spec, x, h, w, dyn):
    """The reference stage as the reference runs it: jitted (chain.py)."""
    return spec.apply(x, h, w, dyn)


def _jax_epilogue(x):
    return np.asarray(jnp.clip(x + 0.5, 0.0, 255.0).astype(jnp.uint8))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (kind, in bucket, valid h/w per image, dst per image, out bucket)
RESAMPLE_CASES = [
    ("lanczos3", (48, 64), ((40, 61), (48, 64)), ((17, 30), (20, 25)), (24, 32)),
    ("lanczos3", (32, 48), ((31, 45), (27, 33)), ((50, 70), (60, 90)), (64, 96)),
    ("lanczos2", (48, 64), ((40, 61), (33, 47)), ((19, 29), (40, 40)), (48, 48)),
    ("cubic", (32, 48), ((31, 45), (32, 48)), ((13, 20), (55, 77)), (64, 96)),
    ("linear", (32, 48), ((29, 41), (32, 48)), ((15, 21), (47, 70)), (48, 96)),
    # nearest at exactly 2x and 1/2x: the half-open box is tie sensitive
    ("nearest", (32, 48), ((32, 48), (20, 30)), ((64, 96), (40, 60)), (64, 96)),
    ("nearest", (32, 48), ((32, 48), (20, 30)), ((16, 24), (10, 15)), (16, 24)),
    # the main path's scale factor (270x480 -> 169x300), cut to a band
    ("lanczos3", (64, 512), ((64, 480), (57, 479)), ((40, 300), (36, 299)), (48, 320)),
]


@pytest.mark.parametrize("kind,inb,hw,dst,outb", RESAMPLE_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(RESAMPLE_CASES)])
def test_resample_matches_sample_spec(kind, inb, hw, dst, outb):
    rng = np.random.default_rng(7)
    x = _img(rng, 2, *inb)
    h, w = _i32(*(a for a, _ in hw)), _i32(*(b for _, b in hw))
    dh, dw = _f32(*(a for a, _ in dst)), _f32(*(b for _, b in dst))
    want, wh, ww = _japply(jst.SampleSpec(*outb, kind), x, h, w,
                           {"dst_h": dh, "dst_w": dw})
    got, gh, gw = kernels.resample(_t(x), _t(h), _t(w), _t(dh), _t(dw), *outb, kind)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, *outb, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)
    assert np.array_equal(gh.numpy(), np.asarray(wh))
    assert np.array_equal(gw.numpy(), np.asarray(ww))


def test_resample_uint8_in_and_out_match_cast_and_epilogue():
    """The RGB transport fuses the chain's cast into the first stage and
    the uint8 epilogue into the last: uint8 -> resample -> uint8."""
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, size=(2, 48, 64, 3), dtype=np.uint8)
    h, w, dh, dw = _i32(45, 48), _i32(64, 57), _f32(20, 31), _f32(30, 40)
    want, _, _ = _japply(jst.SampleSpec(32, 48), x.astype(np.float32), h, w,
                         {"dst_h": dh, "dst_w": dw})
    got, _, _ = kernels.resample(_t(x), _t(h), _t(w), _t(dh), _t(dw), 32, 48,
                                 "lanczos3", out_u8=True)
    assert got.dtype == torch.uint8
    diff = np.abs(got.numpy().astype(int) - _jax_epilogue(want).astype(int))
    assert diff.max() <= U8_TOL


def test_sample_matrix_is_the_reference_matrix():
    src, dst = _f32(37, 64), _f32(20, 90)
    want = np.asarray(jst.sample_matrix(96, 64, jnp.asarray(src), jnp.asarray(dst), "lanczos3"))
    got = reference.sample_matrix(96, 64, _t(src), _t(dst), "lanczos3").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hb,wb,hw", [
    (32, 48, ((32, 48), (27, 41))),  # full bucket, and odd valid dims
    (320, 512, ((270, 480), (269, 479))),  # the main path's bucket
    # K2's row design: a 1x1 image (every chroma index clamps to 0), a
    # bucket with wb % 4 == 2 (unaligned rows, a ragged end) holding a full
    # image (chroma clamped at the bucket edge) and an odd one
    (16, 16, ((1, 1), (16, 16))),
    (18, 54, ((18, 54), (17, 53))),
    (34, 1922, ((33, 1921), (34, 1922))),
    (2, 2, ((1, 1), (2, 2))),  # the smallest bucket: one chroma sample
    (66, 98, ((65, 97), (2, 3))),  # wb % 4 == 2 again, a 2x3 image
])
def test_yuv420_unpack_matches_from_yuv420_spec(hb, wb, hw):
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, size=(2, hb + hb // 2, wb, 1), dtype=np.uint8)
    h, w = _i32(*(a for a, _ in hw)), _i32(*(b for _, b in hw))
    want, _, _ = _japply(jst.FromYuv420Spec(hb, wb), x.astype(np.float32), h, w, {})
    got = kernels.yuv420_to_rgb(_t(x), _t(h), _t(w), hb, wb)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, hb, wb, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("hb,wb,hw", [
    (32, 48, ((32, 48), (27, 41))),
    (208, 304, ((200, 300), (199, 301))),  # the main path's output bucket
    (16, 16, ((0, 0), (1, 1))),  # empty and single-pixel images: 128 chroma
])
def test_yuv420_pack_matches_to_yuv420_spec_and_epilogue(hb, wb, hw):
    rng = np.random.default_rng(10)
    x = rng.uniform(-20.0, 275.0, size=(2, hb, wb, 3)).astype(np.float32)
    h, w = _i32(*(a for a, _ in hw)), _i32(*(b for _, b in hw))
    want, _, _ = _japply(jst.ToYuv420Spec(hb, wb), x, h, w, {})
    got = kernels.rgb_to_yuv420(_t(x), _t(h), _t(w), hb, wb)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, hb + hb // 2, wb, 1)
    diff = np.abs(got.numpy().astype(int) - _jax_epilogue(want).astype(int))
    assert diff.max() <= U8_TOL
    assert (diff == 0).mean() > 0.999


# K3's luma form (K8 folded into K3 on a colorspace=bw chain to JPEG):
# odd valid dims, a valid edge on a chunk edge (128 columns), the main
# path's and the bw /resize's buckets, a bucket with wb % 4 == 2, and
# empty and single-pixel images
PACK_LUMA_CASES = [
    (32, 48, ((32, 48), (27, 41))),
    (208, 304, ((200, 300), (199, 301))),
    (18, 258, ((17, 257), (18, 128))),
    (368, 640, ((360, 640), (359, 639))),
    (16, 16, ((0, 0), (1, 1))),
]


@pytest.mark.parametrize("hb,wb,hw", PACK_LUMA_CASES,
                         ids=[f"{c[0]}x{c[1]}" for c in PACK_LUMA_CASES])
def test_yuv420_pack_luma_matches_gray_then_to_yuv420_spec(hb, wb, hw):
    """The plain `luma` form is `gray` then K3 exactly, and within 1 LSB of
    the JAX GraySpec, then ToYuv420Spec and the uint8 epilogue."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-20.0, 275.0, size=(2, hb, wb, 3)).astype(np.float32)
    h, w = _i32(*(a for a, _ in hw)), _i32(*(b for _, b in hw))
    g, _, _ = _japply(jst.GraySpec(), x, h, w, {})
    want, _, _ = _japply(jst.ToYuv420Spec(hb, wb), g, h, w, {})
    got = kernels.rgb_to_yuv420(_t(x), _t(h), _t(w), hb, wb, luma=True)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, hb + hb // 2, wb, 1)
    diff = np.abs(got.numpy().astype(int) - _jax_epilogue(want).astype(int))
    assert diff.max() <= U8_TOL
    pair = reference.rgb_to_yuv420(reference.gray(_t(x)), _t(h), _t(w), hb, wb)
    assert torch.equal(got, pair)
    # a gray image packs to chroma 128 wherever a block has a valid pixel
    bottom = got.numpy()[:, hb:, :, 0]
    for b, (vh, vw) in enumerate(hw):
        ch, cw = -(-vh // 2), -(-vw // 2)
        if not ch * cw:
            continue
        assert np.abs(bottom[b, :ch, :cw].astype(int) - 128).max() <= 1
        assert np.abs(bottom[b, :ch, wb // 2:wb // 2 + cw].astype(int) - 128).max() <= 1


EMBED_MODES = [
    (JExtend.COPY, PExtend.COPY), (JExtend.LAST, PExtend.LAST),
    (JExtend.MIRROR, PExtend.MIRROR), (JExtend.BLACK, PExtend.BLACK),
    (JExtend.WHITE, PExtend.WHITE), (JExtend.BACKGROUND, PExtend.BACKGROUND),
]


@pytest.mark.parametrize("jmode,pmode", EMBED_MODES, ids=[m[1].value for m in EMBED_MODES])
def test_embed_matches_embed_spec(jmode, pmode):
    """Canvas larger than the image on both axes, offsets that put the
    image off-centre and (mirror) several periods away from it."""
    rng = np.random.default_rng(11)
    x = _img(rng, 2, 24, 32)
    h, w = _i32(17, 24), _i32(23, 31)
    dyn = {"off_y": _i32(15, 2), "off_x": _i32(0, 40), "canvas_h": _i32(40, 30),
           "canvas_w": _i32(36, 80), "fill": np.array([[10, 20, 30], [255, 255, 255]], np.float32)}
    want, wh, ww = _japply(jst.EmbedSpec(48, 96, jmode), x, h, w, dyn)
    got, gh, gw = pst.EmbedSpec(48, 96, pmode).apply(
        _t(x), _t(h), _t(w), {k: _t(v) for k, v in dyn.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)
    assert np.array_equal(gh.numpy(), np.asarray(wh)) and np.array_equal(gw.numpy(), np.asarray(ww))


@pytest.mark.parametrize("top,left", [(0, 0), (5, 7), (20, 30)],
                         ids=["origin", "inside", "crop-at-edge"])
def test_extract_matches_extract_spec(top, left):
    """crop-at-edge: top + out bucket runs past the input bucket, so each
    index clamps on its own (not a shifted window)."""
    rng = np.random.default_rng(12)
    x = _img(rng, 2, 32, 48)
    h, w = _i32(32, 30), _i32(48, 45)
    dyn = {"top": _i32(top, top // 2), "left": _i32(left, left // 3),
           "new_h": _i32(12, 10), "new_w": _i32(18, 15)}
    want, wh, ww = _japply(jst.ExtractSpec(16, 24), x, h, w, dyn)
    got, gh, gw = pst.ExtractSpec(16, 24).apply(
        _t(x), _t(h), _t(w), {k: _t(v) for k, v in dyn.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)
    assert np.array_equal(gh.numpy(), np.asarray(wh)) and np.array_equal(gw.numpy(), np.asarray(ww))


def test_shrink_bucket_matches_and_fuses_the_epilogue():
    rng = np.random.default_rng(13)
    x = _img(rng, 2, 32, 48)
    h, w = _i32(20, 31), _i32(17, 40)
    want, _, _ = _japply(jst.ShrinkBucketSpec(24, 40), x, h, w, {})
    got, gh, gw = pst.ShrinkBucketSpec(24, 40).apply(_t(x), _t(h), _t(w), {})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)
    assert gh is not None and np.array_equal(gh.numpy(), h)
    got_u8, _, _ = pst.ShrinkBucketSpec(24, 40).apply(_t(x), _t(h), _t(w), {}, out_u8=True)
    assert np.array_equal(got_u8.numpy(), _jax_epilogue(want))


ORIENT_SPECS = [(jst.FlipSpec(), pst.FlipSpec()), (jst.FlopSpec(), pst.FlopSpec()),
                (jst.TransposeSpec(), pst.TransposeSpec())]
ORIENT_IDS = [type(p).__name__ for _, p in ORIENT_SPECS]


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("jspec,pspec", ORIENT_SPECS, ids=ORIENT_IDS)
def test_orient_matches_orientation_specs_exactly(jspec, pspec, c):
    """K5's plain version is pure data movement: equal to the JAX spec to
    the bit. Three images of different valid dims in one bucket (one full,
    two with padding rows and columns that the mirror must leave as they
    are), a bucket that is not a multiple of the kernel's 32-pixel tile."""
    rng = np.random.default_rng(14 + c)
    x = _img(rng, 3, 40, 56, c)
    h, w = _i32(40, 33, 1), _i32(56, 41, 17)
    want, wh, ww = _japply(jspec, x, h, w, {})
    got, gh, gw = pspec.apply(_t(x), _t(h), _t(w), {})
    assert got.dtype == torch.float32 and tuple(got.shape) == np.asarray(want).shape
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(gh.numpy(), np.asarray(wh)) and np.array_equal(gw.numpy(), np.asarray(ww))


@pytest.mark.parametrize("jspec,pspec", ORIENT_SPECS, ids=ORIENT_IDS)
def test_orient_uint8_in_and_out_match_cast_and_epilogue(jspec, pspec):
    """The RGB transport starts /flip's chain with uint8 (the cast fused
    into K5) and may end a chain with it (the epilogue fused)."""
    rng = np.random.default_rng(15)
    x = rng.integers(0, 256, size=(3, 24, 40, 3), dtype=np.uint8)
    h, w = _i32(24, 19, 7), _i32(40, 31, 2)
    want, _, _ = _japply(jspec, x.astype(np.float32), h, w, {})
    got, _, _ = pspec.apply(_t(x), _t(h), _t(w), {})
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))
    got_u8, _, _ = pspec.apply(_t(x), _t(h), _t(w), {}, out_u8=True)
    assert got_u8.dtype == torch.uint8
    assert np.array_equal(got_u8.numpy(), _jax_epilogue(want))


def test_orient_rejects_an_unknown_mode():
    x = torch.zeros((1, 8, 8, 3))
    i = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="orient mode"):
        kernels.orient(x, i, i, "rotate")


# K6: (radius, sigma, C, geometry). "base": sigma 0 (the delta), small,
# near the radius and far beyond it (the taps flatten into a box) at C = 1
# to 4; then the seams of the kernel's strips of
# `blur_strip(c, r)` columns and groups of BLUR_ROW_GROUP rows, images
# smaller than r = 64, and sigma 0 beside sigma > 0 in one batch
BLUR_CASES = ([(r, s, c, "base") for r in (2, 4, 64) for s in (0.0, 0.7, 3.0, 40.0)
               for c in (3, 4, 1, 2)]
              + [(4, 1.2, c, "strip") for c in (1, 2, 3, 4)]
              + [(64, 20.0, 3, "under-r"), (4, 1.5, 3, "sigma0-beside")])
BLUR_IDS = [f"r{r}-s{s:g}-{c}" + ("" if g == "base" else f"-{g}") for r, s, c, g in BLUR_CASES]


def _blur_inputs(rng, c, sigma, geometry="base"):
    """Images of different valid dims in one bucket, per-image sigma.
    "base": a 40x56 bucket, none a multiple of 8, one image a single valid
    column; "strip": valid widths one column inside and past a strip and
    valid heights one row inside and past a row group; "under-r": images
    narrower and shorter than r = 64; "sigma0-beside": the delta beside a
    Gaussian."""
    if geometry == "strip":
        strip, rows = kernels.blur_strip(c, 4), kernels.BLUR_ROW_GROUP
        x = _img(rng, 4, 10 * rows, 2 * strip + 6, c)
        h = _i32(2 * rows - 1, 2 * rows + 1, 10 * rows, 1)
        w = _i32(strip - 1, strip + 1, 2 * strip + 6, 2 * strip + 5)
        return x, h, w, _f32(sigma, sigma * 0.5, sigma * 1.5, sigma * 2.0)
    x = _img(rng, 3, 40, 56, c)
    if geometry == "under-r":
        return x, _i32(5, 40, 1), _i32(3, 56, 2), _f32(sigma, sigma * 0.15, 0.5)
    h, w = _i32(40, 33, 17), _i32(56, 41, 1)
    if geometry == "sigma0-beside":
        return x, h, w, _f32(0.0, sigma, 0.0)
    return x, h, w, _f32(sigma, sigma * 0.5, sigma * 1.5)


@pytest.mark.parametrize("radius,sigma,c,geometry", BLUR_CASES, ids=BLUR_IDS)
def test_blur_matches_reference(radius, sigma, c, geometry):
    rng = np.random.default_rng(radius * 100 + int(sigma * 10) + c)
    x, h, w, sig = _blur_inputs(rng, c, sigma, geometry)
    want, wh, ww = _japply(jst.BlurSpec(radius), x, h, w, {"sigma": sig})
    got, gh, gw = pst.BlurSpec(radius).apply(_t(x), _t(h), _t(w), {"sigma": _t(sig)})
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() <= F32_TOL
    assert np.array_equal(gh.numpy(), np.asarray(wh)) and np.array_equal(gw.numpy(), np.asarray(ww))
    # zero outside each image's valid region, padding included
    for i, (hi, wi) in enumerate(zip(h, w)):
        assert not got.numpy()[i, hi:].any() and not got.numpy()[i, :, wi:].any()


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_blur_uint8_in_and_out_match_cast_and_epilogue(c):
    """/blur on a PNG starts its chain with the blur (uint8 in), and a blur
    may end a chain (the epilogue fused)."""
    rng = np.random.default_rng(30 + c)
    x = rng.integers(0, 256, size=(3, 40, 56, c), dtype=np.uint8)
    h, w = _i32(40, 29, 11), _i32(56, 50, 23)
    sig = _f32(1.2, 0.0, 2.5)
    want, _, _ = _japply(jst.BlurSpec(4), x.astype(np.float32), h, w, {"sigma": sig})
    got, _, _ = pst.BlurSpec(4).apply(_t(x), _t(h), _t(w), {"sigma": _t(sig)})
    assert np.abs(got.numpy() - np.asarray(want)).max() <= F32_TOL
    got_u8, _, _ = pst.BlurSpec(4).apply(_t(x), _t(h), _t(w), {"sigma": _t(sig)}, out_u8=True)
    assert got_u8.dtype == torch.uint8
    diff = np.abs(got_u8.numpy().astype(int) - _jax_epilogue(want).astype(int))
    assert diff.max() <= U8_TOL


def test_blur_strip_leaves_room_for_the_halo_at_every_radius():
    """K6's strip: its shared rows hold two to four elements per thread,
    and even at r = 64 the strip is wider than both halos together."""
    assert kernels.blur_strip(3, 4) == 248
    for c in (1, 2, 3, 4):
        assert kernels.blur_strip(c, kernels.MAX_BLUR_RADIUS) >= 2 * kernels.MAX_BLUR_RADIUS
        assert 512 <= kernels.BLUR_EXT[c] <= 1024 and kernels.BLUR_EXT[c] % c == 0


def test_blur_rejects_a_radius_beyond_64():
    x = torch.zeros((1, 8, 8, 3))
    i = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="radius"):
        kernels.blur(x, i, i, torch.tensor([1.0]), 65)


# K7: (replicate, top/left per image): offsets inside the block, past it
# (the tile wraps upward and leftward: floored remainder), and a placed
# block that overhangs the valid region and the bucket
COMPOSITE_CASES = [
    (True, (0, 5), (0, 7)),
    (True, (29, 3), (61, 50)),
    (False, (2, 30), (4, 40)),
    (False, (21, 0), (47, 53)),
]


def _composite_dyn(rng, bsz, tops, lefts):
    return {
        "overlay": rng.uniform(0.0, 255.0, size=(bsz, 8, 16, 4)).astype(np.float32),
        "top": _i32(*tops), "left": _i32(*lefts),
        "opacity": _f32(0.5, 1.7)[:bsz], "block_h": _i32(7, 8)[:bsz],
        "block_w": _i32(13, 16)[:bsz],
    }


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("replicate,tops,lefts", COMPOSITE_CASES,
                         ids=[f"{'tile' if c[0] else 'place'}-{c[1][0]}-{c[2][0]}"
                              for c in COMPOSITE_CASES])
def test_composite_matches_reference(replicate, tops, lefts, c):
    rng = np.random.default_rng(sum(tops) + sum(lefts) + c)
    x = _img(rng, 2, 24, 56, c)
    h, w = _i32(21, 24), _i32(53, 37)
    dyn = _composite_dyn(rng, 2, tops, lefts)
    spec_j = jst.CompositeSpec(8, 16, replicate)
    spec_p = pst.CompositeSpec(8, 16, replicate)
    want, _, _ = _japply(spec_j, x, h, w, dyn)
    got, _, _ = spec_p.apply(_t(x), _t(h), _t(w), {k: _t(v) for k, v in dyn.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() <= F32_TOL
    if c == 4:
        assert np.array_equal(got.numpy()[..., 3], x[..., 3])


@pytest.mark.parametrize("replicate", [True, False])
def test_composite_uint8_in_and_out_match_cast_and_epilogue(replicate):
    rng = np.random.default_rng(40 + replicate)
    x = rng.integers(0, 256, size=(2, 24, 56, 3), dtype=np.uint8)
    h, w = _i32(24, 19), _i32(56, 31)
    dyn = _composite_dyn(rng, 2, (3, 9), (11, 2))
    want, _, _ = _japply(jst.CompositeSpec(8, 16, replicate), x.astype(np.float32), h, w, dyn)
    pdyn = {k: _t(v) for k, v in dyn.items()}
    spec = pst.CompositeSpec(8, 16, replicate)
    got, _, _ = spec.apply(_t(x), _t(h), _t(w), pdyn)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= F32_TOL
    got_u8, _, _ = spec.apply(_t(x), _t(h), _t(w), pdyn, out_u8=True)
    diff = np.abs(got_u8.numpy().astype(int) - _jax_epilogue(want).astype(int))
    assert got_u8.dtype == torch.uint8 and diff.max() <= U8_TOL


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
def test_gray_matches_reference(c, u8):
    rng = np.random.default_rng(50 + c)
    xf = _img(rng, 2, 24, 40, c)
    x = xf.astype(np.uint8) if u8 else xf
    h, w = _i32(24, 17), _i32(40, 9)
    want, _, _ = _japply(jst.GraySpec(), x.astype(np.float32), h, w, {})
    got, _, _ = pst.GraySpec().apply(_t(x), _t(h), _t(w), {}, out_u8=u8)
    if u8:
        diff = np.abs(got.numpy().astype(int) - _jax_epilogue(want).astype(int))
        assert got.dtype == torch.uint8 and diff.max() <= U8_TOL
    else:
        assert np.abs(got.numpy() - np.asarray(want)).max() <= F32_TOL
    if c == 4:
        assert np.array_equal(got.numpy()[..., 3].astype(np.float32), x[..., 3].astype(np.float32))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    kernels.reset_launches()
    x = torch.zeros((1, 16, 16, 3))
    i = torch.tensor([16], dtype=torch.int32)
    f = torch.tensor([8.0])
    kernels.resample(x, i, i, f, f, 8, 8, "lanczos3")
    kernels.gather(x, 8, 8)
    kernels.rgb_to_yuv420(x, i, i, 16, 16)
    kernels.rgb_to_yuv420(x, i, i, 16, 16, luma=True)
    kernels.yuv420_to_rgb(torch.zeros((1, 24, 16, 1), dtype=torch.uint8), i, i, 16, 16)
    for mode in ("flip", "flop", "transpose"):
        kernels.orient(x, i, i, mode)
    kernels.blur(x, i, i, f, 4)
    kernels.composite(x, torch.zeros((1, 8, 8, 4)), i, i, f, i, i, True)
    kernels.gray(x)
    ii = kernels.saliency_ii(x, i, i)
    kernels.window_argmax(ii, i, i, i, i)
    kernels.from_dct(torch.zeros((1, 24, 16, 1), dtype=torch.int16), i, i, 16, 16, 8, "420")
    kernels.to_dct(x, i, i, torch.ones((1, 8, 8)), torch.ones((1, 8, 8)), 16, 16)
    kernels.blur_halo(x, None, None, i, i, f, 2, 0, 16)
    assert set(kernels.LAUNCHES) == {"resample", "yuv420_unpack", "yuv420_pack",
                                     "gather", "orient", "blur", "composite", "gray",
                                     "saliency", "window_argmax", "from_dct", "to_dct",
                                     "blur_halo"}
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_every_spec_class_and_field_matches_the_reference():
    import dataclasses

    names = [n for n, v in vars(jst).items()
             if isinstance(v, type) and dataclasses.is_dataclass(v) and n.endswith("Spec")]
    assert len(names) == 15
    for n in names:
        jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jst, n))]
        pf = [(f.name, f.default) for f in dataclasses.fields(getattr(pst, n))]
        norm = [(k, getattr(d, "value", d)) for k, d in jf]
        assert [(k, getattr(d, "value", d)) for k, d in pf] == norm, n
