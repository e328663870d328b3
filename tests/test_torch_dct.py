"""The port's DCT transport (entropy codec copy, FromDctSpec K11, ToDctSpec
K12, the int16 chain, the pipeline switches) held against the JAX package
on the CPU.

Tolerances:

- `decode_packed`, `quality_tables`, `unpack_dct_egress` and
  `encode_quantized`: bit for bit (integer and byte outputs of the same
  algorithm), on both entropy arms (the numpy arm in
  `tests/test_torch_dct_arms.py`);
- FromDctSpec (K11's plain version): 1e-3 absolute on the 0-255 scale
  (f32; the IDCT's products are summed in another order);
- ToDctSpec (K12's plain version): int16 coefficients within 1, and at
  most 0.1 % of them differing (a coefficient that lands within rounding
  of a .5 tie can round the other way);
- end to end: with the dct transport on, the chain's packed output planes
  within 1 LSB of the JAX package's; with the egress on too, the drained
  coefficients within 1 (at most 0.1 % differing) and the served JPEG's
  decoded pixels within 1 LSB of the JAX package's wherever a 16x16 MCU's
  coefficients are equal in both.
"""

from __future__ import annotations

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from imaginary_tpu import pipeline as jpipeline
from imaginary_tpu.codecs import jpeg_dct as jdct
from imaginary_tpu.ops import buckets as jbuckets
from imaginary_tpu.ops import chain as jchain
from imaginary_tpu.ops import plan as jplan
from imaginary_tpu.ops import stages as jst
from imaginary_tpu.params import build_params_from_query as jquery
from imaginary_tpu_torch import kernels
from imaginary_tpu_torch import pipeline as ppipeline
from imaginary_tpu_torch.codecs import jpeg_dct as pdct
from imaginary_tpu_torch.ops import buckets as pbuckets
from imaginary_tpu_torch.ops import chain as pchain
from imaginary_tpu_torch.ops import plan as pplan
from imaginary_tpu_torch.ops import stages as pst
from imaginary_tpu_torch.params import build_params_from_query as pquery
from tests.conftest import fixture_bytes
from tests.test_torch_plan import assert_same_plan
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

F32_TOL = 1e-3
COEF_TOL = 1
COEF_SHARE = 1e-3
U8_TOL = 1

SHRINKS = [1, 2, 4, 8]
LAYOUTS = ["420", "422", "444", "gray"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _switches_off():
    yield
    for mod in (ppipeline, jpipeline):
        mod.set_transport_dct(False)
        mod.set_transport_dct_egress(False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jpeg(layout: str, h: int, w: int, seed: int = 7, quality: int = 90) -> bytes:
    """A smooth seeded image (noise, upscaled) as a baseline JPEG of the
    layout, made by Pillow (libjpeg)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (max(2, h // 8), max(2, w // 8), 3), dtype=np.uint8)
    im = Image.fromarray(base).resize((w, h), Image.BILINEAR)
    b = io.BytesIO()
    if layout == "gray":
        im.convert("L").save(b, "JPEG", quality=quality)
    else:
        im.save(b, "JPEG", quality=quality,
                subsampling={"444": 0, "422": 1, "420": 2}[layout])
    return b.getvalue()


# (h, w): odd dims, neither a multiple of the MCU, and a small even frame
DIMS = [(117, 203), (64, 96)]


@pytest.mark.parametrize("arm", ["native", "python"])
@pytest.mark.parametrize("shrink", SHRINKS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{d[0]}x{d[1]}")
def test_decode_packed_is_bit_exact_with_reference(dims, layout, shrink, arm):
    buf = _jpeg(layout, *dims)
    got = pdct.decode_packed(buf, shrink, decoder=arm)
    want = jdct.decode_packed(buf, shrink)
    assert got is not None and want is not None
    assert got[1:] == want[1:]
    assert got[0].dtype == np.int16 and np.array_equal(got[0], want[0])


def test_decode_packed_of_the_main_path_source_is_bit_exact():
    buf = fixture_bytes("large.jpg")
    for shrink in SHRINKS:
        got, want = pdct.decode_packed(buf, shrink), jdct.decode_packed(buf, shrink)
        assert got[1:] == want[1:] and np.array_equal(got[0], want[0])


def test_native_arm_is_built_and_chosen_by_default():
    assert pdct.native_available()
    assert pdct.decoder_name() == "native"
    assert pdct.decoder_name(64) == "native"
    pdct.set_decoder("numpy")
    try:
        assert pdct.decoder_name() == "numpy"
    finally:
        pdct.set_decoder("auto")
    with pytest.raises(ValueError):
        pdct.set_decoder("turbo")


def test_out_of_scope_streams_answer_none():
    im = Image.open(io.BytesIO(fixture_bytes("medium.jpg"))).convert("RGB")
    b = io.BytesIO()
    im.save(b, "JPEG", quality=85, progressive=True)
    assert pdct.decode_packed(b.getvalue(), 1) is None
    assert pdct.decode_packed(fixture_bytes("test.png"), 1) is None


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shrink", SHRINKS)
def test_dct_geometry_matches_reference(layout, shrink):
    for h, w in ((1, 1), (117, 203), (1080, 1920), (600, 800), (17, 33)):
        g = pbuckets.dct_packed_geometry(h, w, shrink, layout)
        assert g == jbuckets.dct_packed_geometry(h, w, shrink, layout)
        k, _, _, hb, wb = g
        assert pplan.dct_in_bucket(shrink, hb, wb, layout) == \
            jplan.dct_in_bucket(shrink, hb, wb, layout)
        rows, cols, _ = kernels.dct_in_shape(layout, k, hb, wb)
        assert (rows, cols) == pplan.dct_in_bucket(shrink, hb, wb, layout)


@pytest.fixture(scope="module")
def _jit_apply():
    cache = {}

    def run(spec, x, h, w, dyn):
        if spec not in cache:
            cache[spec] = jax.jit(lambda x, h, w, dyn: spec.apply(x.astype(jnp.float32), h, w,
                                                                  dyn)[0])
        return np.asarray(cache[spec](x, h, w, dyn))

    return run


@pytest.mark.parametrize("shrink", SHRINKS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_from_dct_matches_reference(_jit_apply, layout, shrink):
    """FromDctSpec on real packed coefficients of a JPEG of each layout,
    batched with a seeded variant whose valid dims differ."""
    buf = _jpeg(layout, 117, 203)
    packed, h2, w2, got_layout = pdct.decode_packed(buf, shrink)
    assert got_layout == layout
    k, _, _, hb, wb = pbuckets.dct_packed_geometry(117, 203, shrink, layout)
    rng = np.random.default_rng(shrink)
    other = np.clip(packed.astype(np.int32) + rng.integers(-40, 41, packed.shape),
                    -2000, 2000).astype(np.int16)
    x = np.stack([packed, other])
    h = np.array([h2, max(1, h2 - 5)], np.int32)
    w = np.array([w2, max(1, w2 - 9)], np.int32)
    want = _jit_apply(jst.FromDctSpec(hb, wb, k, layout), x, h, w, {})
    got, gh, gw = pst.FromDctSpec(hb, wb, k, layout).apply(_t(x), _t(h), _t(w), {})
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, hb, wb, 3)
    assert np.abs(got.numpy() - want).max() <= F32_TOL
    assert gh.tolist() == h.tolist() and gw.tolist() == w.tolist()


def _coef_diff(got: np.ndarray, want: np.ndarray):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("quality", [30, 80, 95])
@pytest.mark.parametrize("bucket,dims", [((32, 48), ((30, 45), (17, 48))),
                                         ((208, 304), ((200, 300), (208, 304)))],
                         ids=lambda v: str(v))
def test_to_dct_matches_reference(_jit_apply, bucket, dims, quality):
    """ToDctSpec + the int16 drain on seeded smooth images (edges
    replicated past each image's valid dims, out-of-range values clipped)."""
    rng = np.random.default_rng(quality)
    hb, wb = bucket
    base = rng.uniform(-20.0, 275.0, size=(2, hb // 8 + 1, wb // 8 + 1, 3)).astype(np.float32)
    x = np.asarray(torch.nn.functional.interpolate(
        torch.from_numpy(base).permute(0, 3, 1, 2), size=(hb, wb), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).contiguous())
    h = np.array([d[0] for d in dims], np.int32)
    w = np.array([d[1] for d in dims], np.int32)
    qy, qc = pdct.quality_tables(quality)
    dyn = {"qy": np.stack([qy, qy]).astype(np.float32), "qc": np.stack([qc, qc]).astype(np.float32)}
    spec_j = jst.ToDctSpec(hb, wb)
    want = _jit_apply(spec_j, x, h, w, dyn)
    want = np.asarray(jnp.clip(jnp.round(want), -32768.0, 32767.0).astype(jnp.int16))
    got, _, _ = pst.ToDctSpec(hb, wb).apply(_t(x), _t(h), _t(w),
                                            {k: _t(v) for k, v in dyn.items()})
    assert got.dtype == torch.int16 and tuple(got.shape) == want.shape
    worst, share = _coef_diff(got.numpy(), want)
    assert worst <= COEF_TOL and share <= COEF_SHARE


def test_to_dct_rounds_half_to_even_and_clamps():
    """A flat block whose DC lands exactly on .5 steps rounds to even, and
    a step of 1 at full white saturates nothing (|DC| <= 1016)."""
    x = torch.full((1, 16, 16, 3), 128.0 + 2.5 * 8 / 8)
    one = torch.ones((1, 8, 8))
    out = kernels.to_dct(x, torch.tensor([16], dtype=torch.int32),
                         torch.tensor([16], dtype=torch.int32), one * 20.0, one, 16, 16)
    # Y = 130.5, DC = 8 * 2.5 = 20 -> 20 / 20 = 1 exactly; chroma DC 0
    assert int(out[0, 0, 0, 0]) == 1 and int(out[0, 16, 0, 0]) == 0
    x = torch.full((1, 16, 16, 3), 128.0 + 0.3125)  # DC 2.5 with step 1
    out = kernels.to_dct(x, torch.tensor([16], dtype=torch.int32),
                         torch.tensor([16], dtype=torch.int32), one, one, 16, 16)
    assert int(out[0, 0, 0, 0]) == 2


def test_quality_tables_match_reference():
    for q in (1, 10, 49, 50, 51, 80, 100, 150):
        for a, b in zip(pdct.quality_tables(q), jdct.quality_tables(q)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _blocks(seed: int, h: int, w: int):
    """Seeded quantized coefficients with a JPEG-like spectrum (large DC,
    sparse small AC) in the egress packing, and their re-blocking by both
    packages."""
    rng = np.random.default_rng(seed)
    hb, wb = (h + 15) // 16 * 16, (w + 15) // 16 * 16
    packed = np.zeros((hb + hb // 2, wb, 1), np.int16)
    ac = rng.integers(-30, 31, packed.shape) * (rng.random(packed.shape) < 0.2)
    packed[...] = ac
    packed[0::8, 0::8, 0] = rng.integers(-1000, 1000, packed[0::8, 0::8, 0].shape)
    return packed, hb, wb


@pytest.mark.parametrize("arm", ["native", "python"])
@pytest.mark.parametrize("dims", [(117, 203), (16, 16), (200, 300)], ids=str)
def test_encode_quantized_bytes_equal_reference(dims, arm):
    packed, hb, wb = _blocks(sum(dims), *dims)
    got_qb = pdct.unpack_dct_egress(packed, *dims, hb, wb, 80)
    want_qb = jdct.unpack_dct_egress(packed, *dims, hb, wb, 80)
    for k in ("y", "u", "v"):
        assert np.array_equal(getattr(got_qb, k), getattr(want_qb, k))
    pdct.set_decoder(arm)
    try:
        got = pdct.encode_quantized(got_qb)
        with_restart = pdct.encode_quantized(got_qb, restart_interval=3)
    finally:
        pdct.set_decoder("auto")
    assert got == jdct.encode_quantized(want_qb)
    assert with_restart == jdct.encode_quantized(want_qb, restart_interval=3)
    im = Image.open(io.BytesIO(got))
    assert im.size == (dims[1], dims[0])


def _pixels(body: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB")).astype(np.int32)


def _capture(monkeypatch):
    """Record every chain output of both packages' run_single."""
    seen = {"port": [], "jax": []}
    real_p, real_j = pchain.run_single, jchain.run_single

    def port(arr, plan, device=pchain.DEFAULT_DEVICE):
        out = real_p(arr, plan, device=device)
        seen["port"].append((plan, out))
        return out

    def jax_(arr, plan, **kw):
        out = real_j(arr, plan, **kw)
        seen["jax"].append((plan, out))
        return out

    monkeypatch.setattr(pchain, "run_single", port)
    monkeypatch.setattr(jchain, "run_single", jax_)
    return seen


QUERIES = [("resize", {"width": "300", "height": "200"}), ("resize", {"width": "1600"}),
           ("crop", {"width": "300", "height": "200"}),
           ("smartcrop", {"width": "300", "height": "300"})]


@pytest.mark.parametrize("egress", [False, True], ids=["ingress", "egress"])
@pytest.mark.parametrize("op,query", QUERIES, ids=[f"{o}-{'x'.join(q.values())}"
                                                   for o, q in QUERIES])
def test_process_operation_on_the_dct_transport_matches_reference(monkeypatch, op, query,
                                                                 egress):
    seen = _capture(monkeypatch)
    for mod in (ppipeline, jpipeline):
        mod.set_transport_dct(True)
        mod.set_transport_dct_egress(egress)
    buf = fixture_bytes("large.jpg")
    before = ppipeline.dct_counts()
    got = ppipeline.process_operation(op, buf, pquery(query), device="cpu")
    want = jpipeline.process_operation(op, buf, jquery(query))
    after = ppipeline.dct_counts()
    assert after["served"] == before["served"] + 1
    assert after["out_of_scope"] == before["out_of_scope"]
    (pp, pout), = seen["port"]
    (jp, jout), = seen["jax"]
    assert pp.transport == jp.transport == "dct"
    assert pp.egress == jp.egress == ("dct" if egress else "")
    assert (got.mime, got.width, got.height) == ("image/jpeg", want.width, want.height)
    gpx, wpx = _pixels(got.body), _pixels(want.body)
    assert gpx.shape == wpx.shape
    if not egress:
        for k in ("y", "u", "v"):
            d = np.abs(getattr(pout, k).astype(np.int32) - getattr(jout, k).astype(np.int32))
            assert int(d.max()) <= U8_TOL, k
        return
    eq = None
    for k in ("y", "u", "v"):
        worst, share = _coef_diff(getattr(pout, k), getattr(jout, k))
        assert worst <= COEF_TOL and share <= COEF_SHARE, k
        same = (getattr(pout, k) == getattr(jout, k)).all(axis=(2, 3))
        if k == "y":
            same = same[0::2, 0::2] & same[1::2, 0::2] & same[0::2, 1::2] & same[1::2, 1::2]
        eq = same if eq is None else eq & same
    mask = np.kron(eq, np.ones((16, 16), bool))[: gpx.shape[0], : gpx.shape[1]]
    assert mask.any()
    assert int(np.abs(gpx - wpx).max(axis=2)[mask].max()) <= U8_TOL
    if eq.all():
        assert got.body == want.body


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_idct_basis_bits_equal_the_references(k):
    """K11's and K12's basis is `_idct_basis(k)` word for word (torch's f32
    cos differed from XLA's in one entry of k = 8)."""
    got = kernels.reference.idct_basis(k).numpy()
    want = np.asarray(jst._idct_basis(k))
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_the_kernels_basis_table_holds_the_plain_versions_words():
    """csrc/dct_basis.cuh, which K11 and K12 read, holds the words of the
    plain versions' table."""
    import os
    import re

    path = os.path.join(os.path.dirname(kernels.__file__), "csrc", "dct_basis.cuh")
    with open(path) as f:
        text = f.read()
    rows = re.findall(r"\{([^{}]*)\}", text.split("kIdctBasisBits[4][64] =", 1)[1])
    for k, row in zip((1, 2, 4, 8), rows):
        words = tuple(int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", row))
        assert words == kernels.reference._IDCT_BASIS_BITS[k], k


# Blocks that stay 8x8-aligned through the chain (/flip, /rotate) of a
# quality-90 source re-quantized at the egress's default quality 80, whose
# luma steps are twice the source's: about a fifth of the luma
# coefficients land exactly on a .5 tie, and the f32 rounding of the IDCT
# and the FDCT decides each. The basis is the reference's word for word,
# but its sums come from XLA's CPU matrix products, which split the 8-term
# sums into blocks that depend on the tensor's size; neither the plain
# versions nor K11/K12 follow that (ROADMAP.md queue 3, fault 1). So these cases hold what is exact: every
# luma coefficient where the packages differ lies on a tie (within 1e-3
# of k + 0.5 in the port's f64 recomputation) and differs by one step,
# and chroma meets the existing bound.
TIE_SOURCES = [("444", (480, 640)), ("gray", (360, 480))]
TIE_QUERIES = [("flip", {}), ("rotate", {"rotate": "90"})]
TIE_EPS = 1e-3


def _unrounded_luma(x, h, w, qy, hb: int, wb: int) -> np.ndarray:
    """K12's luma coefficients / step before rounding, in f64, from K12's
    input: [rows, cols, 8, 8] as QuantizedBlocks lays them out."""
    x = x[0].double().numpy()
    iy = np.minimum(np.arange(hb), max(int(h[0]) - 1, 0))
    ix = np.minimum(np.arange(wb), max(int(w[0]) - 1, 0))
    x = np.clip(x[iy][:, ix], 0.0, 255.0)
    y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2] - 128.0
    u = np.arange(8)[:, None]
    xs = np.arange(8)[None, :]
    basis = np.where(u == 0, np.sqrt(1.0 / 8), np.sqrt(2.0 / 8)) * np.cos(
        (2 * xs + 1) * u * np.pi / 16)
    blk = y.reshape(hb // 8, 8, wb // 8, 8)
    coef = np.einsum("rxcz,ux,vz->rcuv", blk, basis, basis)
    return coef / qy[0].double().numpy()[None, None]


@pytest.mark.parametrize("op,query", TIE_QUERIES, ids=[q[0] for q in TIE_QUERIES])
@pytest.mark.parametrize("layout,dims", TIE_SOURCES, ids=[s[0] for s in TIE_SOURCES])
def test_egress_on_block_aligned_chains_differs_only_at_ties(monkeypatch, layout, dims,
                                                             op, query):
    seen = _capture(monkeypatch)
    k12_inputs = []
    real_to_dct = kernels.to_dct

    def to_dct(x, h, w, qy, qc, hb, wb, **kw):
        k12_inputs.append((x.clone(), h.clone(), w.clone(), qy.clone(), hb, wb))
        return real_to_dct(x, h, w, qy, qc, hb, wb, **kw)

    monkeypatch.setattr(kernels, "to_dct", to_dct)
    for mod in (ppipeline, jpipeline):
        mod.set_transport_dct(True)
        mod.set_transport_dct_egress(True)
    buf = _jpeg(layout, *dims, quality=90)
    got = ppipeline.process_operation(op, buf, pquery(query), device="cpu")
    want = jpipeline.process_operation(op, buf, jquery(query))
    (pp, pout), = seen["port"]
    (jp, jout), = seen["jax"]
    assert pp.egress == jp.egress == "dct" and (got.width, got.height) == (
        want.width, want.height)
    for k in ("u", "v"):
        worst, share = _coef_diff(getattr(pout, k), getattr(jout, k))
        assert worst <= COEF_TOL and share <= COEF_SHARE, k
    worst, share = _coef_diff(pout.y, jout.y)
    assert worst <= COEF_TOL
    (x, h, w, qy, hb, wb), = k12_inputs
    ideal = _unrounded_luma(x, h, w, qy, hb, wb)[: pout.y.shape[0], : pout.y.shape[1]]
    ties = np.abs(np.abs(ideal - np.floor(ideal)) - 0.5) < TIE_EPS
    differ = pout.y != jout.y
    assert differ.any() and ties.mean() > 0.05
    assert not (differ & ~ties).any()
    assert share <= ties.mean()


def test_pipeline_endpoint_rides_the_dct_transport(monkeypatch):
    seen = _capture(monkeypatch)
    for mod in (ppipeline, jpipeline):
        mod.set_transport_dct(True)
    ops = ('[{"operation": "crop", "params": {"width": 1600, "height": 900}},'
           ' {"operation": "resize", "params": {"width": 640}}]')
    buf = fixture_bytes("large.jpg")
    got = ppipeline.process_operation("pipeline", buf, pquery({"operations": ops}), device="cpu")
    want = jpipeline.process_operation("pipeline", buf, jquery({"operations": ops}))
    assert [p.transport for p, _ in seen["port"]] == [p.transport for p, _ in seen["jax"]] == ["dct"]
    assert_same_plan(seen["jax"][0][0], seen["port"][0][0])
    assert (got.width, got.height) == (want.width, want.height) == (640, 360)
    d = max(int(np.abs(getattr(seen["port"][0][1], k).astype(np.int32)
                       - getattr(seen["jax"][0][1], k).astype(np.int32)).max()) for k in "yuv")
    assert d <= U8_TOL


@pytest.mark.parametrize("egress", [False, True])
@pytest.mark.parametrize("shrink", SHRINKS)
def test_wrap_plan_dct_matches_reference(shrink, egress):
    for layout in LAYOUTS:
        k, h2, w2, _, _ = pbuckets.dct_packed_geometry(1080, 1920, shrink, layout)
        jp = jplan.plan_operation("resize", jquery({"width": "300"}), h2, w2, 0, 3)
        pp = pplan.plan_operation("resize", pquery({"width": "300"}), h2, w2, 0, 3)
        eg = "dct" if egress else ""
        jw = jplan.wrap_plan_dct(jp, 1080, 1920, shrink, layout=layout, egress=eg,
                                 egress_quality=70)
        pw = pplan.wrap_plan_dct(pp, 1080, 1920, shrink, layout=layout, egress=eg,
                                 egress_quality=70)
        assert_same_plan(jw, pw)
        from tests.test_torch_plan import plan_to_dict

        assert_same_plan(jw, pplan.plan_from_dict(plan_to_dict(jw)))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_run_batch_on_the_dct_transport_matches_reference(layout):
    """int16 coefficients staged in the chunk's one copy, two images of
    one bucket in a batch, each through FromDctSpec -> ... -> ToDctSpec."""
    bufs = [_jpeg(layout, 117, 203, seed=s) for s in (1, 2)]
    got_plans, arrs = [], []
    for b in bufs:
        packed, h2, w2, lay = pdct.decode_packed(b, 1)
        arrs.append(packed)
        p = pplan.plan_operation("resize", pquery({"width": "90"}), h2, w2, 0, 3)
        got_plans.append(pplan.wrap_plan_dct(p, 117, 203, 1, layout=lay, egress="dct",
                                             egress_quality=75))
    want_plans = [jplan.wrap_plan_dct(
        jplan.plan_operation("resize", jquery({"width": "90"}), 117, 203, 0, 3), 117, 203, 1,
        layout=layout, egress="dct", egress_quality=75)] * 2
    got = pchain.run_batch(arrs, got_plans, device="cpu")
    want = jchain.run_batch(arrs, want_plans)
    for g, w in zip(got, want):
        assert (g.h, g.w, g.quality) == (w.h, w.w, w.quality)
        for k in "yuv":
            worst, share = _coef_diff(getattr(g, k), getattr(w, k))
            assert worst <= COEF_TOL and share <= COEF_SHARE


def test_switches_default_off_and_egress_needs_ingress():
    from imaginary_tpu_torch.cli import parse_args
    from imaginary_tpu_torch.web.handlers import ImageService

    assert not ppipeline.transport_dct_enabled()
    assert not ppipeline.transport_dct_egress_enabled()
    args = parse_args([])
    assert not args.transport_dct and not args.transport_dct_egress
    args = parse_args(["--transport-dct", "--transport-dct-egress"])
    assert args.transport_dct and args.transport_dct_egress
    with pytest.raises(SystemExit):
        parse_args(["--transport-dct-egress"])
    with pytest.raises(ValueError):
        ImageService(device="cpu", transport_dct_egress=True)


def test_off_state_never_consults_the_dct_codec(monkeypatch):
    monkeypatch.setattr(pdct, "decode_packed",
                        lambda *_a, **_k: pytest.fail("dct decode ran with the switch off"))
    monkeypatch.setattr(pdct, "encode_quantized",
                        lambda *_a, **_k: pytest.fail("dct encode ran with the switch off"))
    out = ppipeline.process_operation("resize", fixture_bytes("medium.jpg"),
                                      pquery({"width": "100"}), device="cpu")
    assert out.mime == "image/jpeg"


def test_identity_chains_skip_the_dct_transport(monkeypatch):
    ppipeline.set_transport_dct(True)
    monkeypatch.setattr(pdct, "decode_packed",
                        lambda *_a, **_k: pytest.fail("dct decode ran for an identity chain"))
    out = ppipeline.process_operation("convert", fixture_bytes("medium.jpg"),
                                      pquery({"type": "jpeg"}), device="cpu")
    assert out.mime == "image/jpeg"


def test_non_jpeg_output_stays_off_the_transport(monkeypatch):
    ppipeline.set_transport_dct(True)
    monkeypatch.setattr(pdct, "decode_packed",
                        lambda *_a, **_k: pytest.fail("dct decode ran for a png target"))
    out = ppipeline.process_operation("resize", fixture_bytes("medium.jpg"),
                                      pquery({"width": "100", "type": "png"}), device="cpu")
    assert out.mime == "image/png"


def test_out_of_scope_stream_takes_the_pixel_path_and_is_counted():
    ppipeline.set_transport_dct(True)
    im = Image.open(io.BytesIO(fixture_bytes("medium.jpg"))).convert("RGB")
    b = io.BytesIO()
    im.save(b, "JPEG", quality=85, progressive=True)
    before = ppipeline.dct_counts()
    out = ppipeline.process_operation("resize", b.getvalue(), pquery({"width": "100"}),
                                      device="cpu")
    after = ppipeline.dct_counts()
    assert out.mime == "image/jpeg" and out.width == 100
    assert after["out_of_scope"] == before["out_of_scope"] + 1
    assert after["served"] == before["served"]


def test_health_reports_the_dct_transport():
    from imaginary_tpu_torch.web.handlers import ImageService

    svc = ImageService(device="cpu", transport_dct=True, transport_dct_egress=True)
    try:
        resp = svc.process("resize", fixture_bytes("large.jpg"),
                           {"width": "300", "height": "200"})
        assert (resp.status, resp.content_type) == (200, "image/jpeg")
        assert _pixels(resp.body).shape[:2] == (200, 300)
        health = svc.health()["dctTransport"]
        assert health["ingress"] and health["egress"] and health["served"] >= 1
    finally:
        svc.close()
