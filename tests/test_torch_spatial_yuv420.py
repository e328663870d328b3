"""The port's spatial route on the yuv420 transport (4:2:0 JPEG) on the CPU.

The chains a JPEG request runs by default start with K2 (FromYuv420Spec)
and end with K3 (ToYuv420Spec); with their W-shard forms, K1 as a later
stage and K4 (the bucket shrink, extract, embed) over the window exchange,
K5 (the flip, the flop over a window, the transpose over the row-band
all-to-all) and the smartcrop (K9 -> K10 -> K4), they run W-sharded end to
end (`ops/chain.launch_spatial`):

  * `spatial_split` on a 3840x2160 JPEG's plans: no gather for /resize,
    /enlarge, /blur, /flip, the bw dry run, /crop, /smartcrop,
    /rotate?rotate=90, /flop, an embed with a fill and an EXIF-6 /resize
    at n = 2 and 4;
  * every such chain, /rotate at 90, 180 and 270, EXIF orientations 2-8
    and the embed's mirror, copy and fill modes bit-equal to the
    unsharded chain on small JPEGs;
  * K2's shard form at its seams (chip_smoke.SHARD_SEAM_CASES: odd w, the
    valid chroma edge in a shard's halo, a shard wholly past the valid
    width, where the clamp reaches columns outside the shard's halo),
    padding included; K3's (odd h and w, a 2x2 block split by the valid
    edge, luma on and off);
  * K1 as a later stage at 2x and 4x downscale and 2x upscale with
    lanczos3, linear and nearest, its window from one, two or three
    other shards; the shrink's form where the input and output shards
    differ in width; the flip's form;
  * an executor over four cpu entries with spatial=4: no gather on the
    new chains, and a blur whose radius reaches past a shard still
    gathered and counted;
  * within 1 LSB of the JAX executor's spatial route on the conftest's
    virtual devices on the same JPEG bytes.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from imaginary_tpu import pipeline as jpipeline
from imaginary_tpu.engine import Executor as JExecutor
from imaginary_tpu.engine import ExecutorConfig as JExecutorConfig
from imaginary_tpu.params import build_params_from_query as jquery
from imaginary_tpu_torch import codecs, kernels
from imaginary_tpu_torch import pipeline as ppipeline
from imaginary_tpu_torch.engine import Executor, ExecutorConfig
from imaginary_tpu_torch.imgtype import ImageType
from imaginary_tpu_torch.kernels import reference
from imaginary_tpu_torch.ops import chain
from imaginary_tpu_torch.ops.plan import (
    ImagePlan,
    StageInstance,
    plan_operation,
    wrap_plan_yuv420,
)
from imaginary_tpu_torch.ops.stages import (
    BlurSpec,
    FlipSpec,
    FromYuv420Spec,
    SampleSpec,
    ShrinkBucketSpec,
    ToYuv420Spec,
)
from imaginary_tpu_torch.params import build_params_from_query as pquery
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")


@pytest.fixture(autouse=True, scope="module")
def _reference_wire_unlabelled():
    """The reference's lanes book its WIRE ledger by device; leave that
    process-wide ledger unlabelled for the next test file in this worker
    (the reference's exposition tests parse every label it renders)."""
    yield
    from imaginary_tpu.engine.timing import WIRE as reference_wire

    reference_wire.reset()


WAIT_S = 120
U8_TOL = 1  # LSB, against the JAX package
CPU = torch.device("cpu")
BW = {"width": "160", "sigma": "2", "colorspace": "bw"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jpeg(h, w, seed=0, orientation=None) -> bytes:
    """A seeded 4:2:0 JPEG: a gradient under noise, with an EXIF
    orientation when one is given."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    (xx + yy) % 256], axis=-1)
    img = np.clip(img + rng.integers(-40, 41, img.shape), 0, 255).astype(np.uint8)
    out = io.BytesIO()
    kw = {}
    if orientation is not None:
        exif = Image.Exif()
        exif[0x0112] = orientation
        kw["exif"] = exif.tobytes()
    Image.fromarray(img).save(out, "JPEG", quality=90, subsampling=2, **kw)
    return out.getvalue()


def _yuv_plan(buf: bytes, op: str, query: dict) -> ImagePlan:
    """The wrapped yuv420 plan `pipeline.process_operation` builds for a
    4:2:0 JPEG, without decoding it."""
    o = pquery(query)
    meta = codecs.probe_fast(buf)
    assert ppipeline._yuv_eligible(ImageType.JPEG, meta, o)
    shrink = ppipeline._pick_shrink(op, ImageType.JPEG, o, meta)
    sh, sw = -(-meta.height // shrink), -(-meta.width // shrink)
    p = plan_operation(op, o, sh, sw, meta.orientation, 3)
    return wrap_plan_yuv420(p, sh, sw)


def _same(a, b) -> bool:
    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in ("y", "u", "v"))


def _spatial(arr, plan, n):
    y = chain.launch_spatial(arr, plan, [CPU] * n)
    return chain.fetch_batch(y, [arr], [plan])[0], y


def _unsharded(arr, plan):
    return chain.run_batch([arr], [plan], device="cpu")[0]


def _names(plan):
    return [type(s).__name__ for s in plan.spec_key()]


# -- the 3840x2160 JPEG's chains: no gather --------------------------------------

ROUTES_4K = [
    ("resize", "resize", {"width": "1920"}, ["SampleSpec"], None),
    ("enlarge", "enlarge", {"width": "7680", "height": "4320"}, ["SampleSpec"], None),
    ("blur", "blur", {"sigma": "2"}, ["BlurSpec"], None),
    ("flip", "flip", {}, ["FlipSpec"], None),
    ("bw", "resize", dict(BW, width="1920"), ["SampleSpec", "BlurSpec", "GraySpec"], None),
    ("crop", "crop", {"width": "1000", "height": "1000"}, ["SampleSpec", "ExtractSpec"],
     None),
    ("smartcrop", "smartcrop", {"width": "2400", "height": "2000"},
     ["SampleSpec", "SmartExtractSpec"], None),
    ("rotate90", "rotate", {"rotate": "90"}, ["TransposeSpec", "FlopSpec"], None),
    ("flop", "flop", {}, ["FlopSpec"], None),
    ("embed-fill", "resize", {"width": "3000", "height": "2000", "extend": "white"},
     ["SampleSpec", "EmbedSpec"], None),
    ("exif6", "resize", {"width": "1920"}, ["TransposeSpec", "FlopSpec", "SampleSpec"], None),
]


@pytest.fixture(scope="module")
def jpeg_4k() -> bytes:
    return _jpeg(2160, 3840, seed=1)


@pytest.fixture(scope="module")
def jpeg_4k_exif6() -> bytes:
    return _jpeg(2160, 3840, seed=2, orientation=6)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name,op,query,middle,gather", ROUTES_4K,
                         ids=[r[0] for r in ROUTES_4K])
def test_4k_jpeg_chains_shard_end_to_end(jpeg_4k, jpeg_4k_exif6, name, op, query, middle,
                                         gather, n):
    plan = _yuv_plan(jpeg_4k_exif6 if name == "exif6" else jpeg_4k, op, query)
    specs = plan.spec_key()
    assert _names(plan) == ["FromYuv420Spec"] + middle + ["ToYuv420Spec"]
    sharded, gather_at = chain.spatial_split(specs, *plan.in_bucket, n)
    if gather is None:
        assert gather_at is None and sharded == list(range(len(specs)))
    else:
        assert type(specs[gather_at]).__name__ == gather
        assert sharded == list(range(gather_at))
    steps = chain.launch_steps(specs, sharded)
    # the bw chain's K8 folds into K3 on the route as off it
    assert "GraySpec" not in [type(specs[i]).__name__ for i, _ in steps]
    assert any(luma for _, luma in steps) == (name == "bw")


# -- bit-equal to the unsharded chain ---------------------------------------------

ROUTES = [
    ("resize", "resize", {"width": "160"}, None),
    ("enlarge", "enlarge", {"width": "840", "height": "300"}, None),
    ("blur", "blur", {"sigma": "2"}, None),
    ("flip", "flip", {}, None),
    ("bw", "resize", BW, None),
    ("crop", "crop", {"width": "100", "height": "100"}, None),
    ("smartcrop", "smartcrop", {"width": "100", "height": "100"}, None),
    ("rotate90", "rotate", {"rotate": "90"}, None),
    ("rotate180", "rotate", {"rotate": "180"}, None),
    ("rotate270", "rotate", {"rotate": "270"}, None),
    ("flop", "flop", {}, None),
    ("embed-mirror", "resize", {"width": "400", "height": "300", "extend": "mirror"}, None),
    ("embed-copy", "resize", {"width": "400", "height": "300", "extend": "copy"}, None),
    ("embed-fill", "resize", {"width": "400", "height": "300", "extend": "white"}, None),
]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dims", [(150, 420), (151, 423)], ids=["150x420", "151x423"])
@pytest.mark.parametrize("name,op,query,gather", ROUTES, ids=[r[0] for r in ROUTES])
def test_jpeg_chain_is_bit_equal_to_the_unsharded_chain(name, op, query, gather, dims, n):
    buf = _jpeg(*dims, seed=n)
    arr, plan = chip_smoke.request_plan(buf, op, query)
    assert plan.transport == "yuv420"
    got, y = _spatial(arr, plan, n)
    assert y.gathered == gather
    assert y.shards == (0 if gather else n)
    assert _same(got, _unsharded(arr, plan))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("orientation", range(2, 9))
def test_exif_orientations_are_bit_equal_to_the_unsharded_chain(orientation, n):
    """EXIF orientations 2-8 plan the flop, the flip and (5-8) the
    transpose before the /resize: every one runs sharded, no gather."""
    buf = _jpeg(151, 423, seed=orientation, orientation=orientation)
    arr, plan = chip_smoke.request_plan(buf, "resize", {"width": "120"})
    names = _names(plan)
    assert ("TransposeSpec" in names) == (orientation >= 5)
    got, y = _spatial(arr, plan, n)
    assert y.gathered is None and y.shards == n
    assert _same(got, _unsharded(arr, plan))


# -- K2's and K3's shard forms at their seams -------------------------------------

SEAMS = chip_smoke.SHARD_SEAM_CASES


def _seam_inputs(case):
    packed, rgb = chip_smoke.shard_seam_inputs(case, np.random.default_rng(SEAMS.index(case)))
    _, h, w, hb, wb, n = case
    return (packed, torch.from_numpy(rgb), torch.tensor([h], dtype=torch.int32),
            torch.tensor([w], dtype=torch.int32), hb, wb, n)


@pytest.mark.parametrize("case", SEAMS, ids=[c[0] for c in SEAMS])
def test_k2_shard_equals_the_whole_image_columns_padding_included(case):
    packed, _, h, w, hb, wb, n = _seam_inputs(case)
    spec = FromYuv420Spec(hb, wb)
    whole = kernels.yuv420_to_rgb(torch.from_numpy(packed)[None], h, w, hb, wb)
    lw = wb // n
    clamped = 0
    for j in range(n):
        c0, c1 = j * lw, (j + 1) * lw
        x, left, right, in_col0 = spec.shard_input(packed, c0, c1, int(w[0]), {})
        assert in_col0 == c0 and x.shape == (hb + hb // 2, lw, 1)
        assert left.shape == right.shape == (hb // 2, 2, 1)
        # where the clamp reaches a column outside the shard's own halo,
        # the host gave the shard that column
        hi = min(max((int(w[0]) + 1) // 2 - 1, 0), wb // 2 - 1)
        clamped += c0 // 2 - 1 > hi
        xs, ls, rs = (torch.from_numpy(np.ascontiguousarray(a))[None] for a in (x, left, right))
        out, _, _ = spec.apply_shard(xs, ls, rs, h, w, {}, c0, lw, c0, wb, False)
        assert torch.equal(out, whole[:, :, c0:c1])
        assert torch.equal(out, reference.yuv420_to_rgb_shard(xs, ls, rs, h, w, hb, lw))
    if case[0] in ("past-valid", "w4100", "edge-in-left-halo"):
        assert clamped >= 1


@pytest.mark.parametrize("luma", [False, True], ids=["rgb", "luma"])
@pytest.mark.parametrize("case", SEAMS, ids=[c[0] for c in SEAMS])
def test_k3_shards_assemble_to_the_whole_image_planes(case, luma):
    _, rgb, h, w, hb, wb, n = _seam_inputs(case)
    spec = ToYuv420Spec(hb, wb)
    whole = kernels.rgb_to_yuv420(rgb, h, w, hb, wb, luma)
    lw = wb // n
    parts = []
    for j in range(n):
        xs = rgb[:, :, j * lw:(j + 1) * lw].contiguous()
        dyn = {"luma": True} if luma else {}
        out, _, _ = spec.apply_shard(xs, None, None, h, w, dyn, j * lw, lw, j * lw, wb, True)
        assert out.shape == (1, hb + hb // 2, lw, 1) and out.dtype == torch.uint8
        # its own Y columns and the U and V halves of its columns
        assert torch.equal(out[:, :hb], whole[:, :hb, j * lw:(j + 1) * lw])
        cu = slice(j * lw // 2, (j + 1) * lw // 2)
        assert torch.equal(out[:, hb:, :lw // 2], whole[:, hb:, cu])
        assert torch.equal(out[:, hb:, lw // 2:], whole[:, hb:, wb // 2:][:, :, cu])
        parts.append(out)
    assert np.array_equal(spec.shard_assemble(torch.stack(parts)), whole.numpy())


def test_k3_pools_a_block_past_the_valid_width_to_128():
    """The last shard of a 6144-wide bucket holding 4100 valid columns
    lies wholly past them: its chroma is 128, its Y the padding's."""
    case = next(c for c in SEAMS if c[0] == "w4100")
    _, rgb, h, w, hb, wb, n = _seam_inputs(case)
    lw = wb // n
    out = kernels.rgb_to_yuv420_shard(rgb[:, :, -lw:].contiguous(), h, w, hb, lw,
                                      wb - lw, False)
    assert bool((out[:, hb:] == 128).all())
    assert torch.equal(out[:, :hb], kernels.rgb_to_yuv420(rgb, h, w, hb, wb)[:, :hb, -lw:])


# -- K1 as a later stage, the shrink and the flip ---------------------------------

def _packed_plan(h, w, hb, wb, middle, out_hb, out_wb, out_h, out_w):
    stages = ([StageInstance(FromYuv420Spec(hb, wb), {})]
              + [StageInstance(s, d) for s, d in middle]
              + [StageInstance(ToYuv420Spec(out_hb, out_wb), {})])
    return ImagePlan(stages=stages, out_h=out_h, out_w=out_w, transport="yuv420",
                     in_bucket=(hb + hb // 2, wb), in_h=h, in_w=w,
                     out_bucket=(out_hb, out_wb))


def _packed(hb, wb, seed):
    return np.random.default_rng(seed).integers(0, 256, (hb + hb // 2, wb, 1),
                                                dtype=np.uint8)


def _others(windows: list) -> list:
    """For each shard, the number of other shards its window came from."""
    return [len({s for s, _, _ in parts} - {j}) for j, (_, _, parts) in enumerate(windows)]


# (name, input w in its bucket wb, dst_w in its bucket out_wb, the most
# other shards a window over 4 shards takes from): at 2x down the taps
# reach one neighbour; at 4x down into the same bucket shard 0 reads every
# input shard; at 2x up each window sits in one input shard plus the taps
K1_SCALES = [
    ("down2", 250, 256, 125, 128, 2),
    ("down4", 256, 256, 64, 256, 3),
    ("up2", 100, 128, 200, 256, 2),
]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["lanczos3", "linear", "nearest"])
@pytest.mark.parametrize("scale,w,wb,dst_w,out_wb,most", K1_SCALES,
                         ids=[s[0] for s in K1_SCALES])
def test_k1_as_a_later_stage_over_exchanged_windows(scale, w, wb, dst_w, out_wb, most,
                                                    kind, n):
    h, hb, dst_h, out_hb = 40, 48, 30, 32
    sample = (SampleSpec(out_hb, out_wb, kind),
              {"dst_h": np.float32(dst_h), "dst_w": np.float32(dst_w)})
    plan = _packed_plan(h, w, hb, wb, [sample], out_hb, out_wb, dst_h, dst_w)
    arr = _packed(hb, wb, seed=len(kind) + n)
    got, y = _spatial(arr, plan, n)
    assert y.gathered is None and list(y.windows) == [1]
    assert _same(got, _unsharded(arr, plan))
    others = _others(y.windows[1])
    assert min(others) >= 1
    if n == 4:
        assert max(others) == most


def test_k1_windows_come_from_one_two_and_three_other_shards():
    seen = set()
    for _, w, wb, dst_w, out_wb, _ in K1_SCALES:
        sample = (SampleSpec(32, out_wb), {"dst_h": np.float32(30),
                                           "dst_w": np.float32(dst_w)})
        plan = _packed_plan(40, w, 48, wb, [sample], 32, out_wb, 30, dst_w)
        arr = _packed(48, wb, seed=w)
        got, y = _spatial(arr, plan, 4)
        assert _same(got, _unsharded(arr, plan))
        seen.update(_others(y.windows[1]))
    assert {1, 2, 3} <= seen


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("transport", ["yuv420", "rgb"])
def test_shrink_form_where_input_and_output_shards_differ(transport, n):
    """K13 on a 256-wide bucket, then the shrink to 224 columns: output
    shard j reads input columns [j lw, (j + 1) lw) of the wider bucket,
    which straddle two of the blur's shards."""
    h, w, hb, wb = 75, 210, 96, 256
    middle = [(BlurSpec(3), {"sigma": np.float32(1.5)}), (ShrinkBucketSpec(80, 224), {})]
    if transport == "yuv420":
        plan = _packed_plan(h, w, hb, wb, middle, 80, 224, h, w)
        arr = _packed(hb, wb, seed=n)
        shrink = 2
    else:
        plan = ImagePlan(stages=[StageInstance(s, d) for s, d in middle], out_h=h, out_w=w)
        arr = np.random.default_rng(n).integers(0, 256, (h, w, 3), dtype=np.uint8)
        shrink = 1
    got, y = _spatial(arr, plan, n)
    assert y.gathered is None and list(y.windows) == [shrink]
    want = _unsharded(arr, plan)
    assert _same(got, want) if transport == "yuv420" else np.array_equal(got, want)
    lw_in, lw_out = wb // n, 224 // n
    for j, (k0, k1, parts) in enumerate(y.windows[shrink]):
        assert (k0, k1) == (j * lw_out, (j + 1) * lw_out)
        assert [s for s, _, _ in parts] == sorted({k0 // lw_in, (k1 - 1) // lw_in})
    assert max(_others(y.windows[shrink])) == 1


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("transport", ["yuv420", "rgb"])
def test_flip_form_is_column_local(transport, n):
    """The flip mirrors each column's valid rows (odd h in a taller
    bucket) on its own shard: no window, no gather."""
    h, w, hb, wb = 37, 120, 48, 128
    flip = [(FlipSpec(), {})]
    if transport == "yuv420":
        plan = _packed_plan(h, w, hb, wb, flip, hb, wb, h, w)
        arr = _packed(hb, wb, seed=n + 5)
    else:
        plan = ImagePlan(stages=[StageInstance(s, d) for s, d in flip], out_h=h, out_w=w)
        arr = np.random.default_rng(n).integers(0, 256, (h, w, 3), dtype=np.uint8)
    trace = []
    y = chain.launch_spatial(arr, plan, [CPU] * n, trace=trace)
    got = chain.fetch_batch(y, [arr], [plan])[0]
    assert y.gathered is None and y.windows == {}
    want = _unsharded(arr, plan)
    assert _same(got, want) if transport == "yuv420" else np.array_equal(got, want)
    flips = [(args, out) for _, _, spec, args, out in trace if isinstance(spec, FlipSpec)]
    assert len(flips) == n
    for args, out in flips:
        assert torch.equal(out, FlipSpec().apply_shard(*args, impl=reference)[0])


def test_trace_holds_k2_k3_and_the_folded_luma():
    """The bw dry run on a JPEG: the trace has K2, K1, K13 and K3 on each
    shard, no K8, and K3's dyn carries the folded luma; each launch equals
    its plain version on its own arguments."""
    arr, plan = chip_smoke.request_plan(_jpeg(150, 420, seed=21), "resize", BW)
    trace = []
    y = chain.launch_spatial(arr, plan, [CPU] * 4, trace=trace)
    assert _same(chain.fetch_batch(y, [arr], [plan])[0], _unsharded(arr, plan))
    names = [type(spec).__name__ for _, _, spec, _, _ in trace]
    assert names == [n for n in ("FromYuv420Spec", "SampleSpec", "BlurSpec", "ToYuv420Spec")
                     for _ in range(4)]
    for _, _, spec, args, out in trace:
        if isinstance(spec, ToYuv420Spec):
            assert args[5]["luma"] is True and args[-1] is True
        if isinstance(spec, FromYuv420Spec):
            assert args[1].shape[2] == args[2].shape[2] == 2
        assert torch.equal(out, spec.apply_shard(*args, impl=reference)[0])


# -- the executor's route, its gathers counted ------------------------------------

def test_executor_route_shards_the_jpeg_chains_and_counts_crop_gather():
    """Every default JPEG chain runs on the route without a gather, /crop
    and /smartcrop included; a blur whose radius (64, at sigma 20) reaches
    past a 32-column shard of a 100-wide JPEG is K13's `shard_ok` refusal:
    still gathered, and counted at BlurSpec."""
    ex = Executor(ExecutorConfig(device="cpu", mesh_policy="lanes", n_devices=4, spatial=4,
                                 spatial_threshold_px=1, max_form_ms=1.0))
    try:
        buf = _jpeg(150, 420, seed=31)
        seen = []

        def run(arr, plan):
            out = ex.process(arr, plan, timeout=WAIT_S)
            assert _same(out, _unsharded(arr, plan))
            seen.append(plan.transport)
            return out

        routes = (("resize", {"width": "160"}), ("blur", {"sigma": "2"}), ("flip", {}),
                  ("resize", BW), ("crop", {"width": "100", "height": "100"}),
                  ("smartcrop", {"width": "100", "height": "100"}),
                  ("rotate", {"rotate": "90"}), ("flop", {}))
        for op, query in routes:
            ppipeline.process_operation(op, buf, pquery(query), device="cpu", runner=run)
        d = ex.stats.to_dict()
        assert seen == ["yuv420"] * len(routes)
        assert d["spatial_batches"] == len(routes) and d["spatial_gathers"] == {}
        ppipeline.process_operation("blur", _jpeg(150, 100, seed=32), pquery({"sigma": "20"}),
                                    device="cpu", runner=run)
        d = ex.stats.to_dict()
        assert d["spatial_batches"] == len(routes) + 1
        assert d["spatial_gathers"] == {"BlurSpec": 1}
    finally:
        ex.shutdown()


# -- within 1 LSB of the JAX executor's spatial route -----------------------------

JAX_CASES = [
    ("resize", "resize", {"width": "160"}),
    ("blur", "blur", {"sigma": "2"}),
    ("flip", "flip", {}),
    ("dry-run-bw", "resize", BW),
    ("crop", "crop", {"width": "100", "height": "100"}),
    ("smartcrop", "smartcrop", {"width": "100", "height": "100"}),
    ("rotate90", "rotate", {"rotate": "90"}),
    ("rotate180", "rotate", {"rotate": "180"}),
    ("rotate270", "rotate", {"rotate": "270"}),
    ("flop", "flop", {}),
    ("embed-mirror", "resize", {"width": "400", "height": "300", "extend": "mirror"}),
    ("embed-copy", "resize", {"width": "400", "height": "300", "extend": "copy"}),
    ("embed-fill", "resize", {"width": "400", "height": "300", "extend": "white"}),
] + [(f"exif{k}", "resize", {"width": "120"}) for k in range(2, 9)]


@pytest.fixture(scope="module")
def executors():
    """The JAX executor's spatial route on a (2, 2) mesh of the conftest's
    virtual devices, and the port's on a (2, 2) mesh of cpu entries."""
    import jax

    if len(jax.devices()) < 4:
        pytest.fail("the conftest's eight virtual devices are missing")
    jex = JExecutor(JExecutorConfig(mesh_policy="lanes", n_devices=4, spatial=2,
                                    spatial_threshold_px=1, window_ms=1.0))
    pex = Executor(ExecutorConfig(device="cpu", mesh_policy="lanes", n_devices=4,
                                  spatial=2, spatial_threshold_px=1, max_form_ms=1.0))
    try:
        yield jex, pex
    finally:
        jex.shutdown()
        pex.shutdown()


@pytest.mark.parametrize("case,op,query", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_jpeg_spatial_route_matches_the_jax_spatial_route(executors, case, op, query):
    jex, pex = executors
    buf = _jpeg(150, 420, seed=11,
                orientation=int(case[4:]) if case.startswith("exif") else None)
    jseen, pseen = [], []
    j0, p0 = jex.stats.spatial_batches, pex.stats.spatial_batches
    g0 = dict(pex.stats.spatial_gathers)

    def jrun(arr, plan):
        jseen.append(jex.process(arr, plan))
        return jseen[-1]

    def prun(arr, plan):
        pseen.append(pex.process(arr, plan, timeout=WAIT_S))
        return pseen[-1]

    want = jpipeline.process_operation(op, buf, jquery(query), runner=jrun)
    got = ppipeline.process_operation(op, buf, pquery(query), device="cpu", runner=prun)
    assert (got.width, got.height, got.mime) == (want.width, want.height, want.mime)
    assert jex.stats.spatial_batches - j0 == 1 and pex.stats.spatial_batches - p0 == 1
    assert pex.stats.spatial_gathers == g0
    assert len(jseen) == len(pseen) == 1
    for k in ("y", "u", "v"):
        a, b = getattr(pseen[0], k), np.asarray(getattr(jseen[0], k))
        assert a.shape == b.shape
        assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= U8_TOL
