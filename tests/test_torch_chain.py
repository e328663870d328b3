"""The chain runner's identity-shrink skip and its K8 -> K3 fusion, on
the CPU.

A ShrinkBucketSpec whose input already has its output bucket is an
identity copy: `ops/chain.py` drops it from the launches (XLA elides it in
the reference) while plans keep it, so they stay equal to the reference's.
Config 3's /pipeline chain has two such stages, one of them last, so the
stage before it writes the uint8 epilogue. The skipped chain's output is
byte-equal to the chain run stage by stage, and within 1 LSB of the JAX
package's chain on the same plan and input.

A GraySpec whose next live stage is ToYuv420Spec (every colorspace=bw
request with JPEG out on the yuv420 transport) launches nothing: K3 runs
with `luma` and applies K8's luma as it loads. The bw chain then makes one
`rgb_to_yuv420(..., luma=True)` call and no `gray` call, and its planes are
within 1 LSB of the JAX chain's; on the rgb transport and before a
ToDctSpec, `gray` still runs.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from imaginary_tpu import pipeline as jpipeline
from imaginary_tpu.imgtype import ImageType as JImageType
from imaginary_tpu import codecs as jcodecs
from imaginary_tpu.ops import chain as jchain
from imaginary_tpu.ops import plan as jplan
from imaginary_tpu.params import build_params_from_query as jquery
from imaginary_tpu_torch import kernels
from imaginary_tpu_torch import pipeline as ppipeline
from imaginary_tpu_torch.imgtype import ImageType as PImageType
from imaginary_tpu_torch.ops import chain as pchain
from imaginary_tpu_torch.ops import plan as pplan
from imaginary_tpu_torch.ops import stages as S
from imaginary_tpu_torch.ops.buckets import bucket_shape
from imaginary_tpu_torch.params import build_params_from_query as pquery
from tests.conftest import fixture_bytes
from tests.test_torch_plan import assert_same_plan, plan_to_dict
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

U8_TOL = 1
SRC = (270, 480)  # config 3's chain cut to a small PNG (resize to 1/3 of the width)
CONFIG3 = [
    {"operation": "resize", "params": {"width": 160}},
    {"operation": "blur", "params": {"sigma": 1.2}},
    {"operation": "watermark", "params": {"text": "bench", "opacity": 0.5}},
    {"operation": "convert", "params": {"type": "webp"}},
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plans():
    q = {"operations": json.dumps(CONFIG3)}
    jp = jpipeline._build_pipeline_plan(jquery(q), *SRC, 1, 3, JImageType.PNG, None)[0]
    pp = ppipeline._build_pipeline_plan(pquery(q), *SRC, 1, 3, PImageType.PNG)[0]
    return jp, pp


def _frames(n: int) -> list:
    rng = np.random.default_rng(6)
    return [rng.integers(0, 256, size=(*SRC, 3), dtype=np.uint8) for _ in range(n)]


def _counting_gather(monkeypatch) -> list:
    calls = []
    real = kernels.gather

    def gather(x, out_hb, out_wb, *args, **kw):
        calls.append((tuple(x.shape), out_hb, out_wb))
        return real(x, out_hb, out_wb, *args, **kw)

    monkeypatch.setattr(kernels, "gather", gather)
    return calls


def test_config3_plan_keeps_its_identity_shrinks_and_equals_the_reference():
    jp, pp = _plans()
    assert_same_plan(jp, pp)
    names = [type(st.spec).__name__ for st in pp.stages]
    assert names == ["SampleSpec", "BlurSpec", "ShrinkBucketSpec", "CompositeSpec",
                     "ShrinkBucketSpec"]
    assert pchain.live_stages(pp.spec_key(), *bucket_shape(*SRC)) == [0, 1, 3]


@pytest.mark.parametrize("batch", [1, 3])
def test_config3_chain_launches_no_gather_and_keeps_its_output(monkeypatch, batch):
    jp, pp = _plans()
    arrs = _frames(batch)
    calls = _counting_gather(monkeypatch)
    got = pchain.run_batch(arrs, [pp] * batch, device="cpu")
    assert calls == []
    # the same chain with every stage run: byte-equal
    monkeypatch.setattr(pchain, "live_stages", lambda specs, hb, wb: list(range(len(specs))))
    every = pchain.run_batch(arrs, [pp] * batch, device="cpu")
    assert len(calls) == 2  # both shrinks, one launch each
    for a, b in zip(got, every):
        assert a.dtype == np.uint8 and np.array_equal(a, b)
    want = jchain.run_batch(arrs, [jp] * batch)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= U8_TOL


def _apply_all(specs, x, dyns):
    h = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32)
    w = torch.full((x.shape[0],), x.shape[2], dtype=torch.int32)
    return pchain._run_chain(specs, x, h, w, dyns)[0]


def test_a_lone_identity_shrink_returns_its_uint8_input(monkeypatch):
    calls = _counting_gather(monkeypatch)
    x = torch.from_numpy(np.stack(_frames(2))[:, :32, :48].copy())
    y = _apply_all((S.ShrinkBucketSpec(32, 48),), x, [{}])
    assert calls == [] and y.dtype == torch.uint8 and torch.equal(y, x)


def test_a_first_identity_shrink_before_a_stage_that_takes_f32_only_launches():
    # ToYuv420Spec reads f32 only: the shrink casts the uint8 input for it
    specs = (S.ShrinkBucketSpec(32, 48), S.ToYuv420Spec(32, 48))
    assert pchain.live_stages(specs, 32, 48) == [0, 1]
    specs = (S.ShrinkBucketSpec(32, 48), S.FlipSpec())
    assert pchain.live_stages(specs, 32, 48) == [1]


def test_a_last_identity_shrink_after_an_unpack_stage_launches():
    # FromYuv420Spec has no uint8 epilogue, so the shrink keeps ending the chain
    specs = (S.FromYuv420Spec(32, 48), S.ShrinkBucketSpec(32, 48))
    assert pchain.live_stages(specs, 48, 48) == [0, 1]
    specs = (S.FromYuv420Spec(32, 48), S.ShrinkBucketSpec(32, 48), S.ToYuv420Spec(32, 48))
    assert pchain.live_stages(specs, 48, 48) == [0, 2]


def test_a_shrink_that_cuts_the_bucket_launches(monkeypatch):
    calls = _counting_gather(monkeypatch)
    x = torch.from_numpy(np.stack(_frames(1))[:, :40, :64].copy())
    specs = (S.FlipSpec(), S.ShrinkBucketSpec(32, 48))
    assert pchain.live_stages(specs, 40, 64) == [0, 1]
    y = _apply_all(specs, x, [{}, {}])
    assert len(calls) == 1 and tuple(y.shape) == (1, 32, 48, 3) and y.dtype == torch.uint8


# (operation, query, source dims, EXIF orientation): transposes, shrinks
# the planner tightens, and chains with no shape-bearing stage
BUCKET_PLANS = [
    ("resize", {"width": "300", "height": "200"}, (1080, 1920), 1),
    ("thumbnail", {"width": "300", "height": "200"}, (1080, 1920), 1),
    ("crop", {"width": "300", "height": "200"}, (1080, 1920), 1),
    ("rotate", {"rotate": "90"}, (1080, 1920), 1),
    ("rotate", {"rotate": "180"}, (270, 480), 6),
    ("resize", {"width": "120", "height": "90"}, (300, 400), 6),
    ("extract", {"top": "10", "left": "20", "areawidth": "300", "areaheight": "200"},
     (1080, 1920), 1),
    ("enlarge", {"width": "2400", "height": "1400"}, (1080, 1920), 1),
]


@pytest.mark.parametrize("op,query,src,orientation", BUCKET_PLANS,
                         ids=[f"{p[0]}-{p[3]}" for p in BUCKET_PLANS])
def test_the_runner_tracks_the_bucket_as_the_planner_does(op, query, src, orientation):
    """`chain._bucket_after` repeats `plan._final_bucket`'s step: after
    every stage of a plan it is on the bucket the planner tracks there."""
    from imaginary_tpu_torch.ops import plan as pplan

    p = pplan.plan_operation(op, pquery(query), *src, orientation, 3)
    hb, wb = bucket_shape(*src)
    for i, spec in enumerate(p.spec_key()):
        hb, wb = pchain._bucket_after(spec, hb, wb)
        assert (hb, wb) == pplan._final_bucket(p.stages[:i + 1], *src)


BW = {"width": "300", "colorspace": "bw"}


def _recording(monkeypatch) -> list:
    """Record every K8 and K3 wrapper call as (name, luma)."""
    calls = []
    gray, pack = kernels.gray, kernels.rgb_to_yuv420

    def rec_gray(x, out_u8=False, **kw):
        calls.append(("gray", None))
        return gray(x, out_u8, **kw)

    def rec_pack(x, h, w, hb, wb, luma=False, **kw):
        calls.append(("yuv420_pack", luma))
        return pack(x, h, w, hb, wb, luma, **kw)

    monkeypatch.setattr(kernels, "gray", rec_gray)
    monkeypatch.setattr(kernels, "rgb_to_yuv420", rec_pack)
    return calls


def _bw_yuv420_plan(src: bytes, query: dict):
    """The JAX package's colorspace=bw plan on the yuv420 transport, its
    packed input, and the port's copy of the plan."""
    meta = jcodecs.probe_fast(src)
    shrink = jplan.choose_decode_shrink("resize", jquery(query), meta.height, meta.width,
                                        0, 3)
    sh, sw = -(-meta.height // shrink), -(-meta.width // shrink)
    jp = jplan.wrap_plan_yuv420(jplan.plan_operation("resize", jquery(query), sh, sw, 0, 3),
                                sh, sw)
    packed, _, _, _ = jcodecs.decode_yuv420(src, shrink, *bucket_shape(sh, sw))
    return jp, packed, pplan.plan_from_dict(plan_to_dict(jp))


@pytest.mark.parametrize("query", [BW, {"width": "301", "height": "199", "colorspace": "bw"}],
                         ids=["300", "301x199"])
def test_bw_chain_to_jpeg_folds_k8_into_one_k3_launch(monkeypatch, query):
    jp, packed, pp = _bw_yuv420_plan(fixture_bytes("large.jpg"), query)
    names = [type(s).__name__ for s in pp.spec_key()]
    assert names[-2:] == ["GraySpec", "ToYuv420Spec"]
    specs = pp.spec_key()
    steps = pchain.launch_steps(specs, pchain.live_stages(specs, *packed.shape[:2]))
    assert steps[-1] == (len(specs) - 1, True)
    assert all(i != names.index("GraySpec") for i, _ in steps)
    calls = _recording(monkeypatch)
    got = pchain.run_batch([packed], [pp], device="cpu")[0]
    assert calls == [("yuv420_pack", True)]
    want = jchain.run_batch([packed], [jp])[0]
    for k in ("y", "u", "v"):
        g, w = getattr(got, k).astype(int), getattr(want, k).astype(int)
        assert g.shape == w.shape and int(np.abs(g - w).max()) <= U8_TOL


def test_the_fused_step_equals_gray_then_k3(monkeypatch):
    """Byte-equal to the chain with the fusion switched off (every live
    stage its own launch: K8, then K3)."""
    _, packed, pp = _bw_yuv420_plan(fixture_bytes("large.jpg"), BW)
    fused = pchain.run_batch([packed], [pp], device="cpu")[0]
    monkeypatch.setattr(pchain, "launch_steps", lambda specs, run: [(i, False) for i in run])
    calls = _recording(monkeypatch)
    pair = pchain.run_batch([packed], [pp], device="cpu")[0]
    assert calls == [("gray", None), ("yuv420_pack", False)]
    assert all(np.array_equal(getattr(fused, k), getattr(pair, k)) for k in ("y", "u", "v"))


def test_bw_chain_on_the_rgb_transport_still_runs_k8(monkeypatch):
    rng = np.random.default_rng(12)
    src = rng.integers(0, 256, size=(90, 160, 3), dtype=np.uint8)
    pp = pplan.plan_operation("resize", pquery({"width": "80", "colorspace": "bw"}), 90, 160,
                              0, 3)
    assert [type(s).__name__ for s in pp.spec_key()][-1] == "GraySpec"
    calls = _recording(monkeypatch)
    got = pchain.run_batch([src], [pp], device="cpu")[0]
    assert calls == [("gray", None)]
    jp = jplan.plan_operation("resize", jquery({"width": "80", "colorspace": "bw"}), 90, 160,
                              0, 3)
    want = jchain.run_batch([src], [jp])[0]
    assert got.shape == want.shape and int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_gray_before_the_dct_egress_keeps_its_launch(monkeypatch):
    """K12 is not fused with K8: GraySpec -> ToDctSpec stays two launches."""
    specs = (S.GraySpec(), S.ToDctSpec(16, 16))
    assert pchain.launch_steps(specs, [0, 1]) == [(0, False), (1, False)]
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.uniform(0, 255, (1, 16, 16, 3)).astype(np.float32))
    q = torch.ones((1, 8, 8))
    calls = _recording(monkeypatch)
    y = _apply_all(specs, x, [{}, {"qy": q, "qc": q}])
    assert calls == [("gray", None)] and y.dtype == torch.int16


def test_a_fusion_never_crosses_the_spatial_gather(monkeypatch):
    """On the spatial route K1 and K8 run W-sharded and K3, which shards
    only at an even local width (3 columns a shard here), runs after the
    gather as a run of its own: the eight shards' K8 launches stay and K3
    launches plain. The output equals the unsharded chain's, where K8
    folds into K3."""
    from imaginary_tpu_torch.ops.plan import ImagePlan, StageInstance

    specs = (S.SampleSpec(32, 24), S.GraySpec(), S.ToYuv420Spec(32, 24))
    assert pchain.launch_steps(specs, [2]) == [(2, False)]
    assert pchain.launch_steps(specs, [1, 2]) == [(2, True)]
    dyn = {"dst_h": np.float32(30), "dst_w": np.float32(23)}
    plan = ImagePlan(stages=[StageInstance(specs[0], dyn), StageInstance(specs[1], {}),
                             StageInstance(specs[2], {})], out_h=30, out_w=23)
    arr = np.random.default_rng(14).integers(0, 256, size=(60, 46, 3), dtype=np.uint8)
    assert pchain.spatial_split(specs, *bucket_shape(60, 46), 8) == ([0, 1], 2)
    calls = _recording(monkeypatch)
    y = pchain.launch_spatial(arr, plan, ["cpu"] * 8)
    got = pchain.fetch_batch(y, [arr], [plan])[0]
    assert y.gathered == "ToYuv420Spec"
    assert calls == [("gray", None)] * 8 + [("yuv420_pack", False)]
    calls.clear()
    want = pchain.run_batch([arr], [plan], device="cpu")[0]
    assert calls == [("yuv420_pack", True)]
    assert got.dtype == np.uint8 and np.array_equal(got, want)
