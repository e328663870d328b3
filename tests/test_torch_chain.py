"""The chain runner's identity-shrink skip, on the CPU.

A ShrinkBucketSpec whose input already has its output bucket is an
identity copy: `ops/chain.py` drops it from the launches (XLA elides it in
the reference) while plans keep it, so they stay equal to the reference's.
Config 3's /pipeline chain has two such stages, one of them last, so the
stage before it writes the uint8 epilogue. The skipped chain's output is
byte-equal to the chain run stage by stage, and within 1 LSB of the JAX
package's chain on the same plan and input.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from imaginary_tpu import pipeline as jpipeline
from imaginary_tpu.imgtype import ImageType as JImageType
from imaginary_tpu.ops import chain as jchain
from imaginary_tpu.params import build_params_from_query as jquery
from imaginary_tpu_torch import kernels
from imaginary_tpu_torch import pipeline as ppipeline
from imaginary_tpu_torch.imgtype import ImageType as PImageType
from imaginary_tpu_torch.ops import chain as pchain
from imaginary_tpu_torch.ops import stages as S
from imaginary_tpu_torch.ops.buckets import bucket_shape
from imaginary_tpu_torch.params import build_params_from_query as pquery
from tests.test_torch_plan import assert_same_plan

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
