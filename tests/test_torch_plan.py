"""The port's planner held against the JAX package's planner.

Both planners see the same request (options built the same way as
tests/gen_goldens.py builds them) and must emit the same chain: spec class
names and fields, dyn arrays (values and dtypes), out_h/out_w and, for the
packed transport, the buckets. `plan_from_dict` must carry a reference
plan into the port unchanged.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import pytest
import torch

from imaginary_tpu.options import ImageOptions as JOptions
from imaginary_tpu.ops import plan as jplan
from imaginary_tpu.params import build_params_from_query as jquery
from imaginary_tpu_torch.options import ImageOptions as POptions
from imaginary_tpu_torch.ops import plan as pplan
from imaginary_tpu_torch.params import build_params_from_query as pquery
from tests.gen_goldens import MATRIX, PIPELINES, SMARTCROP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plan_to_dict(plan) -> dict:
    """Plain description of a plan (the input `plan_from_dict` takes)."""
    stages = []
    for st in plan.stages:
        fields = {}
        for f in dataclasses.fields(st.spec):
            v = getattr(st.spec, f.name)
            fields[f.name] = v.value if isinstance(v, enum.Enum) else v
        stages.append({"spec": type(st.spec).__name__, "fields": fields,
                       "dyn": {k: np.asarray(v) for k, v in st.dyn.items()}})
    d = {k: getattr(plan, k) for k in (
        "out_h", "out_w", "transport", "in_bucket", "in_h", "in_w",
        "out_bucket", "frame_key", "egress", "egress_quality")}
    d["stages"] = stages
    return d


def assert_same_plan(jp, pp):
    dj, dp = plan_to_dict(jp), plan_to_dict(pp)
    sj, sp = dj.pop("stages"), dp.pop("stages")
    assert dj == dp
    assert [s["spec"] for s in sj] == [s["spec"] for s in sp]
    for a, b in zip(sj, sp):
        assert a["fields"] == b["fields"], a["spec"]
        assert a["dyn"].keys() == b["dyn"].keys(), a["spec"]
        for k in a["dyn"]:
            assert a["dyn"][k].dtype == b["dyn"][k].dtype, (a["spec"], k)
            assert np.array_equal(a["dyn"][k], b["dyn"][k]), (a["spec"], k)


def _options(cls, kw):
    o = cls(**kw)
    for k in kw:
        o.mark_defined(k)
    return o


CASES = [(name, op, kw) for name, op, kw, _ in MATRIX] + [SMARTCROP[:3]]
# the src dims of the reference matrix fixture, and the main path's source
# at full size and at the shrink-on-load size it decodes to
SOURCES = [(740, 550), (1080, 1920), (270, 480)]


@pytest.mark.parametrize("src", SOURCES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("name,op,kw", CASES, ids=[c[0] for c in CASES])
def test_plan_operation_matches_reference(name, op, kw, src):
    jp = jplan.plan_operation(op, _options(JOptions, kw), *src, 0, 3)
    pp = pplan.plan_operation(op, _options(POptions, kw), *src, 0, 3)
    assert_same_plan(jp, pp)
    assert (pp.out_h, pp.out_w) == (jp.out_h, jp.out_w)
    if jp.stages:
        assert_same_plan(jplan.wrap_plan_yuv420(jp, *src),
                         pplan.wrap_plan_yuv420(pp, *src))


MAIN_QUERIES = [
    ("resize", {"width": "300", "height": "200"}),
    ("crop", {"width": "300", "height": "200"}),
    ("resize", {"width": "300"}),
    ("crop", {"width": "640", "height": "640", "gravity": "north"}),
    ("resize", {"width": "300", "height": "200", "extend": "mirror", "embed": "true"}),
    ("resize", {"width": "300", "height": "200", "extend": "white"}),
]


@pytest.mark.parametrize("op,query", MAIN_QUERIES,
                         ids=[f"{op}-{'-'.join(q.values())}" for op, q in MAIN_QUERIES])
@pytest.mark.parametrize("orientation", [0, 6])
def test_query_plans_and_shrink_match_reference(op, query, orientation):
    """The main path as the handler plans it: query -> options -> shrink
    choice on the 1920x1080 source -> plan at the shrunk dims -> packed
    transport wrap."""
    jo, po = jquery(query), pquery(query)
    js = jplan.choose_decode_shrink(op, jo, 1080, 1920, orientation, 3)
    ps = pplan.choose_decode_shrink(op, po, 1080, 1920, orientation, 3)
    assert js == ps
    sh, sw = -(-1080 // js), -(-1920 // js)
    jp = jplan.plan_operation(op, jo, sh, sw, orientation, 3)
    pp = pplan.plan_operation(op, po, sh, sw, orientation, 3)
    assert_same_plan(jplan.wrap_plan_yuv420(jp, sh, sw), pplan.wrap_plan_yuv420(pp, sh, sw))


EXIF_QUERIES = [
    ("resize", {"width": "120", "height": "90"}),
    ("autorotate", {}),
    ("rotate", {"rotate": "90"}),
]


@pytest.mark.parametrize("op,query", EXIF_QUERIES,
                         ids=[f"{op}-{'-'.join(q.values()) or 'plain'}" for op, q in EXIF_QUERIES])
@pytest.mark.parametrize("orientation", range(2, 9))
def test_exif_orientation_plans_match_reference(op, query, orientation):
    """EXIF orientations 2-8 become Flip/Flop/Transpose stages ahead of the
    operation; after a transpose the packed wrap's output bucket is the
    swapped one (`_final_bucket`). Source: the 400x300 EXIF fixture's
    dims, at the shrink each planner picks."""
    jo, po = jquery(query), pquery(query)
    js = jplan.choose_decode_shrink(op, jo, 300, 400, orientation, 3)
    assert pplan.choose_decode_shrink(op, po, 300, 400, orientation, 3) == js
    sh, sw = -(-300 // js), -(-400 // js)
    jp = jplan.plan_operation(op, jo, sh, sw, orientation, 3)
    pp = pplan.plan_operation(op, po, sh, sw, orientation, 3)
    assert_same_plan(jplan.wrap_plan_yuv420(jp, sh, sw), pplan.wrap_plan_yuv420(pp, sh, sw))


def test_rotate_90_chain_is_the_documented_one():
    """Config 2's /rotate runs at full 1080p (rotate never shrinks on
    load): K2 -> Transpose -> Flop -> a real bucket shrink -> K3."""
    o = pquery({"rotate": "90"})
    assert pplan.choose_decode_shrink("rotate", o, 1080, 1920, 0, 3) == 1
    p = pplan.wrap_plan_yuv420(pplan.plan_operation("rotate", o, 1080, 1920, 0, 3), 1080, 1920)
    names = [type(s.spec).__name__ for s in p.stages]
    assert names == ["FromYuv420Spec", "TransposeSpec", "FlopSpec", "ShrinkBucketSpec",
                     "ToYuv420Spec"]
    assert p.in_bucket == (1728, 2048) and p.out_bucket == (1920, 1088)
    assert (p.out_h, p.out_w) == (1920, 1080)


def test_main_path_chain_is_the_documented_one():
    o = pquery({"width": "300", "height": "200"})
    assert pplan.choose_decode_shrink("resize", o, 1080, 1920, 0, 3) == 4
    p = pplan.wrap_plan_yuv420(pplan.plan_operation("resize", o, 270, 480, 0, 3), 270, 480)
    names = [type(s.spec).__name__ for s in p.stages]
    assert names == ["FromYuv420Spec", "SampleSpec", "EmbedSpec", "ToYuv420Spec"]
    assert p.in_bucket == (480, 512) and p.out_bucket == (208, 304)
    assert p.stages[1].spec == pplan.SampleSpec(192, 320, "lanczos3")
    assert (float(p.stages[1].dyn["dst_h"]), float(p.stages[1].dyn["dst_w"])) == (169.0, 300.0)
    assert int(p.stages[2].dyn["off_y"]) == 15


@pytest.mark.parametrize("pname,ops", [(p[0], p[1]) for p in PIPELINES],
                         ids=[p[0] for p in PIPELINES])
def test_fuse_adjacent_shrinking_samples_matches_reference(pname, ops):
    """Per-op plans concatenated (each op planned on the previous op's
    output dims), then fused, on both sides."""
    jstages, pstages = [], []
    cur = (740, 550)
    for op in ops:
        q = {k: str(v) for k, v in op["params"].items()}
        jp = jplan.plan_operation(op["operation"], jquery(q), *cur, 0, 3)
        pp = pplan.plan_operation(op["operation"], pquery(q), *cur, 0, 3)
        jstages += jp.stages
        pstages += pp.stages
        cur = (jp.out_h, jp.out_w)
    jf = jplan.fuse_adjacent_shrinking_samples(jstages, 740, 550)
    pf = pplan.fuse_adjacent_shrinking_samples(pstages, 740, 550)
    assert_same_plan(jplan.ImagePlan(jf, *cur), pplan.ImagePlan(pf, *cur))


@pytest.mark.parametrize("op,query", MAIN_QUERIES[:2], ids=["resize", "crop"])
def test_plan_from_dict_round_trips_a_reference_plan(op, query):
    jp = jplan.wrap_plan_yuv420(jplan.plan_operation(op, jquery(query), 270, 480, 0, 3), 270, 480)
    pp = pplan.plan_from_dict(plan_to_dict(jp))
    assert isinstance(pp, pplan.ImagePlan)
    assert all(type(s.spec).__module__ == "imaginary_tpu_torch.ops.stages" for s in pp.stages)
    assert_same_plan(jp, pp)
    own = pplan.wrap_plan_yuv420(pplan.plan_operation(op, pquery(query), 270, 480, 0, 3), 270, 480)
    assert pp.spec_key() == own.spec_key()


def test_plan_from_dict_carries_enums_and_rejects_unknown_specs():
    jp = jplan.plan_operation("resize", jquery({"width": "300", "height": "200",
                                                "extend": "mirror"}), 270, 480, 0, 3)
    pp = pplan.plan_from_dict(plan_to_dict(jp))
    embed = [s.spec for s in pp.stages if type(s.spec).__name__ == "EmbedSpec"]
    assert embed and embed[0].mode is pplan.Extend.MIRROR
    d = plan_to_dict(jp)
    d["stages"][0]["spec"] = "NoSuchSpec"
    with pytest.raises(ValueError, match="NoSuchSpec"):
        pplan.plan_from_dict(d)


def test_planner_errors_match_reference():
    from imaginary_tpu.errors import ImageError as JErr
    from imaginary_tpu_torch.errors import ImageError as PErr

    for op, q in (("resize", {}), ("crop", {}), ("nope", {"width": "3"})):
        with pytest.raises(JErr) as je:
            jplan.plan_operation(op, jquery(q), 100, 100, 0, 3)
        with pytest.raises(PErr) as pe:
            pplan.plan_operation(op, pquery(q), 100, 100, 0, 3)
        assert (pe.value.message, pe.value.code) == (je.value.message, je.value.code)
