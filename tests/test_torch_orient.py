"""K5's composed orientation and the chain runner's orientation fold, on
the CPU.

K5 runs any run of consecutive flip, flop and transpose stages as one
launch of their composed mode (kernels/csrc/orient.cu, `kernels.orient_run`).
Its plain version (`reference.orient_run`) computes the composed index map
directly; here it is held against the JAX package's stages applied one by
one (`FlipSpec`, `FlopSpec`, `TransposeSpec`, jitted as its chain runs
them) on every orientation sequence the planner emits (/rotate at 90, 180
and 270, EXIF orientations 2-8) and on flip, flop, flip and flip, flip
(the copy), exactly: the
kernel moves data only. Three images of different valid dims share a
bucket that is no multiple of any of the kernel's tiles, at C = 1, 3 and
4, f32 and uint8 in and out.

The one-device runner (`ops/chain._run_steps`) launches each such run as
one `orient_run` (`chain.orient_runs`), a run of one stage too:
`run_batch(device="cpu")` on /rotate and on EXIF 2-8 over the rgb and
yuv420 transports makes one orientation call a run, is within 1 LSB of
the JAX package's `run_batch`, and is byte-equal to the same chain with
each run's stages launched one by one through `kernels.orient` (the chain
before the fold). The spatial route's
sharded stages do not fold: a rotate=90 plan over W-shards still launches
the transpose's and the flop's forms on every shard.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginary_tpu import codecs as jcodecs
from imaginary_tpu.ops import chain as jchain
from imaginary_tpu.ops import plan as jplan
from imaginary_tpu.ops import stages as jst
from imaginary_tpu.params import build_params_from_query as jquery
from imaginary_tpu_torch import kernels
from imaginary_tpu_torch.engine.timing import WIRE
from imaginary_tpu_torch.kernels import reference
from imaginary_tpu_torch.ops import chain as pchain
from imaginary_tpu_torch.ops import plan as pplan
from imaginary_tpu_torch.ops import stages as pst
from imaginary_tpu_torch.ops.buckets import bucket_shape
from imaginary_tpu_torch.params import build_params_from_query as pquery
from tests.conftest import fixture_bytes
from tests.test_torch_plan import plan_to_dict
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

U8_TOL = 1

# The planner's orientation sequences (imaginary_tpu/ops/plan.py:296-340),
# and a /pipeline's flip, flop, flip and flip, flip, each with the one
# mode (t, fy, fx) K5 launches for it: all eight symmetries of the square
SEQUENCES = {
    "rotate90": (("transpose", "flop"), (1, 0, 1)),
    "rotate180": (("flip", "flop"), (0, 1, 1)),
    "rotate270": (("transpose", "flip"), (1, 1, 0)),
    "exif2": (("flop",), (0, 0, 1)),
    "exif3": (("flip", "flop"), (0, 1, 1)),
    "exif4": (("flip",), (0, 1, 0)),
    "exif5": (("transpose",), (1, 0, 0)),
    "exif6": (("transpose", "flop"), (1, 0, 1)),
    "exif7": (("transpose", "flip", "flop"), (1, 1, 1)),
    "exif8": (("transpose", "flip"), (1, 1, 0)),
    "flip-flop-flip": (("flip", "flop", "flip"), (0, 0, 1)),
    "flip-flip": (("flip", "flip"), (0, 0, 0)),
}
JSPECS = {"flip": jst.FlipSpec(), "flop": jst.FlopSpec(), "transpose": jst.TransposeSpec()}
IO = [("f32", "f32"), ("u8", "f32"), ("f32", "u8"), ("u8", "u8")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.partial(jax.jit, static_argnums=0)
def _japply(spec, x, h, w, dyn):
    """The reference stage as the reference runs it: jitted (chain.py)."""
    return spec.apply(x, h, w, dyn)


def _jax_run(names, x, h, w, out_u8: bool):
    for name in names:
        x, h, w = _japply(JSPECS[name], x, h, w, {})
    x = np.asarray(x)
    return np.asarray(jnp.clip(x + 0.5, 0.0, 255.0).astype(jnp.uint8)) if out_u8 else x


@pytest.mark.parametrize("io", IO, ids=[f"{a}-{b}" for a, b in IO])
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("seq", list(SEQUENCES), ids=list(SEQUENCES))
def test_composed_map_equals_the_jax_stages_in_sequence(seq, c, io):
    """A bucket of 37 x 67 (no multiple of the 32 x 64 tiles or the 2048
    elements of a row segment): one image fills it, one leaves padding rows
    and columns, one is a single row by two columns."""
    names = SEQUENCES[seq][0]
    rng = np.random.default_rng(40 + c)
    if io[0] == "u8":
        x = rng.integers(0, 256, size=(3, 37, 67, c), dtype=np.uint8)
    else:
        x = rng.uniform(0.0, 255.0, size=(3, 37, 67, c)).astype(np.float32)
    h = np.array([37, 30, 1], dtype=np.int32)
    w = np.array([67, 51, 2], dtype=np.int32)
    out_u8 = io[1] == "u8"
    want = _jax_run(names, x.astype(np.float32), h, w, out_u8)
    got = kernels.orient_run(torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(w),
                             names, out_u8)
    assert got.dtype == (torch.uint8 if out_u8 else torch.float32)
    assert tuple(got.shape) == want.shape and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seq", list(SEQUENCES), ids=list(SEQUENCES))
def test_composed_mode_is_the_stages_folded(seq):
    """A flip toggles fy, a flop fx, a transpose t with fy and fx swapped
    (orient.cu); an unknown stage name is refused."""
    names, mode = SEQUENCES[seq]
    assert reference.compose_orient(names) == mode
    with pytest.raises(ValueError, match="orient mode"):
        reference.compose_orient(names + ("rotate",))


# (case, operation, query, EXIF orientation)
RUNS = ([(f"rotate{a}", "rotate", {"rotate": str(a)}, 1) for a in (90, 180, 270)]
        + [(f"exif{o}", "resize", {"width": "120"}, o) for o in range(2, 9)])


def _recording(monkeypatch) -> list:
    """Record every K5 wrapper call: ("orient", mode) or ("orient_run", names)."""
    calls = []
    orient, run = kernels.orient, kernels.orient_run

    def rec_orient(x, h, w, mode, *a, **kw):
        calls.append(("orient", mode))
        return orient(x, h, w, mode, *a, **kw)

    def rec_run(x, h, w, names, *a, **kw):
        calls.append(("orient_run", tuple(names)))
        return run(x, h, w, names, *a, **kw)

    monkeypatch.setattr(kernels, "orient", rec_orient)
    monkeypatch.setattr(kernels, "orient_run", rec_run)
    return calls


def _stage_by_stage(x, h, w, names, out_u8=False, out=None):
    """`kernels.orient_run` as the run's stages, one `kernels.orient` each."""
    for k, name in enumerate(names):
        last = k == len(names) - 1
        x = kernels.orient(x, h, w, name, out_u8 and last,
                           **({"out": out} if last and out is not None else {}))
        if name == "transpose":
            h, w = w, h
    return x


def _orient_names(plan) -> tuple:
    return tuple(pst.ORIENT_STAGES[type(s)] for s in plan.spec_key()
                 if type(s) in pst.ORIENT_STAGES)


def _rgb_case(op, query, orientation):
    arr = np.random.default_rng(orientation + 3).integers(0, 256, (151, 423, 3), dtype=np.uint8)
    jp = jplan.plan_operation(op, jquery(query), 151, 423, orientation, 3)
    pp = pplan.plan_operation(op, pquery(query), 151, 423, orientation, 3)
    return arr, jp, pp


def _yuv420_case(op, query, orientation):
    """imaginary.jpg (550 x 740) on the yuv420 transport: the JAX package's
    plan, its packed input, and the port's copy of the plan."""
    src = fixture_bytes("imaginary.jpg")
    meta = jcodecs.probe_fast(src)
    shrink = jplan.choose_decode_shrink(op, jquery(query), meta.height, meta.width,
                                        orientation, 3)
    sh, sw = -(-meta.height // shrink), -(-meta.width // shrink)
    jp = jplan.wrap_plan_yuv420(jplan.plan_operation(op, jquery(query), sh, sw, orientation, 3),
                                sh, sw)
    packed, _, _, _ = jcodecs.decode_yuv420(src, shrink, *bucket_shape(sh, sw))
    return packed, jp, pplan.plan_from_dict(plan_to_dict(jp))


def _close(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and int(np.abs(a.astype(int) - b.astype(int)).max()) <= U8_TOL
    return all(_close(getattr(a, k), getattr(b, k)) for k in ("y", "u", "v"))


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in ("y", "u", "v"))


@pytest.mark.parametrize("transport", ["rgb", "yuv420"])
@pytest.mark.parametrize("case,op,query,orientation", RUNS, ids=[r[0] for r in RUNS])
def test_runner_folds_each_run_into_one_launch(monkeypatch, case, op, query, orientation,
                                               transport):
    arr, jp, pp = (_rgb_case if transport == "rgb" else _yuv420_case)(op, query, orientation)
    names = _orient_names(pp)
    assert names == SEQUENCES[case][0]
    calls = _recording(monkeypatch)
    got = pchain.run_batch([arr, arr], [pp, pp], device="cpu")
    assert calls == [("orient_run", names)]
    want = jchain.run_batch([arr, arr], [jp, jp])
    assert all(_close(a, b) for a, b in zip(got, want))
    calls.clear()
    monkeypatch.setattr(kernels, "orient_run", _stage_by_stage)
    every = pchain.run_batch([arr, arr], [pp, pp], device="cpu")
    assert calls == [("orient", n) for n in names]
    assert all(_equal(a, b) for a, b in zip(got, every))


def test_a_chain_that_is_one_run_launches_once_and_is_not_donated(monkeypatch):
    """EXIF 3's flip, flop as the whole chain on the rgb transport: one
    launch after the fold, so the launch reads the staged batch region and
    must not write it (the donation's two-launch rule counts launches)."""
    pchain.set_donation(True)
    arr = np.random.default_rng(9).integers(0, 256, (40, 70, 3), dtype=np.uint8)
    pp = pplan.ImagePlan(stages=[pplan.StageInstance(pst.FlipSpec(), {}),
                                 pplan.StageInstance(pst.FlopSpec(), {})], out_h=40, out_w=70)
    calls = _recording(monkeypatch)
    before = pchain.donation_stats()["donated"]
    got = pchain.run_batch([arr], [pp], device="cpu")[0]
    assert calls == [("orient_run", ("flip", "flop"))]
    assert pchain.donation_stats()["donated"] == before
    assert np.array_equal(got, arr[::-1, ::-1])


def test_a_folded_last_launch_donates_into_the_batch_region(monkeypatch):
    """/rotate?rotate=90 on the yuv420 transport ends K2 -> K5 -> ... ->
    K3; a chain that ends in the run (a rotate of a PNG whose bucket the
    rotation keeps) donates its folded launch's output like the stage's."""
    pchain.set_donation(True)
    arr = np.random.default_rng(10).integers(0, 256, (48, 48, 3), dtype=np.uint8)
    specs = (pst.SampleSpec(48, 48), pst.TransposeSpec(), pst.FlopSpec())
    dyn = {"dst_h": np.float32(48), "dst_w": np.float32(48)}
    plan = pplan.ImagePlan(stages=[pplan.StageInstance(specs[0], dyn),
                                   pplan.StageInstance(specs[1], {}),
                                   pplan.StageInstance(specs[2], {})], out_h=48, out_w=48)
    calls = _recording(monkeypatch)
    before = pchain.donation_stats()["donated"]
    got = pchain.run_batch([arr], [plan], device="cpu")[0]
    assert calls == [("orient_run", ("transpose", "flop"))]
    assert pchain.donation_stats()["donated"] == before + 1
    pchain.set_donation(False)
    try:
        want = pchain.run_batch([arr], [plan], device="cpu")[0]
    finally:
        pchain.set_donation(True)
    assert np.array_equal(got, want)


@pytest.fixture
def fresh_wire():
    """The spatial launches book WIRE by device; leave the process-wide
    ledger as the next test file expects it (unlabelled)."""
    WIRE.reset()
    yield
    WIRE.reset()


@pytest.mark.parametrize("n", [2, 4])
def test_the_spatial_route_launches_one_form_a_stage(monkeypatch, fresh_wire, n):
    """rotate=90 over n W-shards: the transpose's and the flop's forms run
    on every shard (no orient_run), and the output equals the unsharded,
    folded chain's."""
    arr = np.random.default_rng(11 + n).integers(0, 256, (151, 423, 3), dtype=np.uint8)
    plan = pplan.plan_operation("rotate", pquery({"rotate": "90"}), 151, 423, 1, 3)
    calls = _recording(monkeypatch)
    flops = []
    flop_shard = kernels.flop_shard

    def rec_flop_shard(*a, **kw):
        flops.append(a[3])
        return flop_shard(*a, **kw)

    monkeypatch.setattr(kernels, "flop_shard", rec_flop_shard)
    y = pchain.launch_spatial(arr, plan, [torch.device("cpu")] * n)
    got = pchain.fetch_batch(y, [arr], [plan])[0]
    assert y.gathered is None and y.shards == n
    assert calls == [("orient", "transpose")] * n and len(flops) == n
    calls.clear()
    want = pchain.run_batch([arr], [plan], device="cpu")[0]
    assert calls == [("orient_run", ("transpose", "flop"))]
    assert np.array_equal(got, want)
