"""The port's spatial route on the DCT transport (`--transport-dct`) on the CPU.

A dct chain starts with K11 (FromDctSpec) and ends with K12 (ToDctSpec,
with `--transport-dct-egress`) or K3 (ToYuv420Spec). With K11's and K12's
W-shard forms every such chain runs W-sharded end to end
(`ops/chain.launch_spatial`):

  * `spatial_split` on the plans of a 3840x2160 JPEG of each layout (k =
    8: /resize?width=1920, /crop, /rotate?rotate=90, /flop, /smartcrop)
    and of an 8000x6000 one (k = 4: /resize?width=3000), egress on and
    off, at n = 2 and 4: no gather;
  * every layout at each k it takes, /resize, /crop, /rotate 90, /flop,
    /smartcrop and a filled embed, egress on and off, bit-equal to the
    unsharded chain on 150x420 and 151x423 JPEGs, padding included;
  * each form at `chip_smoke.DCT_SHARD_SEAM_CASES`: the shards of the
    plain version equal to the whole plain version's columns (K11 with
    its halo blocks picked by clamped index, K12's straddling MCUs);
  * an executor over four cpu entries with spatial=4: no gather on the
    dct chains, and a K11 shard off its MCU width gathered and counted;
  * a spatial launch never takes the device frame tier, as the JAX
    package's chain takes it only without a sharding.

The JAX executor's spatial route on the same JPEG bytes is in
`tests/test_torch_spatial_dct_jax.py`.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from imaginary_tpu_torch import kernels
from imaginary_tpu_torch import pipeline as ppipeline
from imaginary_tpu_torch.cache import CacheSet, DeviceFrameCache
from imaginary_tpu_torch.engine import Executor, ExecutorConfig
from imaginary_tpu_torch.kernels import reference
from imaginary_tpu_torch.ops import chain
from imaginary_tpu_torch.ops.plan import choose_decode_shrink, plan_operation, wrap_plan_dct
from imaginary_tpu_torch.ops.stages import FromDctSpec, ToDctSpec, ToYuv420Spec
from imaginary_tpu_torch.params import build_params_from_query as pquery

WAIT_S = 120
CPU = torch.device("cpu")
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
    ppipeline.set_transport_dct(False)
    ppipeline.set_transport_dct_egress(False)
    chain.set_device_frame_cache(None)


def dct_jpeg(layout: str, h: int, w: int, seed: int = 0) -> bytes:
    """A seeded JPEG of the layout: a gradient under noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    (xx + yy) % 256], axis=-1)
    img = np.clip(img + rng.integers(-40, 41, img.shape), 0, 255).astype(np.uint8)
    out = io.BytesIO()
    im = Image.fromarray(img)
    if layout == "gray":
        im.convert("L").save(out, "JPEG", quality=90)
    else:
        im.save(out, "JPEG", quality=90, subsampling={"444": 0, "422": 1, "420": 2}[layout])
    return out.getvalue()


def same(a, b) -> bool:
    """Two fetched dct outputs (YuvPlanes or QuantizedBlocks) equal."""
    return type(a) is type(b) and all(np.array_equal(getattr(a, k), getattr(b, k))
                                      for k in ("y", "u", "v"))


def _names(plan) -> list:
    return [type(s).__name__ for s in plan.spec_key()]


# -- the 3840x2160 and 8000x6000 JPEGs' plans: no gather ----------------------------

def _geometry_plan(h: int, w: int, layout: str, op: str, query: dict, egress: bool):
    """The dct plan `pipeline._process_dct` builds for an h x w JPEG of the
    layout (orientation 1), from its geometry alone."""
    o = pquery(query)
    shrink = choose_decode_shrink(op, o, h, w, 1, 3)
    sh, sw = -(-h // shrink), -(-w // shrink)
    p = plan_operation(op, o, sh, sw, 1, 3)
    return wrap_plan_dct(p, h, w, shrink, layout=layout, egress="dct" if egress else "",
                         egress_quality=80)


BIG_ROUTES = [
    ("resize", 2160, 3840, "resize", {"width": "1920"}, 8),
    ("crop", 2160, 3840, "crop", chip_smoke.SPATIAL_CROP, 8),
    ("rotate90", 2160, 3840, "rotate", {"rotate": "90"}, 8),
    ("flop", 2160, 3840, "flop", {}, 8),
    ("smartcrop", 2160, 3840, "smartcrop", chip_smoke.SPATIAL_SMART, 8),
    ("48mp-resize", 6000, 8000, "resize", {"width": "3000"}, 4),
]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("egress", [False, True], ids=["egress-off", "egress-on"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name,h,w,op,query,k", BIG_ROUTES, ids=[r[0] for r in BIG_ROUTES])
def test_big_dct_chains_shard_end_to_end(name, h, w, op, query, k, layout, egress, n):
    plan = _geometry_plan(h, w, layout, op, query, egress)
    specs = plan.spec_key()
    names = _names(plan)
    assert names[0] == "FromDctSpec" and specs[0].k == k
    assert names[-1] == ("ToDctSpec" if egress else "ToYuv420Spec")
    sharded, gather_at = chain.spatial_split(specs, *plan.in_bucket, n)
    assert gather_at is None
    assert sharded == chain.live_stages(specs, *plan.in_bucket)


def test_4k_and_48mp_plans():
    """A 4K /resize?width=1920 plans FromDctSpec(2560, 4096, k=8) ->
    SampleSpec -> ToDctSpec(1088, 1920); a 48 MP photo at
    /resize?width=3000 decodes at shrink 2: FromDctSpec(3072, 4096, k=4)."""
    p = _geometry_plan(2160, 3840, "420", "resize", {"width": "1920"}, True)
    assert p.spec_key()[0] == FromDctSpec(2560, 4096, 8, "420")
    assert p.spec_key()[-1] == ToDctSpec(1088, 1920)
    assert _names(p) == ["FromDctSpec", "SampleSpec", "ToDctSpec"]
    p = _geometry_plan(6000, 8000, "420", "resize", {"width": "3000"}, True)
    assert p.spec_key()[0] == FromDctSpec(3072, 4096, 4, "420")


# -- bit-equal to the unsharded chain -----------------------------------------------

# (name, op, query, k on a 150x420 JPEG)
ROUTES = [
    ("resize-k8", "resize", {"width": "400"}, 8),
    ("resize-k4", "resize", {"width": "120"}, 4),
    ("resize-k2", "resize", {"width": "80"}, 2),
    # 50x32: a width alone leaves 18 rows, whose egress bucket (24) K12
    # refuses in both packages (not a multiple of 16)
    ("resize-k1", "resize", {"width": "50", "height": "32"}, 1),
    ("crop", "crop", {"width": "100", "height": "100"}, 8),
    ("rotate90", "rotate", {"rotate": "90"}, 8),
    ("flop", "flop", {}, 8),
    ("smartcrop", "smartcrop", {"width": "100", "height": "100"}, 8),
    ("embed-fill", "resize", {"width": "400", "height": "300", "extend": "white"}, 8),
]


def _spatial(arr, plan, n, trace=None):
    y = chain.launch_spatial(arr, plan, [CPU] * n, trace=trace)
    return chain.fetch_batch(y, [arr], [plan])[0], y


def _unsharded(arr, plan):
    return chain.run_batch([arr], [plan], device="cpu")[0]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("egress", [False, True], ids=["egress-off", "egress-on"])
@pytest.mark.parametrize("dims", [(150, 420), (151, 423)], ids=["150x420", "151x423"])
@pytest.mark.parametrize("name,op,query,k", ROUTES, ids=[r[0] for r in ROUTES])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_dct_chain_is_bit_equal_to_the_unsharded_chain(layout, name, op, query, k, dims,
                                                       egress, n):
    buf = dct_jpeg(layout, *dims, seed=n + len(name))
    plan, arr, _ = chip_smoke.dct_request_plan(buf, op, query, egress)
    first = plan.spec_key()[0]
    assert isinstance(first, FromDctSpec) and (first.k, first.layout) == (k, layout)
    got, y = _spatial(arr, plan, n)
    assert y.gathered is None and y.shards == n
    want = _unsharded(arr, plan)
    assert type(got).__name__ == ("QuantizedBlocks" if egress else "YuvPlanes")
    assert same(got, want)


def test_trace_holds_k11_and_k12_shards_against_their_plain_versions():
    """The 4:2:0 /resize at k = 8 with the egress: K11, K1 and K12 on each
    shard; K11 with its two halo blocks, K12 over a window of whole MCUs;
    each launch equal to its plain version on its own arguments."""
    buf = dct_jpeg("420", 151, 423, seed=5)
    plan, arr, _ = chip_smoke.dct_request_plan(buf, "resize", {"width": "400"}, True)
    trace = []
    got, y = _spatial(arr, plan, 4, trace)
    assert same(got, _unsharded(arr, plan))
    names = [type(spec).__name__ for _, _, spec, _, _ in trace]
    assert names == [n for n in ("FromDctSpec", "SampleSpec", "ToDctSpec") for _ in range(4)]
    k12 = max(i for i, _, spec, _, _ in trace if isinstance(spec, ToDctSpec))
    for _, j, spec, args, out in trace:
        if isinstance(spec, FromDctSpec):
            assert args[1].shape[2] == args[2].shape[2] == 16
        if isinstance(spec, ToDctSpec):
            k0, k1, _ = y.windows[k12][j]
            assert k0 % 16 == 0 or k0 == int(args[4][0]) - 1
            assert args[0].shape[2] == k1 - k0 and out.dtype == torch.int16
        assert torch.equal(out, spec.apply_shard(*args, impl=reference)[0])


# -- each form at its seams ---------------------------------------------------------

SEAMS = chip_smoke.DCT_SHARD_SEAM_CASES


@pytest.mark.parametrize("case", SEAMS, ids=[f"{c[0]}-{c[1]}" for c in SEAMS])
def test_shard_form_equals_the_whole_plain_versions_columns(case):
    kernel, name, _, _, (hb, wb), hw, n = case
    whole_args, shards = chip_smoke.dct_shard_inputs(case, np.random.default_rng(len(name)),
                                                     CPU)
    lw = wb // n
    if kernel == "from_dct":
        whole = kernels.from_dct(*whole_args)
        for c0, args in shards:
            got = kernels.from_dct_shard(*args)
            assert got.shape == (len(hw), hb, lw, 3)
            assert torch.equal(got, whole[:, :, c0:c0 + lw])
        return
    whole = kernels.to_dct(*whole_args)
    parts = []
    for c0, args in shards:
        got = kernels.to_dct_shard(*args)
        assert got.shape == (len(hw), hb + hb // 2, lw, 1) and got.dtype == torch.int16
        assert torch.equal(got[:, :hb], whole[:, :hb, c0:c0 + lw])
        parts.append(got)
    assert np.array_equal(ToYuv420Spec(hb, wb).shard_assemble(torch.stack(parts)),
                          whole.numpy())


def test_halo_blocks_reach_the_clamp_block_outside_the_natural_window():
    """Shards wholly past the valid width (hi 49, block 6) take block 6 as
    both halos, not their neighbours; a shard whose right neighbour holds
    the valid chroma edge takes that block."""
    assert kernels.dct_halo_blocks(256, 128, 99, 512) == (6, 6)
    assert kernels.dct_halo_blocks(384, 128, 99, 512) == (6, 6)
    assert kernels.dct_halo_blocks(0, 128, 99, 512) == (0, 6)
    assert kernels.dct_halo_blocks(64, 64, 131, 256) == (3, 8)
    assert kernels.dct_halo_blocks(128, 64, 131, 256) == (7, 8)
    lo, hi = kernels.dct_halo_blocks(128, 64, torch.tensor([256, 131, 99]), 256)
    assert lo.tolist() == [7, 7, 6] and hi.tolist() == [12, 8, 6]


def test_k12_window_of_a_shard_past_the_valid_width_is_one_column():
    spec = ToDctSpec(32, 256)
    assert spec.shard_window(192, 256, 97, 256, {}) == (96, 97)
    assert spec.shard_window(52, 104, 201, 208, {}) == (48, 112)
    assert spec.shard_window(100, 200, 211, 400, {}) == (96, 208)
    assert spec.shard_ok(100, False, 400, 4) and not spec.shard_ok(100, True, 400, 4)
    assert not spec.shard_ok(51, False, 204, 4)


@pytest.mark.parametrize("layout,k,step", [("420", 8, 16), ("422", 8, 16), ("444", 8, 8),
                                           ("gray", 8, 8), ("420", 4, 8), ("422", 2, 8),
                                           ("444", 1, 8)])
def test_k11_shard_ok_takes_whole_mcus_first_only(layout, k, step):
    spec = FromDctSpec(64, 256, k, layout)
    assert kernels.dct_shard_step(layout, k) == step
    assert spec.shard_ok(step * 3, True, 256, 4)
    assert not spec.shard_ok(step * 3, False, 256, 4)
    assert not spec.shard_ok(step * 3 + step // 2, True, 256, 4)


# -- the executor's route, its gathers counted --------------------------------------

def test_executor_route_shards_the_dct_chains_and_counts_a_refused_k11():
    """Every dct chain below runs on the route without a gather, egress
    on and off; a 40-wide 4:2:0 JPEG (coefficient bucket 48, shards of 12
    columns: not whole MCUs) is K11's `shard_ok` refusal: gathered, and
    counted at FromDctSpec."""
    ex = Executor(ExecutorConfig(device="cpu", mesh_policy="lanes", n_devices=4, spatial=4,
                                 spatial_threshold_px=1, max_form_ms=1.0))
    try:
        seen = []

        def run(arr, plan):
            out = ex.process(arr, plan, timeout=WAIT_S)
            assert same(out, _unsharded(arr, plan))
            seen.append(plan.transport)
            return out

        ppipeline.set_transport_dct(True)
        routes = (("resize", {"width": "400"}), ("resize", {"width": "120"}),
                  ("crop", {"width": "100", "height": "100"}), ("rotate", {"rotate": "90"}),
                  ("smartcrop", {"width": "100", "height": "100"}), ("flop", {}))
        done = 0
        for egress in (False, True):
            ppipeline.set_transport_dct_egress(egress)
            for layout in LAYOUTS:
                buf = dct_jpeg(layout, 150, 420, seed=31)
                for op, query in routes:
                    ppipeline.process_operation(op, buf, pquery(query), device="cpu",
                                                runner=run)
                    done += 1
        d = ex.stats.to_dict()
        assert seen == ["dct"] * done
        assert d["spatial_batches"] == done and d["spatial_gathers"] == {}
        ppipeline.process_operation("flip", dct_jpeg("420", 40, 40, seed=32), pquery({}),
                                    device="cpu", runner=run)
        d = ex.stats.to_dict()
        assert d["spatial_batches"] == done + 1
        assert d["spatial_gathers"] == {"FromDctSpec": 1}
    finally:
        ex.shutdown()


# -- the device frame tier ----------------------------------------------------------

def test_spatial_dct_launch_never_takes_the_device_tier():
    """A dct plan with a frame_key: run_single makes its frame resident
    (one miss), a second run_single hits; the spatial launch of the same
    plan stages from the host and books neither a hit nor a miss, and is
    bit-equal. The JAX package's chain takes the tier only when no
    sharding is given (imaginary_tpu/ops/chain.py:311)."""
    buf = dct_jpeg("420", 150, 420, seed=41)
    plan, arr, _ = chip_smoke.dct_request_plan(buf, "resize", {"width": "400"}, True)
    plan = wrap_plan_dct(plan_operation("resize", pquery({"width": "400"}), 150, 420, 1, 3),
                         150, 420, 1, frame_key=("tier", 1, "dct"), layout="420",
                         egress="dct", egress_quality=80)
    cs = CacheSet(frame_mb=8.0, device_mb=8.0)
    dc = DeviceFrameCache(cs.device, cs.stats)
    chain.set_device_frame_cache(dc)
    want = chain.run_single(arr, plan, device="cpu")
    assert same(chain.run_single(arr, plan, device="cpu"), want)
    assert (cs.stats.device_misses, cs.stats.device_hits, len(dc)) == (1, 1, 1)
    got, y = _spatial(arr, plan, 4)
    assert y.gathered is None and y.shards == 4
    assert same(got, want)
    assert (cs.stats.device_misses, cs.stats.device_hits) == (1, 1)
