"""The port's oversize-single spatial route on the CPU: one image's chain
W-sharded over a row of the lanes' mesh (`ops/chain.launch_spatial`,
`engine/executor.py` `_spatial_route`), on meshes of `cpu` entries.

  * port copies of the reference's five spatial tests
    (tests/test_engine.py TestSpatialServing x3,
    tests/test_lanes.py::test_spatial_route_at_mpix_bar,
    tests/test_server.py::TestSpatialServedRequest), on the lane tier
    (the `use_mesh` collector's spatial route is held in
    tests/test_torch_use_mesh.py);
  * the spatial output bit-equal to the unsharded chain's, over 2 and 4
    shards, for every chain below;
  * the spatial output within 1 LSB of the JAX executor's spatial route
    on the conftest's eight virtual devices (mesh (2, 2), the same seeded
    PNG, `process_operation` with each executor as the runner): resize +
    blur, the dry run's resize + blur + bw, a small config-3 /pipeline,
    /rotate, /flop, /crop, /smartcrop and an embed;
  * a stage whose `shard_ok` refuses (a transpose whose output width, the
    input bucket's height, does not split over 3 shards) shows one
    counted gather and the same output;
  * seams: K1 at a 6x downscale and a 2x upscale with the valid width
    ending inside a shard; K13 at R = lw - 1 (sharded) and R = lw
    (gathered, counted); K7 tiled and placed with `left` across a seam;
    blur as the first stage on uint8 input (host halos) and after K1 on
    f32 (exchanged halos).
"""

from __future__ import annotations

import dataclasses
import io
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from imaginary_tpu import pipeline as jpipeline
from imaginary_tpu.engine import Executor as JExecutor
from imaginary_tpu.engine import ExecutorConfig as JExecutorConfig
from imaginary_tpu.params import build_params_from_query as jquery
from imaginary_tpu_torch import kernels
from imaginary_tpu_torch import pipeline as ppipeline
from imaginary_tpu_torch.engine import Executor, ExecutorConfig
from imaginary_tpu_torch.ops import chain
from imaginary_tpu_torch.ops.plan import ImagePlan, StageInstance, plan_operation
from imaginary_tpu_torch.ops.stages import BlurSpec, CompositeSpec, SampleSpec
from imaginary_tpu_torch.options import ImageOptions
from imaginary_tpu_torch.params import build_params_from_query as pquery
from imaginary_tpu_torch.web.app import make_server
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def make_ex():
    made = []

    def make(**kw):
        ex = Executor(ExecutorConfig(device="cpu", max_form_ms=1.0, **kw))
        made.append(ex)
        return ex

    yield make
    for ex in made:
        ex.shutdown()


def _img(h, w, seed=0, c=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, c), dtype=np.uint8)


def _png(h, w, seed) -> bytes:
    out = io.BytesIO()
    Image.fromarray(_img(h, w, seed)).save(out, "PNG")
    return out.getvalue()


def _resize_plan(h, w, width, **kw):
    return plan_operation("resize", ImageOptions(width=width, **kw), h, w, 0, 3)


def _spatial(arr, plan, n):
    """(output, gathered spec name) of the chain W-sharded over n cpu entries."""
    y = chain.launch_spatial(arr, plan, [CPU] * n)
    return chain.fetch_batch(y, [arr], [plan])[0], y.gathered


def _unsharded(arr, plan):
    return chain.run_batch([arr], [plan], device="cpu")[0]


# -- the reference's five spatial tests ----------------------------------------


class TestSpatialServing:
    def test_large_bucket_routes_spatially_and_matches(self, make_ex):
        arr = _img(256, 512, seed=3)
        plan = plan_operation("resize", ImageOptions(width=128, sigma=1.2), 256, 512, 0, 3)
        ex_sp = make_ex(mesh_policy="lanes", n_devices=8, spatial=2,
                        spatial_threshold_px=1)
        out_sp = ex_sp.process(arr, plan, timeout=WAIT_S)
        assert ex_sp.stats.spatial_batches >= 1
        ex_plain = make_ex()
        out_plain = ex_plain.process(arr, plan, timeout=WAIT_S)
        assert ex_plain.stats.spatial_batches == 0
        np.testing.assert_array_equal(out_sp, out_plain)

    def test_small_bucket_stays_batch_sharded(self, make_ex):
        ex = make_ex(mesh_policy="lanes", n_devices=8, spatial=2)
        out = ex.process(_img(100, 80), _resize_plan(100, 80, 40), timeout=WAIT_S)
        assert out.shape == (50, 40, 3)
        assert ex.stats.spatial_batches == 0

    def test_uneven_spatial_falls_back_to_batch_sharding(self, make_ex):
        """W not divisible by the spatial axis: the route is not taken."""
        ex = make_ex(mesh_policy="lanes", n_devices=6, spatial=3,
                     spatial_threshold_px=1)
        # bucket W for a 62-wide image is 64, not a multiple of 3
        out = ex.process(_img(100, 62), _resize_plan(100, 62, 40), timeout=WAIT_S)
        assert out.shape == (65, 40, 3)
        assert ex.stats.spatial_batches == 0


def test_spatial_route_at_mpix_bar(make_ex):
    # (2, 2) mesh over 4 cpu entries; the bucket for a 512x512 single
    # crosses a 0.2 Mpix bar and W splits evenly
    ex = make_ex(mesh_policy="lanes", n_devices=4, spatial=2, spatial_mpix=0.2)
    assert ex.config.spatial_threshold_px == 200_000
    assert ex._spatial_on and ex._mesh.shape == (2, 2)
    arr, plan = _img(512, 512), _resize_plan(512, 512, 48)
    out = ex.submit(arr, plan).result(timeout=WAIT_S)
    assert out.shape[1] == 48
    assert ex.stats.spatial_batches == 1
    # a small single stays below the bar: no new spatial batch
    small, splan = _img(96, 96), _resize_plan(96, 96, 48)
    ex.submit(small, splan).result(timeout=WAIT_S)
    assert ex.stats.spatial_batches == 1


class TestSpatialServedRequest:
    def test_served_request_routes_spatially(self):
        srv = make_server("127.0.0.1", 0, device="cpu", mesh_policy="lanes",
                          n_devices=8, spatial=2, spatial_threshold_px=1)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        port = srv.server_address[1]
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/resize?width=128&type=png",
                data=_png(256, 512, 8), headers={"Content-Type": "image/png"})
            with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                assert r.status == 200
                body = r.read()
            assert Image.open(io.BytesIO(body)).size == (128, 64)
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                        timeout=WAIT_S) as r:
                stats = json.loads(r.read())["executor"]
            assert stats["spatial_batches"] >= 1
            assert stats["spatial_gathers"] == {}
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(timeout=10)


# -- bit-equal to the unsharded chain, and counted gathers ---------------------

# (name, options, the stage gathered at): /blur keeps the image's size and
# ends in a bucket shrink (K4), whose W-shard form reads its columns of the
# wider input bucket through the window exchange; /rotate's transpose
# takes its row bands from every shard, the flop its mirrored window; the
# crop, the embed and the smartcrop's gather read K4 windows
CHAINS = [
    ("resize-blur", dict(width=160, sigma=1.2), None),
    ("resize-blur-bw", dict(width=160, sigma=2.0, colorspace="bw"), None),
    ("blur", dict(sigma=1.5), None),
    ("rotate", dict(rotate=90), None),
    ("flop", dict(flop=True), None),
    ("crop", dict(width=100, height=100), None),
    ("smartcrop", dict(width=100, height=100), None),
    ("embed", dict(width=400, height=300), None),
]
_OPS = {"blur": "blur", "rotate": "rotate", "flop": "flop", "crop": "crop",
        "smartcrop": "smartcrop"}


def _chain_plan(name, kw, h, w):
    from imaginary_tpu_torch.options import Colorspace

    kw = dict(kw)
    if kw.get("colorspace") == "bw":
        kw["colorspace"] = Colorspace.BW
    return plan_operation(_OPS.get(name, "resize"), ImageOptions(**kw), h, w, 0, 3)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name,kw,gather", CHAINS, ids=[c[0] for c in CHAINS])
def test_spatial_chain_is_bit_equal_to_the_unsharded_chain(name, kw, gather, n):
    arr = _img(150, 420, seed=n)
    plan = _chain_plan(name, kw, *arr.shape[:2])
    sharded, gather_at = chain.spatial_split(plan.spec_key(), 160, 448, n)
    assert (gather_at is None) == (gather is None)
    live = chain.live_stages(plan.spec_key(), 160, 448)
    assert len(sharded) == len(live) - (gather is not None)
    got, gathered = _spatial(arr, plan, n)
    assert gathered == gather
    assert np.array_equal(got, _unsharded(arr, plan))


def test_executor_route_counts_batches_and_matches(make_ex):
    ex = make_ex(mesh_policy="sharded", n_devices=4, spatial=4,
                 spatial_threshold_px=1)
    arr = _img(150, 420, seed=9)
    for name, kw, _ in CHAINS:
        plan = _chain_plan(name, kw, *arr.shape[:2])
        assert np.array_equal(ex.process(arr, plan, timeout=WAIT_S),
                              _unsharded(arr, plan))
    d = ex.stats.to_dict()
    assert d["spatial_batches"] == len(CHAINS)
    assert d["spatial_gathers"] == {}
    assert ex.debug_snapshot()["lanes"]["spatial"] == 4


@pytest.mark.parametrize("ops,gathered,dims", [
    ([{"operation": "rotate", "params": {"rotate": 90}}], "TransposeSpec", (380, 420)),
    ([{"operation": "resize", "params": {"width": 192}},
      {"operation": "rotate", "params": {"rotate": 90}}], "TransposeSpec", (192, 212)),
], ids=["rotate", "resize-rotate"])
def test_stage_without_a_sharded_form_is_a_counted_gather(make_ex, ops, gathered, dims):
    """A 420x380 PNG over 3 shards: its 384-wide bucket splits, its
    448-row one does not, so the transpose's output width (the input's
    bucket height: 448, or 256 after the resize to 192 columns) refuses
    its `shard_ok`, and the chain is gathered there, counted."""
    ex = make_ex(mesh_policy="lanes", n_devices=6, spatial=3, spatial_threshold_px=1)
    buf = _png(420, 380, 4)
    seen, direct = [], []

    def run(arr, plan):
        seen.append(ex.process(arr, plan, timeout=WAIT_S))
        direct.append(_unsharded(arr, plan))
        return seen[-1]

    res = ppipeline.process_operation("pipeline", buf,
                                      pquery({"operations": json.dumps(ops)}),
                                      device="cpu", runner=run)
    assert (res.height, res.width) == dims
    assert len(seen) == 1 and np.array_equal(seen[0], direct[0])
    d = ex.stats.to_dict()
    assert d["spatial_batches"] == 1 and d["spatial_gathers"] == {gathered: 1}


def test_any_quarantine_turns_the_route_off_until_the_mesh_is_whole(make_ex):
    ex = make_ex(mesh_policy="lanes", n_devices=4, spatial=2, spatial_threshold_px=1,
                 breaker_threshold=1, breaker_cooldown_s=0.3)
    key = (None, 256, 512, 3)
    assert ex._spatial_route(key)
    ex._note_device_failure(3, RuntimeError("injected"))
    ex._refresh_lane_topology()
    assert not ex._spatial_route(key)
    arr, plan = _img(256, 512), _resize_plan(256, 512, 128)
    want = _unsharded(arr, plan)
    assert np.array_equal(ex.process(arr, plan, timeout=WAIT_S), want)
    assert ex.stats.spatial_batches == 0
    deadline = time.monotonic() + 10.0
    while ex.devhealth.is_quarantined(3) and time.monotonic() < deadline:
        time.sleep(0.05)
        ex.devhealth.note_probe_ok(3)
    ex._refresh_lane_topology()
    assert ex._spatial_route(key)
    assert np.array_equal(ex.process(arr, plan, timeout=WAIT_S), want)
    assert ex.stats.spatial_batches == 1


# -- within 1 LSB of the JAX executor's spatial route --------------------------

JAX_CASES = [
    ("resize-blur", "resize", {"width": "160", "sigma": "1.2"}),
    ("dry-run-bw", "resize", {"width": "160", "sigma": "2", "colorspace": "bw"}),
    ("rotate", "rotate", {"rotate": "90"}),
    ("flop", "flop", {}),
    ("crop", "crop", {"width": "100", "height": "100"}),
    ("smartcrop", "smartcrop", {"width": "100", "height": "100"}),
    ("embed", "resize", {"width": "400", "height": "300", "extend": "mirror"}),
    ("config3", "pipeline", {"operations": json.dumps([
        {"operation": "resize", "params": {"width": 160}},
        {"operation": "blur", "params": {"sigma": 1.2}},
        {"operation": "watermark", "params": {"text": "bench", "opacity": 0.5}},
        {"operation": "convert", "params": {"type": "webp"}}])}),
]


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
def test_spatial_route_matches_the_jax_spatial_route(executors, case, op, query):
    jex, pex = executors
    buf = _png(150, 420, 11)
    jseen, pseen = [], []
    j0, p0 = jex.stats.spatial_batches, pex.stats.spatial_batches

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
    assert len(jseen) == len(pseen) == 1
    a, b = pseen[0], np.asarray(jseen[0])
    assert a.shape == b.shape
    assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= U8_TOL


# -- seams ------------------------------------------------------------------------


def _plan(stages, out_h, out_w) -> ImagePlan:
    return ImagePlan(stages=[StageInstance(s, d) for s, d in stages],
                     out_h=out_h, out_w=out_w)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("scale,src_w,kind", [
    (1 / 6, 700, "lanczos3"), (2.0, 90, "lanczos3"), (1 / 6, 700, "linear"),
    (2.0, 90, "cubic"),
], ids=["down6-lanczos3", "up2-lanczos3", "down6-linear", "up2-cubic"])
def test_k1_shard_form_at_downscale_and_upscale(scale, src_w, kind, n):
    """The valid width ends inside a shard of the input bucket (700 of
    768, 90 of 96); each shard's input window, staged alone, gives its
    output columns bit for bit, f32 and uint8 out."""
    src_h = 40
    arr = _img(src_h, src_w, seed=7)
    dst_w = round(src_w * scale)
    dst_h = max(1, round(src_h * scale))
    out_hb, out_wb = 16 * -(-dst_h // 16), 16 * -(-dst_w // 16)
    assert out_wb % n == 0
    x = torch.from_numpy(chain.pad_to_bucket(arr))[None]
    in_wb = x.shape[2]
    h = torch.tensor([src_h], dtype=torch.int32)
    w = torch.tensor([src_w], dtype=torch.int32)
    dh = torch.tensor([float(dst_h)])
    dw = torch.tensor([float(dst_w)])
    for out_u8 in (False, True):
        whole, _, _ = kernels.resample(x, h, w, dh, dw, out_hb, out_wb, kind, out_u8)
        lw = out_wb // n
        for j in range(n):
            c0, c1 = j * lw, (j + 1) * lw
            k0, k1 = kernels.resample_window(kind, src_w, float(dst_w), in_wb, out_wb,
                                             c0, c1)
            assert k1 - k0 < in_wb or n == 1 or c1 > dst_w
            part, _, gw = kernels.resample(x[:, :, k0:k1].contiguous(), h, w, dh, dw,
                                           out_hb, out_wb, kind, out_u8, cols=(c0, c1),
                                           in_col0=k0, in_wb=in_wb)
            assert torch.equal(part, whole[:, :, c0:c1]) and int(gw[0]) == dst_w
    plan = _plan([(SampleSpec(out_hb, out_wb, kind),
                   {"dst_h": np.float32(dst_h), "dst_w": np.float32(dst_w)})],
                 dst_h, dst_w)
    got, gathered = _spatial(arr, plan, n)
    assert gathered is None and np.array_equal(got, _unsharded(arr, plan))


@pytest.mark.parametrize("radius,gathered", [(15, None), (16, "BlurSpec")],
                         ids=["R=lw-1", "R=lw"])
def test_k13_radius_at_and_past_the_local_width(radius, gathered):
    """After K1 to a 64-wide bucket over 4 shards (lw = 16): R = 15 runs
    sharded with halos from both neighbours; R = 16 is gathered."""
    arr = _img(60, 250, seed=2)
    plan = _plan([(SampleSpec(32, 64), {"dst_h": np.float32(30), "dst_w": np.float32(61)}),
                  (BlurSpec(radius), {"sigma": np.float32(6.0)})], 30, 61)
    got, g = _spatial(arr, plan, 4)
    assert g == gathered
    assert np.array_equal(got, _unsharded(arr, plan))


@pytest.mark.parametrize("replicate,left", [(True, 37), (True, 0), (False, 45),
                                            (False, 60)],
                         ids=["tiled-37", "tiled-0", "placed-45", "placed-60"])
def test_k7_left_across_a_seam(replicate, left):
    """The overlay's left edge (and, tiled, its period of 27 columns) falls
    across the 32-column seams of a 128-wide bucket over 4 shards; C = 4
    keeps the input's alpha."""
    arr = _img(50, 120, seed=5, c=4)
    rng = np.random.default_rng(6)
    overlay = np.zeros((16, 32, 4), np.float32)
    overlay[:11, :27] = rng.uniform(0, 255, (11, 27, 4))
    dyn = {"overlay": overlay, "top": np.int32(3), "left": np.int32(left),
           "opacity": np.float32(0.7), "block_h": np.int32(11),
           "block_w": np.int32(27)}
    plan = _plan([(BlurSpec(4), {"sigma": np.float32(1.0)}),
                  (CompositeSpec(16, 32, replicate), dyn)], 50, 120)
    got, gathered = _spatial(arr, plan, 4)
    assert gathered is None
    assert np.array_equal(got, _unsharded(arr, plan))


@pytest.mark.parametrize("first", ["blur-on-uint8", "blur-after-k1-f32"])
def test_k13_halos_from_the_host_and_from_the_neighbours(first):
    """Blur as the first stage reads uint8 halos staged from the host;
    after K1 it reads the neighbours' f32 columns through the exchange."""
    arr = _img(70, 250, seed=12)
    if first == "blur-on-uint8":
        plan = _plan([(BlurSpec(8), {"sigma": np.float32(2.5)})], 70, 250)
    else:
        plan = _plan([(SampleSpec(80, 256), {"dst_h": np.float32(70),
                                             "dst_w": np.float32(250)}),
                      (BlurSpec(8), {"sigma": np.float32(2.5)})], 70, 250)
    for n in (2, 4):
        got, gathered = _spatial(arr, plan, n)
        assert gathered is None
        assert np.array_equal(got, _unsharded(arr, plan))


def test_split_is_planned_per_stage():
    plan = _resize_plan(2160, 3840, 1280, sigma=1.2)
    specs = plan.spec_key()
    assert chain.spatial_split(specs, 2560, 4096, 4) == ([0, 1], None)
    # an output width that does not split evenly gathers at that stage
    odd = (SampleSpec(64, 72),) + specs[1:]
    assert chain.spatial_split(odd, 256, 512, 16) == ([], 0)
    # K1 as a later stage shards too (its window comes through the
    # exchange); one whose output width does not split gathers there
    twice = specs + (dataclasses.replace(specs[0], out_hb=368, out_wb=640),)
    assert chain.spatial_split(twice, 2560, 4096, 4) == ([0, 1, 2], None)
    odd_later = specs + (dataclasses.replace(specs[0], out_hb=368, out_wb=648),)
    assert chain.spatial_split(odd_later, 2560, 4096, 16) == ([0, 1], 2)


@pytest.mark.parametrize("chain_kind", ["resize-blur-watermark", "resize-blur-bw"])
def test_trace_holds_every_shard_launch(chain_kind):
    """`launch_spatial(trace=...)` records each sharded stage's launch on
    each shard with the arguments it ran on: the stage's own output
    columns, K7's `left` moved to the shard, the uint8 epilogue on the
    last stage only, and each output equal to the stage's plain version
    (`apply_shard(..., impl=reference)`) on those arguments."""
    from imaginary_tpu_torch.kernels import reference
    from imaginary_tpu_torch.ops.stages import GraySpec

    arr = _img(150, 500, seed=13)
    rng = np.random.default_rng(14)
    last = (CompositeSpec(16, 32, True),
            {"overlay": rng.uniform(0, 255, (16, 32, 4)).astype(np.float32),
             "top": np.int32(5), "left": np.int32(70), "opacity": np.float32(0.5),
             "block_h": np.int32(13), "block_w": np.int32(29)}) \
        if chain_kind == "resize-blur-watermark" else (GraySpec(), {})
    plan = _plan([(SampleSpec(80, 256), {"dst_h": np.float32(77),
                                         "dst_w": np.float32(256)}),
                  (BlurSpec(5), {"sigma": np.float32(1.5)}), last], 77, 256)
    n = 4
    trace = []
    y = chain.launch_spatial(arr, plan, [CPU] * n, trace=trace)
    got = chain.fetch_batch(y, [arr], [plan])[0]
    assert np.array_equal(got, _unsharded(arr, plan))
    assert [(i, j) for i, j, *_ in trace] == [(i, j) for i in range(3) for j in range(n)]
    for i, j, spec, args, out in trace:
        x, left, right, h, w, dyn, col0, lw, in_col0, in_wb, out_u8 = args
        assert (col0, lw, out_u8) == (j * 64, 64, i == 2)
        assert tuple(out.shape) == (1, 80, 64, 3)
        assert out.dtype == (torch.uint8 if i == 2 else torch.float32)
        if isinstance(spec, CompositeSpec):
            assert int(dyn["left"][0]) == 70 - col0
        if isinstance(spec, BlurSpec):
            assert (left is None) == (j == 0) and (right is None) == (j == n - 1)
        assert torch.equal(out, spec.apply_shard(*args, impl=reference)[0])
