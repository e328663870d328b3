"""The port's host interpreter (`engine/host_exec.py`) and the executor's
placement policy, held against the reference on the CPU.

- A port copy of tests/test_host_exec.py: the interpreter against the
  port's own device path (the plain versions of the kernels on the CPU)
  at the reference's PSNR bars, the separable resampler (numpy taps
  against the dense port, the native module against the numpy taps),
  and the cost model's spill, shadow probes and host backlog.
- Parity: for every spec of `_HOST_SPECS` and for the yuv420 and dct
  routes, the port's `host_exec.run` against the reference's on plans
  that `assert_same_plan` holds equal, within 1 LSB.
- The port's host answer against its own device path within the
  integrity bars (engine/integrity.py: max |d| <= 96, mean |d| <= 16).
"""

from __future__ import annotations

import io
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from imaginary_tpu.codecs import jpeg_dct as jdct
from imaginary_tpu.codecs import native_backend as jnative
from imaginary_tpu.engine import host_exec as jhost
from imaginary_tpu.options import Colorspace as JColorspace
from imaginary_tpu.options import Extend as JExtend
from imaginary_tpu.options import ImageOptions as JOptions
from imaginary_tpu.ops import plan as jplan
from imaginary_tpu_torch.codecs import native_backend as pnative
from imaginary_tpu_torch.engine import Executor, ExecutorConfig, host_exec
from imaginary_tpu_torch.engine import executor as ex_mod
from imaginary_tpu_torch.engine.integrity import outputs_match
from imaginary_tpu_torch.options import Colorspace, Extend
from imaginary_tpu_torch.options import ImageOptions
from imaginary_tpu_torch.ops import buckets as pbuckets
from imaginary_tpu_torch.ops import chain
from imaginary_tpu_torch.ops import plan as pplan
from imaginary_tpu_torch.ops.plan import plan_operation
from tests.conftest import psnr as _psnr
from tests.test_torch_plan import assert_same_plan
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

U8_TOL = 1
INTEGRITY_TOL, INTEGRITY_MEAN = 96, 16.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(42)
    # smooth-ish content: kernel differences on pure noise are worst-case
    base = rng.integers(0, 256, (34, 60, 3), np.uint8)
    big = np.kron(base, np.ones((8, 8, 1), np.uint8))[:270, :480]
    return np.ascontiguousarray(big)


def _ex(**kw) -> Executor:
    return Executor(ExecutorConfig(device="cpu", **kw))


CASES = [
    ("resize", ImageOptions(width=300, height=200)),
    ("crop", ImageOptions(width=100, height=120)),
    ("fit", ImageOptions(width=200, height=200)),
    ("extract", ImageOptions(top=10, left=20, area_width=200, area_height=100)),
    ("flip", ImageOptions()),
    ("flop", ImageOptions()),
    ("rotate", ImageOptions(rotate=90)),
    ("blur", ImageOptions(sigma=2.0)),
    ("zoom", ImageOptions(factor=2)),
    # pure enlarge and mixed shrink/enlarge: the separable precomputed-tap
    # resample paths (native or numpy taps), graded against the device
    ("enlarge", ImageOptions(width=600, height=400)),
    ("resize-mixed", ImageOptions(width=600, height=100, force=True)),
]


@pytest.mark.parametrize("name,o", CASES, ids=[c[0] for c in CASES])
def test_host_matches_device(img, name, o):
    name = name.split("-")[0]  # "resize-mixed" is a resize with mixed axes
    plan = plan_operation(name, o, img.shape[0], img.shape[1], 1, 3)
    assert host_exec.can_execute(plan)
    hy = host_exec.run(img, plan)
    dy = chain.run_single(img, plan, device="cpu")
    assert hy.shape == dy.shape
    assert _psnr(hy, dy) > 28.0, f"{name}: host/device divergence too large"
    assert outputs_match(hy, dy, exact=False, tol=INTEGRITY_TOL, mean_tol=INTEGRITY_MEAN)


class TestSeparableResample:
    """The interpreter's resampler: the numpy taps against the dense
    sampling-matrix port they replaced, the native module against the
    numpy taps (and bit for bit against the reference's native module)."""

    def _dense_reference(self, x, dh, dw, kernel):
        f = x.astype(np.float32)

        def mat(out_n, in_n, kind):
            y = np.arange(out_n, dtype=np.float32)[:, None]
            k = np.arange(in_n, dtype=np.float32)[None, :]
            scale = out_n / in_n
            centre = (y + 0.5) / scale - 0.5
            stretch = max(1.0, 1.0 / scale)
            wts = host_exec._np_kernel(kind, (k - centre) / stretch)
            norm = wts.sum(axis=-1, keepdims=True)
            return np.where(norm > 1e-6, wts / np.maximum(norm, 1e-6), 0.0)

        t = np.einsum("yk,kwc->ywc", mat(dh, f.shape[0], kernel), f)
        return np.einsum("xw,ywc->yxc", mat(dw, f.shape[1], kernel), t)

    GEOMS = [(120, 300, "lanczos3"), (400, 90, "cubic"), (301, 481, "linear"),
             (500, 600, "lanczos3"), (33, 77, "nearest"), (90, 120, "lanczos2")]

    def test_numpy_taps_match_dense_port(self, img):
        for dh, dw, kernel in self.GEOMS:
            ref = np.clip(self._dense_reference(img, dh, dw, kernel) + 0.5,
                          0, 255).astype(np.uint8)
            got = np.clip(host_exec._np_resize(img, dh, dw, kernel) + 0.5,
                          0, 255).astype(np.uint8)
            assert got.shape == ref.shape
            diff = np.abs(ref.astype(int) - got.astype(int)).max()
            assert diff <= 1, f"{dh}x{dw} {kernel}: maxdiff {diff}"

    @pytest.fixture(scope="class")
    def native_resize(self):
        assert pnative.resample_available()  # g++ builds it on first use
        return pnative.resize_separable

    def test_native_matches_numpy_taps(self, img, native_resize):
        for dh, dw, kernel in self.GEOMS:
            ref = np.clip(host_exec._np_resize(img, dh, dw, kernel) + 0.5,
                          0, 255).astype(np.uint8)
            got = native_resize(img, dh, dw, kernel)
            assert got.shape == ref.shape
            diff = np.abs(ref.astype(int) - got.astype(int)).max()
            assert diff <= 1, f"{dh}x{dw} {kernel}: maxdiff {diff}"

    @pytest.mark.parametrize("c", [1, 2, 3, 4])
    def test_native_is_bit_equal_to_the_references(self, img, native_resize, c):
        assert jnative.resample_available()  # built by the module's reference_native
        x = np.ascontiguousarray(np.dstack([img] * 2)[:, :, :c])
        for dh, dw, kernel in self.GEOMS:
            assert np.array_equal(native_resize(x, dh, dw, kernel),
                                  jnative.resize_separable(x, dh, dw, kernel))

    def test_native_concurrent_calls_consistent(self, img, native_resize):
        ref = native_resize(img, 190, 333, "lanczos3")
        errs = []

        def worker():
            for _ in range(5):
                out = native_resize(img, 190, 333, "lanczos3")
                if not np.array_equal(out, ref):
                    errs.append("divergent result under concurrency")

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs

    def test_fallback_when_native_absent(self, img, monkeypatch):
        monkeypatch.setattr(host_exec, "_NATIVE_RESAMPLE", False)
        o = ImageOptions(width=600, height=400)
        plan = plan_operation("enlarge", o, img.shape[0], img.shape[1], 1, 3)
        hy = host_exec.run(img, plan)
        dy = chain.run_single(img, plan, device="cpu")
        assert hy.shape == dy.shape
        assert _psnr(hy, dy) > 28.0

    def test_tap_tables_are_cached(self):
        host_exec._tap_table.cache_clear()
        host_exec._np_resize(np.zeros((50, 60, 3), np.uint8), 20, 30, "cubic")
        host_exec._np_resize(np.zeros((50, 60, 3), np.uint8), 20, 30, "cubic")
        info = host_exec._tap_table.cache_info()
        assert info.misses == 2  # one per axis
        assert info.hits == 2  # second call reused both


def test_smartcrop_never_spills(img):
    o = ImageOptions(width=64, height=64)
    plan = plan_operation("smartcrop", o, img.shape[0], img.shape[1], 1, 3)
    assert host_exec.can_execute(plan, for_spill=False)
    # excluded from load-dependent placement: the crop window must not
    # depend on the device's backlog
    assert not host_exec.can_execute(plan, for_spill=True)


def test_spill_triggers_when_device_saturated(img):
    ex = _ex(host_spill=True, spill_factor=1.0)
    try:
        ex._ms_per_mb = 10000.0  # a measured slow device
        o = ImageOptions(width=64, height=48)
        plan = plan_operation("resize", o, img.shape[0], img.shape[1], 1, 3)
        ex_mod.reset_placement()
        out = ex.process(img, plan)
        assert out.shape == (48, 64, 3)
        assert ex.stats.spilled == 1
        assert ex.stats.items == 0  # never reached the device queue
        assert ex_mod.last_placement() == "host"  # X-Imaginary-Backend source
    finally:
        ex.shutdown()


def test_cost_model_is_size_aware(img):
    """Placement is priced per unit (wire MB, source megapixels): a queued
    4K item's MB, not the queue's length, pushes a small follower over."""
    ex = _ex(host_spill=True, probe_interval=10**9)
    try:
        o = ImageOptions(width=64, height=48)
        small = ex_mod._Item(img, plan_operation("resize", o, img.shape[0],
                                                 img.shape[1], 1, 3))
        big = ex_mod._Item(np.zeros((2160, 3840, 3), np.uint8),
                           plan_operation("resize", ImageOptions(width=1280),
                                          2160, 3840, 0, 3))
        assert big.wire_mb > 50 * small.wire_mb
        assert big.mpix > 50 * small.mpix
        ex._ms_per_mb = 33.0
        ex._host_ms_per_mpix = 8.0
        assert ex._should_spill(big)
        assert ex._should_spill(small)
        ex._ms_per_mb = 0.05
        assert not ex._should_spill(big)
        assert not ex._should_spill(small)
        ex._ms_per_mb = 1.0
        ex.stats.device_owed_mb = big.wire_mb  # a queued 4K item's worth
        assert ex._should_spill(small)
        ex.stats.device_owed_mb = small.wire_mb  # same queue length, tiny MB
        assert not ex._should_spill(small)
    finally:
        ex.stats.device_owed_mb = 0.0
        ex.shutdown()


def test_shadow_probes_rate_limited_by_wall_clock(img):
    """Within one probe_min_interval_s at most one shadow ships, and cheap
    but stale slots do not feed the 16-slot escape."""
    o = ImageOptions(width=64, height=48)
    plan = plan_operation("resize", o, img.shape[0], img.shape[1], 1, 3)
    ex = _ex(host_spill=True, spill_factor=0.001, probe_interval=2,
             probe_min_interval_s=3600.0)
    try:
        ex._ms_per_mb = 10.0
        ex._drain_floor_ms = 5.0
        for _ in range(40):
            ex.process(img, plan)
        assert ex.stats.spilled == 40
        assert ex.stats.shadow_probes == 1
        assert ex._probe_slots_skipped == 0
    finally:
        ex.shutdown()


def test_host_occupancy_backpressures_spill(img, monkeypatch):
    """The host side includes the pool's owed-megapixel backlog: a
    saturated host pushes arrivals back to the device."""
    ex = _ex(host_spill=True, probe_interval=10**9)
    try:
        item = ex_mod._Item(img, plan_operation("resize", ImageOptions(width=64, height=48),
                                                img.shape[0], img.shape[1], 1, 3))
        ex._ms_per_mb = 33.0
        ex._host_ms_per_mpix = 8.0
        # a card is silicon of its own: the backlog term counts (on the
        # CPU device it cancels)
        monkeypatch.setattr(ex, "_devices", [torch.device("cuda")])
        assert ex._should_spill(item)
        ex._host_owed_mpix = 1000.0 * ex._ncpus
        assert not ex._should_spill(item)
        ex._host_owed_mpix = 0.0
        assert ex._should_spill(item)
    finally:
        ex.shutdown()


def test_spill_books_and_releases_host_occupancy(img):
    ex = _ex(host_spill=True, spill_factor=1.0, probe_interval=10**9)
    try:
        ex._ms_per_mb = 10000.0
        plan = plan_operation("resize", ImageOptions(width=64, height=48),
                              img.shape[0], img.shape[1], 1, 3)
        ex.process(img, plan)
        assert ex.stats.spilled == 1
        assert ex._host_inflight == 0 and ex._host_owed_mpix == 0.0
        d = ex.stats.to_dict()
        assert d["host_inflight"] == 0 and d["host_owed_mpix"] == 0.0
        assert "host_spill_p50_ms" in d and "host_spill_p99_ms" in d
    finally:
        ex.shutdown()


def test_force_host_pins_placement(img):
    ex = _ex(force_host=True)
    try:
        plan = plan_operation("resize", ImageOptions(width=64, height=48),
                              img.shape[0], img.shape[1], 1, 3)
        ex_mod.reset_placement()
        out = ex.process(img, plan)
        assert out.shape == (48, 64, 3)
        assert ex.stats.spilled == 1 and ex.stats.items == 0
        assert ex_mod.last_placement() == "host"
    finally:
        ex.shutdown()


def test_no_spill_when_device_fast(img):
    ex = _ex(host_spill=True)
    try:
        ex._ms_per_mb = 0.01
        plan = plan_operation("resize", ImageOptions(width=64, height=48),
                              img.shape[0], img.shape[1], 1, 3)
        ex_mod.reset_placement()
        out = ex.process(img, plan)
        assert out.shape == (48, 64, 3)
        assert ex.stats.spilled == 0 and ex.stats.items == 1
        assert ex_mod.last_placement() == "device"
    finally:
        ex.shutdown()


def test_spill_is_off_by_default_and_auto_is_the_cost_model(img):
    """The port's default never spills, however slow the device reads; None
    ("auto", the reference's default) runs the cost model."""
    plan = plan_operation("resize", ImageOptions(width=64, height=48),
                          img.shape[0], img.shape[1], 1, 3)
    ex = _ex()
    try:
        assert ex.config.host_spill is False
        ex._ms_per_mb = 1e6
        ex.process(img, plan)
        assert ex.stats.spilled == 0 and ex.stats.items == 1
    finally:
        ex.shutdown()
    ex = _ex(host_spill=None, spill_factor=1.0)
    try:
        assert ex.config.host_spill is True
        ex._ms_per_mb = 1e6
        ex.process(img, plan)
        assert ex.stats.spilled == 1
    finally:
        ex.shutdown()


def test_host_spill_failpoint_falls_back_to_the_device(img):
    from imaginary_tpu_torch import failpoints

    ex = _ex(force_host=True)
    failpoints.activate("host.spill=error")
    try:
        plan = plan_operation("resize", ImageOptions(width=64, height=48),
                              img.shape[0], img.shape[1], 1, 3)
        ex_mod.reset_placement()
        out = ex.process(img, plan)
        assert np.array_equal(out, chain.run_single(img, plan, device="cpu"))
        assert ex.stats.spill_errors == 1 and ex.stats.spilled == 0
        assert ex_mod.last_placement() == "device"
    finally:
        failpoints.deactivate()
        ex.shutdown()


def test_embed_modes_match_device(img):
    small = img[:100, :150]
    for extend in (Extend.MIRROR, Extend.COPY, Extend.WHITE, Extend.BLACK,
                   Extend.BACKGROUND):
        o = ImageOptions(width=300, height=200, embed=True, extend=extend,
                         background=(10, 200, 30))
        o.mark_defined("embed")
        plan = plan_operation("resize", o, 100, 150, 1, 3)
        hy = host_exec.run(small, plan)
        dy = chain.run_single(small, plan, device="cpu")
        assert hy.shape == dy.shape
        assert _psnr(hy, dy) > 28.0, extend


def test_watermark_composite_matches_device(img):
    o = ImageOptions(width=200, text="hello tpu", opacity=0.7)
    plan = plan_operation("watermark", o, img.shape[0], img.shape[1], 1, 3)
    assert host_exec.can_execute(plan)
    hy = host_exec.run(img, plan)
    dy = chain.run_single(img, plan, device="cpu")
    assert hy.shape == dy.shape
    assert _psnr(hy, dy) > 25.0


# -- parity with the reference's interpreter ------------------------------------


def _opts(cls, kw):
    o = cls(**kw)
    for k in kw:
        o.mark_defined(k)
    return o


# (id, operation, options, source dims, channels): every spec of
# _HOST_SPECS on the rgb transport
RGB_CASES = [
    ("resize", "resize", {"width": 300, "height": 200}, (270, 480), 3),
    ("enlarge", "enlarge", {"width": 600, "height": 400}, (270, 480), 3),
    ("mixed", "resize", {"width": 600, "height": 100, "force": True}, (270, 480), 3),
    ("crop", "crop", {"width": 100, "height": 120}, (270, 480), 3),
    ("extract", "extract", {"top": 10, "left": 20, "area_width": 200,
                            "area_height": 100}, (270, 480), 3),
    ("embed-mirror", "resize", {"width": 300, "height": 200, "embed": True,
                                "extend": "mirror"}, (100, 150), 3),
    ("embed-white", "resize", {"width": 300, "height": 200, "embed": True,
                               "extend": "white"}, (100, 150), 3),
    ("flip", "flip", {}, (270, 480), 3),
    ("flop", "flop", {}, (270, 480), 4),
    ("rotate", "rotate", {"rotate": 90}, (270, 480), 3),
    ("blur", "blur", {"sigma": 2.0}, (270, 480), 3),
    ("watermark", "watermark", {"width": 200, "text": "hello", "opacity": 0.7},
     (270, 480), 3),
    ("bw", "resize", {"width": 200, "colorspace": "bw"}, (270, 480), 4),
    ("smartcrop", "smartcrop", {"width": 64, "height": 64}, (270, 480), 3),
    ("shrink-bucket", "extract", {"top": 0, "left": 0, "area_width": 40,
                                  "area_height": 30}, (1080, 1920), 3),
]


def _seeded(h, w, c, seed=5):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, c), np.uint8)
    return np.ascontiguousarray(np.kron(base, np.ones((8, 8, 1), np.uint8))[:h, :w])


def _plans(op, kw, h, w, c):
    kw = dict(kw)
    ext = kw.pop("extend", None)
    bw = kw.pop("colorspace", None) == "bw"
    jo, po = _opts(JOptions, kw), _opts(ImageOptions, kw)
    if ext is not None:
        jo.extend, po.extend = JExtend(ext), Extend(ext)
        jo.mark_defined("extend")
        po.mark_defined("extend")
    if bw:
        jo.colorspace, po.colorspace = JColorspace.BW, Colorspace.BW
        jo.mark_defined("colorspace")
        po.mark_defined("colorspace")
    jp = jplan.plan_operation(op, jo, h, w, 1, c)
    pp = plan_operation(op, po, h, w, 1, c)
    assert_same_plan(jp, pp)
    return jp, pp


def _max_diff(got, want) -> int:
    planes = (lambda o: [o] if isinstance(o, np.ndarray) else [o.y, o.u, o.v])
    worst = 0
    for a, b in zip(planes(got), planes(want)):
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        worst = max(worst, int(np.abs(a.astype(int) - b.astype(int)).max()))
    return worst


@pytest.mark.parametrize("name,op,kw,src,c", RGB_CASES, ids=[c[0] for c in RGB_CASES])
def test_host_run_matches_the_references(name, op, kw, src, c):
    arr = _seeded(*src, c)
    jp, pp = _plans(op, kw, *src, c)
    assert host_exec.can_execute(pp, for_spill=False)
    assert host_exec.can_execute(pp) == jhost.can_execute(jp)
    assert _max_diff(host_exec.run(arr, pp), jhost.run(arr, jp)) <= U8_TOL
    if not host_exec.can_execute(pp):
        return  # smartcrop: host and card saliency may pick other windows
    # the host answer against the port's own device path, within the bars
    assert outputs_match(host_exec.run(arr, pp), chain.run_single(arr, pp, device="cpu"),
                         exact=False, tol=INTEGRITY_TOL, mean_tol=INTEGRITY_MEAN)


def test_rgb_cases_cover_every_host_spec():
    seen = set()
    for _, op, kw, src, c in RGB_CASES:
        seen |= {type(s.spec).__name__ for s in _plans(op, kw, *src, c)[1].stages}
    want = {cls.__name__ for cls in host_exec._HOST_SPECS} - {"FromYuv420Spec",
                                                              "ToYuv420Spec"}
    assert want <= seen


def _jpeg(layout: str, h: int, w: int, seed: int = 3) -> bytes:
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3), dtype=np.uint8)
    im = Image.fromarray(base).resize((w, h), Image.BILINEAR)
    b = io.BytesIO()
    if layout == "gray":
        im.convert("L").save(b, "JPEG", quality=90)
    else:
        im.save(b, "JPEG", quality=90, subsampling={"444": 0, "422": 1, "420": 2}[layout])
    return b.getvalue()


PACKED_CASES = [("resize", {"width": 150}), ("flip", {}), ("blur", {"sigma": 1.5}),
                ("crop", {"width": 100, "height": 80}), ("bw", {"width": 120})]


@pytest.mark.parametrize("op,kw", PACKED_CASES, ids=[c[0] for c in PACKED_CASES])
def test_yuv420_route_matches_the_references(op, kw):
    from imaginary_tpu.codecs import decode_yuv420 as jdecode_yuv420

    h, w = 181, 243
    buf = _jpeg("420", h, w)
    name, kw = ("resize", dict(kw, colorspace="bw")) if op == "bw" else (op, kw)
    jp0, pp0 = _plans(name, kw, h, w, 3)
    jp, pp = jplan.wrap_plan_yuv420(jp0, h, w), pplan.wrap_plan_yuv420(pp0, h, w)
    assert_same_plan(jp, pp)
    packed, _, _, _ = jdecode_yuv420(buf, 1, *pbuckets.bucket_shape(h, w))
    assert host_exec.can_execute(pp) == jhost.can_execute(jp)
    got, want = host_exec.run(packed, pp), jhost.run(packed, jp)
    assert _max_diff(got, want) <= U8_TOL
    assert outputs_match(got, chain.run_single(packed, pp, device="cpu"), exact=False,
                         tol=INTEGRITY_TOL, mean_tol=INTEGRITY_MEAN)


@pytest.mark.parametrize("shrink", [1, 2, 4])
@pytest.mark.parametrize("layout", ["420", "422", "444", "gray"])
def test_dct_route_matches_the_references(layout, shrink):
    h, w = 181, 243
    buf = _jpeg(layout, h, w)
    packed, sh, sw, got_layout = jdct.decode_packed(buf, shrink)
    assert got_layout == layout
    jp0, pp0 = _plans("resize", {"width": 100}, sh, sw, 3)
    jp = jplan.wrap_plan_dct(jp0, h, w, shrink, layout=layout)
    pp = pplan.wrap_plan_dct(pp0, h, w, shrink, layout=layout)
    assert_same_plan(jp, pp)
    assert host_exec.can_execute(pp) and jhost.can_execute(jp)
    got, want = host_exec.run(packed, pp), jhost.run(packed, jp)
    assert _max_diff(got, want) <= U8_TOL
    assert outputs_match(got, chain.run_single(packed, pp, device="cpu"), exact=False,
                         tol=INTEGRITY_TOL, mean_tol=INTEGRITY_MEAN)


def test_dct_egress_and_host_dct_spill_off_stay_on_the_device():
    h, w = 64, 96
    packed, sh, sw, layout = jdct.decode_packed(_jpeg("420", h, w), 1)
    _, pp0 = _plans("flip", {}, sh, sw, 3)
    egress = pplan.wrap_plan_dct(pp0, h, w, 1, layout=layout, egress="dct",
                                 egress_quality=80)
    assert not host_exec.can_execute(egress, for_spill=False)
    plain = pplan.wrap_plan_dct(pp0, h, w, 1, layout=layout)
    assert host_exec.can_execute(plain)
    host_exec.set_dct_spill(False)
    try:
        assert not host_exec.can_execute(plain)
    finally:
        host_exec.set_dct_spill(True)
