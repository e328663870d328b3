"""The executor's admission half in the port, held against the reference.

Port copies, under their names, of the reference's
`tests/test_continuous.py` classes `TestContinuousAdmission` (the convoy
policy included), `TestDonationSafety` and `TestKnobDefaultsAgree`,
`tests/test_engine.py`'s `TestBatchLadderUnification::
test_defaults_agree_everywhere` and `tests/test_host_bytes.py`'s
`TestCodecArena`, with the port's:

- donation: the chunk's last launch writes into its staged input buffer
  (ops/chain.py). A donated chain equals the undonated one bit for bit on
  the routes' chains (config 1's K2 -> K1 -> K4 -> K3, config 3's K1 ->
  K6 -> K7, the crop's K4, the flip's K5, the bw K8, the dct egress's
  K12), and never writes the caller's array. The reference's latch case
  (a backend that refuses donation) is not ported: nothing on the card
  refuses aliasing, so `donation_rejected` stays 0;
- convoy: the same answers as continuous, in fewer groups than launches;
- the WIRE ledger: after N requests at B=1, h2d and d2h equal N times
  the staged and the fetched bytes computed from the plan;
- the drain: image routes answer the reference app's 503 with
  Retry-After while /health keeps answering 200.
"""

from __future__ import annotations

import asyncio
import io
import time

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from imaginary_tpu_torch import pipeline
from imaginary_tpu_torch.engine import Executor, ExecutorConfig
from imaginary_tpu_torch.engine.timing import TIMES, WIRE
from imaginary_tpu_torch.ops import chain as chain_mod
from imaginary_tpu_torch.ops.plan import plan_operation
from imaginary_tpu_torch.options import ImageOptions
from tests.conftest import fixture_bytes
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")


def _img(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _resize_plan(h, w, width):
    return plan_operation("resize", ImageOptions(width=width), h, w, 0, 3)


def _cpu(**kw) -> Executor:
    return Executor(ExecutorConfig(device="cpu", host_spill=False, **kw))


@pytest.fixture(autouse=True)
def _restore_donation():
    """Donation is process-wide: a test that turns it off must not leak."""
    yield
    chain_mod.set_donation(True)


class TestContinuousAdmission:
    def _slow_drain(self, monkeypatch, delay_s=0.4):
        real = chain_mod.fetch_batch

        def slow(y, arrs, plans):
            time.sleep(delay_s)
            return real(y, arrs, plans)

        monkeypatch.setattr(chain_mod, "fetch_batch", slow)

    def test_item_lands_in_next_chunk_not_behind_drain(self, monkeypatch):
        """Submit B while A's drain is in flight: under the continuous
        policy B launches as its own chunk at once, long before A's slow
        drain returns."""
        self._slow_drain(monkeypatch)
        ex = _cpu(batch_policy="continuous", max_form_ms=2.0)
        try:
            plan = _resize_plan(100, 80, 40)
            fa = ex.submit(_img(100, 80), plan)
            for _ in range(600):
                if ex.stats.batches >= 1:
                    break
                time.sleep(0.005)
            assert ex.stats.batches == 1
            fb = ex.submit(_img(100, 80, seed=1), plan)
            deadline = time.monotonic() + 0.15  # well inside A's 400 ms drain
            while time.monotonic() < deadline and ex.stats.batches < 2:
                time.sleep(0.005)
            assert ex.stats.batches == 2
            assert not fa.done()
            assert fa.result(timeout=30).shape == (50, 40, 3)
            assert fb.result(timeout=30).shape == (50, 40, 3)
        finally:
            ex.shutdown()

    def test_convoy_policy_holds_while_link_busy(self, monkeypatch):
        """The convoy really convoys: with a group's drain in flight (its
        chunk counted in `_inflight` until the drain returns), a
        window-expired item stays queued until the link idles or the hold
        cap fires."""
        self._slow_drain(monkeypatch)
        ex = _cpu(batch_policy="convoy", window_ms=1.0, max_hold_ms=10_000.0)
        try:
            plan = _resize_plan(100, 80, 40)
            fa = ex.submit(_img(100, 80), plan)
            for _ in range(200):
                if ex.stats.batches >= 1:
                    break
                time.sleep(0.005)
            fb = ex.submit(_img(100, 80, seed=1), plan)
            time.sleep(0.1)  # far past the 1 ms window; the drain is still busy
            assert ex.stats.batches == 1  # held: that is the convoy
            assert ex.debug_snapshot()["inflight_groups"] == 1
            assert fa.result(timeout=30).shape == (50, 40, 3)
            assert fb.result(timeout=30).shape == (50, 40, 3)
            assert ex.stats.batches == 2
        finally:
            ex.shutdown()

    def test_coalesced_drain_preserves_per_item_results(self, monkeypatch):
        """Several chunks queued behind one slow drain are each read back
        with their own pixels (no cross-chunk mixing)."""
        self._slow_drain(monkeypatch, delay_s=0.1)
        ex = _cpu(batch_policy="continuous", max_form_ms=1.0)
        try:
            plan = _resize_plan(100, 80, 40)
            arrs = [_img(100, 80, seed=i) for i in range(6)]
            futs = []
            for a in arrs:
                futs.append(ex.submit(a, plan))
                time.sleep(0.01)
            outs = [f.result(timeout=60) for f in futs]
            assert ex.stats.batches >= 2
            refs = [chain_mod.run_single(a, plan, device="cpu") for a in arrs]
            for out, ref in zip(outs, refs):
                np.testing.assert_array_equal(out, ref)
        finally:
            ex.shutdown()

    def test_convoy_group_is_one_fetch_over_several_launches(self):
        """A convoy group of more than max_batch items launches as several
        chunks drained by one fetch (groups < batches), and answers what
        the continuous policy answers."""
        plan = _resize_plan(100, 80, 40)
        arrs = [_img(100, 80, seed=i) for i in range(10)]
        outs = {}
        for pol in ("continuous", "convoy"):
            ex = _cpu(batch_policy=pol, window_ms=200.0, max_form_ms=200.0, max_batch=4)
            try:
                futs = [ex.submit(a, plan) for a in arrs]
                outs[pol] = [f.result(timeout=60) for f in futs]
                d = ex.stats.to_dict()
            finally:
                ex.shutdown()
            if pol == "convoy":
                assert (d["groups"], d["batches"]) == (1, 3)
                assert d["avg_group"] == 10.0 and d["avg_batch"] == pytest.approx(3.333)
                assert d["max_group"] == 10
        for a, b in zip(outs["continuous"], outs["convoy"]):
            np.testing.assert_array_equal(a, b)

    def test_convoy_formation_books_as_batch_form(self):
        TIMES.reset()
        ex = _cpu(batch_policy="convoy", window_ms=30.0)
        try:
            ex.process(_img(100, 80), _resize_plan(100, 80, 40))
        finally:
            ex.shutdown()
        snap = TIMES.snapshot()
        assert snap["batch_form"]["p50_ms"] >= 25.0  # the window is formation
        assert snap["dispatch_wait"]["p50_ms"] < 5.0

    def test_unknown_policy_is_refused(self):
        with pytest.raises(ValueError, match="batch policy"):
            _cpu(batch_policy="fifo")


def _color_png() -> bytes:
    """A seeded 300x420 RGB PNG (the rgb transport's chains)."""
    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(_img(300, 420, seed=9)).save(out, "PNG")
    return out.getvalue()


def _pipeline_input(op: str, opts: ImageOptions, src, **kw) -> tuple:
    """The (array, plan) the pipeline hands its runner for `op` on `src`
    (a fixture's name, or bytes)."""
    seen = []

    def runner(arr, plan):
        seen.append((arr, plan))
        return chain_mod.run_single(arr, plan, device="cpu")

    buf = src if isinstance(src, bytes) else fixture_bytes(src)
    pipeline.process_operation(op, buf, opts, device="cpu", runner=runner, **kw)
    return seen[0]


def _mark() -> np.ndarray:
    rng = np.random.default_rng(5)
    return rng.integers(0, 256, (48, 96, 4), dtype=np.uint8)


DONATION_ROUTES = [
    ("config1", "resize", dict(width=300, height=200), "large.jpg", {}),
    ("config3", "pipeline", [
        {"operation": "resize", "params": {"width": 200}},
        {"operation": "blur", "params": {"sigma": 2}},
        {"operation": "watermarkImage",
         "params": {"image": "x", "top": 4, "left": 8, "opacity": 0.7}}],
     "png", {"watermark_rgba": _mark()}),
    ("crop", "crop", dict(width=300, height=200), "large.jpg", {}),
    ("flip", "pipeline", [{"operation": "resize", "params": {"width": 200}},
                          {"operation": "flip", "params": {}}], "png", {}),
    ("bw", "resize", dict(width=300, colorspace="bw"), "png", {}),
]


def _opts(fields):
    """The options a query of `fields` gives (a list: a /pipeline's
    operations)."""
    import json

    from imaginary_tpu_torch.params import build_params_from_query

    if isinstance(fields, list):
        return build_params_from_query({"operations": json.dumps(fields)})
    return build_params_from_query({k: str(v) for k, v in fields.items()})


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in ("y", "u", "v"))


class TestDonationSafety:
    def test_cache_resident_array_is_never_donated(self):
        """A read-only caller array (what a frame cache hands every
        request that shares it) is never written: donation consumes only
        the staged copy."""
        chain_mod.set_donation(True)
        arr, plan = _pipeline_input("crop", ImageOptions(width=300, height=200),
                                    "large.jpg")
        arr = np.array(arr)
        arr.setflags(write=False)
        pinned = arr.tobytes()
        before = chain_mod.donation_stats()["donated"]
        out1 = chain_mod.run_single(arr, plan, device="cpu")
        out2 = chain_mod.run_single(arr, plan, device="cpu")
        assert chain_mod.donation_stats()["donated"] == before + 2
        assert arr.tobytes() == pinned
        assert _equal(out1, out2)

    def test_batched_launch_stages_a_copy(self):
        """Through the executor, donated chunks leave the callers' arrays
        as they were."""
        chain_mod.set_donation(True)
        ex = _cpu(max_form_ms=20.0)
        try:
            plan = plan_operation("blur", ImageOptions(sigma=2.0), 60, 80, 0, 3)
            assert len(chain_mod.live_stages(plan.spec_key(), 64, 96)) == 2
            arrs = [_img(60, 80, seed=i) for i in range(3)]
            pinned = [a.tobytes() for a in arrs]
            before = chain_mod.donation_stats()["donated"]
            for f in [ex.submit(a, plan) for a in arrs]:
                f.result(timeout=60)
            assert chain_mod.donation_stats()["donated"] > before
            assert [a.tobytes() for a in arrs] == pinned
        finally:
            ex.shutdown()

    @pytest.mark.parametrize("name,op,fields,src,kw", DONATION_ROUTES,
                             ids=[r[0] for r in DONATION_ROUTES])
    def test_donated_chain_equals_the_undonated(self, name, op, fields, src, kw):
        src = _color_png() if src == "png" else src
        arr, plan = _pipeline_input(op, _opts(fields), src, **kw)
        batch = [arr, arr.copy()]
        chain_mod.set_donation(False)
        want = chain_mod.run_batch(batch, [plan, plan], device="cpu")
        chain_mod.set_donation(True)
        before = chain_mod.donation_stats()["donated"]
        got = chain_mod.run_batch(batch, [plan, plan], device="cpu")
        assert chain_mod.donation_stats()["donated"] == before + 1
        assert all(_equal(g, w) for g, w in zip(got, want))

    def test_dct_egress_donates_k12(self):
        was = (pipeline.transport_dct_enabled(), pipeline.transport_dct_egress_enabled())
        pipeline.set_transport_dct(True)
        pipeline.set_transport_dct_egress(True)
        try:
            arr, plan = _pipeline_input("resize", ImageOptions(width=300), "large.jpg")
        finally:
            pipeline.set_transport_dct(was[0])
            pipeline.set_transport_dct_egress(was[1])
        assert type(plan.stages[-1].spec).__name__ == "ToDctSpec"
        chain_mod.set_donation(False)
        want = chain_mod.run_batch([arr], [plan], device="cpu")[0]
        chain_mod.set_donation(True)
        before = chain_mod.donation_stats()["donated"]
        got = chain_mod.run_batch([arr], [plan], device="cpu")[0]
        assert chain_mod.donation_stats()["donated"] == before + 1
        for k in ("y", "u", "v"):
            assert np.array_equal(getattr(got, k), getattr(want, k))

    def test_one_launch_chain_is_not_donated(self):
        """A chain of one launch would overwrite the region its only
        kernel reads: it runs undonated (the shape rule, not an error)."""
        chain_mod.set_donation(True)
        plan = _resize_plan(100, 80, 40)
        assert len(chain_mod.live_stages(plan.spec_key(), 128, 128)) == 1
        before = chain_mod.donation_stats()["donated"]
        chain_mod.run_single(_img(100, 80), plan, device="cpu")
        assert chain_mod.donation_stats()["donated"] == before

    def test_output_larger_than_the_batch_region_is_not_donated(self):
        chain_mod.set_donation(True)
        plan = plan_operation("enlarge", ImageOptions(width=400, height=300), 60, 80, 0, 3)
        blur = plan_operation("blur", ImageOptions(sigma=1.0), 60, 80, 0, 3)
        from imaginary_tpu_torch.ops.plan import ImagePlan

        # the enlarge, then the blur alone: its 304x400 output is past the
        # 64x96 bucket the batch region holds
        big = ImagePlan(stages=plan.stages + blur.stages[:1], out_h=plan.out_h,
                        out_w=plan.out_w)
        before = chain_mod.donation_stats()["donated"]
        chain_mod.run_single(_img(60, 80), big, device="cpu")
        assert chain_mod.donation_stats()["donated"] == before

    def test_stats_surface_the_donation(self):
        chain_mod.set_donation(False)
        ex = _cpu(max_form_ms=2.0)
        try:
            ex.process(_img(100, 80), _resize_plan(100, 80, 40))
            d = ex.stats.to_dict()
        finally:
            ex.shutdown()
        assert (d["donation_enabled"], d["donation_rejected"]) == (False, 0)
        chain_mod.set_donation(True)
        assert ex.stats.to_dict()["donation_enabled"] is True


class TestKnobDefaultsAgree:
    """One source of truth for the batching knobs across the command
    line, the server options and the executor, in both packages."""

    def test_defaults_agree_everywhere(self):
        from imaginary_tpu.cli import build_parser as ref_parser
        from imaginary_tpu.engine.executor import ExecutorConfig as RefConfig
        from imaginary_tpu.web.config import ServerOptions as RefOptions
        from imaginary_tpu_torch.cli import build_parser
        from imaginary_tpu_torch.web.config import ServerOptions

        args = build_parser().parse_args([])
        o = ServerOptions()
        assert (args.batch_policy == o.batch_policy == ExecutorConfig().batch_policy
                == "continuous")
        assert args.batch_form_ms == o.batch_form_ms == 5.0
        assert args.max_inflight == o.max_inflight == ExecutorConfig().max_inflight == 4
        assert args.donation == "on" and o.donation is True
        assert args.batch_window_ms == o.batch_window_ms == ExecutorConfig().window_ms == 3.0
        ra, ro, rc = ref_parser().parse_args([]), RefOptions(), RefConfig()
        for name in ("batch_policy", "batch_form_ms", "max_inflight", "donation",
                     "batch_window_ms", "max_queue_ms", "pressure_rss_mb", "qos_config",
                     "arena_mb", "dct_native"):
            assert getattr(args, name) == getattr(ra, name), name
            assert getattr(o, name) == getattr(ro, name), name
        for name in ("window_ms", "max_group", "max_hold_ms", "batch_policy",
                     "max_form_ms", "qos", "pressure"):
            assert getattr(ExecutorConfig(), name) == getattr(rc, name), name


class TestBatchLadderUnification:
    def test_defaults_agree_everywhere(self):
        from imaginary_tpu_torch.cli import build_parser
        from imaginary_tpu_torch.engine.executor import MAX_BATCH
        from imaginary_tpu_torch.web.config import ServerOptions

        assert ExecutorConfig().max_batch == MAX_BATCH
        assert ServerOptions().max_batch == MAX_BATCH
        args = build_parser().parse_args([])
        assert args.max_batch == MAX_BATCH
        assert (ExecutorConfig().spatial_threshold_px
                == ServerOptions().spatial_threshold_px
                == args.spatial_threshold_px)


class TestCodecArena:
    @pytest.fixture(autouse=True)
    def _needs_arena(self):
        from imaginary_tpu_torch.codecs import native_backend

        assert native_backend.arena_stats() is not None
        native_backend.set_arena_cap(0.0)
        yield
        native_backend.set_arena_cap(0.0)

    def test_scratch_reused_across_calls(self):
        from imaginary_tpu_torch.codecs import native_backend

        arr = np.random.default_rng(3).integers(0, 256, (240, 320, 3), dtype=np.uint8)
        a = native_backend.resize_separable(arr, 120, 160, "lanczos3")
        before = native_backend.arena_stats()
        b = native_backend.resize_separable(arr, 120, 160, "lanczos3")
        after = native_backend.arena_stats()
        assert after["reuses"] > before["reuses"]
        assert after["misses"] == before["misses"]
        assert after["bytes"] == before["bytes"]
        assert np.array_equal(a, b)

    def test_cap_evicts_oversize_scratch(self):
        from imaginary_tpu_torch.codecs import native_backend

        arr = np.random.default_rng(4).integers(0, 256, (240, 320, 3), dtype=np.uint8)
        native_backend.resize_separable(arr, 120, 160, "lanczos3")
        assert native_backend.set_arena_cap(0.001)
        before = native_backend.arena_stats()
        out = native_backend.resize_separable(arr, 120, 160, "lanczos3")
        after = native_backend.arena_stats()
        assert after["evictions"] > before["evictions"]
        assert after["cap_bytes"] == int(0.001 * 1024 * 1024)
        assert out.shape == (120, 160, 3)

    def test_jpeg_decode_reuses_its_staging_planes(self):
        from imaginary_tpu_torch import codecs
        from imaginary_tpu_torch.codecs import native_backend

        buf = fixture_bytes("large.jpg")
        codecs.decode_yuv420(buf, 1, 1088, 1920)
        before = native_backend.arena_stats()
        codecs.decode_yuv420(buf, 1, 1088, 1920)
        after = native_backend.arena_stats()
        assert after["reuses"] >= before["reuses"] + 3
        assert after["misses"] == before["misses"]


def _staged_bytes(arr: np.ndarray, plan) -> int:
    """The one H2D buffer of a B=1 launch, from the plan alone: the batch,
    its valid dims and each stage's params, each at a 16-byte offset."""
    def aligned(n: int) -> int:
        return (n + 15) // 16 * 16

    batch = arr if plan.in_bucket is not None else chain_mod.pad_to_bucket(arr)
    total = aligned(batch.nbytes) + 2 * aligned(4)
    for st in plan.stages:
        for v in st.dyn.values():
            total += aligned(np.asarray(v).nbytes)
    return total


def _fetched_bytes(plan, channels: int) -> int:
    if plan.out_bucket is not None:
        hb, wb = plan.out_bucket
        return (hb + hb // 2) * wb
    from imaginary_tpu_torch.ops.buckets import tight_dim

    return tight_dim(plan.out_h) * tight_dim(plan.out_w) * channels


class TestWireLedger:
    def test_totals_equal_the_plan_bytes(self):
        """N config 1 requests at B=1: h2d and d2h are N times the staged
        and the fetched bytes the plan gives, one transfer each way."""
        arr, plan = _pipeline_input("resize", ImageOptions(width=300, height=200),
                                    "large.jpg")
        WIRE.reset()
        ex = _cpu(max_form_ms=0.0)
        n = 3
        try:
            for _ in range(n):
                ex.process(arr, plan)
            d = ex.stats.to_dict()
        finally:
            ex.shutdown()
        assert d["wire_transfers"] == {"h2d": n, "d2h": n}
        assert d["wire_bytes"]["h2d"] == n * _staged_bytes(arr, plan)
        assert d["wire_bytes"]["d2h"] == n * _fetched_bytes(plan, 1)
        assert "wire_bytes_by_device" not in d

    def test_sharded_launch_books_by_device(self):
        WIRE.reset()
        ex = _cpu(mesh_policy="sharded", n_devices=2, max_form_ms=200.0,
                  shard_min_items=2)
        try:
            plan = _resize_plan(96, 96, 40)
            for f in [ex.submit(_img(96, 96, seed=i), plan) for i in range(4)]:
                f.result(timeout=60)
            d = ex.stats.to_dict()
        finally:
            ex.shutdown()
        by_dev = d["wire_bytes_by_device"]
        assert sum(by_dev["h2d"].values()) == d["wire_bytes"]["h2d"]
        assert sum(by_dev["d2h"].values()) == d["wire_bytes"]["d2h"]


def _drain_answers(ref: bool) -> list:
    async def runner():
        if ref:
            from imaginary_tpu.web.app import create_app
            from imaginary_tpu.web.config import ServerOptions as Options

            o = Options(host_spill=False)
        else:
            from imaginary_tpu_torch.web.app import create_app
            from imaginary_tpu_torch.web.config import ServerOptions as Options

            o = Options(device="cpu")
        app = create_app(o, log_stream=io.StringIO())
        client = TestClient(TestServer(app))
        await client.start_server()
        out = []
        try:
            app._state["draining"] = True  # what serve() sets on SIGTERM
            r = await client.post("/resize?width=100", data=fixture_bytes("large.jpg"),
                                  headers={"Content-Type": "image/jpeg"})
            out.append((r.status, await r.read(), r.headers.get("Retry-After")))
            r = await client.get("/health")
            out.append((r.status, None, r.headers.get("Retry-After")))
        finally:
            await client.close()
        return out

    return asyncio.run(runner())


class TestDrainShed:
    def test_image_routes_shed_and_health_answers_like_the_reference(self):
        port, ref = _drain_answers(False), _drain_answers(True)
        assert port == ref
        assert port[0][0] == 503 and port[0][2] == "2"
        assert port[1][0] == 200
