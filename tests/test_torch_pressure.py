"""The port's memory-pressure governor and brownout ladder held against the
reference's (`imaginary_tpu/engine/pressure.py`, `tests/test_pressure.py`).

The reference's `TestGovernor`, `TestBombGate`, `TestHttpLadder` and
`TestMallocTrim` run against the port (its app on `device="cpu"`), with
the two executor rungs of its `TestOomRecovery` (the batch byte cap and
the oversize item forced to the host; the port's OOM bisection is held
in tests/test_torch_placement.py) and `TestCacheBrownout` (the cache
tiers' ladder, cache.py). Beside them, one `rss_fn` sequence
gives the port's and the reference's governors the same levels,
transitions and batch caps, and the ladder's HTTP answers equal the
reference app's.

What differs, and why: the port decodes no PDF, so
`test_pdf_mini_inflate_budget_pin` has nothing to pin; and it has no
wide events, so
`test_wide_event_carries_pressure_level` reads the request trace's
fields, which the reference's wide event is built from.
"""

from __future__ import annotations

import asyncio
import io
import json
import random
import struct
import time
import zlib

import numpy as np
import pytest
from aiohttp import FormData
from aiohttp.test_utils import TestClient, TestServer

from imaginary_tpu import failpoints as jfailpoints
from imaginary_tpu.engine import pressure as jpm
from imaginary_tpu_torch import codecs, failpoints
from imaginary_tpu_torch.codecs import CodecError
from imaginary_tpu_torch.engine import pressure as pm
from imaginary_tpu_torch.engine.executor import Executor, ExecutorConfig
from imaginary_tpu_torch.obs import trace as obs_trace
from imaginary_tpu_torch.ops.plan import plan_operation
from imaginary_tpu_torch.options import ImageOptions
from imaginary_tpu_torch.web.config import ServerOptions
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")


def _cfg(**kw) -> pm.PressureConfig:
    kw.setdefault("rss_limit_mb", 1000.0)
    kw.setdefault("sample_interval_s", 0.0)  # every level() call re-samples
    return pm.PressureConfig(**kw)


def png_bomb(w: int = 60000, h: int = 60000) -> bytes:
    """A structurally valid PNG declaring w x h over one token IDAT."""
    def chunk(tag: bytes, payload: bytes) -> bytes:
        body = tag + payload
        return (struct.pack(">I", len(payload)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"\x00"))
            + chunk(b"IEND", b""))


def gif_bomb(w: int = 65500, h: int = 65500) -> bytes:
    return b"GIF89a" + struct.pack("<HH", w, h) + b"\x00\x00\x00"


def jpeg_bomb(w: int = 60000, h: int = 60000) -> bytes:
    app0 = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    sof0 = b"\xff\xc0" + struct.pack(">HBHHB", 11, 8, h, w, 1) + b"\x01\x11\x00"
    sos = b"\xff\xda\x00\x08\x01\x01\x00\x00\x3f\x00"
    return b"\xff\xd8" + app0 + sof0 + sos + b"\xff\xd9"


def small_jpeg(w: int = 320, h: int = 240) -> bytes:
    from PIL import Image

    arr = np.linspace(0, 255, w * h * 3).reshape(h, w, 3).astype(np.uint8)
    out = io.BytesIO()
    Image.fromarray(arr).save(out, "JPEG", quality=85)
    return out.getvalue()


def _resize_plan():
    return plan_operation("resize", ImageOptions(width=32, height=32, force=True),
                          64, 64, 0, 3)


def _submit_n(ex, n: int) -> list:
    rng = np.random.default_rng(0)
    return [ex.submit(rng.integers(0, 255, (64, 64, 3), np.uint8), _resize_plan())
            for _ in range(n)]


# --- the governor ------------------------------------------------------------

class TestGovernor:
    def test_levels_and_hysteresis(self):
        vals = {"v": 100.0}
        g = pm.MemoryGovernor(_cfg(), rss_fn=lambda: vals["v"])
        assert g.level() == pm.LEVEL_OK
        vals["v"] = 800.0
        assert g.level() == pm.LEVEL_ELEVATED
        vals["v"] = 950.0
        assert g.level() == pm.LEVEL_CRITICAL
        vals["v"] = 870.0  # below critical, above its demote band: latches
        assert g.level() == pm.LEVEL_CRITICAL
        vals["v"] = 840.0
        assert g.level() == pm.LEVEL_ELEVATED
        vals["v"] = 720.0
        assert g.level() == pm.LEVEL_ELEVATED
        vals["v"] = 600.0
        assert g.level() == pm.LEVEL_OK
        snap = g.snapshot()
        assert snap["transitions"] == {"ok": 1, "elevated": 2, "critical": 1}
        assert snap["level"] == "ok"
        assert len(snap["recent_transitions"]) == 4

    def test_sampling_interval_caches(self):
        calls = [0]

        def rss():
            calls[0] += 1
            return 100.0

        g = pm.MemoryGovernor(_cfg(sample_interval_s=60.0), rss_fn=rss)
        for _ in range(50):
            g.level()
        assert calls[0] == 1

    def test_host_and_device_signals(self):
        g = pm.MemoryGovernor(_cfg(hbm_limit_mb=100.0), rss_fn=lambda: 100.0)
        assert g.level() == pm.LEVEL_OK
        g.bind_sources(host_mb_fn=lambda: 800.0)
        assert g.level() == pm.LEVEL_CRITICAL
        g.bind_sources(host_mb_fn=lambda: 0.0, device_mb_fn=lambda: 80.0)
        assert g.level() == pm.LEVEL_ELEVATED

    def test_memory_rss_failpoint_forces_critical(self):
        g = pm.MemoryGovernor(_cfg(), rss_fn=lambda: 1.0)
        assert g.level() == pm.LEVEL_OK
        failpoints.activate("memory.rss=error")
        try:
            assert g.level() == pm.LEVEL_CRITICAL
        finally:
            failpoints.deactivate()
        assert g.level() == pm.LEVEL_OK

    def test_transition_callbacks_and_batch_cap(self):
        vals = {"v": 100.0}
        seen = []
        g = pm.MemoryGovernor(_cfg(batch_mb=40.0), rss_fn=lambda: vals["v"])
        g.on_transition(lambda old, new: seen.append((old, new)))
        assert g.batch_cap_mb() == 0.0
        vals["v"] = 800.0
        assert g.batch_cap_mb() == 40.0
        vals["v"] = 950.0
        assert g.batch_cap_mb() == 20.0
        assert seen == [(0, 1), (1, 2)]

    def test_from_options_off_by_default(self):
        assert pm.from_options(ServerOptions()) is None
        g = pm.from_options(ServerOptions(pressure_rss_mb=512.0))
        assert g is not None and g.config.rss_limit_mb == 512.0

    def test_release_memory_reports(self):
        got = pm.release_memory()
        assert "collected" in got and "trimmed" in got

    @pytest.mark.parametrize("seed", [0, 1])
    def test_levels_equal_the_reference(self, seed):
        """One rss/host/device sequence (failpoint firings included) gives
        both governors the same levels, batch caps and snapshots."""
        rng = random.Random(seed)
        seq = [(rng.uniform(0, 1100), rng.uniform(0, 200), rng.uniform(0, 120),
                rng.random() < 0.05) for _ in range(300)]
        i = {"k": 0}
        kw = dict(rss_limit_mb=1000.0, hbm_limit_mb=100.0, sample_interval_s=0.0,
                  batch_mb=24.0)
        mine = pm.MemoryGovernor(pm.PressureConfig(**kw),
                                 rss_fn=lambda: seq[i["k"]][0],
                                 host_mb_fn=lambda: seq[i["k"]][1],
                                 device_mb_fn=lambda: seq[i["k"]][2])
        ref = jpm.MemoryGovernor(jpm.PressureConfig(**kw),
                                 rss_fn=lambda: seq[i["k"]][0],
                                 host_mb_fn=lambda: seq[i["k"]][1],
                                 device_mb_fn=lambda: seq[i["k"]][2])
        got, want = [], []
        for k, (_, _, _, forced) in enumerate(seq):
            i["k"] = k
            for mod in (failpoints, jfailpoints):
                mod.activate("memory.rss=error" if forced else "")
            try:
                got.append((mine.level(), mine.batch_cap_mb()))
                want.append((ref.level(), ref.batch_cap_mb()))
            finally:
                for mod in (failpoints, jfailpoints):
                    mod.deactivate()
        assert got == want
        assert {lvl for lvl, _ in got} == {0, 1, 2}
        a, b = mine.snapshot(), ref.snapshot()
        for k in ("level", "state", "transitions", "batch_sheds", "pixel_clamps"):
            assert a[k] == b[k], k
        assert [(t["from"], t["to"]) for t in a["recent_transitions"]] == \
            [(t["from"], t["to"]) for t in b["recent_transitions"]]


# --- the executor's rungs (the reference's TestOomRecovery) ------------------

class TestOomRecovery:
    def test_pressure_batch_byte_cap(self):
        """Elevated pressure slices a group by wire bytes, not just item
        count: launches shrink before the card overflows."""
        gov = pm.MemoryGovernor(_cfg(batch_mb=0.05), rss_fn=lambda: 800.0)  # elevated
        ex = Executor(ExecutorConfig(device="cpu", host_spill=False, window_ms=1.0,
                                     pressure=gov))
        try:
            outs = [f.result(timeout=60) for f in _submit_n(ex, 8)]
            assert all(o.shape == (32, 32, 3) for o in outs)
            assert ex.stats.pressure_capped_batches > 0
        finally:
            ex.shutdown()

    def test_pressure_oversize_forced_to_host(self):
        gov = pm.MemoryGovernor(_cfg(oversize_mpix=0.001), rss_fn=lambda: 800.0)
        ex = Executor(ExecutorConfig(device="cpu", host_spill=False, window_ms=1.0,
                                     pressure=gov))
        try:
            out = ex.process(np.random.randint(0, 255, (64, 64, 3), np.uint8),
                             _resize_plan())
            assert out.shape == (32, 32, 3)
            assert ex.stats.pressure_host_forced == 1
            assert ex.stats.spilled == 1  # rode the spill branch
            assert ex.stats.batches == 0
        finally:
            ex.shutdown()


# --- decode-bomb hardening ---------------------------------------------------

class TestBombGate:
    @pytest.fixture(autouse=True)
    def _reset_cap(self):
        token = codecs.set_decode_pixel_cap(0.0)
        yield
        codecs._DECODE_PIXEL_CAP.reset(token)

    @pytest.mark.parametrize("bomb,fmt", [
        (png_bomb(), "png"), (gif_bomb(), "gif"), (jpeg_bomb(), "jpeg"),
    ])
    def test_corpus_rejected_before_allocation(self, bomb, fmt):
        codecs.set_decode_pixel_cap(18.0)
        with pytest.raises(CodecError) as ei:
            codecs.decode(bomb)
        assert ei.value.code == 413
        assert "megapixel" in ei.value.message

    def test_cap_zero_gate_disarmed(self):
        try:
            codecs.decode(gif_bomb(200, 200))
        except CodecError as e:
            assert e.code != 413

    def test_small_image_passes_gate(self):
        codecs.set_decode_pixel_cap(18.0)
        d = codecs.decode(small_jpeg())
        assert d.array.shape[:2] == (240, 320)

    def test_codec_bomb_failpoint(self):
        codecs.set_decode_pixel_cap(0.0)
        failpoints.activate("codec.bomb=error")
        try:
            with pytest.raises(CodecError) as ei:
                codecs.decode(small_jpeg())
            assert ei.value.code == 413
        finally:
            failpoints.deactivate()


class TestCacheBrownout:
    def test_set_budget_evicts_down(self):
        from imaginary_tpu_torch.cache import ByteBudgetLRU

        evicted = []
        lru = ByteBudgetLRU(1000, on_evict=lambda n: evicted.append(n))
        for i in range(10):
            lru.put(i, b"x", 100)
        assert lru.bytes_used == 1000
        lru.set_budget(300)
        assert lru.bytes_used <= 300
        assert sum(evicted) == 7
        assert lru.get(9) is not None  # most-recent survives
        assert lru.get(0) is None  # LRU went first

    def test_apply_pressure_ladder(self):
        from imaginary_tpu_torch.cache import CacheSet

        cs = CacheSet(result_mb=1.0, frame_mb=1.0, coalesce=False,
                      source_ttl_s=60.0, source_mb=1.0)
        base = cs.result.budget
        cs.apply_pressure(pm.LEVEL_ELEVATED)
        assert cs.result.budget == base // 2
        assert cs.source.budget > 0
        cs.apply_pressure(pm.LEVEL_CRITICAL)
        assert cs.result.budget == base // 4
        assert cs.source.budget == 0 and not cs.source.enabled
        cs.apply_pressure(pm.LEVEL_OK)
        assert cs.result.budget == base and cs.source.enabled
        assert cs.stats.pressure_shrinks == 2
        assert cs.to_dict()["pressure_shrinks"] == 2

    def test_critical_flushes_source_entries(self):
        from imaginary_tpu_torch.cache import CacheSet

        cs = CacheSet(source_ttl_s=60.0, source_mb=1.0)
        cs.source.put("k", b"body", 4)
        assert cs.source.get("k") == b"body"
        cs.apply_pressure(pm.LEVEL_CRITICAL)
        assert cs.source.get("k") is None  # evicted, not just disabled


# --- HTTP: the brownout ladder end to end ------------------------------------

QOS_CFG = json.dumps({
    "default": {"class": "standard"},
    "tenants": [{"name": "bulk", "class": "batch", "api_keys": ["bulk-key"]}],
})

PRESSURE_OPTS = dict(pressure_rss_mb=1_000_000.0)  # governor on, rung ok


def run(options: dict, fn, origin_handler=None, ref: bool = False):
    """Run `fn(client, origin_url)` against a fresh app: the port's on the
    CPU, or with `ref` the reference's (host spill off, as the port's)."""

    async def runner():
        from aiohttp import web

        origin_url = origin = None
        if origin_handler is not None:
            oapp = web.Application()
            oapp.router.add_route("*", "/{tail:.*}", origin_handler)
            origin = TestServer(oapp)
            await origin.start_server()
            origin_url = f"http://127.0.0.1:{origin.port}"
        if ref:
            from imaginary_tpu.web.app import create_app
            from imaginary_tpu.web.config import ServerOptions as JServerOptions

            app = create_app(JServerOptions(**options, host_spill=False),
                             log_stream=io.StringIO())
        else:
            from imaginary_tpu_torch.web.app import create_app

            app = create_app(ServerOptions(**options, device="cpu"),
                             log_stream=io.StringIO())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            await fn(client, origin_url)
        finally:
            await client.close()
            if origin is not None:
                await origin.close()

    asyncio.run(runner())


def _arm_critical(client, mod=failpoints):
    """Force the service's governor to critical through the memory.rss
    failpoint (the sample interval zeroed so the next request re-samples)."""
    client.server.app["service"].pressure.config.sample_interval_s = 0.0
    mod.activate("memory.rss=error")


def _form(buf: bytes, name: str = "s.jpg", ctype: str = "image/jpeg") -> FormData:
    form = FormData()
    form.add_field("file", buf, filename=name, content_type=ctype)
    return form


class TestHttpLadder:
    def test_parity_defaults_build_no_governor(self):
        async def fn(client, _):
            assert client.server.app["service"].pressure is None
            body = await (await client.get("/health")).json()
            assert "pressure" not in body
            assert "imaginary_tpu_pressure" not in await (await client.get("/metrics")).text()

        run(dict(), fn)

    def test_health_and_metrics_pressure_block(self):
        async def fn(client, _):
            body = await (await client.get("/health")).json()
            assert body["pressure"]["level"] == "ok"
            assert body["pressure"]["rss_mb"] > 0
            text = await (await client.get("/metrics")).text()
            assert "imaginary_tpu_pressure_state 0" in text
            assert "imaginary_tpu_oom_splits_total 0" in text
            assert 'imaginary_tpu_pressure_transitions_total{level="critical"} 0' in text

        run(dict(**PRESSURE_OPTS), fn)

    def test_multipart_bomb_rejected_413(self):
        async def fn(client, _):
            for bomb, name, ctype in ((png_bomb(), "b.png", "image/png"),
                                      (gif_bomb(), "b.gif", "image/gif"),
                                      (jpeg_bomb(), "b.jpg", "image/jpeg")):
                res = await client.post("/resize?width=100&height=100",
                                        data=_form(bomb, name, ctype))
                assert res.status == 413, (name, await res.text())

        run(dict(**PRESSURE_OPTS), fn)

    def test_url_bomb_rejected_413(self):
        from aiohttp import web as aioweb

        async def origin(request):
            return aioweb.Response(body=png_bomb(), content_type="image/png")

        async def fn(client, origin_url):
            res = await client.get(f"/resize?width=100&height=100&url={origin_url}/bomb.png")
            assert res.status == 413, await res.text()

        run(dict(enable_url_source=True, **PRESSURE_OPTS), fn, origin_handler=origin)

    def test_bomb_is_422_without_governor(self):
        async def fn(client, _):
            res = await client.post("/resize?width=100&height=100",
                                    data=_form(png_bomb(), "b.png", "image/png"))
            assert res.status == 422

        run(dict(), fn)

    def test_critical_sheds_batch_class_only(self):
        async def fn(client, _):
            _arm_critical(client)
            try:
                res = await client.post("/resize?width=64&height=64&key=bulk-key",
                                        data=_form(small_jpeg()))
                assert res.status == 503
                assert "Retry-After" in res.headers
                assert "memory pressure" in (await res.json())["message"]
                res = await client.post("/resize?width=64&height=64",
                                        data=_form(small_jpeg()))
                assert res.status == 200
            finally:
                failpoints.deactivate()
            assert client.server.app["service"].pressure.snapshot()["batch_sheds"] >= 1

        run(dict(qos_config=QOS_CFG, **PRESSURE_OPTS), fn)

    def test_critical_clamps_output_resolution(self):
        async def fn(client, _):
            _arm_critical(client)
            try:
                # 6000x6000 = 36 MP output > 18 * 0.25 = 4.5 MP clamp
                res = await client.post("/enlarge?width=6000&height=6000",
                                        data=_form(small_jpeg()))
                assert res.status == 413
                assert "Retry-After" in res.headers
                res = await client.post("/resize?width=64&height=64",
                                        data=_form(small_jpeg()))
                assert res.status == 200
            finally:
                failpoints.deactivate()
            assert client.server.app["service"].pressure.snapshot()["pixel_clamps"] >= 1

        run(dict(**PRESSURE_OPTS), fn)

    def test_critical_shrinks_cache_budgets(self):
        """The reference's test: the critical rung quarters the result
        tier and turns the source tier off; ok restores both."""
        async def fn(client, _):
            svc = client.server.app["service"]
            base = svc.caches.result.budget
            assert base > 0 and svc.caches.source.enabled
            _arm_critical(client)
            try:
                res = await client.get("/health")
                assert (await res.json())["pressure"]["level"] == "critical"
                assert svc.caches.result.budget == base // 4
                assert not svc.caches.source.enabled
            finally:
                failpoints.deactivate()
            # recovery restores the configured budgets
            res = await client.get("/health")
            assert (await res.json())["pressure"]["level"] == "ok"
            assert svc.caches.result.budget == base
            assert svc.caches.source.enabled

        run(dict(cache_result_mb=4.0, cache_source_ttl=60.0, **PRESSURE_OPTS), fn)

    def test_wide_event_carries_pressure_level(self):
        seen = {}

        async def fn(client, _):
            svc = client.server.app["service"]
            real = svc.run

            def run_and_read(*a, **k):
                out = real(*a, **k)
                seen.update(obs_trace.current().fields)
                return out

            svc.run = run_and_read
            res = await client.post("/resize?width=64&height=64", data=_form(small_jpeg()))
            assert res.status == 200

        run(dict(**PRESSURE_OPTS), fn)
        assert seen.get("pressure") == "ok"

    def test_ladder_answers_equal_the_reference(self):
        """The ladder's statuses, bodies and Retry-After headers on both
        apps: a bomb's 413, the critical rung's batch shed and its pixel
        clamps, and what still serves at critical."""
        answers = {}

        def fn_for(side):
            mod = jfailpoints if side == "ref" else failpoints

            async def fn(client, _):
                out = []
                res = await client.post("/resize?width=100&height=100",
                                        data=_form(png_bomb(), "b.png", "image/png"))
                out.append((res.status, await res.read(), res.headers.get("Retry-After")))
                _arm_critical(client, mod)
                try:
                    for path, key in (("/resize?width=64&height=64", "bulk-key"),
                                      ("/enlarge?width=6000&height=6000", None),
                                      ("/resize?width=64&height=64", None)):
                        headers = {"API-Key": key} if key else {}
                        res = await client.post(path, data=_form(small_jpeg()),
                                                headers=headers)
                        body = await res.read()
                        out.append((res.status, body if res.status != 200 else b"",
                                    res.headers.get("Retry-After")))
                finally:
                    mod.deactivate()
                answers[side] = out

            return fn

        for side in ("ref", "port"):
            run(dict(qos_config=QOS_CFG, **PRESSURE_OPTS), fn_for(side),
                ref=side == "ref")
        assert answers["port"] == answers["ref"]
        assert [s for s, _, _ in answers["port"]] == [413, 503, 413, 200]


class TestMallocTrim:
    def test_release_memory_drops_rss(self):
        """gc.collect alone leaves freed pages in glibc's arena;
        release_memory's malloc_trim returns them to the OS: asserted as
        an RSS drop after releasing a 256 MB buffer."""
        from imaginary_tpu_torch.web.health import _rss_mb

        if not pm._malloc_trim():
            pytest.skip("malloc_trim unavailable on this libc")
        buf = bytearray(256 * 1024 * 1024)
        buf[::4096] = b"x" * len(buf[::4096])  # touch every page
        high = _rss_mb()
        del buf
        got = pm.release_memory()
        assert got["trimmed"]
        time.sleep(0.1)
        low = _rss_mb()
        assert high - low > 128.0, (high, low)
