"""The device-resident frame tier (`ops/chain.py`, --cache-device-mb), on
the CPU tier.

The reference's `tests/test_dct.py::TestDeviceFrameCache` runs against the
port on `device="cpu"`, where the tier holds CPU tensors through the same
code as on a card, with the HTTP surface of its `TestHttpSurfaces` case
(/health and /metrics; the port has no /debugz). What differs, and why:
the port stages h, w and the dyns in the launch's one H2D, and books them,
where the reference books the batch alone; so a repeat request's H2D is
those bytes, not zero. Its batch bytes are zero, which is what the
reference's test holds.

Beside them: a hit stages no batch byte and is bit-equal to a miss and
to the tier off; a donated chain over resident parts leaves each resident
tensor bit-unchanged; the sharded and spatial launches, a launch the
failover ladder pins to another entry and a plan without a frame_key
bypass the tier; keys carry the device; a --force-host request over a
frame-cached, read-only array answers the same twice and never writes
it.
"""

from __future__ import annotations

import asyncio
import hashlib
import io

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from imaginary_tpu_torch import codecs, failpoints, pipeline
from imaginary_tpu_torch.cache import CacheSet, DeviceFrameCache, FrameCache
from imaginary_tpu_torch.codecs import jpeg_dct
from imaginary_tpu_torch.engine.executor import Executor, ExecutorConfig
from imaginary_tpu_torch.engine.timing import WIRE
from imaginary_tpu_torch.ops import chain as chain_mod
from imaginary_tpu_torch.ops.plan import plan_operation, wrap_plan_dct
from imaginary_tpu_torch.options import ImageOptions
from imaginary_tpu_torch.parallel.mesh import get_mesh
from imaginary_tpu_torch.web.config import ServerOptions
from tests.conftest import fixture_bytes

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _fixtures(testdata):
    return testdata


@pytest.fixture(autouse=True)
def _clean():
    yield
    chain_mod.set_device_frame_cache(None)
    pipeline.set_transport_dct(False)
    chain_mod.set_donation(True)
    failpoints.deactivate()


def _aligned(n: int) -> int:
    return (n + 15) // 16 * 16


def _dct_item(name="medium.jpg", width=100, key="d0"):
    """(packed coefficients, their dct-transport plan with a frame_key)."""
    buf = fixture_bytes(name)
    meta = codecs.probe_fast(buf)
    packed, h2, w2, layout = jpeg_dct.decode_packed(buf, 1)
    plan = plan_operation("resize", ImageOptions(width=width), h2, w2, meta.orientation, 3)
    return packed, wrap_plan_dct(plan, meta.height, meta.width, 1,
                                 frame_key=(key, 1, "dct"), layout=layout)


def _arm(device_mb=8.0):
    cs = CacheSet(frame_mb=8.0, device_mb=device_mb)
    dc = DeviceFrameCache(cs.device, cs.stats)
    chain_mod.set_device_frame_cache(dc)
    return cs, dc


class TestDeviceFrameCache:
    def _serve_twice(self, cs):
        dc = DeviceFrameCache(cs.device, cs.stats)
        chain_mod.set_device_frame_cache(dc)
        fc = FrameCache(cs.frames, cs.stats)
        pipeline.set_transport_dct(True)
        buf = fixture_bytes("medium.jpg")
        digest = hashlib.sha256(buf).hexdigest()
        o = ImageOptions(width=100)
        w0 = WIRE.snapshot()
        r1 = pipeline.process_operation("resize", buf, o, device=CPU,
                                        frame_cache=fc, source_digest=digest)
        w1 = WIRE.snapshot()
        r2 = pipeline.process_operation("resize", buf, o, device=CPU,
                                        frame_cache=fc, source_digest=digest)
        w2 = WIRE.snapshot()
        assert r1.body == r2.body
        return dc, (w0, w1, w2)

    def test_hot_source_pays_zero_h2d(self):
        cs = CacheSet(frame_mb=8.0, device_mb=8.0)
        dc, (w0, w1, w2) = self._serve_twice(cs)
        packed = dc.bytes_used
        assert w1["h2d"] > w0["h2d"]  # first request staged the input
        # the repeat stages h, w and the dyns only: zero batch bytes
        assert (w1["h2d"] - w0["h2d"]) - (w2["h2d"] - w1["h2d"]) == _aligned(packed)
        assert w2["h2d_transfers"] - w1["h2d_transfers"] == 1
        assert w2["d2h"] > w1["d2h"]  # the result still drains
        assert cs.stats.device_misses == 1 and cs.stats.device_hits == 1
        assert dc.bytes_used > 0
        assert cs.to_dict()["device_bytes"] == dc.bytes_used

    def test_pressure_ladder_shrinks_then_disables(self):
        cs = CacheSet(frame_mb=8.0, device_mb=8.0)
        dc, _ = self._serve_twice(cs)
        base = cs.device.budget
        assert base == int(8.0 * 1e6)
        cs.apply_pressure(1)  # elevated: halve
        assert cs.device.budget == base // 2
        assert dc.enabled
        cs.apply_pressure(2)  # critical: disable + flush
        assert not dc.enabled
        assert dc.bytes_used == 0 and len(dc) == 0
        # disabled cache: serving continues, inputs just re-stage
        w_before = WIRE.snapshot()["h2d"]
        buf = fixture_bytes("medium.jpg")
        digest = hashlib.sha256(buf).hexdigest()
        fc = FrameCache(cs.frames, cs.stats)
        pipeline.process_operation("resize", buf, ImageOptions(width=100), device=CPU,
                                   frame_cache=fc, source_digest=digest)
        assert WIRE.snapshot()["h2d"] > w_before
        cs.apply_pressure(0)  # recovery: budget restored
        assert cs.device.budget == base and dc.enabled

    def test_no_digest_no_device_caching(self):
        cs = CacheSet(device_mb=8.0)
        dc = DeviceFrameCache(cs.device, cs.stats)
        chain_mod.set_device_frame_cache(dc)
        pipeline.set_transport_dct(True)
        pipeline.process_operation("resize", fixture_bytes("medium.jpg"),
                                   ImageOptions(width=100), device=CPU)
        # without a content digest there is no stable identity to pin
        assert len(dc) == 0 and cs.stats.device_hits == 0

    def test_health_metrics_carry_device_and_wire(self):
        from imaginary_tpu_torch.web.app import create_app

        opts = ServerOptions(transport_dct=True, cache_frame_mb=8.0,
                             cache_device_mb=8.0, device=CPU)

        async def runner():
            app = create_app(opts, log_stream=io.StringIO())
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                body = fixture_bytes("medium.jpg")
                for _ in range(2):
                    res = await client.post(
                        "/resize?width=100", data=body,
                        headers={"Content-Type": "image/jpeg"})
                    assert res.status == 200
                h = await (await client.get("/health")).json()
                assert h["cache"]["device_bytes"] > 0
                assert h["cache"]["device_hits"] >= 1
                assert h["executor"]["wire_bytes"]["d2h"] > 0
                m = await (await client.get("/metrics")).text()
                assert 'imaginary_tpu_wire_bytes_total{direction="h2d"}' in m
                assert 'imaginary_tpu_wire_transfers_total{direction="d2h"}' in m
                assert "imaginary_tpu_cache_device_bytes" in m
            finally:
                await client.close()
            # the service's close hands the resident frames back
            assert chain_mod.device_frame_cache() is None

        asyncio.run(runner())


def _launch(arrs, plans, **kw):
    y = chain_mod.launch_batch(arrs, plans, device=CPU, **kw)
    return chain_mod.fetch_batch(y, arrs, plans)


def _planes(outs) -> list:
    return [np.concatenate([o.y.ravel(), o.u.ravel(), o.v.ravel()]) for o in outs]


def test_hit_stages_no_batch_bytes_and_is_bit_equal():
    a1, p1 = _dct_item(key="a")
    a2, p2 = _dct_item(key="b")
    arrs, plans = [a1, a2], [p1, p2]
    off = _planes(_launch(arrs, plans))
    cs, dc = _arm()
    w0 = WIRE.snapshot()
    miss = _planes(_launch(arrs, plans, device_cache=True))
    w1 = WIRE.snapshot()
    hit = _planes(_launch(arrs, plans, device_cache=True))
    w2 = WIRE.snapshot()
    for a, b, c in zip(off, miss, hit):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    batch = _aligned(a1.nbytes) + _aligned(a2.nbytes)
    assert (w1["h2d"] - w0["h2d"]) - (w2["h2d"] - w1["h2d"]) == batch
    assert w1["h2d_transfers"] - w0["h2d_transfers"] == 3  # two items, then the rest
    assert w2["h2d_transfers"] - w1["h2d_transfers"] == 1
    assert (cs.stats.device_misses, cs.stats.device_hits) == (2, 2)
    assert dc.bytes_used == a1.nbytes + a2.nbytes


def test_keys_carry_the_device():
    a, p = _dct_item(key="k")
    cs, dc = _arm()
    _launch([a], [p], device_cache=True)
    assert list(cs.device._map) == [(p.frame_key, "cpu")]


def test_donated_chain_leaves_resident_tensors_unchanged():
    """Donation writes the last launch's output into the batch region of
    the launch's own stacked buffer, never into a resident frame."""
    chain_mod.set_donation(True)
    a, p = _dct_item(key="don")
    cs, dc = _arm()
    before = chain_mod.donation_stats()["donated"]
    first = _planes(_launch([a, a], [p, p], device_cache=True))
    (x, event), = [v for v, _, _ in cs.device._map.values()]
    assert event is None  # the CPU tier records no event
    crc = x.clone()
    second = _planes(_launch([a, a], [p, p], device_cache=True))
    assert chain_mod.donation_stats()["donated"] > before
    assert torch.equal(x, crc)
    assert np.array_equal(x.numpy().reshape(a.shape), a)
    for u, v in zip(first, second):
        assert np.array_equal(u, v)


def test_plan_without_frame_key_bypasses():
    a, p = _dct_item(key="nokey")
    p.frame_key = None
    cs, dc = _arm()
    _launch([a], [p], device_cache=True)
    assert len(dc) == 0 and cs.stats.device_misses == 0


def test_sharded_and_spatial_launches_bypass():
    a, p = _dct_item(key="mesh")
    cs, dc = _arm()
    mesh = get_mesh(devices=[CPU] * 2)
    y = chain_mod.launch_sharded([a, a], [p, p], mesh)
    chain_mod.fetch_batch(y, [a, a], [p, p])
    y = chain_mod.launch_spatial(a, p, [CPU, CPU])
    chain_mod.fetch_batch(y, [a], [p])
    assert len(dc) == 0
    assert cs.stats.device_misses == cs.stats.device_hits == 0


def test_failover_pinned_launch_bypasses():
    """The global ladder's first rung uses the tier; a chunk the ladder
    moves to another entry (entry 0 struck) stages anew."""
    a, p = _dct_item(key="ladder")
    cs, dc = _arm()
    ex = Executor(ExecutorConfig(device=CPU, n_devices=2, breaker_threshold=100))
    try:
        ex.process(a, p, timeout=60)
        assert (cs.stats.device_misses, len(dc)) == (1, 1)
        failpoints.activate("device.chip_error[0]=error")
        ex.process(a, p, timeout=60)
        assert ex.stats.device_failures >= 1
        assert cs.stats.device_misses + cs.stats.device_hits == 1
    finally:
        ex.shutdown()


def test_force_host_over_read_only_frame_never_writes_it():
    from imaginary_tpu_torch.web.app import create_app

    answers = []

    async def runner():
        app = create_app(ServerOptions(cache_frame_mb=64.0, force_host=True, device=CPU),
                         log_stream=io.StringIO())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            svc = app["service"]
            for _ in range(2):
                res = await client.post("/resize?width=120&height=80",
                                        data=fixture_bytes("imaginary.jpg"),
                                        headers={"Content-Type": "image/jpeg"})
                assert res.status == 200
                assert res.headers["X-Imaginary-Backend"] == "host"
                answers.append(await res.read())
                entries = [v for v, _, _ in svc.caches.frames._map.values()]
                assert len(entries) == 1
                arr = entries[0][0]
                assert not arr.flags.writeable
                answers.append(hashlib.sha256(arr.tobytes()).digest())
            assert svc.caches.stats.frame_hits == 1
        finally:
            await client.close()

    asyncio.run(runner())
    assert answers[0] == answers[2] and answers[1] == answers[3]
