"""The port's fleet data plane (`imaginary_tpu_torch/fleet/`) held against
the reference's (`imaginary_tpu/fleet/`, `tests/test_fleet.py`).

The reference's shm protocol class and its tiered-lookup class run
against the port, with their names: the mmap file, fencing, checksum
corruption, torn slots (a real SIGKILLed writer in the slow-marked case),
eviction, and over HTTP on `device="cpu"` the shm tier behind the local
one, fleet-off byte parity, the fenced worker and the /health, /metrics
and /debugz blocks. The reference's read-guard class is ported in
`tests/test_torch_ingress.py`.

Beside them, the two packages on the same file: a slot that one
package's `ShmCache` writes, the other reads, both ways, with the same
epoch table, fence and claim table; and `rendezvous_owner` picks the
reference's owner for 1,000 seeded keys over member sets of 1 to 8. Then
the port's ownership plane on its own: the claim runner's outcomes, the
fleet qos hooks of the limiter and the scheduler, and a forward hop
between two services on one file.
"""

from __future__ import annotations

import asyncio
import hashlib
import io
import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from imaginary_tpu.fleet import ownership as jownership
from imaginary_tpu.fleet import shmcache as jshmcache
from imaginary_tpu_torch import cache as cache_mod
from imaginary_tpu_torch import failpoints
from imaginary_tpu_torch.fleet import ownership, shmcache
from imaginary_tpu_torch.fleet.shmcache import FREE, SEALED, WRITING, ShmCache
from imaginary_tpu_torch.web.config import ServerOptions
from tests.conftest import fixture_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _fixtures(testdata):
    return testdata


@pytest.fixture(autouse=True)
def _disarm():
    yield
    failpoints.deactivate()
    ownership.set_fleet_qos(None)


@pytest.fixture(autouse=True)
def _no_fleet_env(monkeypatch):
    """Each service creates its own standalone file unless a test names one."""
    monkeypatch.delenv(shmcache.PATH_ENV, raising=False)


@pytest.fixture()
def shm(tmp_path):
    path = str(tmp_path / "fleet.shm")
    sup = ShmCache(path, create=True, size_mb=2.0, owner=True)
    worker = ShmCache(path, create=False, worker=0, epoch=0)
    yield sup, worker
    worker.close()
    sup.close()


def _key(tag: bytes) -> bytes:
    return hashlib.sha256(tag).digest()


# --- shm protocol (the reference's TestShmCache) ------------------------------


class TestShmCache:
    def test_roundtrip_and_counters(self, shm):
        _, w = shm
        k = _key(b"a")
        assert w.get(k) is None
        assert w.stats.misses == 1
        assert w.put(k, b"image/jpeg\ndevice", b"B" * 1000)
        meta, body = w.get(k)
        assert (meta, bytes(body)) == (b"image/jpeg\ndevice", b"B" * 1000)
        assert w.stats.hits == 1 and w.stats.publishes == 1

    def test_cross_process_attach_sees_entries(self, shm, tmp_path):
        _, w = shm
        k = _key(b"shared")
        w.put(k, b"m", b"payload")
        sibling = ShmCache(w.path, create=False, worker=1, epoch=0)
        try:
            meta, body = sibling.get(k)
            assert (meta, bytes(body)) == (b"m", b"payload")
        finally:
            sibling.close()

    def test_oversize_entry_refused(self, shm):
        _, w = shm
        assert not w.put(_key(b"big"), b"m", b"x" * shmcache.SLOT_BYTES)
        assert w.stats.publish_oversize == 1

    def test_attach_rejects_non_cache_file(self, tmp_path):
        bogus = tmp_path / "bogus.shm"
        bogus.write_bytes(b"\x00" * 8192)
        with pytest.raises(ValueError):
            ShmCache(str(bogus), create=False)

    def test_fencing_blocks_publish_not_read(self, shm):
        sup, w = shm
        k = _key(b"f")
        assert w.put(k, b"m", b"body")
        sup.stamp_epoch(0, 7)  # a successor for index 0 was stamped
        assert w.fenced()
        assert not w.put(_key(b"f2"), b"m", b"body2")
        assert w.stats.fenced_publishes == 1
        # the deposed worker may still read (sealed entries are immutable)
        meta, body = w.get(k)
        assert (meta, bytes(body)) == (b"m", b"body")
        sup.stamp_epoch(0, 0)
        assert not w.fenced()

    def test_zombie_failpoint_forces_fenced_path(self, shm):
        _, w = shm
        failpoints.activate("worker.zombie=error")
        assert not w.put(_key(b"z"), b"m", b"b")
        assert w.stats.fenced_publishes == 1

    def test_checksum_corruption_reads_as_miss_and_reclaims(self, shm):
        _, w = shm
        k = _key(b"c")
        w.put(k, b"m", b"D" * 256)
        idx = w._candidates(k)[0]
        off = w._slot_off(idx) + shmcache._SLOT_DATA_OFF + 10
        w._mm[off] ^= 0x80  # one flipped bit under a sealed checksum
        assert w.get(k) is None  # corrupt bytes are never returned
        assert w.stats.corrupt == 1
        assert w.stats.corrupt_served == 0
        assert w._slot_state(idx) == FREE

    def test_write_failpoint_error_abandons_cleanly(self, shm):
        _, w = shm
        k = _key(b"e")
        failpoints.activate("fleet.write=error")
        try:
            assert not w.put(k, b"m", b"b")
        finally:
            failpoints.deactivate()
        assert w._slot_state(w._candidates(k)[0]) == FREE
        assert w.put(k, b"m", b"b")
        meta, body = w.get(k)
        assert (meta, bytes(body)) == (b"m", b"b")

    def test_torn_slot_skipped_and_swept(self, shm):
        _, w = shm
        k = _key(b"t")
        w.put(k, b"m", b"body")
        idx = w._candidates(k)[0]
        # a WRITING slot with no live lock holder: what a SIGKILLed writer
        # leaves (the slow case below does it for real)
        struct.pack_into("<I", w._mm, w._slot_off(idx), WRITING)
        assert w.get(k) is None
        assert w.sweep() == 1
        assert w._slot_state(idx) == FREE

    def test_eviction_prefers_oldest_tick(self, shm):
        _, w = shm
        for i in range(w.nslots * 12):
            w.put(_key(b"fill%d" % i), b"m", b"y" * 200)
        assert w.slot_scan()["sealed"] <= w.nslots
        assert w.stats.evictions > 0

    def test_epoch_table_bounds(self, shm):
        sup, _ = shm
        sup.stamp_epoch(shmcache.MAX_WORKERS + 5, 9)  # clamped, no crash
        assert sup.epoch_of(shmcache.MAX_WORKERS - 1) == 9

    def test_snapshot_surfaces(self, shm):
        _, w = shm
        w.put(_key(b"s"), b"m", b"b")
        snap = w.snapshot()
        for field in ("worker", "epoch", "fenced", "slots", "sealed", "hits", "misses",
                      "publishes", "corrupt", "corrupt_served", "torn_reclaimed"):
            assert field in snap
        dbg = w.debug_snapshot()
        assert dbg["path"] == w.path and "epochs" in dbg

    def test_shared_key_matches_etag_derivation(self):
        key = (hashlib.sha256(b"src").digest(), "resize", ("w", 300))
        assert cache_mod.strong_etag(key) == '"' + cache_mod.shared_key(key).hex()[:32] + '"'

    @pytest.mark.slow
    def test_sigkilled_writer_leaves_reclaimable_torn_slot(self, tmp_path):
        path = str(tmp_path / "torn.shm")
        sup = ShmCache(path, create=True, size_mb=1.0, owner=True)
        code = (
            "import hashlib\n"
            "from imaginary_tpu_torch import failpoints\n"
            "from imaginary_tpu_torch.fleet.shmcache import ShmCache\n"
            "failpoints.activate('fleet.write=delay(30s)')\n"
            f"w = ShmCache({path!r}, create=False, worker=1, epoch=0)\n"
            "print('mid-write', flush=True)\n"
            "w.put(hashlib.sha256(b'torn').digest(), b'm', b'x' * 500)\n"
        )
        p = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE)
        try:
            assert b"mid-write" in p.stdout.readline()
            time.sleep(1.0)  # the deposit is inside the WRITING window
            p.kill()
            p.wait(timeout=30)
            k = hashlib.sha256(b"torn").digest()
            idx = sup._candidates(k)[0]
            assert sup._slot_state(idx) == WRITING
            assert sup.get(k) is None
            assert sup.sweep() == 1  # the kernel released the dead lock
            assert sup._slot_state(idx) == FREE
        finally:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            sup.close()


# --- the two packages on one file ---------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_slot_one_package_writes_the_other_reads(tmp_path, writer):
    """Both packages map the same layout byte for byte: magic, geometry,
    epoch table, slot header, checksum and claim table."""
    assert shmcache.MAGIC == jshmcache.MAGIC
    for name in ("HEADER_BYTES", "MAX_WORKERS", "SLOT_BYTES", "ASSOC", "META_BYTES",
                 "_SLOT_DATA_OFF", "CLAIM_SLOTS", "QOS_TENANTS", "_OFF_EPOCHS"):
        assert getattr(shmcache, name) == getattr(jshmcache, name), name
    make = {"reference": jshmcache.ShmCache, "port": ShmCache}
    reader_cls = make["port" if writer == "reference" else "reference"]
    path = str(tmp_path / "both.shm")
    sup = make[writer](path, create=True, size_mb=2.0, owner=True)
    w = make[writer](path, create=False, worker=2, epoch=5)
    r = reader_cls(path, create=False, worker=3, epoch=6)
    try:
        sup.stamp_epoch(2, 5)
        sup.stamp_epoch(3, 6)
        rng = np.random.default_rng(21)
        entries = {}
        for i in range(24):
            k = _key(b"k%d" % i)
            body = rng.integers(0, 256, int(rng.integers(1, 60000)), dtype=np.uint8).tobytes()
            meta = b"image/png\ndevice"
            assert w.put(k, meta, body)
            entries[k] = (meta, body)
        got = {k: r.get(k) for k in entries}
        for k, (meta, body) in entries.items():
            if got[k] is None:
                continue  # evicted by a later colliding deposit
            assert got[k][0] == meta and bytes(got[k][1]) == body
        assert sum(v is not None for v in got.values()) == w.slot_scan()["sealed"] > 0
        assert r.slot_scan() == w.slot_scan()
        assert r.live_workers() == w.live_workers() == [(2, 5), (3, 6)]
        # the writer's fence as both read it
        sup.stamp_epoch(2, 9)
        assert w.fenced() and r.epoch_of(2) == 9 and not r.fenced()
        assert not w.put(_key(b"late"), b"m", b"b")
        # a claim another process holds through one package, the other
        # package sees busy; once the holder dies the kernel frees it
        ck = _key(b"claim")
        pkg = "imaginary_tpu" if writer == "reference" else "imaginary_tpu_torch"
        code = (f"from {pkg}.fleet.shmcache import ShmCache\n"
                f"c = ShmCache({path!r}, create=False, worker=3, epoch=6)\n"
                f"assert c.claim_acquire({ck!r}).won\n"
                "print('held', flush=True)\n"
                "import time; time.sleep(60)\n")
        holder = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                  stdout=subprocess.PIPE)
        try:
            assert b"held" in holder.stdout.readline()
            seen = r.claim_acquire(ck)
            assert seen.busy and seen.holder == 3
            assert r.claim_scan()["live"] == 1
        finally:
            holder.kill()
            holder.wait(timeout=30)
        won = r.claim_acquire(ck)
        assert won.won and r.stats.claims_reclaimed == 1
        r.claim_release(won)
        assert w.claim_scan() == r.claim_scan()
    finally:
        r.close()
        w.close()
        sup.close()


def test_rendezvous_owner_matches_the_reference():
    rng = np.random.default_rng(1000)
    for _ in range(1000):
        key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        n = int(rng.integers(1, 9))
        idxs = sorted(rng.choice(64, n, replace=False).tolist())
        members = [(i, int(rng.integers(1, 100))) for i in idxs]
        want = jownership.rendezvous_owner(members, key)
        assert ownership.rendezvous_owner(members, key) == want
        assert want in idxs
    assert ownership.rendezvous_owner([], b"k" * 32) is None


# --- the claim runner and the fleet qos hooks ----------------------------------


class _Caches:
    """The CacheSet surface the claim runner reads."""

    def __init__(self, shm):
        self.shm = shm
        self.stored = []

    def shm_store(self, key, out, placement):
        self.stored.append((key, placement))
        self.shm.put(cache_mod.shared_key(key), (out.mime + "\n" + placement).encode(), out.body)

    def shm_lookup(self, key):
        got = self.shm.get(cache_mod.shared_key(key))
        if got is None:
            return None
        mime, _, placement = got[0].decode().partition("\n")
        from imaginary_tpu_torch.pipeline import ProcessedImage

        return ProcessedImage(body=bytes(got[1]), mime=mime), placement


def test_claim_runner_runs_once_and_redeems_the_waiter(shm):
    from imaginary_tpu_torch.pipeline import ProcessedImage

    sup, _ = shm
    # one handle for both runners: POSIX record locks do not exclude two
    # handles of one process, so the second runner meets the first through
    # the handle's own table of held claims (the sibling-thread path)
    a = b = ShmCache(sup.path, create=False, worker=0, epoch=1)
    sup.stamp_epoch(0, 1)
    key = (_key(b"src"), "resize", ("w", 1))
    skey = cache_mod.shared_key(key)
    runs = []

    async def main():
        ca, cb = _Caches(a), _Caches(b)
        fa = ownership.FleetCoherence(a, worker=0, hop_s=0.1, poll_s=0.01)
        fb = ownership.FleetCoherence(b, worker=1, hop_s=0.1, poll_s=0.01)
        gate = asyncio.Event()

        async def produce():
            runs.append(1)
            await gate.wait()
            return ProcessedImage(body=b"BODY", mime="image/jpeg"), "device"

        first = asyncio.ensure_future(fa.run_claimed(key, skey, produce, ca))
        await asyncio.sleep(0.05)
        second = asyncio.ensure_future(fb.run_claimed(key, skey, produce, cb))
        await asyncio.sleep(0.05)
        gate.set()
        return await first, await second, fa, fb

    try:
        (o1, p1), (o2, p2), fa, fb = asyncio.run(main())
        assert len(runs) == 1
        assert bytes(o1.body) == bytes(o2.body) == b"BODY" and p1 == p2 == "device"
        assert a.stats.claims_won == 1 and a.stats.claims_busy >= 1
        assert fb.stats.claim_waits == 1 and fb.stats.waiter_hits == 1
        assert a.claim_scan()["live"] == 0
    finally:
        a.close()


def test_claim_failpoint_fails_open_to_a_local_run(shm):
    from imaginary_tpu_torch.pipeline import ProcessedImage

    sup, w = shm
    failpoints.activate("fleet.claim=error")
    flc = ownership.FleetCoherence(w, worker=0, hop_s=0.1)

    async def produce():
        return ProcessedImage(body=b"X", mime="image/png"), "device"

    key = (_key(b"d"), "op")
    out, _ = asyncio.run(flc.run_claimed(key, cache_mod.shared_key(key), produce, _Caches(w)))
    assert out.body == b"X" and flc.stats.local_fallbacks == 1


def test_fleet_qos_bounds_a_tenant_across_processes(shm):
    """The limiter's and the scheduler's hooks read the shared tables:
    two handles on one file meet one GCRA budget and one share cap."""
    from imaginary_tpu_torch.qos.limiter import TenantLimiter
    from imaginary_tpu_torch.qos.sched import FairScheduler
    from imaginary_tpu_torch.qos.shed import TenantShareExceeded
    from imaginary_tpu_torch.qos.tenancy import load_policy

    sup, w = shm
    other = ShmCache(sup.path, create=False, worker=1, epoch=0)
    try:
        policy = load_policy('{"tenants": [{"name": "t", "class": "batch", "rate": 1, '
                             '"burst": 1, "max_share": 0.001, "api_keys": ["k"]}]}')
        tenant = next(t for t in policy.tenants if t.name == "t")  # a queue cap of 1
        lim = TenantLimiter(0, 0)
        ownership.set_fleet_qos(ownership.FleetQos(w, clock=lambda: 1000.0))
        assert lim.allow(tenant)[0] and lim.allow(tenant)[0]
        ownership.set_fleet_qos(ownership.FleetQos(other, clock=lambda: 1000.0))
        allowed, retry = lim.allow(tenant)
        assert not allowed and retry > 0  # the other process's budget is spent
        sched = FairScheduler(policy)

        class Item:
            qos = ("t", 2, 0.001, None)

        ownership.set_fleet_qos(ownership.FleetQos(w))
        sched.put(Item())
        ownership.set_fleet_qos(ownership.FleetQos(other))
        with pytest.raises(TenantShareExceeded):
            FairScheduler(policy).put(Item())  # the cap is fleet-wide
        assert other.qos_share_total("t") == 1
        ownership.set_fleet_qos(ownership.FleetQos(w))
        sched.get_nowait()  # the pop releases the charge on its process's column
        assert other.qos_share_total("t") == 0
    finally:
        other.close()


# --- the tiered HTTP path (the reference's TestTieredLookup) -------------------


def run(options, fn):
    """Run fn(client, app) against a fresh port app on the CPU."""

    async def runner():
        from imaginary_tpu_torch.web.app import create_app

        app = create_app(options, log_stream=io.StringIO())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            await fn(client, app)
        finally:
            await client.close()

    asyncio.run(runner())


def _opts(**kw) -> ServerOptions:
    return ServerOptions(device="cpu", **kw)


def jpg() -> bytes:
    return fixture_bytes("imaginary.jpg")


def _post_kw():
    return {"data": jpg(), "headers": {"Content-Type": "image/jpeg"}}


class TestTieredLookup:
    def test_shm_hit_bytes_identical_to_local_hit(self):
        async def fn(client, app):
            svc = app["service"]
            r1 = await client.post("/resize?width=120&height=90", **_post_kw())
            b1 = await r1.read()
            assert r1.status == 200
            r2 = await client.post("/resize?width=120&height=90", **_post_kw())
            assert await r2.read() == b1  # local hit
            svc.caches.result.clear()
            r3 = await client.post("/resize?width=120&height=90", **_post_kw())
            assert await r3.read() == b1  # shm hit: byte-identical
            assert r3.headers.get("X-Imaginary-Backend") == r1.headers.get("X-Imaginary-Backend")
            assert r3.headers.get("ETag") == r1.headers.get("ETag")
            assert svc.caches.shm.stats.hits == 1

        run(_opts(fleet_cache_mb=4.0, cache_result_mb=4.0), fn)

    def test_shm_tier_works_without_local_result_cache(self):
        async def fn(client, app):
            svc = app["service"]
            r1 = await client.post("/resize?width=100", **_post_kw())
            b1 = await r1.read()
            assert r1.status == 200 and svc.caches.shm.stats.publishes == 1
            r2 = await client.post("/resize?width=100", **_post_kw())
            assert await r2.read() == b1
            assert svc.caches.shm.stats.hits == 1
            etag = r1.headers.get("ETag")
            assert etag
            r3 = await client.post("/resize?width=100", data=jpg(), headers={
                "Content-Type": "image/jpeg", "If-None-Match": etag})
            assert r3.status == 200  # POST never 304s

        run(_opts(fleet_cache_mb=4.0), fn)

    def test_fleet_off_byte_parity(self):
        bodies = {}

        async def baseline(client, app):
            r = await client.post("/resize?width=140&height=100", **_post_kw())
            bodies["off"] = await r.read()
            assert app["service"].caches.shm is None
            h = await client.get("/health")
            assert "fleet" not in await h.json()

        async def armed(client, app):
            r = await client.post("/resize?width=140&height=100", **_post_kw())
            bodies["on"] = await r.read()

        run(_opts(), baseline)
        run(_opts(fleet_cache_mb=4.0), armed)
        assert bodies["off"] == bodies["on"]

    def test_fenced_worker_serves_but_does_not_publish(self):
        async def fn(client, app):
            svc = app["service"]
            svc.caches.shm.stamp_epoch(0, 99)  # depose worker 0
            r = await client.post("/resize?width=90", **_post_kw())
            assert r.status == 200
            assert svc.caches.shm.stats.fenced_publishes == 1
            assert svc.caches.shm.stats.publishes == 0
            h = await (await client.get("/health")).json()
            assert h["fleet"]["fenced"] is True

        run(_opts(fleet_cache_mb=4.0), fn)

    def test_fleet_write_fault_degrades_to_uncached_success(self):
        async def fn(client, app):
            failpoints.activate("fleet.write=error")
            try:
                r = await client.post("/resize?width=80", **_post_kw())
                assert r.status == 200
            finally:
                failpoints.deactivate()
            assert app["service"].caches.shm.stats.publishes == 0

        run(_opts(fleet_cache_mb=4.0), fn)

    def test_health_metrics_debugz_fleet_blocks(self):
        async def fn(client, app):
            await client.post("/resize?width=70", **_post_kw())
            h = await (await client.get("/health")).json()
            assert h["epoch"] == 0
            fleet = h["fleet"]
            assert fleet["publishes"] == 1 and fleet["sealed"] == 1
            m = await (await client.get("/metrics")).text()
            assert "imaginary_tpu_fleet_cache_publishes_total 1" in m
            assert "imaginary_tpu_fleet_cache_corrupt_served_total 0" in m
            assert "imaginary_tpu_fleet_epoch 0" in m
            d = await (await client.get("/debugz")).json()
            assert d["fleet"]["path"] == app["service"].caches.shm.path

        run(_opts(fleet_cache_mb=4.0, enable_debug=True), fn)

    def test_corrupt_shared_entry_recomputed_not_served(self):
        async def fn(client, app):
            svc = app["service"]
            r1 = await client.post("/resize?width=60", **_post_kw())
            b1 = await r1.read()
            shm = svc.caches.shm
            for idx in range(shm.nslots):
                if shm._slot_state(idx) == SEALED:
                    shm._mm[shm._slot_off(idx) + shmcache._SLOT_DATA_OFF + 24] ^= 0xFF
            svc.caches.result.clear()
            r2 = await client.post("/resize?width=60", **_post_kw())
            b2 = await r2.read()
            assert r2.status == 200 and b2 == b1  # recomputed, identical
            assert shm.stats.corrupt >= 1
            assert shm.stats.corrupt_served == 0

        run(_opts(fleet_cache_mb=4.0, cache_result_mb=4.0), fn)


def test_forward_hop_between_two_services_on_one_file(tmp_path, monkeypatch):
    """Two services as workers 0 and 1 of one fleet file with coherence:
    a request that worker 1 takes for a digest worker 0 owns is answered
    over the forward hop, byte-equal to worker 0's own answer; the
    non-owner holds no device frame tier; the shm tier serves the next
    one."""
    from imaginary_tpu_torch.web import workers
    from imaginary_tpu_torch.web.handlers import ImageService

    path = str(tmp_path / "pair.shm")
    sup = ShmCache.create_for_fleet(4.0, path=path)
    sup.stamp_epoch(0, 1)
    sup.stamp_epoch(1, 2)
    monkeypatch.setenv(shmcache.PATH_ENV, path)
    services = {}
    for idx, epoch in ((0, 1), (1, 2)):
        monkeypatch.setenv(workers.WORKER_ENV, str(idx))
        monkeypatch.setenv(workers.WORKER_EPOCH_ENV, str(epoch))
        services[idx] = ImageService(_opts(fleet_cache_mb=4.0, fleet_coherence=True,
                                           cache_device_mb=8.0, fleet_hop_ms=20000))
    monkeypatch.delenv(workers.WORKER_ENV)
    monkeypatch.delenv(workers.WORKER_EPOCH_ENV)

    async def main():
        await services[0].start_coherence()
        await services[1].start_coherence()
        try:
            buf = jpg()
            for width in range(40, 120):
                query = {"width": str(width)}
                prepared = services[1].prepare(buf, query)
                key = cache_mod.request_key(cache_mod.source_digest(buf), "resize",
                                            prepared.opts)
                if services[1].coherence.owner_of(cache_mod.shared_key(key)) == 0:
                    break
            fwd = await services[1].coherence.try_forward(
                "resize", query, buf, cache_mod.shared_key(key))
            assert fwd is not None
            own = services[0].run("resize", buf, services[0].prepare(buf, query))
            assert bytes(fwd[0].body) == own[0].body
            return key
        finally:
            await services[1].aclose()
            await services[0].aclose()

    try:
        key = asyncio.run(main())
        assert services[1].coherence.stats.forwards == 1
        assert services[0].coherence.stats.serve_forwarded == 1
        assert services[0].executor.config.device_owner
        assert not services[1].executor.config.device_owner
        assert services[0]._device_frames is not None and services[1]._device_frames is None
        reader = ShmCache(path, create=False, worker=5, epoch=0)
        try:
            assert reader.get(cache_mod.shared_key(key)) is not None
        finally:
            reader.close()
    finally:
        sup.close()


# --- the supervisor's env contract ---------------------------------------------


def test_worker_epoch_env_helper(monkeypatch):
    from imaginary_tpu_torch.web.workers import WORKER_EPOCH_ENV, worker_epoch

    monkeypatch.delenv(WORKER_EPOCH_ENV, raising=False)
    assert worker_epoch() == 0
    monkeypatch.setenv(WORKER_EPOCH_ENV, "17")
    assert worker_epoch() == 17
