"""The port's multi-tenant qos (`imaginary_tpu_torch/qos/`) held against the
reference's (`imaginary_tpu/qos/`).

The reference's `tests/test_qos.py`, its eleven classes under their
names, run against the port's modules and app (`device="cpu"`), and
beside them the same inputs go through both packages:

- `parse_policy` of one JSON gives the same tenants and knobs;
- one put/get sequence gives the same pop order from both
  `FairScheduler`s (share-cap rejections included);
- one clock gives the same `TenantLimiter` decisions;
- the HTTP answers of the qos cases (class shedding, the `qos.admit`
  failpoint, the per-tenant 429) have the reference app's statuses,
  bodies and Retry-After headers.

What differs, and why: the port has no /debugz and no wide events, so
`test_tenant_stamped_on_trace_surfaces` and
`test_wide_event_carries_tenant` read the request trace's fields (what
the reference's slow ring and wide event are built from) and hold them
against the reference's wide event.
"""

from __future__ import annotations

import asyncio
import io
import json
import queue as queue_mod
import random
import threading

import numpy as np
import pytest
from aiohttp import FormData
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from imaginary_tpu import failpoints as jfailpoints
from imaginary_tpu.qos import sched as jsched
from imaginary_tpu.qos import tenancy as jtenancy
from imaginary_tpu.qos.limiter import TenantLimiter as JTenantLimiter
from imaginary_tpu.web import middleware as jmiddleware
from imaginary_tpu.web.config import ServerOptions as JServerOptions
from imaginary_tpu_torch import failpoints
from imaginary_tpu_torch.obs import trace as obs_trace
from imaginary_tpu_torch.qos import CLASSES
from imaginary_tpu_torch.qos.limiter import TenantLimiter
from imaginary_tpu_torch.qos.sched import FairScheduler
from imaginary_tpu_torch.qos.shed import TenantShareExceeded
from imaginary_tpu_torch.qos.tenancy import (
    TenantSpec,
    load_policy,
    parse_policy,
    request_qos,
)
from imaginary_tpu_torch.web import middleware as pmiddleware
from imaginary_tpu_torch.web.config import ServerOptions
from imaginary_tpu_torch.web.middleware import GCRARateLimiter
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")


def policy_doc(**overrides) -> dict:
    """A small two-tenant policy: gold=interactive (keyed), hog=batch
    (ip-matched, 1/16 queue share on a 64-slot queue -> cap 4)."""
    doc = {
        "default": {"class": "standard"},
        "tenants": [
            {"name": "gold", "class": "interactive", "api_keys": ["gold-key"]},
            {"name": "hog", "class": "batch", "ips": ["10.9.9.9"],
             "max_share": 1.0 / 16.0},
        ],
        "queue_cap": 64,
    }
    doc.update(overrides)
    return doc


def policy(**overrides):
    return parse_policy(json.dumps(policy_doc(**overrides)))


class Item:
    """Stand-in for the executor's _Item: the scheduler only reads .qos."""

    def __init__(self, qos=None, tag=None):
        self.qos = qos
        self.tag = tag


def drain(sched, n):
    return [sched.get_nowait().tag for _ in range(n)]


# --- tenancy ------------------------------------------------------------------


class TestPolicyParsing:
    def test_empty_is_off(self):
        assert load_policy("") is None
        assert load_policy("   ") is None

    def test_file_path(self, tmp_path):
        p = tmp_path / "qos.json"
        p.write_text(json.dumps({"default": {"class": "batch"}}))
        pol = load_policy(str(p))
        assert pol.default.klass == "batch"

    def test_missing_file_fails_loudly(self):
        with pytest.raises(ValueError, match="cannot read"):
            load_policy("/nonexistent/qos.json")

    def test_unknown_class_rejected(self):
        with pytest.raises(ValueError, match="unknown class"):
            parse_policy('{"default": {"class": "platinum"}}')

    def test_unknown_keys_rejected(self):
        with pytest.raises(ValueError, match="unknown top-level"):
            parse_policy('{"tenantz": []}')
        with pytest.raises(ValueError, match="unknown key"):
            parse_policy('{"default": {"clazz": "batch"}}')

    def test_bad_max_share_rejected(self):
        with pytest.raises(ValueError, match="max_share"):
            parse_policy('{"default": {"max_share": 0}}')
        with pytest.raises(ValueError, match="max_share"):
            parse_policy('{"default": {"max_share": 1.5}}')

    def test_duplicate_tenant_rejected(self):
        doc = {"tenants": [
            {"name": "a", "api_keys": ["x"]},
            {"name": "a", "api_keys": ["y"]},
        ]}
        with pytest.raises(ValueError, match="duplicate"):
            parse_policy(json.dumps(doc))

    def test_unmatchable_tenant_rejected(self):
        with pytest.raises(ValueError, match="matches nothing"):
            parse_policy('{"tenants": [{"name": "ghost"}]}')

    def test_default_cannot_carry_keys(self):
        with pytest.raises(ValueError, match="default tenant cannot"):
            parse_policy('{"default": {"api_keys": ["k"]}}')

    def test_invalid_json(self):
        with pytest.raises(ValueError, match="invalid JSON"):
            parse_policy("{nope")

    def test_snapshot_never_leaks_keys(self):
        snap = policy().snapshot()
        assert "gold-key" not in json.dumps(snap)
        gold = next(t for t in snap["tenants"] if t["name"] == "gold")
        assert gold["api_keys"] == 1  # a count, not the credential

    def test_request_qos_defaults_outside_request(self):
        name, kidx, share, deadline_t = request_qos(policy())
        assert name == "default" and CLASSES[kidx] == "standard"
        assert share == 1.0 and deadline_t is None

    @pytest.mark.parametrize("doc", [
        policy_doc(),
        policy_doc(aging_dispatches={"batch": 3}, shed_fractions={"standard": 0.6}),
        {"default": {"class": "batch", "rate": 5, "burst": 2},
         "tenants": [{"name": "t", "api_keys": ["a", "b"], "ips": ["1.2.3.4"],
                      "class": "interactive", "max_share": 0.25}],
         "queue_cap": 9},
    ], ids=["two-tenants", "knobs", "rates"])
    def test_parse_policy_gives_the_reference_tenants(self, doc):
        text = json.dumps(doc)
        mine, ref = parse_policy(text), jtenancy.parse_policy(text)
        assert mine.snapshot() == ref.snapshot()
        assert mine.tenant_names() == ref.tenant_names()
        assert (mine.queue_cap, mine.aging_dispatches, mine.shed_fractions) == (
            ref.queue_cap, ref.aging_dispatches, ref.shed_fractions)

    def test_request_qos_reads_the_ports_deadline(self):
        from imaginary_tpu_torch import deadline as deadline_mod

        tr = obs_trace.RequestTrace("rid")
        tr.tenant = policy().tenants[0]
        tr.deadline = deadline_mod.Deadline(2.0, t0=100.0)
        token = obs_trace.activate(tr)
        try:
            assert request_qos(policy()) == ("gold", 0, 1.0, 102.0)
        finally:
            obs_trace.deactivate(token)


# --- limiter ------------------------------------------------------------------


class TestGCRAEviction:
    def test_expired_entry_sweep(self, monkeypatch):
        """When the store hits MAX_KEYS, expired entries (tat in the
        past) are dropped FIRST; live entries keep their state."""
        import time as time_mod

        monkeypatch.setattr(GCRARateLimiter, "MAX_KEYS", 8)
        lim = GCRARateLimiter(per_sec=1, burst=0)
        now = time_mod.monotonic()
        for i in range(7):
            lim._tat[f"old{i}"] = now - 10.0
        lim._tat["live"] = now + 100.0
        allowed, _ = lim.allow("newcomer")
        assert allowed
        assert "newcomer" in lim._tat
        assert all(f"old{i}" not in lim._tat for i in range(7))
        blocked, retry = lim.allow("live")
        assert not blocked and retry > 0

    def test_oldest_tat_half_eviction_keeps_throttled(self, monkeypatch):
        """All-live flood: the oldest-tat half evicts; clients closest to
        throttle (largest tat) keep their state."""
        import time as time_mod

        monkeypatch.setattr(GCRARateLimiter, "MAX_KEYS", 8)
        lim = GCRARateLimiter(per_sec=1, burst=0)
        now = time_mod.monotonic()
        for i in range(8):
            lim._tat[f"k{i}"] = now + 10.0 + i
        lim.allow("flood")
        assert all(f"k{i}" in lim._tat for i in range(4, 8))
        assert all(f"k{i}" not in lim._tat for i in range(4))
        blocked, _ = lim.allow("k7")
        assert not blocked

    def test_throttle_state_survives_flood(self, monkeypatch):
        monkeypatch.setattr(GCRARateLimiter, "MAX_KEYS", 16)
        lim = GCRARateLimiter(per_sec=1, burst=1)
        for _ in range(5):
            lim.allow("victim")
        assert lim.allow("victim")[0] is False
        for i in range(40):
            lim.allow(f"flood{i}")
        assert lim.allow("victim")[0] is False

    def test_per_key_override_params(self):
        lim = GCRARateLimiter(per_sec=1000, burst=100)
        strict = dict(emission=1.0, tau=0.0)  # 1 rps, no burst
        assert lim.allow("t:strict", **strict)[0] is True
        assert lim.allow("t:strict", **strict)[0] is False
        for _ in range(20):
            assert lim.allow("t:generous")[0] is True  # global params


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


class TestTenantLimiter:
    def test_tenant_rate_overrides_global(self):
        tl = TenantLimiter(global_rate=1000, global_burst=100)
        strict = TenantSpec(name="s", rate=1.0, burst=0)
        assert tl.allow(strict)[0] is True
        allowed, retry = tl.allow(strict)
        assert allowed is False and retry > 0

    def test_inherits_global_when_no_rate(self):
        tl = TenantLimiter(global_rate=1, global_burst=0)
        ten = TenantSpec(name="t")
        assert tl.allow(ten)[0] is True
        assert tl.allow(ten)[0] is False

    def test_unlimited_mints_no_state(self):
        tl = TenantLimiter(global_rate=0, global_burst=0)
        ten = TenantSpec(name="anon")
        for _ in range(100):
            assert tl.allow(ten) == (True, 0.0)
        assert len(tl._gcra._tat) == 0

    def test_tenants_do_not_share_buckets(self):
        tl = TenantLimiter(global_rate=1, global_burst=0)
        assert tl.allow(TenantSpec(name="a"))[0] is True
        assert tl.allow(TenantSpec(name="b"))[0] is True
        assert tl.allow(TenantSpec(name="a"))[0] is False

    def test_decisions_equal_the_reference_on_one_clock(self, monkeypatch):
        """The same tenants, calls and clock give both limiters the same
        (allowed, retry_after) sequence."""
        clock = _Clock()
        monkeypatch.setattr(pmiddleware.time, "monotonic", clock)
        monkeypatch.setattr(jmiddleware.time, "monotonic", clock)
        specs = [("a", 2.0, 1), ("b", 0.0, -1), ("c", 5.0, 0), ("d", 0.5, 3)]
        mine = TenantLimiter(global_rate=3, global_burst=2)
        ref = JTenantLimiter(global_rate=3, global_burst=2)
        rng = random.Random(17)
        got, want = [], []
        for _ in range(400):
            name, rate, burst = rng.choice(specs)
            clock.t += rng.choice((0.0, 0.01, 0.1, 0.37, 1.0))
            got.append(mine.allow(TenantSpec(name=name, rate=rate, burst=burst)))
            want.append(ref.allow(jtenancy.TenantSpec(name=name, rate=rate, burst=burst)))
        assert got == want
        assert {a for a, _ in got} == {True, False}


# --- sched --------------------------------------------------------------------


class TestFairScheduler:
    def test_fifo_parity_default_tenant(self):
        s = FairScheduler(policy())
        for i in range(32):
            s.put(Item(tag=i))
        assert drain(s, 32) == list(range(32))

    def test_sentinel_never_overtakes_items(self):
        s = FairScheduler(policy())
        s.put(Item(tag="a"))
        s.put(None)
        assert s.get_nowait().tag == "a"
        assert s.get_nowait() is None
        assert s.get(timeout=0.01) is None

    def test_get_timeout_raises_empty(self):
        s = FairScheduler(policy())
        with pytest.raises(queue_mod.Empty):
            s.get(timeout=0.01)
        with pytest.raises(queue_mod.Empty):
            s.get_nowait()

    def test_strict_priority_between_classes(self):
        s = FairScheduler(policy())
        s.put(Item(qos=("hog", 2, 1.0, None), tag="b"))
        s.put(Item(qos=("default", 1, 1.0, None), tag="s"))
        s.put(Item(qos=("gold", 0, 1.0, None), tag="i"))
        assert drain(s, 3) == ["i", "s", "b"]

    def test_aging_bounds_batch_starvation(self):
        pol = policy()
        aging = pol.aging_dispatches[2]
        s = FairScheduler(pol)
        s.put(Item(qos=("hog", 2, 1.0, None), tag="batch"))
        for i in range(aging + 4):
            s.put(Item(qos=("gold", 0, 1.0, None), tag=f"i{i}"))
        order = []
        for _ in range(aging + 1):
            order.append(s.get_nowait().tag)
            s.put(Item(qos=("gold", 0, 1.0, None), tag="refill"))
        assert "batch" in order, f"batch starved through {order}"
        assert order.index("batch") <= aging

    def test_aging_respects_configured_threshold(self):
        s = FairScheduler(policy(aging_dispatches={"batch": 3}))
        s.put(Item(qos=("hog", 2, 1.0, None), tag="batch"))
        for i in range(8):
            s.put(Item(qos=("gold", 0, 1.0, None), tag=f"i{i}"))
        assert drain(s, 4) == ["i0", "i1", "i2", "batch"]

    def test_edf_within_class(self):
        s = FairScheduler(policy())
        s.put(Item(qos=("d", 1, 1.0, None), tag="none1"))
        s.put(Item(qos=("d", 1, 1.0, 200.0), tag="late"))
        s.put(Item(qos=("d", 1, 1.0, 50.0), tag="early"))
        s.put(Item(qos=("d", 1, 1.0, None), tag="none2"))
        assert drain(s, 4) == ["early", "late", "none1", "none2"]

    def test_edf_does_not_cross_classes(self):
        s = FairScheduler(policy())
        s.put(Item(qos=("hog", 2, 1.0, 1.0), tag="b-urgent"))
        s.put(Item(qos=("gold", 0, 1.0, 9999.0), tag="i-relaxed"))
        assert drain(s, 2) == ["i-relaxed", "b-urgent"]

    def test_tenant_share_cap_rejects_n_plus_1(self):
        s = FairScheduler(policy())
        hog = ("hog", 2, 1.0 / 16.0, None)
        for i in range(4):
            s.put(Item(qos=hog, tag=i))
        with pytest.raises(TenantShareExceeded) as exc:
            s.put(Item(qos=hog, tag=4))
        assert exc.value.http_code() == 503
        assert exc.value.headers.get("Retry-After") == "1"
        assert "hog" in exc.value.message
        s.get_nowait()
        s.put(Item(qos=hog, tag="fits-again"))

    def test_share_cap_does_not_limit_other_tenants(self):
        s = FairScheduler(policy())
        for _ in range(4):
            s.put(Item(qos=("hog", 2, 1.0 / 16.0, None)))
        for _ in range(40):
            s.put(Item(qos=("gold", 0, 1.0, None)))
        assert s.qsize() == 44

    def test_depths_and_stats(self):
        pol = policy()
        s = FairScheduler(pol)
        s.put(Item(qos=("gold", 0, 1.0, None)))
        s.put(Item(qos=("hog", 2, 1.0, None)))
        assert s.depths() == {"interactive": 1, "standard": 0, "batch": 1}
        stats = pol.stats.to_dict()["classes"]
        assert stats["interactive"]["queued"] == 1
        assert stats["batch"]["queued"] == 1
        s.get_nowait()
        assert pol.stats.to_dict()["classes"]["interactive"]["dispatched"] == 1

    def test_blocking_get_wakes_on_put(self):
        s = FairScheduler(policy())
        got = []
        t = threading.Thread(target=lambda: got.append(s.get(timeout=5.0)))
        t.start()
        s.put(Item(tag="wake"))
        t.join(timeout=5.0)
        assert not t.is_alive() and got[0].tag == "wake"

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_pop_order_equals_the_reference(self, seed):
        """One random sequence of puts (three classes, deadlines or none,
        a capped hog) and pops gives both schedulers the same pop order,
        the same rejections and the same counters."""
        text = json.dumps(policy_doc(aging_dispatches={"standard": 3, "batch": 5}))
        mine, ref = parse_policy(text), jtenancy.parse_policy(text)
        ms, rs = FairScheduler(mine), jsched.FairScheduler(ref)
        rng = random.Random(seed)
        tenants = [("gold", 0, 1.0), ("default", 1, 1.0), ("hog", 2, 1.0 / 16.0)]
        got, want = [], []
        for n in range(300):
            if rng.random() < 0.55:
                name, kidx, share = rng.choice(tenants)
                dl = rng.choice((None, None, float(rng.randint(0, 50))))
                for s, out in ((ms, got), (rs, want)):
                    try:
                        s.put(Item(qos=(name, kidx, share, dl), tag=n))
                    except Exception as e:  # noqa: BLE001 - each side's own 503 type
                        out.append(("rejected", n, type(e).__name__ == "TenantShareExceeded"))
            else:
                for s, out in ((ms, got), (rs, want)):
                    try:
                        out.append(("pop", s.get_nowait().tag))
                    except queue_mod.Empty:
                        out.append(("empty",))
        assert got == want
        assert any(g[0] == "rejected" for g in got)
        assert mine.stats.to_dict() == ref.stats.to_dict()


class TestExecutorIntegration:
    def test_fifo_queue_without_qos(self):
        from imaginary_tpu_torch.engine.executor import Executor, ExecutorConfig

        ex = Executor(ExecutorConfig(device="cpu"))
        try:
            assert isinstance(ex._queue, queue_mod.Queue)
            assert "qos_queued" not in ex.debug_snapshot()
        finally:
            ex.shutdown()

    def test_fair_scheduler_with_qos(self):
        from imaginary_tpu_torch.engine.executor import Executor, ExecutorConfig

        ex = Executor(ExecutorConfig(device="cpu", qos=policy()))
        try:
            assert isinstance(ex._queue, FairScheduler)
            assert ex.debug_snapshot()["qos_queued"] == {c: 0 for c in CLASSES}
        finally:
            ex.shutdown()

    def test_share_cap_refunds_owed_ledger(self):
        """A submit rejected by the share cap cancels its future and
        releases its owed charge: the queue estimate never counts work
        that was never queued."""
        from imaginary_tpu_torch.engine.executor import Executor, ExecutorConfig
        from imaginary_tpu_torch.ops.plan import plan_operation
        from imaginary_tpu_torch.options import ImageOptions

        ex = Executor(ExecutorConfig(device="cpu", qos=policy(), host_spill=False))
        try:
            ex._ms_per_mb = 5.0  # price the link so the charge is real

            def reject(_item):
                raise TenantShareExceeded("hog")

            ex._queue.put = reject  # instance override; deleted below
            arr = np.zeros((64, 64, 3), dtype=np.uint8)
            plan = plan_operation("resize", ImageOptions(width=32), 64, 64, 0, 3)
            with pytest.raises(TenantShareExceeded):
                ex.submit(arr, plan)
            assert ex.estimated_wait_ms() == 0.0
            assert ex.stats.device_owed_mb == 0.0
        finally:
            del ex._queue.put  # restore for the shutdown sentinel
            ex.shutdown()


# --- HTTP surfaces ------------------------------------------------------------


def small_jpeg() -> bytes:
    im = Image.new("RGB", (64, 48), (120, 30, 200))
    b = io.BytesIO()
    im.save(b, "JPEG", quality=90)
    return b.getvalue()


def multipart() -> FormData:
    form = FormData()
    form.add_field("file", small_jpeg(), filename="t.jpg", content_type="image/jpeg")
    return form


def run(options, fn, ref: bool = False):
    """Run `fn(client, app)` against a fresh app: the port's on the CPU,
    or with `ref` the reference's (its host spill off, as the port's)."""

    async def runner():
        if ref:
            from imaginary_tpu.web.app import create_app

            o = JServerOptions(**options, host_spill=False)
        else:
            from imaginary_tpu_torch.web.app import create_app

            o = ServerOptions(**options, device="cpu")
        app = create_app(o, log_stream=io.StringIO())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            await fn(client, app)
        finally:
            await client.close()

    asyncio.run(runner())


def both(options, fn) -> tuple:
    """`fn(client, app)` -> value, on the reference's app and the port's:
    (reference's value, port's value)."""
    out = {}
    for side in ("ref", "port"):
        async def wrap(client, app, side=side):
            out[side] = await fn(client, app)

        run(options, wrap, ref=side == "ref")
    return out["ref"], out["port"]


QOS_CFG = json.dumps({
    "default": {"class": "standard"},
    "tenants": [
        {"name": "gold", "class": "interactive", "api_keys": ["gold-key"]},
        {"name": "bulk", "class": "batch", "api_keys": ["bulk-key"]},
        {"name": "lim", "class": "standard", "api_keys": ["lim-key"],
         "rate": 1, "burst": 0},
    ],
})


class TestThrottle429:
    def test_429_json_body_without_qos(self):
        async def fn(client, app):
            statuses = []
            for _ in range(4):
                r = await client.get("/health")
                statuses.append(r.status)
                last = r
            assert 429 in statuses
            assert last.status == 429
            assert last.headers["Retry-After"].isdigit()
            assert await last.json() == {"message": "Too Many Requests", "status": 429}
            assert last.content_type == "application/json"

        run(dict(concurrency=1, burst=1), fn)

    def test_429_placeholder_body(self):
        async def fn(client, app):
            last = None
            for _ in range(4):
                last = await client.get("/resize?width=50&height=40")
            assert last.status == 429
            assert last.content_type.startswith("image/")
            err = json.loads(last.headers["Error"])
            assert err["status"] == 429
            im = Image.open(io.BytesIO(await last.read()))
            assert (im.width, im.height) == (50, 40)

        run(dict(concurrency=1, burst=1, enable_placeholder=True, mount="/tmp"), fn)

    def test_429_counted_in_red_counters(self):
        async def fn(client, app):
            assert (await client.get("/health", headers={"API-Key": "lim-key"})).status == 200
            r = await client.get("/health", headers={"API-Key": "lim-key"})
            assert r.status == 429
            text = await (await client.get("/metrics")).text()
            from tests.test_obs import parse_exposition_strict

            _, samples = parse_exposition_strict(text)
            red = {(dict(labels).get("route"), dict(labels).get("code")): v
                   for n, labels, v in samples if n == "imaginary_tpu_requests_total"}
            assert red.get(("/health", "4xx"), 0) >= 1

        run(dict(qos_config=QOS_CFG), fn)

    def test_per_tenant_429_equals_the_reference(self):
        async def fn(client, app):
            got = []
            for key in ("lim-key", "lim-key", "gold-key", "lim-key"):
                r = await client.get("/form", headers={"API-Key": key})
                got.append(await _status_and_retry(r))
            return got

        ref, port = both(dict(qos_config=QOS_CFG), fn)
        assert port == ref
        assert [s for s, _, _ in port] == [200, 429, 200, 429]


async def _status_and_retry(r) -> tuple:
    """(status, body but a 200's, Retry-After) of an answer."""
    body = await r.read()
    return r.status, body if r.status != 200 else b"", r.headers.get("Retry-After")


class TestTenantHTTP:
    def test_per_tenant_limit_leaves_others_alone(self):
        async def fn(client, app):
            assert (await client.get("/health", headers={"API-Key": "lim-key"})).status == 200
            assert (await client.get("/health", headers={"API-Key": "lim-key"})).status == 429
            for _ in range(5):
                assert (await client.get(
                    "/health", headers={"API-Key": "gold-key"})).status == 200
                assert (await client.get("/health")).status == 200

        run(dict(qos_config=QOS_CFG), fn)

    def test_rate_limited_counter_by_class(self):
        async def fn(client, app):
            await client.get("/health", headers={"API-Key": "lim-key"})
            await client.get("/health", headers={"API-Key": "lim-key"})
            stats = app["service"].qos.stats.to_dict()["classes"]
            assert stats["standard"]["rate_limited"] >= 1

        run(dict(qos_config=QOS_CFG), fn)

    def test_tenant_stamped_on_trace_surfaces(self):
        """The tenant and class ride the request's trace (the port has no
        /debugz: its pool thread reads the trace the middleware stamped),
        and the executor's live view carries the per-class queue."""
        async def fn(client, app):
            svc = app["service"]
            seen = {}
            real = svc.run

            def run_and_read(*a, **k):
                out = real(*a, **k)
                seen.update(obs_trace.current().fields)
                return out

            svc.run = run_and_read
            r = await client.post("/resize?width=32", data=multipart(),
                                  headers={"API-Key": "gold-key"})
            assert r.status == 200
            assert seen["tenant"] == "gold" and seen["qos_class"] == "interactive"
            assert svc.qos.queue_cap == 256
            assert svc.executor.debug_snapshot()["qos_queued"] == {c: 0 for c in CLASSES}

        run(dict(qos_config=QOS_CFG), fn)

    def test_wide_event_carries_tenant(self):
        """The port's trace fields carry the tenant and class the
        reference's wide event carries for the same request."""
        stream = io.StringIO()

        async def ref_runner():
            from imaginary_tpu.web.app import create_app

            app = create_app(JServerOptions(qos_config=QOS_CFG, wide_events=True,
                                            host_spill=False), log_stream=stream)
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                r = await client.post("/resize?width=32", data=multipart(),
                                      headers={"API-Key": "bulk-key"})
                assert r.status == 200
            finally:
                await client.close()

        asyncio.run(ref_runner())
        events = [json.loads(line) for line in stream.getvalue().splitlines()
                  if line.startswith("{")]
        ev = next(e for e in events if e.get("op") == "resize")
        seen = {}

        async def fn(client, app):
            svc = app["service"]
            real = svc.run

            def run_and_read(*a, **k):
                out = real(*a, **k)
                seen.update(obs_trace.current().fields)
                return out

            svc.run = run_and_read
            r = await client.post("/resize?width=32", data=multipart(),
                                  headers={"API-Key": "bulk-key"})
            assert r.status == 200

        run(dict(qos_config=QOS_CFG), fn)
        assert (seen["tenant"], seen["qos_class"]) == (ev["tenant"], ev["qos_class"]) == (
            "bulk", "batch")


def _estimate(ms: float):
    """`fn(client, app)` that pins the app's queue estimate, then sends
    one request per key: [(status, body, Retry-After)]."""
    async def fn(client, app):
        app["service"].estimated_queue_ms = lambda: ms
        out = []
        for key in ("bulk-key", None, "gold-key"):
            headers = {"API-Key": key} if key else {}
            r = await client.post("/resize?width=32", data=multipart(), headers=headers)
            out.append(await _status_and_retry(r))
        return out

    return fn


class TestClassShedding:
    def test_lowest_class_sheds_first(self):
        async def fn(client, app):
            svc = app["service"]
            svc.estimated_queue_ms = lambda: 60.0  # 50 < 60 < 75 < 100
            r = await client.post("/resize?width=32", data=multipart(),
                                  headers={"API-Key": "bulk-key"})
            assert r.status == 503
            assert r.headers["Retry-After"].isdigit()
            assert (await r.json())["status"] == 503
            r = await client.post("/resize?width=32", data=multipart(),
                                  headers={"API-Key": "gold-key"})
            assert r.status == 200
            stats = svc.qos.stats.to_dict()["classes"]
            assert stats["batch"]["shed"] == 1
            assert stats["interactive"]["admitted"] == 1

        run(dict(qos_config=QOS_CFG, max_queue_ms=100.0), fn)

    def test_standard_sheds_between(self):
        async def fn(client, app):
            app["service"].estimated_queue_ms = lambda: 80.0  # > 75
            r = await client.post("/resize?width=32", data=multipart())
            assert r.status == 503

        run(dict(qos_config=QOS_CFG, max_queue_ms=100.0), fn)

    def test_without_qos_single_threshold(self):
        async def fn(client, app):
            app["service"].estimated_queue_ms = lambda: 60.0
            r = await client.post("/resize?width=32", data=multipart())
            assert r.status == 200

        run(dict(max_queue_ms=100.0), fn)

    @pytest.mark.parametrize("est_ms,qos_on,sheds", [
        (60.0, True, 1), (80.0, True, 2), (1500.0, True, 3), (60.0, False, 0),
        (150.0, False, 3)])
    def test_sheds_equal_the_reference(self, est_ms, qos_on, sheds):
        opts = dict(max_queue_ms=100.0, **({"qos_config": QOS_CFG} if qos_on else {}))
        ref, port = both(opts, _estimate(est_ms))
        assert port == ref
        assert sum(s == 503 for s, _, _ in port) == sheds


class TestAdmitFailpoint:
    def test_injected_shed_decision(self):
        async def fn(client, app):
            failpoints.activate("qos.admit=error")
            try:
                r = await client.post("/resize?width=32", data=multipart(),
                                      headers={"API-Key": "bulk-key"})
                assert r.status == 503
                assert r.headers["Retry-After"] == "1"
                assert "shed" in (await r.json())["message"]
            finally:
                failpoints.deactivate()
            r = await client.post("/resize?width=32", data=multipart())
            assert r.status == 200
            assert app["service"].qos.stats.to_dict()["classes"]["batch"]["shed"] == 1

        run(dict(qos_config=QOS_CFG), fn)

    def test_once_wrapper_sheds_exactly_one(self):
        async def fn(client, app):
            failpoints.activate("qos.admit=once(error)")
            try:
                first = await client.post("/resize?width=32", data=multipart())
                second = await client.post("/resize?width=32", data=multipart())
                assert first.status == 503 and second.status == 200
            finally:
                failpoints.deactivate()

        run(dict(), fn)

    def test_injected_shed_equals_the_reference(self):
        async def fn(client, app):
            got = []
            for spec in ("qos.admit=error", "qos.admit=once(error)"):
                for mod in (failpoints, jfailpoints):
                    mod.activate(spec)
                try:
                    for key in ("bulk-key", "gold-key"):
                        r = await client.post("/resize?width=32", data=multipart(),
                                              headers={"API-Key": key})
                        got.append(await _status_and_retry(r))
                finally:
                    for mod in (failpoints, jfailpoints):
                        mod.deactivate()
            got.append(app["service"].qos.stats.to_dict())
            return got

        ref, port = both(dict(qos_config=QOS_CFG), fn)
        assert port[:-1] == ref[:-1]
        for cls in CLASSES:
            for k in ("admitted", "shed"):
                assert port[-1]["classes"][cls][k] == ref[-1]["classes"][cls][k], (cls, k)


class TestQosSurfaces:
    def test_health_and_metrics_blocks(self):
        async def fn(client, app):
            r = await client.post("/resize?width=32", data=multipart(),
                                  headers={"API-Key": "gold-key"})
            assert r.status == 200
            h = await (await client.get("/health")).json()
            assert set(h["qos"]["classes"]) == set(CLASSES)
            assert h["qos"]["classes"]["interactive"]["admitted"] >= 1
            text = await (await client.get("/metrics")).text()
            from tests.test_obs import parse_exposition_strict

            types, samples = parse_exposition_strict(text)
            assert types["imaginary_tpu_qos_queued"] == "gauge"
            assert types["imaginary_tpu_qos_shed_total"] == "counter"
            qos_names = {n for n, _, _ in samples if "qos" in n}
            assert {"imaginary_tpu_qos_queued", "imaginary_tpu_qos_admitted_total",
                    "imaginary_tpu_qos_shed_total",
                    "imaginary_tpu_qos_share_rejected_total",
                    "imaginary_tpu_qos_rate_limited_total",
                    "imaginary_tpu_qos_dispatched_total"} <= qos_names
            admitted = [v for n, labels, v in samples
                        if n == "imaginary_tpu_qos_admitted_total"
                        and dict(labels)["class"] == "interactive"]
            assert admitted and admitted[0] >= 1

        run(dict(qos_config=QOS_CFG), fn)

    def test_qos_off_surfaces_absent(self):
        async def fn(client, app):
            h = await (await client.get("/health")).json()
            assert "qos" not in h
            text = await (await client.get("/metrics")).text()
            assert "imaginary_tpu_qos_" not in text

        run(dict(), fn)


class TestQosOffParity:
    def test_qos_off_and_default_config_byte_identical(self):
        bodies = {}

        def capture(tag, options):
            async def fn(client, app):
                r = await client.post("/resize?width=48&height=36", data=multipart())
                assert r.status == 200
                bodies[tag] = await r.read()

            run(options, fn)

        capture("off", dict())
        capture("on", dict(qos_config='{"default": {}}'))
        assert bodies["off"] == bodies["on"]

    def test_cli_flag_roundtrip(self):
        from imaginary_tpu_torch.cli import build_parser, options_from_args

        args = build_parser().parse_args(["--qos-config", '{"default": {}}'])
        assert options_from_args(args).qos_config == '{"default": {}}'
        with pytest.raises(SystemExit):
            options_from_args(build_parser().parse_args(
                ["--qos-config", '{"default": {"class": "bogus"}}']))
