"""The port's cross-host plane (`imaginary_tpu_torch/fleet/multihost.py`,
`fleet/router.py`): a port copy of `tests/test_multihost.py`.

Every class of the reference's file runs against the port, with its names:
the --peers grammar, host identity and epochs, host rendezvous, the peer
table, gossip with an injected fetch, the route decision, the forward
ladder with an injected hop (every rung without a socket), spillover, the
shm host epoch, the /fleetz host block and the cluster view, and the HTTP
cases on the port's app on `device="cpu"`: the --peers-off byte parity, a
dead peer failing open, a real hop between two apps and the spillover
offer before the critical rung's shed. The two-supervisor case keeps the
reference's slow mark.

Beside the copy, the two packages on the same inputs: `parse_peers` and
`rendezvous_host` over seeded host sets and keys; a shm file stamped with
a host epoch by one package's `ShmCache`, read as fenced or not by the
other's, both ways; `build_fleetz(host=...)` and `build_cluster_view` as
equal dicts; and with --peers off, no header and no /health block of the
plane.
"""

import asyncio
import io
import json
import os
import random
import threading
import time

import pytest
from aiohttp.test_utils import TestClient, TestServer

from imaginary_tpu.fleet import multihost as jmh
from imaginary_tpu.fleet import shmcache as jshmcache
from imaginary_tpu.obs import aggregate as jagg
from imaginary_tpu_torch import cache as cache_mod
from imaginary_tpu_torch import failpoints
from imaginary_tpu_torch.fleet import multihost as mh
from imaginary_tpu_torch.fleet import router as router_mod
from imaginary_tpu_torch.fleet import shmcache
from imaginary_tpu_torch.fleet.shmcache import ShmCache
from imaginary_tpu_torch.obs import aggregate as agg
from imaginary_tpu_torch.obs import trace as obs_trace
from imaginary_tpu_torch.web.config import ServerOptions
from tests.conftest import fixture_bytes
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _fixtures(testdata):
    return testdata


@pytest.fixture(autouse=True)
def _clean_host_env():
    """The identity helpers stamp os.environ (the worker-inherit contract);
    every test starts and ends unstamped, so an armed state cannot leak
    into a parity check elsewhere."""
    for env in (mh.HOST_ID_ENV, mh.HOST_EPOCH_ENV):
        os.environ.pop(env, None)
    yield
    for env in (mh.HOST_ID_ENV, mh.HOST_EPOCH_ENV):
        os.environ.pop(env, None)
    failpoints.deactivate()


def _host_payload(hid="peer-b", epoch=5, serve="http://127.0.0.1:1",
                  workers=2, queue=3.0, plevel=0):
    return {"host": {"id": hid, "epoch": epoch, "serve_url": serve,
                     "workers_alive": workers, "est_queue_ms": queue,
                     "pressure_level": plevel}}


# --- --peers grammar -------------------------------------------------------------


class TestParsePeers:
    def test_csv_whitespace_scheme_default_dedup(self):
        got = mh.parse_peers(
            " 10.0.0.2:9101, http://10.0.0.3:9101/ \n 10.0.0.2:9101")
        assert got == ["http://10.0.0.2:9101", "http://10.0.0.3:9101"]

    def test_at_file_with_comments(self, tmp_path):
        f = tmp_path / "peers.txt"
        f.write_text("# fleet\nhttp://a:1\n\nb:2  # second host\n")
        assert mh.parse_peers("@" + str(f)) == ["http://a:1", "http://b:2"]

    def test_unreadable_file_refuses(self, tmp_path):
        with pytest.raises(ValueError):
            mh.parse_peers("@" + str(tmp_path / "missing.txt"))

    def test_empty_spec(self):
        assert mh.parse_peers("") == []
        assert mh.parse_peers("  ,  ") == []


def _seeded_peer_specs(seed: int, n: int = 40) -> list:
    """Peer lists in the grammar's every form: bare host:port, http and
    https bases, trailing slashes, duplicates, commas, blanks, newlines."""
    rng = random.Random(seed)
    specs = []
    for _ in range(n):
        entries = []
        for _ in range(rng.randint(0, 6)):
            host = rng.choice(["10.0.0.%d" % rng.randint(1, 9), "h-%d" % rng.randint(1, 5),
                               "127.0.0.1", "peer.example"])
            e = f"{host}:{rng.randint(9000, 9010)}"
            e = rng.choice(["", "http://", "https://"]) + e + rng.choice(["", "/"])
            entries.append(e)
            if rng.random() < 0.2:
                entries.append(e)  # a duplicate
        seps = [rng.choice([",", " ", ", ", "\n", " ,\n "]) for _ in entries]
        specs.append("".join(e + s for e, s in zip(entries, seps)))
    return specs


class TestParsePeersParity:
    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_inline_specs_parse_as_the_references(self, seed):
        for spec in _seeded_peer_specs(seed):
            assert mh.parse_peers(spec) == jmh.parse_peers(spec), spec

    @pytest.mark.parametrize("seed", [4, 5])
    def test_at_files_parse_as_the_references(self, tmp_path, seed):
        rng = random.Random(seed)
        for i, spec in enumerate(_seeded_peer_specs(seed, 12)):
            lines = [ln + (rng.choice(["", "  # a comment"])) for ln in spec.split("\n")]
            f = tmp_path / f"peers-{i}.txt"
            f.write_text("# the fleet\n" + "\n".join(lines) + "\n")
            assert mh.parse_peers("@" + str(f)) == jmh.parse_peers("@" + str(f))

    def test_unreadable_file_refuses_in_both(self, tmp_path):
        missing = "@" + str(tmp_path / "none.txt")
        with pytest.raises(ValueError):
            mh.parse_peers(missing)
        with pytest.raises(ValueError):
            jmh.parse_peers(missing)


# --- host identity & epochs --------------------------------------------------------


class TestHostIdentity:
    def test_unarmed_reads_empty(self):
        assert mh.host_id() == ""
        assert mh.host_epoch() == 0

    def test_mint_strictly_greater_across_restarts(self):
        t = [1000.0]
        first = mh.mint_host_epoch(clock=lambda: t[0])
        t[0] += 0.001  # even one ms later
        assert mh.mint_host_epoch(clock=lambda: t[0]) > first

    def test_ensure_stamps_once_and_children_inherit(self):
        hid, epoch = mh.ensure_host_identity("host-a", clock=lambda: 1234.5)
        assert (hid, epoch) == ("host-a", 1234500)
        assert os.environ[mh.HOST_ID_ENV] == "host-a"
        # re-entry (a worker re-running main) keeps the incarnation: a
        # worker never mints its own host epoch
        hid2, epoch2 = mh.ensure_host_identity("other", clock=lambda: 9999.0)
        assert (hid2, epoch2) == ("host-a", 1234500)

    def test_default_id_is_hostname(self):
        import socket

        hid, _ = mh.ensure_host_identity("")
        assert hid == socket.gethostname()

    def test_garbage_epoch_env_reads_zero(self):
        os.environ[mh.HOST_EPOCH_ENV] = "not-a-number"
        assert mh.host_epoch() == 0

    def test_env_contract_is_the_references(self):
        assert (mh.HOST_ID_ENV, mh.HOST_EPOCH_ENV) == (jmh.HOST_ID_ENV, jmh.HOST_EPOCH_ENV)
        assert mh.PEER_PROBE_TIMEOUT_S == jmh.PEER_PROBE_TIMEOUT_S
        for clock in (lambda: 0.0, lambda: 1.7e9 + 0.4567, lambda: 12.3456789):
            assert mh.mint_host_epoch(clock) == jmh.mint_host_epoch(clock)


# --- host rendezvous ---------------------------------------------------------------


class TestRendezvousHost:
    def test_deterministic_and_all_hosts_used(self):
        hosts = ["h1", "h2", "h3"]
        keys = [b"k%d" % i for i in range(300)]
        owners = [mh.rendezvous_host(hosts, k) for k in keys]
        assert owners == [mh.rendezvous_host(hosts, k) for k in keys]
        assert set(owners) == set(hosts)

    def test_minimal_disruption_on_host_leave(self):
        keys = [b"d%d" % i for i in range(300)]
        before = {k: mh.rendezvous_host(["h1", "h2", "h3"], k) for k in keys}
        after = {k: mh.rendezvous_host(["h1", "h3"], k) for k in keys}
        for k in keys:
            if before[k] != "h2":
                assert after[k] == before[k]
            else:
                assert after[k] in ("h1", "h3")

    def test_empty_is_none(self):
        assert mh.rendezvous_host([], b"x") is None

    @pytest.mark.parametrize("seed", [7, 8, 9])
    def test_owner_is_the_references_over_seeded_hosts_and_keys(self, seed):
        rng = random.Random(seed)
        for n in range(1, 9):
            hosts = [f"host-{rng.randint(0, 999)}" for _ in range(n)]
            for _ in range(200):
                key = cache_mod.shared_key((rng.randbytes(32), "resize", n))
                assert mh.rendezvous_host(hosts, key) == jmh.rendezvous_host(hosts, key)


# --- peer table --------------------------------------------------------------------


class TestPeerTable:
    def test_failed_poll_marks_dead_immediately(self):
        t = mh.PeerTable(["http://p:1"], clock=lambda: 100.0)
        t.observe("http://p:1", _host_payload())
        assert len(t.alive()) == 1
        t.observe("http://p:1", None)
        p = t.peers()[0]
        assert not p.alive and p.failures == 1
        assert t.alive() == []

    def test_staleness_is_a_read_side_judgement(self):
        now = [100.0]
        t = mh.PeerTable(["http://p:1"], staleness_s=5.0, clock=lambda: now[0])
        t.observe("http://p:1", _host_payload())
        assert len(t.alive()) == 1
        now[0] += 20.0  # gossip wedged: no observe() ever marked it dead
        assert t.alive() == []
        assert t.lookup("peer-b") is None

    def test_epoch_bump_counts_restarts(self):
        t = mh.PeerTable(["http://p:1"], clock=lambda: 1.0)
        t.observe("http://p:1", _host_payload(epoch=5))
        t.observe("http://p:1", _host_payload(epoch=5))
        assert t.peers()[0].epoch_bumps == 0
        t.observe("http://p:1", _host_payload(epoch=9))
        assert t.peers()[0].epoch_bumps == 1

    def test_least_loaded_skips_critical_peers(self):
        from imaginary_tpu_torch.engine.pressure import LEVEL_CRITICAL

        t = mh.PeerTable(["http://a:1", "http://b:1"], clock=lambda: 1.0)
        t.observe("http://a:1", _host_payload(hid="a", queue=1.0, plevel=LEVEL_CRITICAL))
        t.observe("http://b:1", _host_payload(hid="b", queue=50.0))
        got = t.least_loaded()
        assert got is not None and got.host_id == "b"
        t.observe("http://b:1", _host_payload(hid="b", queue=50.0, plevel=LEVEL_CRITICAL))
        assert t.least_loaded() is None

    def test_lookup_by_host_id(self):
        t = mh.PeerTable(["http://a:1"], clock=lambda: 1.0)
        t.observe("http://a:1", _host_payload(hid="a"))
        assert t.lookup("a").base == "http://a:1"
        assert t.lookup("nobody") is None

    def test_snapshot_is_the_references(self):
        payloads = [_host_payload(hid="a", epoch=3), None, _host_payload(hid="a", epoch=8),
                    {"host": {"id": "a", "epoch": 0}}, "not a dict", _host_payload(queue=7.5)]
        ours = mh.PeerTable(["http://a:1", "http://c:1"], clock=lambda: 4.0)
        ref = jmh.PeerTable(["http://a:1", "http://c:1"], clock=lambda: 4.0)
        for p in payloads:
            ours.observe("http://a:1", p)
            ref.observe("http://a:1", p)
            assert ours.snapshot() == ref.snapshot()


# --- gossip ------------------------------------------------------------------------


class TestGossip:
    def test_poll_once_injectable_fetch(self):
        t = mh.PeerTable(["http://good:1", "http://bad:1"], clock=lambda: 1.0)

        def fetch(url, timeout):
            assert timeout == mh.PEER_PROBE_TIMEOUT_S
            if "good" in url:
                return json.dumps(_host_payload(hid="g"))
            return "not json {{{"

        g = mh.GossipAgent(t, fetch=fetch)
        g.poll_once()
        assert g.polls == 1
        by = {p.base: p for p in t.peers()}
        assert by["http://good:1"].alive
        assert not by["http://bad:1"].alive

    def test_peer_health_failpoint_marks_dead(self):
        t = mh.PeerTable(["http://p:1"], clock=lambda: 1.0)
        g = mh.GossipAgent(t, fetch=lambda u, to: json.dumps(_host_payload()))
        failpoints.activate("peer.health=error")
        try:
            g.poll_once()
        finally:
            failpoints.deactivate()
        assert t.alive() == []
        g.poll_once()  # disarmed: the peer answers again
        assert len(t.alive()) == 1

    def test_thread_polls_and_closes(self):
        t = mh.PeerTable(["http://p:1"], clock=lambda: 1.0)
        polled = threading.Event()

        def fetch(url, timeout):
            polled.set()
            return json.dumps(_host_payload())

        g = mh.GossipAgent(t, interval_s=0.05, fetch=fetch).start()
        try:
            assert polled.wait(5.0)
            assert any(th.name == "peer-gossip" for th in threading.enumerate())
        finally:
            g.close()
        assert g._thread is None


# --- router: the route decision and the fail-open hop ladder ------------------------


def _router(table=None, **kw):
    table = table or mh.PeerTable(["http://b:1"], clock=lambda: 1.0)
    kw.setdefault("self_id", "host-a")
    kw.setdefault("self_epoch", 100)
    kw.setdefault("route_all", True)
    return router_mod.HostRouter(table, **kw)


def _owned_key(r, owner):
    for i in range(2000):
        k = b"key-%d" % i
        if r.owner_host(k) == owner:
            return k
    raise AssertionError("no key owned by " + owner)


def _ok_headers(peer):
    return {router_mod.HOST_EPOCH_HEADER: f"{peer.host_id}:{peer.host_epoch}",
            "Content-Type": "image/jpeg",
            "X-Imaginary-Backend": "device"}


class TestRouteDecision:
    def test_ladder(self):
        r = _router()
        r.table.observe("http://b:1", _host_payload(hid="host-b"))
        k = _owned_key(r, "host-b")
        # the hop marker: arrived over the wire, runs locally
        assert r.route_target({router_mod.ROUTE_HEADER: "fwd=x"}, k) is None
        assert r.stats.served_for_peer == 0  # route_target doesn't book it
        assert r.note_hop_marker({router_mod.ROUTE_HEADER: "fwd=x"})
        assert r.stats.served_for_peer == 1
        # the client's pin
        assert r.route_target({router_mod.ROUTE_HEADER: "local"}, k) is None
        # owned by the peer: forwarded
        assert r.route_target({}, k).host_id == "host-b"
        # self-owned keys stay local
        assert r.route_target({}, _owned_key(r, "host-a")) is None

    def test_router_off_requires_hint(self):
        r = _router(route_all=False)
        r.table.observe("http://b:1", _host_payload(hid="host-b"))
        k = _owned_key(r, "host-b")
        assert r.route_target({}, k) is None
        assert r.route_target({router_mod.ROUTE_HEADER: "route"}, k).host_id == "host-b"

    def test_single_host_cluster_never_routes(self):
        r = _router()  # the peer was never observed: no alive entry
        assert r.owner_host(b"anything") is None
        assert r.route_target({}, b"anything") is None

    def test_dead_owner_falls_back_local(self):
        now = [1.0]
        t = mh.PeerTable(["http://b:1"], staleness_s=5.0, clock=lambda: now[0])
        r = _router(table=t)
        t.observe("http://b:1", _host_payload(hid="host-b"))
        k = _owned_key(r, "host-b")
        assert r.route_target({}, k) is not None
        # gossip can no longer vouch for host-b: local
        t.observe("http://b:1", None)
        assert r.route_target({}, k) is None

    def test_headers_are_the_references(self):
        from imaginary_tpu.fleet import router as jrouter

        assert (router_mod.ROUTE_HEADER, router_mod.HOST_EPOCH_HEADER) == (
            jrouter.ROUTE_HEADER, jrouter.HOST_EPOCH_HEADER)
        assert router_mod.RouterStats().to_dict() == jrouter.RouterStats().to_dict()


class TestForwardLadder:
    def _peer(self, r):
        r.table.observe("http://b:1", _host_payload(hid="host-b", epoch=7,
                                                    serve="http://b:2"))
        return r.table.lookup("host-b")

    def test_success_returns_processed_image(self):
        calls = {}

        async def hop(method, url, body, headers, timeout):
            calls.update(method=method, url=url, body=body, headers=headers,
                         timeout=timeout)
            return 200, _ok_headers(self._peer(r)), b"JPEGBYTES"

        r = _router(hop=hop)
        peer = self._peer(r)
        got = asyncio.run(r.try_forward(peer, "resize", {"width": "100"}, b"src",
                                        "image/jpeg"))
        assert got is not None
        out, placement = got
        assert bytes(out.body) == b"JPEGBYTES"
        assert out.mime == "image/jpeg"
        assert placement == "device"
        assert r.stats.forwards == 1
        assert calls["method"] == "POST"
        assert calls["url"] == "http://b:2/resize?width=100"
        assert calls["body"] == b"src"
        assert calls["headers"][router_mod.ROUTE_HEADER] == "fwd=host-a"
        assert 0 < calls["timeout"] <= r.hop_s

    def test_non_200_fails_open(self):
        async def hop(*a, **kw):
            return 503, {}, b"shed"

        r = _router(hop=hop)
        peer = self._peer(r)
        assert asyncio.run(r.try_forward(peer, "resize", {}, b"s", "image/jpeg")) is None
        assert r.stats.forward_fails == 1

    def test_hop_exception_fails_open(self):
        async def hop(*a, **kw):
            raise OSError("connection refused")

        r = _router(hop=hop)
        peer = self._peer(r)
        assert asyncio.run(r.try_forward(peer, "resize", {}, b"s", "image/jpeg")) is None
        assert r.stats.forward_fails == 1

    def test_stale_host_epoch_answer_is_fenced(self):
        async def hop(*a, **kw):
            return 200, {router_mod.HOST_EPOCH_HEADER: "host-b:3",
                         "Content-Type": "image/jpeg"}, b"old"

        r = _router(hop=hop)
        peer = self._peer(r)  # gossip knows epoch 7; the answer says 3
        assert asyncio.run(r.try_forward(peer, "resize", {}, b"s", "image/jpeg")) is None
        assert r.stats.fenced_answers == 1
        assert r.stats.forwards == 0

    def test_missing_epoch_stamp_is_fenced(self):
        async def hop(*a, **kw):
            return 200, {"Content-Type": "image/jpeg"}, b"x"

        r = _router(hop=hop)
        peer = self._peer(r)
        assert asyncio.run(r.try_forward(peer, "resize", {}, b"s", "image/jpeg")) is None
        assert r.stats.fenced_answers == 1

    def test_other_hosts_stamp_is_fenced(self):
        async def hop(*a, **kw):
            return 200, {router_mod.HOST_EPOCH_HEADER: "host-c:7",
                         "Content-Type": "image/jpeg"}, b"x"

        r = _router(hop=hop)
        peer = self._peer(r)
        assert asyncio.run(r.try_forward(peer, "resize", {}, b"s", "image/jpeg")) is None
        assert r.stats.fenced_answers == 1

    def test_exhausted_deadline_never_dials(self):
        async def hop(*a, **kw):
            raise AssertionError("dialed with no budget")

        r = _router(hop=hop)
        peer = self._peer(r)
        from imaginary_tpu_torch import deadline as deadline_mod

        tr = obs_trace.RequestTrace(request_id="t", enabled=False)
        tr.deadline = deadline_mod.Deadline(0.001, t0=time.monotonic() - 1.0)
        token = obs_trace.activate(tr)
        try:
            got = asyncio.run(r.try_forward(peer, "resize", {}, b"s", "image/jpeg"))
        finally:
            obs_trace.deactivate(token)
        assert got is None
        assert r.stats.forward_fails == 1

    def test_deadline_clamps_hop_budget(self):
        seen = {}

        async def hop(method, url, body, headers, timeout):
            seen["timeout"] = timeout
            return 200, _ok_headers(self._peer(r)), b"x"

        r = _router(hop=hop, hop_s=30.0)
        peer = self._peer(r)
        from imaginary_tpu_torch import deadline as deadline_mod

        tr = obs_trace.RequestTrace(request_id="t", enabled=False)
        tr.deadline = deadline_mod.Deadline(0.5)
        token = obs_trace.activate(tr)
        try:
            asyncio.run(r.try_forward(peer, "resize", {}, b"s", "image/jpeg"))
        finally:
            obs_trace.deactivate(token)
        assert seen["timeout"] <= 0.5

    def test_peer_forward_failpoint_fails_open_without_dialing(self):
        async def hop(*a, **kw):
            raise AssertionError("failpoint must fire before the dial")

        r = _router(hop=hop)
        peer = self._peer(r)
        failpoints.activate("peer.forward[host-b]=error")
        try:
            got = asyncio.run(r.try_forward(peer, "resize", {}, b"s", "image/jpeg"))
        finally:
            failpoints.deactivate()
        assert got is None
        assert r.stats.forward_fails == 1

    def test_peer_forward_failpoint_keyed_to_another_host_dials(self):
        async def hop(*a, **kw):
            return 200, _ok_headers(self._peer(r)), b"x"

        r = _router(hop=hop)
        peer = self._peer(r)
        failpoints.activate("peer.forward[host-c]=error")
        try:
            got = asyncio.run(r.try_forward(peer, "resize", {}, b"s", "image/jpeg"))
        finally:
            failpoints.deactivate()
        assert got is not None and r.stats.forwards == 1


class TestSpillover:
    def test_spill_target_is_least_loaded_noncritical(self):
        from imaginary_tpu_torch.engine.pressure import LEVEL_CRITICAL

        t = mh.PeerTable(["http://b:1", "http://c:1"], clock=lambda: 1.0)
        r = _router(table=t)
        assert r.spill_target() is None  # nobody alive yet
        t.observe("http://b:1", _host_payload(hid="b", queue=9.0))
        t.observe("http://c:1", _host_payload(hid="c", queue=2.0))
        assert r.spill_target().host_id == "c"
        t.observe("http://c:1", _host_payload(hid="c", queue=2.0, plevel=LEVEL_CRITICAL))
        assert r.spill_target().host_id == "b"

    def test_try_spill_roundtrip_and_fail_open(self):
        async def ok_hop(method, url, body, headers, timeout):
            assert method == "GET"
            assert url == "http://b:2/resize?width=9&url=x"
            assert headers[router_mod.ROUTE_HEADER] == "fwd=host-a"
            assert headers["Accept"] == "image/webp"
            assert "X-Other" not in headers
            return 200, _ok_headers(peer), b"BODY"

        r = _router(hop=ok_hop)
        r.table.observe("http://b:1", _host_payload(hid="host-b", epoch=7,
                                                    serve="http://b:2"))
        peer = r.table.lookup("host-b")
        got = asyncio.run(r.try_spill(peer, "GET", "/resize?width=9&url=x", b"",
                                      {"Accept": "image/webp", "X-Other": "1"}))
        assert got == (200, "image/jpeg", b"BODY")
        assert r.stats.spills == 1

        async def shed_hop(*a, **kw):
            return 503, {}, b"shed there too"

        r2 = _router(hop=shed_hop)
        r2.table.observe("http://b:1", _host_payload(hid="host-b", serve="http://b:2"))
        peer2 = r2.table.lookup("host-b")
        assert asyncio.run(r2.try_spill(peer2, "GET", "/x", b"", {})) is None
        assert r2.stats.spill_fails == 1


# --- shm host epoch ----------------------------------------------------------------


class TestShmHostEpoch:
    def test_stamp_roundtrip_and_host_fencing(self, tmp_path):
        path = str(tmp_path / "fleet.shm")
        sup = ShmCache(path, create=True, size_mb=1.0, owner=True)
        try:
            assert sup.host_epoch_stamp() == 0
            assert not sup.host_fenced()  # unarmed: never fenced
            sup.stamp_host_epoch(500)
            assert sup.host_epoch_stamp() == 500
            # this process was born into incarnation 400: deposed
            os.environ[mh.HOST_EPOCH_ENV] = "400"
            assert sup.host_fenced()
            # the current incarnation (or a newer one) is never fenced
            os.environ[mh.HOST_EPOCH_ENV] = "500"
            assert not sup.host_fenced()
        finally:
            sup.close()

    def test_creator_stamps_armed_host_epoch(self, tmp_path):
        os.environ[mh.HOST_EPOCH_ENV] = "777"
        path = str(tmp_path / "fleet2.shm")
        sup = ShmCache(path, create=True, size_mb=1.0, owner=True)
        try:
            assert sup.host_epoch_stamp() == 777
        finally:
            sup.close()

    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_the_other_package_reads_the_stamp_and_the_fence(self, tmp_path, writer):
        """One package stamps the host epoch into the header; the other,
        attached to the same file, reads it and fences on it as the writer
        does, for a process born before, at and after the stamp."""
        write_cls, read_cls = ((jshmcache.ShmCache, ShmCache) if writer == "reference"
                               else (ShmCache, jshmcache.ShmCache))
        path = str(tmp_path / "fleet.shm")
        sup = write_cls(path, create=True, size_mb=1.0, owner=True)
        peer = read_cls(path, create=False, worker=0, epoch=0)
        try:
            assert peer.host_epoch_stamp() == 0 and not peer.host_fenced()
            sup.stamp_host_epoch(1_700_000_000_123)
            assert peer.host_epoch_stamp() == sup.host_epoch_stamp() == 1_700_000_000_123
            for born in ("", "1700000000000", "1700000000123", "1700000000999"):
                os.environ[mh.HOST_EPOCH_ENV] = born
                assert peer.host_fenced() == sup.host_fenced(), born
            os.environ[mh.HOST_EPOCH_ENV] = "1700000000000"
            assert peer.host_fenced()
        finally:
            peer.close()
            sup.close()

    def test_a_creator_with_an_armed_epoch_stamps_like_the_references(self, tmp_path):
        os.environ[mh.HOST_EPOCH_ENV] = "4242"
        ours = ShmCache(str(tmp_path / "a.shm"), create=True, size_mb=1.0, owner=True)
        ref = jshmcache.ShmCache(str(tmp_path / "b.shm"), create=True, size_mb=1.0, owner=True)
        try:
            assert ours.host_epoch_stamp() == ref.host_epoch_stamp() == 4242
            assert bytes(ours._mm[:shmcache.HEADER_BYTES]) == \
                bytes(ref._mm[:jshmcache.HEADER_BYTES])
        finally:
            ours.close()
            ref.close()


# --- /fleetz host block and the cluster view ------------------------------------------


class TestFleetzCluster:
    def test_build_fleetz_host_block_rollup(self):
        view = {0: {"pid": 1, "alive": True, "epoch": 1},
                1: {"pid": 2, "alive": False, "epoch": 1}}
        health = {0: {"estimatedQueueMs": 12.5, "pressure": {"state": 1}}}
        out = agg.build_fleetz(view, health, set(),
                               host={"id": "h-a", "epoch": 9, "serve_url": "http://h-a:1"})
        assert out["host"] == {"id": "h-a", "epoch": 9, "serve_url": "http://h-a:1",
                               "workers_alive": 1, "est_queue_ms": 12.5,
                               "pressure_level": 1}
        # parity: no host argument, no host block
        assert "host" not in agg.build_fleetz(view, health, set())

    def test_cluster_view_merges_local_and_peers(self):
        t = mh.PeerTable(["http://b:1", "http://c:1"], clock=lambda: 1.0)
        t.observe("http://b:1", _host_payload(hid="b", epoch=4))
        # c never answered: it appears dead, its fleetz withheld
        local = agg.build_fleetz({}, {}, set(),
                                 host={"id": "a", "epoch": 2, "serve_url": "u"})
        out = mh.build_cluster_view(local, t)
        assert out["scope"] == "cluster"
        assert out["hosts"]["a"]["local"] is True
        assert out["hosts"]["b"]["alive"] is True
        assert out["peers"]["http://b:1"]["fleetz"] is not None
        assert out["peers"]["http://c:1"]["fleetz"] is None
        assert out["local"] is local

    @pytest.mark.parametrize("seed", [11, 12, 13])
    def test_build_fleetz_and_the_cluster_view_equal_the_references(self, seed):
        rng = random.Random(seed)
        view = {i: {"pid": 100 + i, "alive": rng.random() < 0.7, "epoch": rng.randint(1, 9)}
                for i in range(rng.randint(1, 4))}
        health = {i: {"estimatedQueueMs": round(rng.uniform(0, 50), 3),
                      "pressure": {"state": rng.randint(0, 2)}}
                  for i in view if rng.random() < 0.8}
        missed = {i for i in view if i not in health}
        host = {"id": f"h-{seed}", "epoch": rng.randint(1, 10**12),
                "serve_url": f"http://127.0.0.1:{9000 + seed}"}
        ours = agg.build_fleetz(view, health, missed, now=1000.0, host=host)
        ref = jagg.build_fleetz(view, health, missed, now=1000.0, host=host)
        assert ours == ref
        bases = [f"http://p{i}:1" for i in range(3)]
        now = [50.0]
        tables = (mh.PeerTable(bases, staleness_s=5.0, clock=lambda: now[0]),
                  jmh.PeerTable(bases, staleness_s=5.0, clock=lambda: now[0]))
        for step in range(12):
            base = rng.choice(bases)
            payload = None if rng.random() < 0.3 else _host_payload(
                hid=base[7:9], epoch=rng.randint(1, 5), queue=rng.uniform(0, 9),
                plevel=rng.randint(0, 2))
            for t in tables:
                t.observe(base, payload)
            now[0] += rng.choice([0.5, 1.0, 7.0])
            got = mh.build_cluster_view(ours, tables[0], now=1000.0 + step)
            want = jmh.build_cluster_view(ref, tables[1], now=1000.0 + step)
            assert got == want
            picks = [t.least_loaded() for t in tables]
            assert [p and p.to_dict() for p in picks] == [picks[1] and picks[1].to_dict()] * 2


# --- HTTP: parity, surfaces, a live cross-host forward ---------------------------------


def run(options, fn):
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


def jpg() -> bytes:
    return fixture_bytes("imaginary.jpg")


def _post_kw():
    return {"data": jpg(), "headers": {"Content-Type": "image/jpeg"}}


def _opts(**kw) -> ServerOptions:
    return ServerOptions(device="cpu", **kw)


class TestMultihostHttp:
    def test_peers_off_byte_parity(self):
        os.environ.pop(shmcache.PATH_ENV, None)
        bodies, names = {}, {}

        async def baseline(client, app):
            r = await client.post("/resize?width=140", **_post_kw())
            bodies["off"] = await r.read()
            names["off"] = set(r.headers)
            assert router_mod.HOST_EPOCH_HEADER not in r.headers
            h = await (await client.get("/health")).json()
            assert "multihost" not in h and "host" not in h
            assert app["service"].multihost is None
            # no peers: no identity stamps, no gossip thread
            assert mh.host_id() == ""
            assert not any(t.name == "peer-gossip" for t in threading.enumerate())

        async def armed(client, app):
            r = await client.post("/resize?width=140", **_post_kw())
            bodies["on"] = await r.read()
            names["on"] = set(r.headers)
            svc = app["service"]
            assert r.headers[router_mod.HOST_EPOCH_HEADER] == svc.multihost.identity_header
            h = await (await client.get("/health")).json()
            assert h["host"]["id"] == "parity-host"
            assert h["multihost"]["host_id"] == "parity-host"
            assert h["multihost"]["router"] is False

        run(_opts(), baseline)
        run(_opts(peers="http://127.0.0.1:1", host_id="parity-host"), armed)
        assert bodies["off"] == bodies["on"]
        # the plane adds its stamp and nothing else
        assert names["on"] - names["off"] == {router_mod.HOST_EPOCH_HEADER}

    def test_peers_off_headers_match_the_reference_apps(self):
        """With --peers off the port's answer and /health carry no key of the
        plane, as the reference's app does not on the same request."""
        from imaginary_tpu.web.app import create_app as reference_app
        from imaginary_tpu.web.config import ServerOptions as RefOptions

        got = {}

        async def fn(client, app):
            r = await client.post("/resize?width=140", **_post_kw())
            got["port"] = set(r.headers)
            got["port_health"] = set(await (await client.get("/health")).json())

        run(_opts(), fn)

        async def ref():
            app = reference_app(RefOptions(host_spill=False), log_stream=io.StringIO())
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                r = await client.post("/resize?width=140", **_post_kw())
                got["ref"] = set(r.headers)
                got["ref_health"] = set(await (await client.get("/health")).json())
            finally:
                await client.close()

        asyncio.run(ref())
        for key in ("port", "ref"):
            assert router_mod.HOST_EPOCH_HEADER not in got[key]
            assert router_mod.ROUTE_HEADER not in got[key]
        for key in ("port_health", "ref_health"):
            assert not {"host", "multihost"} & got[key]

    def test_unreachable_peer_fails_open(self):
        # --router armed, the only peer dead: every request runs locally,
        # the same bytes, no new error class
        async def armed(client, app):
            r = await client.post("/resize?width=133", **_post_kw())
            assert r.status == 200
            h = await (await client.get("/health")).json()
            assert h["multihost"]["forwards"] == 0

        run(_opts(peers="http://127.0.0.1:1", router=True, host_id="solo"), armed)

    def test_forward_e2e_between_two_hosts(self):
        # two real apps, distinct host identities, routing armed on A: a
        # request for a digest B owns takes one real HTTP hop and serves
        # B's bytes; B books served_for_peer and never re-routes
        async def fn():
            from imaginary_tpu_torch.params import build_params_from_query
            from imaginary_tpu_torch.web.app import create_app

            def boot(hid):
                os.environ[mh.HOST_ID_ENV] = hid
                os.environ[mh.HOST_EPOCH_ENV] = str(100)
                try:
                    return create_app(
                        _opts(peers="http://127.0.0.1:1", router=True, host_id=hid,
                              fleet_hop_ms=15000.0),
                        log_stream=io.StringIO())
                finally:
                    os.environ.pop(mh.HOST_ID_ENV, None)
                    os.environ.pop(mh.HOST_EPOCH_ENV, None)

            app_a, app_b = boot("host-a"), boot("host-b")
            ca = TestClient(TestServer(app_a))
            cb = TestClient(TestServer(app_b))
            await ca.start_server()
            await cb.start_server()
            try:
                ra = app_a["service"].multihost
                rb = app_b["service"].multihost
                # cross-teach the tables by hand (gossip would need two
                # admin planes; the table's API is the contract), with the
                # gossip of the placeholder base stopped so that its failed
                # poll cannot mark the taught peer dead
                ra.close()
                ra.table.observe("http://127.0.0.1:1",
                                 _host_payload(hid="host-b", epoch=100,
                                               serve=str(cb.make_url("")).rstrip("/")))
                body = jpg()
                digest = cache_mod.source_digest(body)
                width = None
                for cand in range(60, 300):
                    opts = build_params_from_query({"width": str(cand)})
                    skey = cache_mod.shared_key(cache_mod.request_key(digest, "resize", opts))
                    if ra.owner_host(skey) == "host-b":
                        width = cand
                        break
                assert width is not None
                fwd = await ca.post(f"/resize?width={width}", **_post_kw())
                assert fwd.status == 200
                assert fwd.headers[router_mod.HOST_EPOCH_HEADER] == "host-a:100"
                b_fwd = await fwd.read()
                assert ra.stats.forwards == 1
                assert rb.stats.served_for_peer == 1
                assert rb.stats.forwards == 0  # one hop, ever
                direct = await cb.post(f"/resize?width={width}", **_post_kw())
                assert await direct.read() == b_fwd
                # a digest A owns never leaves A
                for cand in range(60, 300):
                    opts = build_params_from_query({"width": str(cand)})
                    skey = cache_mod.shared_key(cache_mod.request_key(digest, "resize", opts))
                    if ra.owner_host(skey) == "host-a":
                        local = await ca.post(f"/resize?width={cand}", **_post_kw())
                        assert local.status == 200
                        break
                assert ra.stats.forwards == 1 and rb.stats.served_for_peer == 1
            finally:
                await ca.close()
                await cb.close()

        asyncio.run(fn())

    def test_forwarded_query_drops_the_source_and_resolves_auto(self):
        """The hop ships the source in its body: `url`, `file` and `sign`
        leave the query, and type=auto goes as the negotiated type."""
        shipped = {}

        async def fn(client, app):
            ra = app["service"].multihost
            ra.close()  # the table is taught by hand: no gossip poll of the dead base

            async def hop(method, url, body, headers, timeout):
                shipped.update(url=url, body=body)
                peer = ra.table.lookup("host-b")
                return 200, _ok_headers(peer), b"FORWARDED"

            ra._hop = hop
            ra.table.observe("http://127.0.0.1:1",
                             _host_payload(hid="host-b", epoch=100, serve="http://b:2"))
            headers = {"Content-Type": "image/jpeg", "Accept": "image/webp",
                       router_mod.ROUTE_HEADER: "route"}
            digest = cache_mod.source_digest(jpg())
            for width in range(60, 300):  # a digest host-b owns
                query = {"width": str(width), "type": "auto", "sign": "abc"}
                opts = app["service"].prepare(jpg(), query, headers).opts
                skey = cache_mod.shared_key(cache_mod.request_key(digest, "resize", opts))
                if ra.owner_host(skey) == "host-b":
                    break
            shipped["width"] = str(width)
            r = await client.post(f"/resize?width={width}&type=auto&sign=abc",
                                  data=jpg(), headers=headers)
            assert r.status == 200
            assert await r.read() == b"FORWARDED"
            assert r.headers["Vary"] == "Accept"

        os.environ[mh.HOST_EPOCH_ENV] = "100"
        run(_opts(peers="http://127.0.0.1:1", host_id="host-a", fleet_hop_ms=15000.0), fn)
        from urllib.parse import parse_qs, urlsplit

        q = parse_qs(urlsplit(shipped["url"]).query)
        assert q == {"width": [shipped["width"]], "type": ["webp"]}
        assert shipped["body"] == jpg()

    def test_spillover_offers_before_shedding(self):
        # force A's governor critical (the memory.rss chaos site) and point
        # its table at a healthy B: batch-class work that would 503 on A
        # ships to B and answers 200; with B critical too, A sheds the 503
        # the request was owed anyway (no ping-pong)
        qos_cfg = json.dumps({
            "default": {"class": "standard"},
            "tenants": [{"name": "bulk", "class": "batch", "api_keys": ["bulk-key"]}],
        })

        async def fn():
            from imaginary_tpu_torch.web.app import create_app

            def boot(hid, pressure):
                os.environ[mh.HOST_ID_ENV] = hid
                os.environ[mh.HOST_EPOCH_ENV] = "100"
                try:
                    o = _opts(peers="http://127.0.0.1:1", host_id=hid,
                              fleet_hop_ms=15000.0, qos_config=qos_cfg,
                              pressure_rss_mb=1_000_000.0 if pressure else 0.0)
                    return create_app(o, log_stream=io.StringIO())
                finally:
                    os.environ.pop(mh.HOST_ID_ENV, None)
                    os.environ.pop(mh.HOST_EPOCH_ENV, None)

            app_a, app_b = boot("host-a", True), boot("host-b", False)
            ca = TestClient(TestServer(app_a))
            cb = TestClient(TestServer(app_b))
            await ca.start_server()
            await cb.start_server()
            try:
                svc_a = app_a["service"]
                ra = svc_a.multihost
                ra.close()  # taught by hand, as above
                serve_b = str(cb.make_url("")).rstrip("/")
                ra.table.observe("http://127.0.0.1:1",
                                 _host_payload(hid="host-b", epoch=100, serve=serve_b))
                svc_a.pressure.config.sample_interval_s = 0.0
                failpoints.activate("memory.rss=error")
                try:
                    from imaginary_tpu_torch.engine.pressure import LEVEL_CRITICAL

                    assert svc_a.pressure.level() == LEVEL_CRITICAL
                    r = await ca.post("/resize?width=123&key=bulk-key", **_post_kw())
                    assert r.status == 200  # spilled, not shed
                    assert ra.stats.spills == 1
                    rb = app_b["service"].multihost
                    assert rb.stats.served_for_peer >= 1
                    assert rb.stats.spills == 0  # the marker blocks a re-spill
                    # B critical too: no spill target, A sheds its 503
                    ra.table.observe("http://127.0.0.1:1",
                                     _host_payload(hid="host-b", epoch=100,
                                                   plevel=LEVEL_CRITICAL, serve=serve_b))
                    r2 = await ca.post("/resize?width=124&key=bulk-key", **_post_kw())
                    assert r2.status == 503
                    assert "Retry-After" in r2.headers
                    assert ra.stats.spills == 1
                finally:
                    failpoints.deactivate()
            finally:
                await ca.close()
                await cb.close()

        asyncio.run(fn())

    def test_worker_hang_blocks_health(self):
        """worker.hang on the port's /health: a delay(200ms) holds the
        answer (the supervisor's liveness probe reads the wedged loop)."""
        async def fn(client, app):
            failpoints.activate("worker.hang=delay(200ms)")
            try:
                t0 = time.perf_counter()
                r = await client.get("/health")
                assert r.status == 200
                assert time.perf_counter() - t0 >= 0.2
            finally:
                failpoints.deactivate()

        run(_opts(), fn)


# --- the supervisor's side: the admin plane and the shm stamp ---------------------------


class TestSupervisorPlane:
    def test_fleet_admin_serves_the_host_block_and_the_cluster_view(self):
        import urllib.request

        from imaginary_tpu_torch.obs.aggregate import FleetAdmin

        t = mh.PeerTable(["http://b:1"])
        t.observe("http://b:1", _host_payload(hid="host-b", epoch=4))

        def fetch(url, timeout):
            if url.endswith("/health"):
                return json.dumps({"worker": 0, "epoch": 1, "estimatedQueueMs": 2.0})
            raise OSError("no metrics here")

        admin = FleetAdmin(0, "http://127.0.0.1:1/metrics", "http://127.0.0.1:1/health",
                           lambda: {0: {"pid": 1, "alive": True, "epoch": 1}},
                           scrape_deadline_s=0.3, fetch=fetch,
                           host_info={"id": "host-a", "epoch": 9, "serve_url": "http://x:1"},
                           peer_table=t).start()
        try:
            def get(path):
                with urllib.request.urlopen(f"http://127.0.0.1:{admin.port}{path}",
                                            timeout=10) as r:
                    return json.loads(r.read())

            plain = get("/fleetz")
            assert plain["host"]["id"] == "host-a" and plain["host"]["workers_alive"] == 1
            assert "scope" not in plain
            cluster = get("/fleetz?scope=cluster")
            assert cluster["scope"] == "cluster"
            assert cluster["hosts"]["host-a"]["local"] is True
            assert cluster["hosts"]["host-b"]["alive"] is True
            assert cluster["local"]["host"]["epoch"] == 9
        finally:
            admin.close()

    def test_fleet_admin_without_peers_has_no_host_block(self):
        import urllib.request

        from imaginary_tpu_torch.obs.aggregate import FleetAdmin

        admin = FleetAdmin(0, "http://127.0.0.1:1/metrics", "http://127.0.0.1:1/health",
                           lambda: {}, scrape_deadline_s=0.1,
                           fetch=lambda u, to: (_ for _ in ()).throw(OSError())).start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{admin.port}/fleetz?scope=cluster", timeout=10) as r:
                body = json.loads(r.read())
            assert "host" not in body and "scope" not in body
        finally:
            admin.close()

    def test_host_identity_from_the_command_line(self):
        from imaginary_tpu_torch import cli

        assert cli.host_identity(cli.options_from_args(cli.parse_args([]))) is None
        o = cli.options_from_args(cli.parse_args(
            ["--peers", "127.0.0.1:9101", "--host-id", "host-a", "--port", "9200",
             "--path-prefix", "/img/"]))
        info = cli.host_identity(o)
        assert info["id"] == "host-a" and info["epoch"] == mh.host_epoch() > 0
        assert info["serve_url"] == "http://127.0.0.1:9200/img"
        assert os.environ[mh.HOST_ID_ENV] == "host-a"


# --- two real supervisors (subprocess e2e) -------------------------------------------------


@pytest.mark.slow
def test_two_supervisor_cluster_forward():
    """The full stack: two `python -m imaginary_tpu_torch.cli` clusters on
    one machine, each a supervisor and two workers with its own admin
    plane, cross-pointed --peers, --router on. Gossip learns the peer over
    real sockets; a digest owned by the other host takes a real hop."""
    import signal
    import subprocess
    import sys
    import urllib.request

    import bench_util

    ports = [bench_util.free_port() for _ in range(4)]
    sp_a, sp_b, ad_a, ad_b = ports
    env = dict(os.environ)
    env.pop(mh.HOST_ID_ENV, None)
    env.pop(mh.HOST_EPOCH_ENV, None)
    env.pop(shmcache.PATH_ENV, None)
    env["IMAGINARY_TPU_DEVICE"] = "cpu"

    def start_host(hid, port, admin, peer_admin):
        return subprocess.Popen(
            [sys.executable, "-m", "imaginary_tpu_torch.cli", "--workers", "2",
             "--device", "cpu", "--port", str(port), "--host-id", hid,
             "--peers", f"http://127.0.0.1:{peer_admin}",
             "--router", "--fleet-hop-ms", "15000",
             "--peer-probe-interval", "0.3",
             "--fleet-cache-mb", "8", "--fleet-admin-port", str(admin),
             "--cache-result-mb", "8"],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)

    pa = start_host("host-a", sp_a, ad_a, ad_b)
    pb = start_host("host-b", sp_b, ad_b, ad_a)
    try:
        def wait_http(url, deadline=120.0):
            t0 = time.monotonic()
            while time.monotonic() - t0 < deadline:
                try:
                    with urllib.request.urlopen(url, timeout=2.0) as r:
                        return json.loads(r.read().decode())
                except Exception:
                    time.sleep(0.3)
            raise AssertionError("never healthy: " + url)

        ha = wait_http(f"http://127.0.0.1:{sp_a}/health")
        wait_http(f"http://127.0.0.1:{sp_b}/health")
        assert ha["host"]["id"] == "host-a"
        # the cluster view converges once gossip has crossed
        t0 = time.monotonic()
        cluster = {}
        while time.monotonic() - t0 < 30.0:
            cluster = wait_http(f"http://127.0.0.1:{ad_a}/fleetz?scope=cluster")
            if cluster.get("hosts", {}).get("host-b", {}).get("alive"):
                break
            time.sleep(0.5)
        assert cluster["hosts"]["host-b"]["alive"] is True
        assert cluster["hosts"]["host-a"]["local"] is True

        # the workers' gossip rides the same admin planes; give them a beat
        # to see host-b alive, then hunt a width A must forward
        body = fixture_bytes("imaginary.jpg")
        deadline = time.monotonic() + 60.0
        forwarded = False
        while time.monotonic() < deadline and not forwarded:
            for width in range(90, 130):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{sp_a}/resize?width={width}", data=body,
                    method="POST", headers={"Content-Type": "image/jpeg",
                                            "Connection": "close"})
                with urllib.request.urlopen(req, timeout=30.0) as r:
                    assert r.status == 200
                    assert r.headers[router_mod.HOST_EPOCH_HEADER].startswith("host-a:")
            h = wait_http(f"http://127.0.0.1:{sp_a}/health")
            if h.get("multihost", {}).get("forwards", 0) > 0:
                forwarded = True
        assert forwarded, "no request ever took the cross-host hop"
    finally:
        for p in (pa, pb):
            try:
                p.send_signal(signal.SIGTERM)
            except ProcessLookupError:
                pass
        for p in (pa, pb):
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
