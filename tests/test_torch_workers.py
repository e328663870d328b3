"""Multi-process serving of the port (--workers N, web/workers.py): a port
copy of `tests/test_workers.py`.

N worker processes accept on one port through SO_REUSEPORT under a
supervisor that forwards signals, respawns crashed workers, replaces hung
ones and rolls the fleet on SIGHUP. These tests boot real fleets of
`python -m imaginary_tpu_torch.cli` workers on the CPU
(IMAGINARY_TPU_DEVICE=cpu, set explicitly: each worker is a fresh torch
interpreter), so the file keeps to one 2-worker fleet for the supervisor's
behaviours; every wait has its own deadline. The reference's three
slow-marked cases keep their marks. Beside the copy: config 1 from the
fleet is byte-equal to the single-process port app's answer with both
workers answering, and the fleet's flag checks.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _health(port: int, timeout: float = 2.0) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/health", headers={"Connection": "close"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _wait_healthy(port: int, deadline_s: float = 60.0) -> dict:
    end = time.monotonic() + deadline_s
    last = None
    while time.monotonic() < end:
        try:
            return _health(port)
        except Exception as e:  # noqa: PERF203 - boot poll
            last = e
            time.sleep(0.5)
    raise AssertionError(f"fleet never became healthy: {last}")


def _sample_pids(port: int, n: int = 24) -> set:
    pids = set()
    for _ in range(n):
        try:
            pids.add(_health(port)["pid"])
        except Exception:
            time.sleep(0.2)
    return pids


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    from tests.conftest import free_port
    port = free_port()
    admin_port = free_port()
    env = dict(os.environ)
    env["IMAGINARY_TPU_DEVICE"] = "cpu"
    env.pop("IMAGINARY_TPU_WORKER", None)
    env.pop("IMAGINARY_TPU_WORKER_EPOCH", None)
    # a known shared-cache path so tests can assert fencing against the
    # LIVE fleet's file; a short roll grace keeps the roll test fast
    fleet_path = str(tmp_path_factory.mktemp("fleet") / "cache.shm")
    env["IMAGINARY_TPU_FLEET_PATH"] = fleet_path
    sup = subprocess.Popen(
        [sys.executable, "-m", "imaginary_tpu_torch.cli", "--workers", "2",
         "--port", str(port), "--fleet-cache-mb", "8",
         "--fleet-roll-grace", "1.0",
         "--fleet-admin-port", str(admin_port)],
        cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        _wait_healthy(port)
        yield port, sup, fleet_path, admin_port
    finally:
        if sup.poll() is None:
            sup.send_signal(signal.SIGTERM)
            try:
                sup.wait(timeout=15)
            except subprocess.TimeoutExpired:
                sup.kill()
                sup.wait()


def test_two_workers_share_one_port(fleet):
    port, _, _, _ = fleet
    # let the second worker finish booting before sampling the pair
    end = time.monotonic() + 45
    pids = set()
    while time.monotonic() < end and len(pids) < 2:
        pids |= _sample_pids(port)
    assert len(pids) == 2, f"expected 2 serving pids, saw {pids}"
    h = _health(port)
    assert h["worker"] in (0, 1)


def test_crashed_worker_is_respawned(fleet):
    port, _, _, _ = fleet
    victim = _health(port)["pid"]
    os.kill(victim, signal.SIGKILL)
    # the supervisor notices within its 200 ms sweep and respawns; the
    # replacement pays a fresh boot
    end = time.monotonic() + 60
    while time.monotonic() < end:
        pids = _sample_pids(port, n=10)
        if len(pids) == 2 and victim not in pids:
            break
        time.sleep(0.5)
    else:
        pytest.fail(f"victim {victim} not replaced (pids now {pids})")
    # service stayed up throughout (samples above ARE the liveness probe)


def test_requests_served_during_and_after_respawn(fleet):
    port, _, _, _ = fleet
    from tests.conftest import fixture_bytes

    body = fixture_bytes("imaginary.jpg")
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/resize?width=64", data=body,
        headers={"Content-Type": "image/jpeg", "Connection": "close"},
    )
    ok = 0
    for _ in range(6):
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
            ok += 1
    assert ok == 6


def test_epochs_stamped_and_fleet_block_served(fleet):
    port, _, fleet_path, _ = fleet
    # both worker indices carry supervisor-stamped epochs; with the
    # shared cache armed every /health response carries the fleet block
    seen = {}
    end = time.monotonic() + 45
    while time.monotonic() < end and len(seen) < 2:
        try:
            h = _health(port)
            seen[h["worker"]] = h["epoch"]
            assert "fleet" in h
        except Exception:
            time.sleep(0.2)
    assert set(seen) == {0, 1}, seen
    assert all(e > 0 for e in seen.values())
    assert len(set(seen.values())) == 2  # epochs are fleet-unique
    # the shm epoch table agrees with what the workers report
    from imaginary_tpu_torch.fleet.shmcache import ShmCache

    client = ShmCache(fleet_path, create=False)
    try:
        for idx, epoch in seen.items():
            assert client.epoch_of(idx) >= epoch
    finally:
        client.close()


def _admin_get(admin_port: int, path: str, timeout: float = 15.0) -> str:
    req = urllib.request.Request(f"http://127.0.0.1:{admin_port}{path}")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read().decode("utf-8")


def _counter_series(text: str) -> dict:
    """{(name, sorted-labels): value} for every counter/histogram sample
    in a merged exposition (the series whose fleet totals must be
    monotonic across respawns)."""
    from tests.test_obs import parse_exposition_strict

    types, samples = parse_exposition_strict(text)
    out = {}
    for name, labels, value in samples:
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[: -len(suffix)] if name.endswith(suffix) else None
            if base and types.get(base) == "histogram":
                family = base
        if types.get(family) in ("counter", "histogram"):
            out[(name, tuple(sorted(labels.items())))] = value
    return out


def test_fleet_admin_metrics_monotonic_across_sigkill_respawn(fleet):
    """The supervisor admin port serves a merged strict-exposition /metrics whose counter totals
    never go backwards across a forced worker SIGKILL + respawn, and
    /fleetz reports the respawn (restart count, fresh pid) even while
    the replacement is still booting (stale partial data, never a 500)."""
    port, _, _, admin_port = fleet
    from tests.conftest import fixture_bytes
    from tests.test_obs import check_histograms, parse_exposition_strict

    body = fixture_bytes("imaginary.jpg")
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/resize?width=64", data=body,
        headers={"Content-Type": "image/jpeg", "Connection": "close"},
    )

    def traffic(n):
        for _ in range(n):
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status == 200

    # make sure both workers are up before the baseline scrape
    end = time.monotonic() + 45
    pids = set()
    while time.monotonic() < end and len(pids) < 2:
        pids |= _sample_pids(port)
    assert len(pids) == 2

    traffic(8)
    text1 = _admin_get(admin_port, "/metrics")
    types1, samples1 = parse_exposition_strict(text1)  # strict contract
    check_histograms(types1, samples1)
    v1 = _counter_series(text1)
    assert any(n == "imaginary_tpu_requests_total" for n, _l in v1)

    # force a respawn: SIGKILL whichever worker answers, then watch the
    # supervisor's own /fleetz report the replacement
    victim_h = _health(port)
    victim_pid, victim_idx = victim_h["pid"], victim_h["worker"]
    before = json.loads(_admin_get(admin_port, "/fleetz"))
    restarts_before = before["workers"][str(victim_idx)]["restarts"]
    epoch_before = before["workers"][str(victim_idx)]["epoch"]
    os.kill(victim_pid, signal.SIGKILL)

    end = time.monotonic() + 90
    respawned = False
    while time.monotonic() < end:
        fz = json.loads(_admin_get(admin_port, "/fleetz"))
        w = fz["workers"].get(str(victim_idx))
        if w and w["alive"] and w["pid"] != victim_pid \
                and w["restarts"] > restarts_before \
                and w["epoch"] > epoch_before:
            respawned = True
            break
        time.sleep(0.5)
    assert respawned, "fleetz never reported the respawn"

    # wait until the replacement actually serves again, push traffic
    # through the whole fleet, and re-scrape
    end = time.monotonic() + 90
    while time.monotonic() < end:
        if len(_sample_pids(port, n=10)) == 2:
            break
        time.sleep(0.5)
    traffic(8)
    text2 = _admin_get(admin_port, "/metrics")
    types2, samples2 = parse_exposition_strict(text2)
    check_histograms(types2, samples2)
    v2 = _counter_series(text2)

    # THE invariant: no counter series the fleet reported before the
    # kill may regress after the zeroed respawn (reset correction)
    regressions = {
        k: (v1[k], v2[k]) for k in v1.keys() & v2.keys()
        if v2[k] < v1[k]
    }
    assert not regressions, f"fleet counters went backwards: {regressions}"
    total1 = sum(v for (n, _l), v in v1.items()
                 if n == "imaginary_tpu_requests_total")
    total2 = sum(v for (n, _l), v in v2.items()
                 if n == "imaginary_tpu_requests_total")
    assert total2 > total1  # the post-respawn traffic is in the totals


@pytest.mark.slow
def test_sighup_rolls_fleet_with_monotonic_epochs(fleet):
    port, sup, fleet_path, _ = fleet
    from tests.conftest import fixture_bytes

    body = fixture_bytes("imaginary.jpg")

    def epochs_now(deadline_s=45):
        got = {}
        end = time.monotonic() + deadline_s
        while time.monotonic() < end and len(got) < 2:
            try:
                h = _health(port)
                got[h["worker"]] = max(got.get(h["worker"], 0), h["epoch"])
            except Exception:
                time.sleep(0.2)
        return got

    before = epochs_now()
    assert set(before) == {0, 1}
    sup.send_signal(signal.SIGHUP)
    # the roll replaces both workers one at a time; service must answer
    # throughout (each replacement pays a fresh torch boot, so be patient)
    observed = {0: [before[0]], 1: [before[1]]}
    end = time.monotonic() + 240
    rolled = False
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/resize?width=48", data=body,
        headers={"Content-Type": "image/jpeg", "Connection": "close"},
    )
    while time.monotonic() < end:
        try:
            h = _health(port)
            observed[h["worker"]].append(h["epoch"])
        except Exception:
            pass
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status == 200
        except (urllib.error.HTTPError, OSError):
            pass  # noqa: PERF203 - a straggler 503 during drain is the documented contract
        cur = {i: max(v) for i, v in observed.items()}
        if cur[0] > before[0] and cur[1] > before[1]:
            rolled = True
            break
        time.sleep(0.3)
    assert rolled, f"roll never completed: {observed}"
    # Epoch discipline per index: during a handover BOTH the old and the
    # new holder serve (that is the zero-downtime design), so samples may
    # interleave the two epochs — but nothing outside {old, new} may ever
    # appear, and the new epoch is strictly greater.
    for idx, seq in observed.items():
        new = max(seq)
        assert new > before[idx]
        assert set(seq) <= {before[idx], new}, \
            f"worker {idx} showed an off-the-books epoch: {seq}"
    # fencing: the deposed epochs can no longer publish to the shared
    # cache (the SIGSTOP zombie protocol, asserted against the live file)
    from imaginary_tpu_torch.fleet.shmcache import ShmCache

    zombie = ShmCache(fleet_path, create=False, worker=0, epoch=before[0])
    try:
        assert zombie.fenced()
        assert not zombie.put(b"z" * 32, b"m", b"b")
        assert zombie.stats.fenced_publishes == 1
    finally:
        zombie.close()
    # and the fleet still serves normally after the roll
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200


def _per_worker_resizes(admin_port: int) -> dict:
    """{worker: its /resize 2xx count} from the admin plane's per-worker
    view (reset-corrected, labelled by worker)."""
    from tests.test_obs import parse_exposition_strict

    _types, samples = parse_exposition_strict(_admin_get(admin_port, "/metrics?per_worker=1"))
    out = {}
    for name, labels, value in samples:
        if name == "imaginary_tpu_requests_total" and labels.get("route") == "/resize" \
                and labels.get("code") == "2xx":
            out[int(labels["worker"])] = value
    return out


def test_config1_byte_equal_to_the_single_process_app(fleet):
    """Config 1 (/resize?width=300&height=200 on large.jpg) from the
    2-worker fleet is byte-equal to the single-process port app's answer,
    and both workers answered some of it."""
    port, _, _, admin_port = fleet
    from imaginary_tpu_torch.web.config import ServerOptions
    from imaginary_tpu_torch.web.handlers import ImageService
    from tests.conftest import fixture_bytes

    body = fixture_bytes("large.jpg")
    svc = ImageService(ServerOptions(device="cpu"))
    try:
        want = svc.process("resize", body, {"width": "300", "height": "200"}).body
    finally:
        svc.close()
    end = time.monotonic() + 45
    pids = set()
    while time.monotonic() < end and len(pids) < 2:
        pids |= _sample_pids(port)
    assert len(pids) == 2
    before = _per_worker_resizes(admin_port)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/resize?width=300&height=200", data=body,
        headers={"Content-Type": "image/jpeg", "Connection": "close"})
    end = time.monotonic() + 60
    sent = 0
    while sent < 8 or time.monotonic() < end:
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
            assert r.read() == want
        sent += 1
        if sent >= 8:
            after = _per_worker_resizes(admin_port)
            if all(after.get(w, 0) > before.get(w, 0) for w in (0, 1)):
                break
    else:
        pytest.fail(f"both workers never answered config 1: {before} -> {after}")


def test_flag_checks_of_the_fleet():
    from imaginary_tpu_torch import cli

    assert cli._resolve_workers(0) == max(1, os.cpu_count() or 1)
    assert cli._resolve_workers(3) == 3
    args = cli.parse_args(["--device", "cpu", "--mesh-hosts", "2", "--workers", "2",
                           "--coordinator-address", "127.0.0.1:1", "--process-id", "0"])
    with pytest.raises(SystemExit, match="--mesh-hosts requires --workers 1"):
        cli.options_from_args(args)
    for flag in ("--fleet-coherence", "--fleet-qos"):
        with pytest.raises(SystemExit, match="require --fleet-cache-mb"):
            cli.options_from_args(cli.parse_args(["--device", "cpu", flag]))
    o = cli.options_from_args(cli.parse_args(
        ["--device", "cpu", "--workers", "2", "--fleet-cache-mb", "8", "--fleet-coherence",
         "--fleet-qos", "--fleet-hop-ms", "40", "--fleet-roll-grace", "2",
         "--fleet-admin-port", "9901"]))
    assert (o.workers, o.fleet_cache_mb, o.fleet_coherence, o.fleet_qos, o.fleet_hop_ms,
            o.fleet_roll_grace_s, o.fleet_admin_port) == (2, 8.0, True, True, 40.0, 2.0, 9901)


def test_sigterm_drains_whole_fleet(fleet):
    # runs LAST in-module: tears the shared fleet down for real
    port, sup, _, _ = fleet
    worker_pids = set()
    end = time.monotonic() + 30
    while time.monotonic() < end and len(worker_pids) < 2:
        worker_pids |= _sample_pids(port, n=6)
    sup.send_signal(signal.SIGTERM)
    rc = sup.wait(timeout=30)
    assert rc == 0
    for pid in worker_pids:
        with pytest.raises(OSError):
            os.kill(pid, 0)  # ESRCH: worker really exited


def test_metrics_url_for():
    from imaginary_tpu_torch.web.workers import metrics_url_for

    assert metrics_url_for("http://127.0.0.1:8080/health") \
        == "http://127.0.0.1:8080/metrics"
    # --path-prefix survives, and only the PATH component is rewritten
    assert metrics_url_for("https://127.0.0.1:8443/api/v1/health") \
        == "https://127.0.0.1:8443/api/v1/metrics"
    # a probe URL that can't yield a /metrics sibling fails at boot,
    # not as an admin plane silently scraping garbage
    with pytest.raises(ValueError):
        metrics_url_for("http://127.0.0.1:8080/healthz")


def test_worker_index_helper():
    from imaginary_tpu_torch.web.workers import WORKER_ENV, worker_index

    assert worker_index() == 0  # non-fleet process is the device owner
    os.environ[WORKER_ENV] = "3"
    try:
        assert worker_index() == 3
    finally:
        del os.environ[WORKER_ENV]


@pytest.mark.slow
def test_serving_process_ignores_sighup(tmp_path):
    """SIGHUP often lands on the whole process GROUP (terminal hangup,
    init systems, signal-forwarding wrappers). Only the supervisor may
    treat it as a roll trigger; a serving process must keep serving —
    the default disposition would turn 'roll the fleet' into 'kill
    every worker at once' (caught live: a forwarded SIGHUP dropped
    requests until this pin)."""
    from tests.conftest import fixture_bytes, free_port

    port = free_port()
    env = dict(os.environ)
    env["IMAGINARY_TPU_DEVICE"] = "cpu"
    env.pop("IMAGINARY_TPU_WORKER", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "imaginary_tpu_torch.cli", "--port", str(port)],
        cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        _wait_healthy(port)
        proc.send_signal(signal.SIGHUP)
        time.sleep(1.0)
        assert proc.poll() is None, "serving process died on SIGHUP"
        body = fixture_bytes("imaginary.jpg")
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/resize?width=64", data=body,
            headers={"Content-Type": "image/jpeg", "Connection": "close"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


@pytest.mark.slow
def test_hung_worker_replacement_is_drain_aware(tmp_path):
    """Drain-aware replacement ordering for a hung (SIGSTOPped) worker:
    the supervisor stamps the fence and spawns the replacement BEFORE it
    starts tearing the hung worker down — observable as the shm epoch
    table advancing while the hung process is still alive (teardown of a
    stopped process is SIGKILL after the hang grace; a supervisor that
    killed first would show the bump only after the pid vanished). The
    replacement must then actually serve, and the zombie must die."""
    from tests.conftest import free_port

    port = free_port()
    fleet_path = str(tmp_path / "fence.shm")
    env = dict(os.environ)
    env["IMAGINARY_TPU_DEVICE"] = "cpu"
    env.pop("IMAGINARY_TPU_WORKER", None)
    env.pop("IMAGINARY_TPU_WORKER_EPOCH", None)
    env["IMAGINARY_TPU_FLEET_PATH"] = fleet_path
    env.update({
        "IMAGINARY_TPU_SUPERVISOR_PROBE_INTERVAL": "0.3",
        "IMAGINARY_TPU_SUPERVISOR_PROBE_TIMEOUT": "1.0",
        "IMAGINARY_TPU_SUPERVISOR_LIVENESS_TIMEOUT": "3.0",
        "IMAGINARY_TPU_SUPERVISOR_HANG_GRACE": "2.0",
        "IMAGINARY_TPU_SUPERVISOR_BOOT_GRACE": "20.0",
    })
    sup = subprocess.Popen(
        [sys.executable, "-m", "imaginary_tpu_torch.cli", "--workers", "2",
         "--port", str(port), "--fleet-cache-mb", "4"],
        cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        _wait_healthy(port)
        seen = {}
        end = time.monotonic() + 45
        while time.monotonic() < end and len(seen) < 2:
            try:
                h = _health(port)
                seen[h["worker"]] = (h["pid"], h["epoch"])
            except Exception:
                time.sleep(0.2)
        assert set(seen) == {0, 1}
        time.sleep(2.0)  # let the SUPERVISOR's probe sight both workers
        zpid, zepoch = seen[1]
        from imaginary_tpu_torch.fleet.shmcache import ShmCache

        client = ShmCache(fleet_path, create=False, worker=1, epoch=zepoch)
        try:
            os.kill(zpid, signal.SIGSTOP)
            # the fence/spawn must land while the hung pid still exists
            fenced_while_hung_alive = False
            end = time.monotonic() + 60
            while time.monotonic() < end:
                bumped = client.epoch_of(1) > zepoch
                try:
                    os.kill(zpid, 0)
                except ProcessLookupError:
                    # pid gone: only acceptable if the bump came first
                    assert fenced_while_hung_alive, \
                        "hung worker torn down before fence+replacement"
                    break
                if bumped:
                    fenced_while_hung_alive = True
                    break
                time.sleep(0.05)
            assert fenced_while_hung_alive
            assert client.fenced()
            new_epoch = client.epoch_of(1)
            assert new_epoch > zepoch
        finally:
            client.close()
        # the replacement must come up serving at the stamped epoch
        end = time.monotonic() + 60
        replacement_serving = False
        while time.monotonic() < end:
            try:
                h = _health(port)
                if h["worker"] == 1 and h["pid"] != zpid \
                        and h["epoch"] == new_epoch:
                    replacement_serving = True
                    break
            except Exception:
                pass
            time.sleep(0.2)
        assert replacement_serving, "replacement never served"
        # release the zombie into the queued SIGTERM; the supervisor's
        # SIGKILL escalation may already have reaped it (SIGKILL acts on
        # stopped processes) — either way it must END UP dead
        try:
            os.kill(zpid, signal.SIGCONT)
        except ProcessLookupError:
            pass  # already SIGKILLed past the hang grace: teardown done
        end = time.monotonic() + 30
        while time.monotonic() < end:
            try:
                os.kill(zpid, 0)
            except ProcessLookupError:
                break
            time.sleep(0.2)
        else:
            pytest.fail("revived zombie never exited")
    finally:
        if sup.poll() is None:
            sup.send_signal(signal.SIGTERM)
            try:
                sup.wait(timeout=15)
            except subprocess.TimeoutExpired:
                sup.kill()
                sup.wait()


# --- supervisor paths that need no worker boot ----------------------------------


def test_backoff_uses_full_jitter(monkeypatch):
    from imaginary_tpu_torch.web import workers

    calls = []

    def fake_uniform(lo, hi):
        calls.append((lo, hi))
        return hi

    monkeypatch.setattr(workers.random, "uniform", fake_uniform)
    assert workers._backoff_delay(0.5, 1) == 0.5
    assert workers._backoff_delay(0.5, 3) == 2.0
    assert workers._backoff_delay(0.5, 30) == 30.0  # capped
    # every delay is drawn uniform over [0, cap] — full jitter, so a
    # correlated fleet death respawns decorrelated
    assert calls == [(0.0, 0.5), (0.0, 2.0), (0.0, 30.0)]


def test_reuseport_guard_refuses_without_support(monkeypatch):
    import socket as socket_mod

    from imaginary_tpu_torch.web.workers import check_reuseport

    check_reuseport()  # this host has it (the fleet fixture relies on it)
    monkeypatch.delattr(socket_mod, "SO_REUSEPORT")
    with pytest.raises(SystemExit, match="SO_REUSEPORT"):
        check_reuseport()


def test_restart_budget_exhaustion_shuts_the_fleet_down(monkeypatch):
    """A worker argv that dies at once (argparse rejects the flag before
    any device is touched) must burn its respawn budget and stop the
    supervisor with a nonzero exit — not spin forever."""
    from imaginary_tpu_torch.web.workers import run_supervisor

    monkeypatch.setenv("IMAGINARY_TPU_SUPERVISOR_RESTART_BUDGET", "2")
    monkeypatch.setenv("IMAGINARY_TPU_SUPERVISOR_BACKOFF", "0.05")
    monkeypatch.delenv("IMAGINARY_TPU_WORKER", raising=False)
    saved = {s: signal.getsignal(s)
             for s in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP)}
    t0 = time.monotonic()
    try:
        rc = run_supervisor(["--no-such-flag"], workers=1)
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    assert rc != 0
    assert time.monotonic() - t0 < 60.0  # budget ended it, not a timeout
