"""The port's per-device fault domains (`engine/devhealth.py`), the
executor's failover ladder and hedging, and the keyed failpoints
(`failpoints.py`) on the CPU: port copies of tests/test_devhealth.py's
TestRegistry, TestChipFailover, TestHedging and TestKeyedFailpoints, and
the same event sequences (failures, corruptions with clean probes,
capacity events, probe latencies that trip and clear fail-slow, `pick`
with exclusions) fed into both packages' registries, which must end in
equal states, counts and strike histories.

Left out with the code they test: the qos batch class's hedging rule and
the worker supervisor.
"""

from __future__ import annotations

import threading
import time

import pytest
import torch

from imaginary_tpu import failpoints as jfailpoints
from imaginary_tpu.engine import devhealth as jdevhealth
import numpy as np

from imaginary_tpu_torch import failpoints
from imaginary_tpu_torch.engine import Executor, ExecutorConfig
from imaginary_tpu_torch.engine import executor as ex_mod
from imaginary_tpu_torch.engine.devhealth import (
    STATE_DEGRADED,
    STATE_HALF_OPEN,
    STATE_HEALTHY,
    STATE_QUARANTINED,
    CorruptionError,
    DeviceHealthRegistry,
)
from imaginary_tpu_torch.obs import trace as obs_trace
from imaginary_tpu_torch.ops.plan import plan_operation
from imaginary_tpu_torch.options import ImageOptions


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(h=96, w=128, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _plan(h=96, w=128, width=48):
    return plan_operation("resize", ImageOptions(width=width), h, w, 0, 3)


def _ex(**kw) -> Executor:
    kw.setdefault("max_form_ms", 1.0)
    return Executor(ExecutorConfig(device="cpu", **kw))


class TestRegistry:
    def test_breaker_independence(self):
        reg = DeviceHealthRegistry(4, threshold=3, cooldown_s=60)
        for _ in range(3):
            reg.note_failure(1, "chip 1 sick")
        assert reg.is_quarantined(1)
        assert not reg.is_quarantined(0)
        assert reg.healthy_indices() == [0, 2, 3]
        assert reg.available_indices() == [0, 2, 3]
        assert reg.any_available()
        # sticky pick skips the quarantined chip, never its peers
        assert reg.pick() == 0
        assert reg.pick(exclude={0}) == 2

    def test_one_device_trip_half_open_and_reset(self):
        """Trip on the Nth CONSECUTIVE failure, half-open at cooldown
        expiry, one more failure re-opens at once, only a success resets."""
        reg = DeviceHealthRegistry(1, threshold=3, cooldown_s=0.2)
        assert reg.any_available()
        reg.note_failure(0)
        reg.note_failure(0)
        assert reg.any_available()
        tripped = reg.note_failure(0)
        assert tripped and not reg.any_available()
        rec = reg.record(0)
        assert rec.breaker_opens == 1
        time.sleep(0.25)
        assert reg.any_available()
        assert rec.state(time.monotonic()) == STATE_HALF_OPEN
        assert reg.note_failure(0)
        assert not reg.any_available()
        time.sleep(0.25)
        reg.note_ok(0)
        assert rec.state(time.monotonic()) == STATE_HEALTHY
        assert rec.consecutive_failures == 0
        assert rec.readmissions == 1
        reg.note_failure(0)
        assert reg.any_available()

    def test_generation_moves_like_the_reference(self):
        """Same steps on both registries: a trip, a failure while open, a
        re-admission and a success move `generation` equally."""
        regs = [DeviceHealthRegistry(2, threshold=2, cooldown_s=0.05),
                jdevhealth.DeviceHealthRegistry(2, threshold=2, cooldown_s=0.05)]
        gens = []
        for reg in regs:
            seen = []
            for step in ("fail", "fail", "fail", "sleep", "ok", "ok", "fail"):
                if step == "fail":
                    reg.note_failure(1, "x")
                elif step == "ok":
                    reg.note_ok(1)
                else:
                    time.sleep(0.08)
                seen.append(reg.generation)
            gens.append(seen)
        assert gens[0] == gens[1] == [0, 1, 1, 1, 2, 2, 2]

    def test_snapshot_shape(self):
        reg = DeviceHealthRegistry(2, threshold=1, cooldown_s=60)
        reg.note_failure(1, "boom")
        snap = reg.snapshot()
        assert snap["count"] == 2
        assert snap["healthy"] == 1
        assert snap["quarantined"] == 1
        states = {d["device"]: d["state"] for d in snap["per_device"]}
        assert states == {0: STATE_HEALTHY, 1: STATE_QUARANTINED}
        assert snap["per_device"][1]["last_error"] == "boom"
        assert "lanes" not in snap
        reg.set_lane_stats_provider(lambda: [{"lane": 0}, {"lane": 1}])
        assert len(reg.snapshot()["lanes"]) == 2

    def test_note_ok_books_the_latency_ewma(self):
        reg = DeviceHealthRegistry(1)
        reg.note_ok(0, latency_ms=0.0)
        reg.note_ok(0, latency_ms=10.0)
        rec = reg.record(0)
        assert rec.latency_samples == 2
        assert rec.latency_ewma_ms == pytest.approx(2.0)

    def test_probe_readmits_and_respects_failures(self):
        reg = DeviceHealthRegistry(2, threshold=1, cooldown_s=0.1)
        sick = {1}

        def probe(idx):
            if idx in sick:
                raise RuntimeError("still sick")

        reg.note_failure(1)
        reg.start_probing(probe, timeout_s=2.0)
        try:
            time.sleep(0.5)
            assert reg.record(1).probes >= 1
            assert reg.healthy_indices() != [0, 1]
            sick.clear()
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if reg.record(1).state(time.monotonic()) == STATE_HEALTHY:
                    break
                time.sleep(0.05)
            assert reg.record(1).state(time.monotonic()) == STATE_HEALTHY
            assert reg.record(1).readmissions == 1
        finally:
            reg.close()

    def test_hung_probe_books_a_failure(self):
        reg = DeviceHealthRegistry(2, threshold=1, cooldown_s=0.1)
        release = threading.Event()

        def probe(idx):
            release.wait(timeout=30)

        reg.note_failure(1)
        before = reg.record(1).failures
        reg.start_probing(probe, timeout_s=0.3)
        try:
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if reg.record(1).failures > before:
                    break
                time.sleep(0.05)
            assert reg.record(1).failures > before
            assert not reg.is_quarantined(0)
        finally:
            release.set()
            reg.close()

    def test_probe_before_cooldown_does_not_readmit(self):
        reg = DeviceHealthRegistry(2, threshold=1, cooldown_s=60)
        reg.note_failure(0)
        reg.note_probe_ok(0)
        assert reg.is_quarantined(0)
        assert reg.due_for_probe() == []


class TestRegistryBranches:
    """The branches this slice brings: corruption strikes and the clean
    probe debt, capacity events, fail-slow, the strike history."""

    def test_corruption_quarantines_at_once_and_needs_clean_probes(self):
        reg = DeviceHealthRegistry(2, threshold=3, cooldown_s=0.05)
        assert reg.note_corruption(1, CorruptionError("bad bytes"), clean_probes=3)
        assert reg.is_quarantined(1)
        rec = reg.record(1)
        assert rec.corruptions == 1 and rec.clean_probes_needed == 3
        time.sleep(0.08)
        reg.note_probe_ok(1)
        reg.note_probe_ok(1)
        assert rec.state(time.monotonic()) == STATE_HALF_OPEN
        reg.note_probe_ok(1)
        assert rec.state(time.monotonic()) == STATE_HEALTHY
        assert rec.readmissions == 1
        kinds = [e["kind"] for e in reg.strike_history()]
        assert kinds == ["corruption"]

    def test_capacity_is_booked_not_struck(self):
        reg = DeviceHealthRegistry(1, threshold=1, cooldown_s=60)
        reg.note_capacity(0, "CUDA out of memory")
        rec = reg.record(0)
        assert rec.oom_events == 1 and rec.consecutive_failures == 0
        assert reg.any_available() and reg.strike_history() == []

    def test_failslow_demotes_sheds_and_recovers(self):
        reg = DeviceHealthRegistry(3, threshold=3, cooldown_s=60)
        reg.configure_failslow(3.0, min_samples=2, strikes=20)
        for _ in range(3):
            reg.note_probe_ok(0, latency_ms=1.0)
            reg.note_probe_ok(1, latency_ms=1.0)
            reg.note_probe_ok(2, latency_ms=50.0)
        rec = reg.record(2)
        assert rec.state(time.monotonic()) == STATE_DEGRADED
        assert rec.demotions == 1 and reg.snapshot()["degraded"] == 1
        assert reg.pick(exclude={0, 1}) == 2  # limping beats nothing
        assert reg.pick() == 0
        for _ in range(30):
            reg.note_probe_ok(2, latency_ms=1.0)
        assert rec.state(time.monotonic()) == STATE_HEALTHY
        assert [e["kind"] for e in reg.strike_history()] == ["failslow_demote"]

    def test_set_consecutive_preloads_the_trip(self):
        reg = DeviceHealthRegistry(1, threshold=3, cooldown_s=60)
        reg.set_consecutive(0, 2)
        assert reg.note_failure(0, "hang")
        assert not reg.any_available()


def _drive(reg, jreg_mod, steps) -> list:
    """Feed `steps` into `reg`; record what each step returns."""
    out = []
    for step, *args in steps:
        if step == "sleep":
            time.sleep(args[0])
            out.append(None)
        elif step == "corrupt":
            out.append(reg.note_corruption(args[0], "wrong bytes", clean_probes=args[1]))
        elif step == "probe_ok":
            out.append(reg.note_probe_ok(*args))
        elif step == "pick":
            out.append(reg.pick(exclude=args[0]))
        else:
            out.append(getattr(reg, step)(*args))
    return out


def _comparable(snap: dict) -> dict:
    snap = dict(snap)
    snap["per_device"] = [{k: v for k, v in d.items() if k != "quarantined_for_s"}
                          for d in snap["per_device"]]
    return snap


SEQUENCES = {
    "failures": [("note_failure", 1, "x"), ("note_failure", 1, "x"),
                 ("note_failure", 0, "y"), ("pick", set()), ("pick", {0}),
                 ("note_ok", 0, 2.0), ("note_failure", 1, "x"), ("pick", {0})],
    "corruption": [("corrupt", 2, 2), ("pick", set()), ("sleep", 0.06),
                   ("probe_ok", 2, 1.0), ("probe_ok", 2, 1.0), ("pick", {0, 1})],
    "capacity": [("note_capacity", 0, "oom"), ("note_capacity", 0, "oom"),
                 ("note_failure", 0, "crash"), ("pick", set())],
    "failslow": ([("probe_ok", i, 1.0) for _ in range(3) for i in (0, 1)]
                 + [("probe_ok", 2, 40.0)] * 3 + [("pick", set()), ("pick", {0, 1})]
                 + [("probe_ok", 2, 1.0)] * 25 + [("pick", {0})]),
    "failslow-quarantine": ([("probe_ok", i, 1.0) for _ in range(3) for i in (0, 1)]
                            + [("probe_ok", 2, 90.0)] * 12 + [("pick", {0, 1})]),
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_event_sequences_end_equal_to_the_references(name):
    """The same events into both packages' registries: equal returns,
    snapshots (but the cooldown clock), strike kinds and generations."""
    regs = [DeviceHealthRegistry(3, threshold=2, cooldown_s=0.05),
            jdevhealth.DeviceHealthRegistry(3, threshold=2, cooldown_s=0.05)]
    for reg in regs:
        reg.configure_failslow(3.0, min_samples=2, strikes=4)
    got, want = (_drive(reg, jdevhealth, SEQUENCES[name]) for reg in regs)
    assert got == want
    assert _comparable(regs[0].snapshot()) == _comparable(regs[1].snapshot())
    strip = (lambda h: [{k: v for k, v in e.items() if k != "t"} for e in h])
    assert strip(regs[0].strike_history()) == strip(regs[1].strike_history())
    assert regs[0].generation == regs[1].generation


# -- the executor: chip failure -> failover -> quarantine -> re-admit ------------


class TestChipFailover:
    def test_sick_primary_fails_over_and_quarantines_alone(self):
        """Device 0 (the primary) dies; its chunks move to device 1 and the
        requests keep succeeding: losing a device costs capacity, not
        availability."""
        failpoints.activate("device.chip_error[0]=error")
        ex = _ex(n_devices=2, breaker_threshold=3, breaker_cooldown_s=60)
        try:
            tr = obs_trace.RequestTrace("req-failover")
            token = obs_trace.activate(tr)
            try:
                ex_mod.reset_placement()
                out = ex.process(_img(), _plan(), timeout=120)
            finally:
                obs_trace.deactivate(token)
            assert out.shape == (36, 48, 3)
            assert ex_mod.last_placement() == "device"  # device 1, not the host
            assert tr.fields["placement_attempts"] == ["device:0:error", "device:1"]
            for i in range(2):
                ex.process(_img(seed=i + 1), _plan(), timeout=120)
            assert ex.devhealth.is_quarantined(0)
            snap = ex.devhealth.snapshot()
            assert snap["quarantined"] == 1 and snap["healthy"] == 1
            assert not ex._breaker_is_open()
            assert ex.stats.breaker_opens == 0 and ex.stats.breaker_host_served == 0
            tr2 = obs_trace.RequestTrace("req-after-quarantine")
            token = obs_trace.activate(tr2)
            try:
                ex.process(_img(seed=9), _plan(), timeout=120)
            finally:
                obs_trace.deactivate(token)
            assert tr2.fields["placement_attempts"] == ["device:1"]
        finally:
            failpoints.deactivate()
            ex.shutdown()

    def test_chip_error_failpoint_quarantine_and_probe_readmission(self):
        failpoints.activate("device.chip_error[0]=error")
        ex = _ex(n_devices=2, breaker_threshold=2, breaker_cooldown_s=0.3)
        try:
            for i in range(2):
                assert ex.process(_img(seed=i), _plan(), timeout=120).shape == (36, 48, 3)
            assert ex.devhealth.is_quarantined(0)
            assert not ex._breaker_is_open()
            snap = failpoints.snapshot()
            assert snap["sites"]["device.chip_error[0]"]["fired"] >= 2
            time.sleep(0.8)  # the probes fail while the fault is armed
            assert ex.devhealth.record(0).state(time.monotonic()) != STATE_HEALTHY
            failpoints.deactivate()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if ex.devhealth.record(0).state(time.monotonic()) == STATE_HEALTHY:
                    break
                time.sleep(0.05)
            assert ex.devhealth.record(0).state(time.monotonic()) == STATE_HEALTHY
            assert ex.devhealth.record(0).readmissions >= 1
        finally:
            failpoints.deactivate()
            ex.shutdown()

    def test_one_device_outage_is_served_by_the_host_and_closes_on_success(self):
        failpoints.activate("device.chip_error=error")
        # host placement on, as the reference's auto default has it
        ex = _ex(breaker_threshold=2, breaker_cooldown_s=0.2, host_spill=True)
        try:
            for i in range(2):
                with pytest.raises(failpoints.FailpointError):
                    ex.process(_img(seed=i), _plan(), timeout=30)
            assert ex._breaker_is_open() and ex.stats.breaker_opens == 1
            ex_mod.reset_placement()
            assert ex.process(_img(seed=5), _plan(), timeout=30).shape == (36, 48, 3)
            assert ex_mod.last_placement() == "host"
            assert ex.stats.breaker_host_served == 1
            failpoints.deactivate()
            time.sleep(0.3)  # half-open: the next request is the probe
            ex_mod.reset_placement()
            ex.process(_img(seed=6), _plan(), timeout=30)
            assert ex_mod.last_placement() == "device"
            assert not ex._breaker_is_open()
        finally:
            failpoints.deactivate()
            ex.shutdown()

    def test_one_device_outage_answers_the_devices_error_with_host_spill_off(self):
        """The port's default: a struck card sends nothing to the host.
        Every request of the cooldown surfaces the device's error, and the
        first clean launch after it closes the breaker on the card."""
        failpoints.activate("device.chip_error=error")
        ex = _ex(breaker_threshold=2, breaker_cooldown_s=0.2)
        try:
            for i in range(4):
                ex_mod.reset_placement()
                with pytest.raises(failpoints.FailpointError):
                    ex.process(_img(seed=i), _plan(), timeout=30)
                assert ex_mod.last_placement() == "device"
            assert ex.stats.breaker_opens >= 1
            assert ex.stats.breaker_host_served == 0 and ex.stats.spilled == 0
            failpoints.deactivate()
            time.sleep(0.3)
            ex_mod.reset_placement()
            out = ex.process(_img(seed=6), _plan(), timeout=30)
            np.testing.assert_array_equal(
                out, ex_mod.chain_mod.run_batch([_img(seed=6)], [_plan()], device="cpu")[0])
            assert ex_mod.last_placement() == "device"
            assert ex.stats.breaker_host_served == 0
        finally:
            failpoints.deactivate()
            ex.shutdown()


# -- hedging -------------------------------------------------------------------


class _BlockedDevice:
    """Every launch blocks until released."""

    def __init__(self, monkeypatch):
        self.release = threading.Event()
        real = ex_mod.chain_mod.launch_batch

        def blocked(*a, **k):
            self.release.wait(timeout=60)
            return real(*a, **k)

        monkeypatch.setattr(ex_mod.chain_mod, "launch_batch", blocked)


class TestHedging:
    def test_off_by_default_no_hedge_machinery(self):
        ex = _ex()
        try:
            fut = ex.submit(_img(), _plan())
            assert fut.result(timeout=120).shape == (36, 48, 3)
            assert not hasattr(fut, "_hedge_placement")
            assert ex.stats.hedges_launched == 0
        finally:
            ex.shutdown()

    def test_hedge_wins_over_stuck_device_and_ledger_balances(self, monkeypatch):
        blocked = _BlockedDevice(monkeypatch)
        ex = _ex(hedge_threshold_ms=50.0)
        try:
            ex_mod.reset_placement()
            t0 = time.monotonic()
            out = ex.process(_img(), _plan(), timeout=30)
            assert out.shape == (36, 48, 3)
            assert ex_mod.last_placement() == "host"  # the twin's pixels
            assert ex.stats.hedges_won == 1
            assert (time.monotonic() - t0) * 1000.0 < 10_000.0
            blocked.release.set()
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                with ex._lock:
                    if ex.stats.device_owed_mb < 1e-9 and ex._device_items == 0:
                        break
                time.sleep(0.05)
            with ex._lock:
                assert ex.stats.device_owed_mb < 1e-9 and ex._device_items == 0
        finally:
            blocked.release.set()
            ex.shutdown()

    def test_hedge_budget_caps_concurrent_twins(self, monkeypatch):
        blocked = _BlockedDevice(monkeypatch)
        host_gate = threading.Event()
        real_host_run = ex_mod.host_exec.run

        def slow_host_run(arr, plan):
            host_gate.wait(timeout=30)
            return real_host_run(arr, plan)

        monkeypatch.setattr(ex_mod.host_exec, "run", slow_host_run)
        ex = _ex(hedge_threshold_ms=50.0, hedge_budget=0.05)
        try:
            futs = [ex.submit(_img(seed=i), _plan()) for i in range(3)]
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if ex.stats.hedges_launched + ex.stats.hedges_skipped >= 3:
                    break
                time.sleep(0.02)
            assert ex.stats.hedges_launched == 1
            assert ex.stats.hedges_skipped == 2
            host_gate.set()
            blocked.release.set()
            for f in futs:
                f.result(timeout=60)
        finally:
            host_gate.set()
            blocked.release.set()
            ex.shutdown()

    def test_device_error_while_twin_runs_surfaces_device_error(self, monkeypatch):
        def dead(*a, **k):
            raise RuntimeError("device fell over")

        monkeypatch.setattr(ex_mod.chain_mod, "launch_batch", dead)
        monkeypatch.setattr(ex_mod.host_exec, "run",
                            lambda arr, plan: (_ for _ in ()).throw(
                                RuntimeError("twin also fell over")))
        ex = _ex(max_form_ms=200, hedge_threshold_ms=50.0, breaker_threshold=100)
        try:
            with pytest.raises(RuntimeError, match="fell over"):
                ex.process(_img(), _plan(), timeout=30)
        finally:
            ex.shutdown()


class TestKeyedFailpoints:
    def teardown_method(self):
        failpoints.deactivate()

    def test_keyed_site_parses_and_scopes(self):
        failpoints.activate("device.chip_error[1]=error")
        failpoints.hit("device.chip_error", key=0)
        with pytest.raises(failpoints.FailpointError):
            failpoints.hit("device.chip_error", key=1)

    def test_bare_site_matches_every_key(self):
        failpoints.activate("device.chip_error=error")
        with pytest.raises(failpoints.FailpointError):
            failpoints.hit("device.chip_error", key=3)
        with pytest.raises(failpoints.FailpointError):
            failpoints.hit("device.chip_error")

    def test_unknown_base_site_rejected(self):
        with pytest.raises(ValueError, match="unknown failpoint site"):
            failpoints.parse("device.nope[1]=error")

    @pytest.mark.parametrize("spec", ["device.chip_error[2]=error",
                                      "device.chip_error=error(0.5)",
                                      "device.chip_error[0]=error;device.chip_error[3]=error"])
    def test_parse_agrees_with_the_reference(self, spec):
        assert set(failpoints.parse(spec)) == set(jfailpoints.parse(spec))

    def test_bad_action_rejected(self):
        with pytest.raises(ValueError):
            failpoints.parse("device.chip_error=error(2)")
        with pytest.raises(ValueError):
            failpoints.parse("device.chip_error")

    @pytest.mark.parametrize("site", ["device.oom", "device.corrupt", "device.slow",
                                      "host.spill"])
    def test_this_slices_sites_parse_like_the_references(self, site):
        for spec in (f"{site}=error", f"{site}[2]=delay(5ms)"):
            assert set(failpoints.parse(spec)) == set(jfailpoints.parse(spec))

    @pytest.mark.parametrize("spec", ["worker.hang=delay(30ms)", "worker.hang=error",
                                      "peer.forward[host-b]=error", "peer.forward=delay(5ms)",
                                      "peer.health=error(0.5)"])
    def test_worker_hang_and_peer_sites_parse_like_the_references(self, spec):
        """The cross-host plane's sites and worker.hang: the same parse as
        the reference's (a host id key may carry a dash)."""
        got, want = failpoints.parse(spec), jfailpoints.parse(spec)
        assert set(got) == set(want)
        def fields(specs):
            return [(sp.kind, sp.p, sp.duration_s, sp.once, sp.raw) for sp in specs.values()]

        assert fields(got) == fields(want)

    def test_worker_hang_delay_blocks_the_caller(self):
        """worker.hang is a synchronous site: an armed delay(30ms) holds the
        calling thread (the /health handler's event loop) for 30 ms."""
        failpoints.activate("worker.hang=delay(30ms)")
        t0 = time.perf_counter()
        failpoints.hit("worker.hang")
        assert time.perf_counter() - t0 >= 0.030

    def test_deactivate_disarms(self):
        failpoints.activate("device.chip_error=error")
        failpoints.deactivate()
        failpoints.hit("device.chip_error", key=0)
