"""The port's per-device fault domains (`engine/devhealth.py`) and its
keyed failpoints (`failpoints.py`) on the CPU: the registry cases of
tests/test_devhealth.py that the trimmed modules keep, with the
reference's registry run beside the port's where both take the same
steps.

Left out with the code they test: the sticky `pick` of the global ladder,
fail-slow demotion, corruption strikes, hedging and the supervisor.
"""

from __future__ import annotations

import threading
import time

import pytest
import torch

from imaginary_tpu import failpoints as jfailpoints
from imaginary_tpu.engine import devhealth as jdevhealth
from imaginary_tpu_torch import failpoints
from imaginary_tpu_torch.engine.devhealth import (
    STATE_HALF_OPEN,
    STATE_HEALTHY,
    STATE_QUARANTINED,
    DeviceHealthRegistry,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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

    def test_deactivate_disarms(self):
        failpoints.activate("device.chip_error=error")
        failpoints.deactivate()
        failpoints.hit("device.chip_error", key=0)
