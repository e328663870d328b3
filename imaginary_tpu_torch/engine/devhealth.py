"""Per-device fault domains: health records, breakers, quarantine, probes
(a trimmed copy of `imaginary_tpu/engine/devhealth.py`, kept to what the
lane tier needs).

Each mesh entry (a lane of the executor) is its own fault domain:

  * it carries its own record (consecutive-failure count, totals, an
    error-rate EWMA and a drain-latency EWMA, probe counts);
  * after `threshold` CONSECUTIVE failed launches or drains it is
    QUARANTINED for `cooldown_s`: its lane leaves the rotation and what it
    held moves to the surviving lanes;
  * when the cooldown expires it goes HALF-OPEN, and a background probe
    (a tiny kernel launch on that entry, run on a side thread joined with
    a timeout, so a probe that hangs books a failure instead of wedging
    the prober) re-admits it on success; a failed probe re-opens it at
    once, since the consecutive count only resets on a success.

`generation` moves on every quarantine and every re-admission, so the
executor can tell cheaply that the topology changed. The registry keeps
its own lock, never held while calling into torch, and every method is
safe from collector, fetcher, probe and request threads.

Not ported yet: fail-slow demotion, corruption strikes and the golden
probe, capacity (OOM) events, the sticky `pick` of the global ladder,
and the strike history.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

STATE_HEALTHY = "healthy"
STATE_QUARANTINED = "quarantined"
STATE_HALF_OPEN = "half_open"


class DeviceRecord:
    """One fault domain's live state. Mutated only under the registry
    lock; read-copied into snapshots."""

    __slots__ = ("idx", "consecutive_failures", "failures", "successes",
                 "breaker_opens", "quarantined_until", "error_ewma",
                 "latency_ewma_ms", "latency_samples", "last_probe_t",
                 "probes", "readmissions", "last_error")

    def __init__(self, idx: int):
        self.idx = idx
        self.consecutive_failures = 0
        self.failures = 0
        self.successes = 0
        self.breaker_opens = 0
        self.quarantined_until = 0.0  # monotonic; 0 = never tripped
        self.error_ewma = 0.0
        self.latency_ewma_ms: Optional[float] = None  # None = never sampled
        self.latency_samples = 0
        self.last_probe_t = 0.0
        self.probes = 0
        self.readmissions = 0
        self.last_error = ""

    def state(self, now: float) -> str:
        if now < self.quarantined_until:
            return STATE_QUARANTINED
        if self.quarantined_until > 0.0:
            # cooldown over, no success has closed the breaker yet
            return STATE_HALF_OPEN
        return STATE_HEALTHY

    def to_dict(self, now: float) -> dict:
        return {
            "device": self.idx,
            "state": self.state(now),
            "consecutive_failures": self.consecutive_failures,
            "failures": self.failures,
            "successes": self.successes,
            "breaker_opens": self.breaker_opens,
            "quarantined_for_s": round(max(0.0, self.quarantined_until - now), 3),
            "error_ewma": round(self.error_ewma, 4),
            "latency_ewma_ms": round(self.latency_ewma_ms or 0.0, 3),
            "latency_samples": self.latency_samples,
            "probes": self.probes,
            "readmissions": self.readmissions,
            "last_error": self.last_error,
        }


class DeviceHealthRegistry:
    """Per-device breakers. After `threshold` CONSECUTIVE failures a
    device quarantines for `cooldown_s`; the count persists through the
    cooldown, so one more failure in the half-open window re-opens it at
    once, and only a success resets it."""

    def __init__(self, n_devices: int = 1, threshold: int = 3,
                 cooldown_s: float = 30.0):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self._lock = threading.Lock()
        self._records = [DeviceRecord(i) for i in range(max(1, n_devices))]
        self.generation = 0  # bumped on every quarantine and re-admission
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_stop = threading.Event()
        # the lanes' snapshot, merged into snapshot() (the /health block)
        self._lane_stats_provider: Optional[Callable[[], list]] = None

    def set_lane_stats_provider(self, fn: Optional[Callable[[], list]]) -> None:
        self._lane_stats_provider = fn

    def record(self, idx: int) -> DeviceRecord:
        with self._lock:
            return self._records[idx]

    # -- breaker transitions ---------------------------------------------

    def note_failure(self, idx: int, err: object = None) -> bool:
        """Book one failed launch or drain against device `idx`; returns
        whether it tripped (or re-tripped) the device's breaker."""
        now = time.monotonic()
        with self._lock:
            rec = self._records[idx]
            rec.consecutive_failures += 1
            rec.failures += 1
            rec.error_ewma = 0.8 * rec.error_ewma + 0.2
            if err is not None:
                rec.last_error = str(err)[:200]
            if (rec.consecutive_failures >= self.threshold
                    and now >= rec.quarantined_until):
                rec.quarantined_until = now + self.cooldown_s
                rec.breaker_opens += 1
                self.generation += 1
                return True
            return False

    def note_ok(self, idx: int, latency_ms: Optional[float] = None) -> None:
        """A success on device `idx`: closes its breaker (a re-admission
        when it was open) and folds `latency_ms` into its EWMA."""
        with self._lock:
            rec = self._records[idx]
            was_open = rec.quarantined_until > 0.0
            rec.consecutive_failures = 0
            rec.quarantined_until = 0.0
            rec.successes += 1
            rec.error_ewma *= 0.8
            if was_open:
                rec.readmissions += 1
                self.generation += 1
            if latency_ms is not None:
                rec.latency_ewma_ms = (
                    latency_ms if rec.latency_ewma_ms is None
                    else 0.8 * rec.latency_ewma_ms + 0.2 * latency_ms)
                rec.latency_samples += 1

    def note_probe_ok(self, idx: int) -> None:
        """A clean probe: re-admits the device unless its cooldown is still
        running."""
        with self._lock:
            if time.monotonic() < self._records[idx].quarantined_until:
                return
        self.note_ok(idx)

    # -- views -------------------------------------------------------------

    def is_quarantined(self, idx: int) -> bool:
        now = time.monotonic()
        with self._lock:
            return now < self._records[idx].quarantined_until

    def any_available(self) -> bool:
        """True when at least one device is dispatchable (healthy or
        half-open)."""
        now = time.monotonic()
        with self._lock:
            return any(now >= r.quarantined_until for r in self._records)

    def healthy_indices(self) -> list:
        now = time.monotonic()
        with self._lock:
            return [r.idx for r in self._records if r.state(now) == STATE_HEALTHY]

    def available_indices(self) -> list:
        now = time.monotonic()
        with self._lock:
            return [r.idx for r in self._records if now >= r.quarantined_until]

    def due_for_probe(self) -> list:
        """Half-open devices not probed within min(1 s, cooldown)."""
        now = time.monotonic()
        with self._lock:
            return [r.idx for r in self._records
                    if now - r.last_probe_t >= min(1.0, self.cooldown_s)
                    and r.quarantined_until > 0.0 and now >= r.quarantined_until]

    def snapshot(self) -> dict:
        """The /health `deviceHealth` block, with the lanes' snapshot
        under "lanes" when a provider is installed."""
        now = time.monotonic()
        with self._lock:
            per = [r.to_dict(now) for r in self._records]
        out = {
            "count": len(per),
            "healthy": sum(1 for d in per if d["state"] == STATE_HEALTHY),
            "quarantined": sum(1 for d in per if d["state"] == STATE_QUARANTINED),
            "per_device": per,
        }
        provider = self._lane_stats_provider
        if provider is not None:
            lanes = provider()
            if lanes:
                out["lanes"] = lanes
        return out

    # -- background probe --------------------------------------------------

    def start_probing(self, probe_fn: Callable[[int], None],
                      timeout_s: float = 5.0) -> None:
        """Start the re-admission prober: every half-open device is probed
        by `probe_fn(idx)`, which raises on failure, on a side thread
        joined with `timeout_s`. A probe that hangs books a failure and is
        left to die with the process."""
        if self._probe_thread is not None:
            return

        def loop():
            while not self._probe_stop.wait(min(1.0, max(0.05, self.cooldown_s / 4))):
                for idx in self.due_for_probe():
                    with self._lock:
                        self._records[idx].last_probe_t = time.monotonic()
                        self._records[idx].probes += 1
                    outcome: dict = {}

                    def attempt(i=idx):
                        try:
                            probe_fn(i)
                        except Exception as e:  # noqa: BLE001 - the probe is a boundary
                            outcome["err"] = e

                    t = threading.Thread(target=attempt, daemon=True,
                                         name=f"itpu-probe-{idx}")
                    t.start()
                    t.join(timeout=timeout_s)
                    if t.is_alive() or "err" in outcome:
                        self.note_failure(idx, outcome.get("err", "probe hang"))
                    else:
                        self.note_probe_ok(idx)

        self._probe_thread = threading.Thread(target=loop, name="itpu-devprobe",
                                              daemon=True)
        self._probe_thread.start()

    def close(self) -> None:
        self._probe_stop.set()
        t = self._probe_thread
        if t is not None:
            t.join(timeout=5)
