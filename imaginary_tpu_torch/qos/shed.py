"""Class-based overload shedding policy + the qos counter surface (the
port's copy of `imaginary_tpu/qos/shed.py`).

DAGOR-style admission: under overload the LOWEST class sheds first. The
web layer's existing depth gate (--max-queue-ms on estimated_queue_ms())
stays the mechanism; this module only grades its threshold per class —
`batch` is refused when the estimated queueing delay crosses half the
operator's budget, `standard` at three quarters, `interactive` at the
full budget — so as backlog builds, capacity is progressively reserved
for the classes whose latency the operator actually sells. The shed
response keeps the exact contract the gate already has: 503 + Retry-After
(same as --max-queue-ms, shutdown drain, and deadline admission).

QosStats is the one counter block every qos surface reads: per-class
admitted/shed/share-rejected/rate-limited/dispatched counters plus the
live per-class queue depth gauge (bound by the scheduler). /health embeds
`to_dict()` and /metrics renders it as `imaginary_tpu_qos_*`.
"""

from __future__ import annotations

import threading

from imaginary_tpu_torch.errors import ImageError
from imaginary_tpu_torch.qos import CLASSES

# Fraction of --max-queue-ms at which each class sheds (index-aligned
# with CLASSES). Overridable per deployment via the qos config's
# "shed_fractions" map.
DEFAULT_SHED_FRACTIONS = (1.0, 0.75, 0.5)

# Memory-pressure brownout (engine/pressure.py): the MINIMUM governor
# level at which each class is shed outright, index-aligned with CLASSES.
# Only the batch class sheds, and only at critical — interactive and
# standard traffic is instead bounded by the pixel-admission clamp and
# the executor's batch byte cap; batch work is the class whose deferral
# the operator already sold (same DAGOR logic as the queue grading above,
# applied to a different scarce resource).
PRESSURE_SHED_LEVELS = (99, 99, 2)


def shed_for_pressure(level: int, class_index: int) -> bool:
    """True when the governor's current rung sheds this class outright
    (503 + Retry-After, the overload contract). `class_index` beyond the
    known classes (defensive) never sheds."""
    if class_index < 0 or class_index >= len(PRESSURE_SHED_LEVELS):
        return False
    return level >= PRESSURE_SHED_LEVELS[class_index]


class TenantShareExceeded(ImageError):
    """A tenant's in-queue share cap rejected the N+1th queued item.

    Deliberately the same 503 + Retry-After contract as the overload
    gate: to the client it IS overload — of their own share. Raised from
    Executor.submit (pool thread), it rides the request future back to
    the handler's ImageError path like any other typed HTTP error."""

    def __init__(self, tenant: str):
        super().__init__(
            f"Tenant {tenant!r} queue share exhausted, retry later", 503,
            headers={"Retry-After": "1"})
        self.tenant = tenant


class QosStats:
    """Per-class qos counters. Mutated from the event loop (admission,
    rate limit), pool threads (share caps), and the collector thread
    (dispatch) — one lock, trivial critical sections."""

    _COUNTERS = ("admitted", "shed", "share_rejected", "rate_limited",
                 "dispatched")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = {
            name: {c: 0 for c in self._COUNTERS} for name in CLASSES
        }
        self._depth_fn = None  # scheduler-bound live queue-depth reader

    def bind_depths(self, fn) -> None:
        """The scheduler registers its per-class depth reader here (last
        scheduler bound wins — one executor per policy in practice)."""
        self._depth_fn = fn

    def _inc(self, kidx: int, counter: str) -> None:
        name = CLASSES[kidx]
        with self._lock:
            self._counts[name][counter] += 1

    def note_admitted(self, kidx: int) -> None:
        self._inc(kidx, "admitted")

    def note_shed(self, kidx: int) -> None:
        self._inc(kidx, "shed")

    def note_share_rejected(self, kidx: int) -> None:
        self._inc(kidx, "share_rejected")

    def note_rate_limited(self, kidx: int) -> None:
        self._inc(kidx, "rate_limited")

    def note_dispatched(self, kidx: int) -> None:
        self._inc(kidx, "dispatched")

    def to_dict(self) -> dict:
        """The /health `qos` block (and /metrics source): one sub-dict
        per class — counters plus the live queued gauge."""
        depth_fn = self._depth_fn
        depths = depth_fn() if depth_fn is not None else {}
        with self._lock:
            classes = {
                name: dict(counts, queued=depths.get(name, 0))
                for name, counts in self._counts.items()
            }
        return {"classes": classes}
