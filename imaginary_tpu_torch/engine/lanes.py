"""Per-GPU continuous-batching lanes (the port's copy of
`imaginary_tpu/engine/lanes.py`).

With one collector/fetcher pair the whole fleet of cards is served
through one pipeline. A *lane* is one mesh entry's private slice of that
machinery: its own intake queue, its own formation cap, its own bounded
in-flight window and its own CUDA stream, so N entries run N overlapped
collect -> launch -> drain pipelines. Entries may share a card (four
lanes on one H100): each lane's stream keeps their launches from
serialising on one stream.

Placement (LaneScheduler.place) is load- and cache-aware:

  * the load signal is (outstanding items x EWMA per-item service ms):
    queue depth alone would starve a slow lane's queue onto a fast one
    too late, and the EWMA alone ignores the backlog already committed;
  * frame-cache affinity: an item whose `plan.frame_key` was placed
    before prefers that lane, unless its score exceeds `imbalance` x the
    best. The port has no device frame cache yet, so its plans carry no
    frame_key and placement is least-loaded.

Ledger discipline: `_lane_owe` charges the outstanding-items count and is
released by the item future's done-callback (a charge site guards its
enqueue with an except that cancels the future); `_lane_charge` and
`_lane_release` bracket the drain-scoped in-flight count in a
try/finally. The executor's lane loops live in engine/executor.py.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Optional


class Lane:
    """One mesh entry's intake queue, stream and in-flight bookkeeping.

    Thread roles mirror the executor's global pair: a collector thread
    forms chunks from `queue` and launches them on `stream` (None on the
    CPU), and a fetcher thread drains `fetch_queue` (bounded at
    `max_inflight` launched-but-undrained chunks: the lane's only
    backpressure, like the global fetch queue).
    """

    __slots__ = ("idx", "device", "stream", "queue", "fetch_queue", "owed",
                 "inflight", "dispatches", "ewma_ms", "served_ms",
                 "served_items", "affinity_hits", "affinity_misses",
                 "active", "lock", "collector", "fetcher")

    def __init__(self, idx: int, device, max_inflight: int = 2, stream=None):
        self.idx = idx
        self.device = device
        self.stream = stream
        self.queue: queue_mod.Queue = queue_mod.Queue()
        self.fetch_queue: queue_mod.Queue = queue_mod.Queue(
            maxsize=max(1, int(max_inflight)))
        self.lock = threading.Lock()
        # outstanding items: placed on this lane, future not yet resolved
        # (charged by _lane_owe, released by the future done-callback)
        self.owed = 0
        # items inside the drain the fetcher is blocked on right now
        # (charged/released by _lane_charge/_lane_release in a finally)
        self.inflight = 0
        self.dispatches = 0  # device calls launched on this lane
        self.ewma_ms = 0.0  # per-item service ms, launch -> drain complete
        # cumulative service the lane delivered (an operator's lifetime view)
        self.served_ms = 0.0
        self.served_items = 0
        self.affinity_hits = 0
        self.affinity_misses = 0
        # False while this entry is quarantined: the scheduler skips the
        # lane and its collector re-places whatever it holds
        self.active = True
        self.collector: Optional[threading.Thread] = None
        self.fetcher: Optional[threading.Thread] = None

    def put(self, item) -> None:
        self.queue.put(item)

    def score(self) -> float:
        """The scheduler's load signal: outstanding work priced at this
        lane's measured service rate. +1 so an idle lane with a slow
        EWMA still compares against an idle fast one instead of both
        scoring zero."""
        with self.lock:
            return (self.owed + 1) * max(self.ewma_ms, 1.0)

    def note_service(self, ms_per_item: float, n_items: int = 1) -> None:
        """Fold one drain's per-item latency into the service EWMA and
        book the drain's wall time (`ms_per_item * n_items`) into the
        cumulative served ledger."""
        with self.lock:
            if self.ewma_ms <= 0.0:
                self.ewma_ms = ms_per_item
            else:
                self.ewma_ms = 0.7 * self.ewma_ms + 0.3 * ms_per_item
            self.served_ms += ms_per_item * n_items
            self.served_items += n_items

    def snapshot(self) -> dict:
        with self.lock:
            owed, inflight = self.owed, self.inflight
            ewma = self.ewma_ms
        hits, misses = self.affinity_hits, self.affinity_misses
        total = hits + misses
        return {
            "lane": self.idx,
            "active": self.active,
            "queued": max(0, owed - inflight),
            "inflight": inflight,
            "dispatches": self.dispatches,
            "ewma_ms": round(ewma, 3),
            "served_ms": round(self.served_ms, 3),
            "served_items": self.served_items,
            "affinity_hits": hits,
            "affinity_misses": misses,
            "affinity_hit_ratio": round(hits / total, 3) if total else 0.0,
        }


class LaneScheduler:
    """Places items onto lanes by (depth x EWMA) with frame-cache
    affinity. Owns the bounded frame_key->lane map; the executor owns the
    lanes' threads and the quarantine/re-admission transitions."""

    AFFINITY_CAP = 4096

    def __init__(self, lanes: list, imbalance: float = 4.0):
        self.lanes = lanes
        # a cache-affine lane is preferred until its score exceeds this
        # multiple of the best lane's: sticky under mild skew (a resident
        # frame saves a whole H2D) but never letting one hot key convoy a
        # lane while its peers idle
        self.imbalance = max(1.0, float(imbalance))
        self._affinity: dict = {}  # frame_key -> lane idx of last placement
        self._lock = threading.Lock()

    def active_lanes(self, exclude=()) -> list:
        return [ln for ln in self.lanes
                if ln.active and ln.idx not in exclude]

    def lane(self, idx: int) -> Optional[Lane]:
        for ln in self.lanes:
            if ln.idx == idx:
                return ln
        return None

    def place(self, item, exclude=()) -> Optional[Lane]:
        """Choose a lane for one item; None when every lane is out of
        rotation (the caller falls back to the global failover path).
        Does NOT charge the lane — the caller pairs this with _lane_owe
        so the charge site is the one the ledger rule can see."""
        lanes = self.active_lanes(exclude)
        if not lanes:
            return None
        best = min(lanes, key=lambda ln: ln.score())
        chosen = best
        fk = getattr(item.plan, "frame_key", None)
        if fk is not None:
            with self._lock:
                pref_idx = self._affinity.get(fk)
            pref = None
            if pref_idx is not None:
                for ln in lanes:
                    if ln.idx == pref_idx:
                        pref = ln
                        break
            if pref is not None:
                if pref is best or pref.score() <= self.imbalance * best.score():
                    chosen = pref
                    chosen.affinity_hits += 1
                else:
                    # imbalance fallback: the frame re-stages on the new
                    # lane (one H2D) rather than convoying
                    best.affinity_misses += 1
            with self._lock:
                if (fk not in self._affinity
                        and len(self._affinity) >= self.AFFINITY_CAP):
                    self._affinity.clear()  # bounded; re-learns in one pass
                self._affinity[fk] = chosen.idx
        return chosen

    def snapshot(self) -> list:
        return [ln.snapshot() for ln in self.lanes]


# -- lane ledger primitives ----------------------------------------------------
#
# Every caller of _lane_charge releases in a later finally; every caller of
# _lane_owe guards its enqueue with an except that cancels the future.


def _lane_charge(lane: Lane, n: int = 1) -> None:
    """Charge `n` items entering a drain against the lane's in-flight
    count. Callers MUST release in a finally."""
    with lane.lock:
        lane.inflight += n


def _lane_release(lane: Lane, n: int = 1) -> None:
    with lane.lock:
        lane.inflight = max(0, lane.inflight - n)


def _lane_owe(lane: Lane, item) -> None:
    """Charge one outstanding item against `lane`, released when the
    item's future resolves. Re-placement (drain-on-quarantine) moves the
    charge: the previous owner is refunded here and the done-callback —
    attached exactly once — releases whichever lane owns the item at
    resolution. Callers MUST guard their enqueue with an except that
    cancels the future, so a failed put refunds immediately.
    """
    prev = getattr(item, "lane", None)
    if prev is lane:
        return
    if prev is not None:
        with prev.lock:
            prev.owed = max(0, prev.owed - 1)
    first = prev is None
    item.lane = lane
    with lane.lock:
        lane.owed += 1
    if first:
        item.future.add_done_callback(lambda _f: _lane_owe_done(item))


def _lane_owe_done(item) -> None:
    """Done-callback half of _lane_owe: refund the owning lane."""
    lane = getattr(item, "lane", None)
    item.lane = None
    if lane is not None:
        with lane.lock:
            lane.owed = max(0, lane.owed - 1)
