"""Class-aware fair scheduler: the executor's qos intake queue (the port's
copy of `imaginary_tpu/qos/sched.py`).

Drop-in replacement for the micro-batch executor's FIFO `queue.Queue`
(same put/get/get_nowait/qsize surface, None as the shutdown sentinel) —
the collector's chunking/ladder/mesh logic is untouched, it just pops
from this instead. Three policies compose, all decided at pop time under
one lock:

  1. STRICT PRIORITY WITH AGING between classes. The highest non-empty
     class dispatches — except that every pop a non-empty class is
     bypassed increments its bypass counter, and a class whose counter
     reaches its aging threshold (`aging_dispatches`, default standard=4
     batch=8) is force-served next. That is a weighted-fair interleave
     with hard starvation bounds: under sustained interactive load a
     waiting batch item STILL dispatches at least once every 8 pops
     (tests/test_torch_qos.py pins the bound), instead of waiting
     forever the way pure strict priority would.

  2. EDF WITHIN A CLASS. Items carry their request deadline's absolute
     expiry (the port's deadline.py, read by `tenancy.request_qos`); the
     class heap pops earliest-deadline-first, so a request about to 504
     goes ahead of one with budget to spare. Items without a deadline
     sort last among their class, in arrival order — with deadlines off
     this degrades to exact FIFO within the class, which is how the
     single-default-tenant configuration stays ordering-identical to the
     plain FIFO queue.

  3. PER-TENANT IN-QUEUE SHARE CAPS at put time. A tenant whose
     `max_share` < 1.0 may hold at most max_share x queue_cap items in
     the intake queue; the N+1th put raises TenantShareExceeded (503 +
     Retry-After via shed.py) back through Executor.submit — one hog
     cannot occupy the whole queue no matter how fast it submits.
     With --fleet-qos armed the same cap is ALSO charged against the
     shm share table (fleet/ownership.py FleetQos), so the bound holds
     across every SO_REUSEPORT worker's queue, not per process; the
     charge is taken before any local mutation and released in
     _pop_locked, and any shared-table fault degrades to the local cap
     alone (fail-open).

Thread model: puts arrive from many pool threads, gets from the single
collector thread; one Condition guards everything (critical sections are
a heap push/pop and counter bumps — far cheaper than the device work the
queue feeds).
"""

from __future__ import annotations

import heapq
import math
import queue as queue_mod
import threading
import time
from typing import Optional

from imaginary_tpu_torch.fleet import ownership
from imaginary_tpu_torch.qos import CLASSES
from imaginary_tpu_torch.qos.shed import TenantShareExceeded
from imaginary_tpu_torch.qos.tenancy import QosPolicy


class FairScheduler:
    def __init__(self, policy: QosPolicy):
        self.policy = policy
        self._cv = threading.Condition(threading.Lock())
        self._heaps = [[] for _ in CLASSES]  # (deadline_t, seq, tenant, item)
        self._bypass = [0] * len(CLASSES)
        self._tenant_counts: dict = {}
        self._seq = 0
        self._size = 0
        self._closed = False
        policy.stats.bind_depths(self.depths)

    # -- queue.Queue surface the collector consumes ------------------------

    def put(self, item) -> None:
        """Enqueue one executor item (or the None shutdown sentinel).
        Raises TenantShareExceeded when the item's tenant is at its
        in-queue cap — the caller (Executor.submit) surfaces the 503."""
        if item is None:
            with self._cv:
                self._closed = True
                self._cv.notify_all()
            return
        qos = getattr(item, "qos", None)
        if qos is None:
            ten = self.policy.default
            name, kidx, max_share, deadline_t = (
                ten.name, ten.class_index, ten.max_share, None)
        else:
            name, kidx, max_share, deadline_t = qos
        charged = False
        with self._cv:
            if max_share < 1.0:
                cap = max(1, int(self.policy.queue_cap * max_share))
                if self._tenant_counts.get(name, 0) >= cap:
                    self.policy.stats.note_share_rejected(kidx)
                    raise TenantShareExceeded(name)
                fq = ownership.fleet_qos()
                if fq is not None:
                    # fleet-wide cap: same absolute bound, charged
                    # against the shm share table so a tenant spread
                    # over N workers' queues still holds <= cap items
                    got = fq.share_charge(name, cap)
                    if got is False:
                        self.policy.stats.note_share_rejected(kidx)
                        raise TenantShareExceeded(name)
                    charged = got is True
            self._seq += 1
            heapq.heappush(
                self._heaps[kidx],
                (deadline_t if deadline_t is not None else math.inf,
                 self._seq, name, charged, item))
            self._tenant_counts[name] = self._tenant_counts.get(name, 0) + 1
            self._size += 1
            self._cv.notify()

    def get(self, timeout: Optional[float] = None):
        """Pop per the class policy; None once closed AND drained (the
        sentinel must never overtake queued work — the collector still
        dispatches everything accepted before shutdown)."""
        with self._cv:
            end = None if timeout is None else time.monotonic() + timeout
            while True:
                if self._size:
                    return self._pop_locked()
                if self._closed:
                    return None
                if end is None:
                    self._cv.wait()
                else:
                    rem = end - time.monotonic()
                    if rem <= 0:
                        raise queue_mod.Empty
                    self._cv.wait(rem)

    def get_nowait(self):
        with self._cv:
            if self._size:
                return self._pop_locked()
            if self._closed:
                return None
            raise queue_mod.Empty

    def qsize(self) -> int:
        with self._cv:
            return self._size

    # -- surfaces ----------------------------------------------------------

    def depths(self) -> dict:
        """Live per-class queue depth (the /health and /metrics gauge)."""
        with self._cv:
            return {name: len(self._heaps[i])
                    for i, name in enumerate(CLASSES)}

    # -- internals ---------------------------------------------------------

    def _select_locked(self) -> int:
        # Aged classes first, in priority order: a class bypassed past
        # its threshold is owed a dispatch before the strict-priority
        # winner (threshold 0 = exempt from aging, i.e. the top class).
        aging = self.policy.aging_dispatches
        for i in range(len(CLASSES)):
            if self._heaps[i] and aging[i] > 0 and self._bypass[i] >= aging[i]:
                return i
        for i in range(len(CLASSES)):
            if self._heaps[i]:
                return i
        raise AssertionError("_select_locked on empty scheduler")

    def _pop_locked(self):
        i = self._select_locked()
        _, _, name, charged, item = heapq.heappop(self._heaps[i])
        self._size -= 1
        if charged:
            fq = ownership.fleet_qos()
            if fq is not None:
                fq.share_release(name)
        left = self._tenant_counts.get(name, 1) - 1
        if left <= 0:
            self._tenant_counts.pop(name, None)
        else:
            self._tenant_counts[name] = left
        self._bypass[i] = 0
        for j in range(len(CLASSES)):
            if j != i and self._heaps[j]:
                self._bypass[j] += 1
        self.policy.stats.note_dispatched(i)
        return item
