"""Content-addressed multi-tier caching with request coalescing (the
port's copy of `imaginary_tpu/cache.py`).

Production image services win most of their throughput from result caching
and duplicate-suppression AHEAD of the compute path. Tiers, all keyed
content-addressed (sha256 of the source bytes + the canonicalized
operation/options), all DEFAULT OFF to preserve reference parity:

  * encoded-result LRU (byte budget): repeat requests skip decode ->
    process -> encode entirely and serve stored bytes.
  * singleflight coalescer: N concurrent identical (digest, plan) requests
    run the pipeline ONCE and fan the result out; the group counts as one
    unit of host-pool queue pressure in the admission gate.
  * decoded-frame LRU (digest -> ndarray): different operations on the
    same hot source skip the decode stage.
  * device-resident packed-frame tier: a dct-transport input staged on the
    card once and reused by later launches on that card (ops/chain.py).

On top of the result tier the handler derives a STRONG ETag from the cache
key and answers If-None-Match with 304 before the pipeline runs; a TTL'd
remote-source cache in web/sources.py does the same duplicate-suppression
for ?url= fetches. Hit/miss/eviction/coalesce counters ride into /health
and /metrics next to Executor.stats().

Key derivation: sha256(source bytes) x canonical(op name, ImageOptions).
The options canonicalization runs AFTER Accept negotiation resolved
`type=auto`, so a negotiated webp and a negotiated jpeg response never
share an entry (the ETag differs the same way, which is exactly what the
handler's `Vary: Accept` promises). Any byte change in the source changes
the digest and therefore misses — there is no invalidation protocol to get
wrong.

The reference's fleet shm tier (`attach_shm`, `shm_lookup`, `shm_store`)
is not ported: `CacheSet.shm` stays None.
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

from imaginary_tpu_torch import failpoints
from imaginary_tpu_torch.obs import trace as obs_trace


@dataclasses.dataclass
class CacheStats:
    """Counters for every tier (the /health + /metrics surface)."""

    result_hits: int = 0
    result_misses: int = 0
    result_evictions: int = 0
    frame_hits: int = 0
    frame_misses: int = 0
    frame_evictions: int = 0
    device_hits: int = 0
    device_misses: int = 0
    device_evictions: int = 0
    source_hits: int = 0
    source_misses: int = 0
    source_evictions: int = 0
    # singleflight: executed = groups that ran the pipeline; coalesced =
    # requests that waited on another request's run instead of executing
    flight_executed: int = 0
    flight_coalesced: int = 0
    etag_304: int = 0
    # brownout ladder (engine/pressure.py): times the tiers' budgets were
    # shrunk by a pressure transition (restores don't count — the
    # interesting fact is how often memory pressure took cache capacity)
    pressure_shrinks: int = 0


class ByteBudgetLRU:
    """Thread-safe LRU bounded by a BYTE budget, with optional per-entry
    TTL. Entries are (value, size, expires); an expired entry counts as a
    miss and is dropped on access. Oversize single entries (larger than
    the whole budget) are refused rather than evicting everything."""

    def __init__(self, budget_bytes: int, ttl_s: float = 0.0,
                 on_evict: Optional[Callable[[int], None]] = None):
        self.budget = max(0, int(budget_bytes))
        self.ttl = max(0.0, float(ttl_s))
        self._map: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self._on_evict = on_evict

    @property
    def enabled(self) -> bool:
        return self.budget > 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def get(self, key) -> Optional[Any]:
        # chaos site for every tier's lookup; consumers (result lookup,
        # FrameCache, the source cache) degrade an injected error to a
        # miss — a broken cache must cost latency, not availability
        failpoints.hit("cache.get")
        with self._lock:
            entry = self._map.get(key)
            if entry is None:
                return None
            value, size, expires = entry
            if expires and time.monotonic() >= expires:
                del self._map[key]
                self._bytes -= size
                return None
            self._map.move_to_end(key)
            return value

    def put(self, key, value, size: int) -> None:
        if not self.enabled or size > self.budget:
            return
        expires = time.monotonic() + self.ttl if self.ttl > 0 else 0.0
        evicted = 0
        with self._lock:
            old = self._map.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._map[key] = (value, size, expires)
            self._bytes += size
            while self._bytes > self.budget and self._map:
                _, (_, osize, _) = self._map.popitem(last=False)
                self._bytes -= osize
                evicted += 1
        if evicted and self._on_evict is not None:
            self._on_evict(evicted)

    def set_budget(self, budget_bytes: int) -> None:
        """Re-budget the tier live, evicting LRU-first down to the new
        budget (the brownout ladder shrinks budgets at elevated pressure
        and restores them at ok — eviction here must actually free the
        bytes, not just move a limit)."""
        evicted = 0
        with self._lock:
            self.budget = max(0, int(budget_bytes))
            while self._bytes > self.budget and self._map:
                _, (_, osize, _) = self._map.popitem(last=False)
                self._bytes -= osize
                evicted += 1
        if evicted and self._on_evict is not None:
            self._on_evict(evicted)

    def clear(self) -> None:
        with self._lock:
            self._map.clear()
            self._bytes = 0


class Singleflight:
    """Coalesce concurrent identical requests onto one execution.

    The leader's work runs in its OWN task: a leader client disconnecting
    (coroutine cancellation) must not cancel the shared run that other
    waiters — and the result cache — depend on. Every awaiter shields the
    shared task, so a cancelled waiter detaches without leaking anything;
    the pipeline's _inflight accounting lives inside the task and counts
    the whole group as one unit of queue pressure. Errors propagate to
    every waiter; the done-callback consumes the exception so a group
    whose waiters all vanished never logs 'exception was never retrieved'.
    """

    def __init__(self, stats: Optional[CacheStats] = None):
        self._groups: dict = {}
        self.stats = stats or CacheStats()

    def inflight(self) -> int:
        return len(self._groups)

    async def run(self, key, thunk: Callable[[], Any]):
        task = self._groups.get(key)
        if task is None:
            task = asyncio.ensure_future(thunk())
            self._groups[key] = task
            self.stats.flight_executed += 1

            def _done(t, _key=key):
                self._groups.pop(_key, None)
                if not t.cancelled():
                    t.exception()  # mark retrieved

            task.add_done_callback(_done)
            return await asyncio.shield(task)
        self.stats.flight_coalesced += 1
        # a follower's trace shows WHERE the time went: not in its own
        # pipeline run but waiting on the leader's (the leader's context
        # owns the shared run's stage spans)
        tr = obs_trace.current()
        if tr is not None:
            tr.annotate(coalesced=True)
        with obs_trace.span("coalesce_wait"):
            return await asyncio.shield(task)


def _canon(v):
    """Stable, hashable rendering of an options value tree."""
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, dict):
        return tuple(sorted((str(k), _canon(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return tuple(sorted(str(x) for x in v))
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return tuple(
            (f.name, _canon(getattr(v, f.name))) for f in dataclasses.fields(v)
        )
    return v


def source_digest(buf: bytes) -> bytes:
    return hashlib.sha256(buf).digest()


def request_key(digest: bytes, op_name: str, opts) -> tuple:
    """The content-addressed cache key: source digest x canonicalized
    operation. Must be derived AFTER type=auto Accept negotiation."""
    return (digest, op_name, _canon(opts))


def strong_etag(key: tuple) -> str:
    """Strong ETag for a request key. sha256 over the digest plus the
    deterministic repr of the canonical options tuple (primitives only,
    so repr is stable across processes of the same build)."""
    return '"' + shared_key(key).hex()[:32] + '"'


def shared_key(key: tuple) -> bytes:
    """32-byte cross-process spelling of a request key (the reference's
    fleet shm tier keys its slots by it). Same derivation the strong ETag
    truncates — the repr of the canonical tuple is primitives-only and
    stable across processes of the same build."""
    h = hashlib.sha256(key[0])
    h.update(repr(key[1:]).encode())
    return h.digest()


def etag_matches(header: str, etag: str) -> bool:
    """If-None-Match comparison: `*` or any listed strong tag. Weak tags
    (W/ prefix) never strong-match."""
    header = header.strip()
    if not header:
        return False
    if header == "*":
        return True
    return any(part.strip() == etag for part in header.split(","))


class CacheSet:
    """The serving process's cache tiers + counters, built from
    ServerOptions and owned by ImageService (one per worker process,
    mirroring the executor)."""

    def __init__(self, result_mb: float = 0.0, frame_mb: float = 0.0,
                 coalesce: bool = False, source_ttl_s: float = 0.0,
                 source_mb: float = 32.0, device_mb: float = 0.0):
        self.stats = CacheStats()
        s = self.stats

        def _ev(field):
            def bump(n, _f=field):
                setattr(s, _f, getattr(s, _f) + n)
            return bump

        self.result = ByteBudgetLRU(int(result_mb * 1e6),
                                    on_evict=_ev("result_evictions"))
        self.frames = ByteBudgetLRU(int(frame_mb * 1e6),
                                    on_evict=_ev("frame_evictions"))
        # device-resident packed-frame tier (dct transport inputs staged
        # once, reused across requests — ops/chain consults it via the
        # DeviceFrameCache facade). Values are device tensors, so the
        # byte budget is chargeable device memory: eviction drops the last
        # reference and the caching allocator frees the block once every
        # stream that read it is past the read (record_stream).
        self.device = ByteBudgetLRU(int(device_mb * 1e6),
                                    on_evict=_ev("device_evictions"))
        self.source = ByteBudgetLRU(
            int(source_mb * 1e6) if source_ttl_s > 0 else 0,
            ttl_s=source_ttl_s, on_evict=_ev("source_evictions"))
        self.coalesce = bool(coalesce)
        self.flight = Singleflight(stats=s)
        # the fleet shm tier (the reference's fleet/shmcache.py) is not
        # ported: None keeps `keyed` the reference's formula
        self.shm = None
        # pristine budgets, restored when pressure recedes (the brownout
        # ladder below mutates the live ones)
        self._base_budgets = (self.result.budget, self.frames.budget,
                              self.source.budget, self.device.budget)
        self._pressure_level = 0

    def apply_pressure(self, level: int) -> None:
        """Brownout rung for the cache tiers (engine/pressure.py wires
        this as a governor transition callback). Elevated: result/frame
        budgets halve — cache hits are cheap to re-earn, resident cache
        bytes are exactly the RSS the governor is trying to reclaim.
        Critical: quarter budgets and DISABLE the remote-source cache
        (whole encoded bodies, the largest entries per hit). The device
        frame tier shrinks on the same rungs but disables entirely at
        critical: its bytes are resident device memory next to the batch
        buffers the executor needs to keep serving,
        so it is the first tier to give everything back. Level ok
        restores the configured budgets; entries evicted under pressure
        simply miss and re-fill."""
        if level == self._pressure_level:
            return
        self._pressure_level = level
        result_b, frame_b, source_b, device_b = self._base_budgets
        if level >= 2:
            self.result.set_budget(result_b // 4)
            self.frames.set_budget(frame_b // 4)
            self.source.set_budget(0)
            self.device.set_budget(0)
        elif level == 1:
            self.result.set_budget(result_b // 2)
            self.frames.set_budget(frame_b // 2)
            self.source.set_budget(source_b)
            self.device.set_budget(device_b // 2)
        else:
            self.result.set_budget(result_b)
            self.frames.set_budget(frame_b)
            self.source.set_budget(source_b)
            self.device.set_budget(device_b)
        if level > 0:
            self.stats.pressure_shrinks += 1

    @classmethod
    def from_options(cls, o) -> "CacheSet":
        return cls(
            result_mb=getattr(o, "cache_result_mb", 0.0),
            frame_mb=getattr(o, "cache_frame_mb", 0.0),
            coalesce=getattr(o, "cache_coalesce", False),
            source_ttl_s=getattr(o, "cache_source_ttl", 0.0),
            source_mb=getattr(o, "cache_source_mb", 32.0),
            device_mb=getattr(o, "cache_device_mb", 0.0),
        )

    @property
    def keyed(self) -> bool:
        """Whether any tier needs the content-addressed request key."""
        return self.result.enabled or self.coalesce or self.shm is not None

    def to_dict(self) -> dict:
        """Executor.stats()-style reporting for /health and /metrics."""
        s = self.stats
        return {
            "result_hits": s.result_hits,
            "result_misses": s.result_misses,
            "result_evictions": s.result_evictions,
            "result_items": len(self.result),
            "result_bytes": self.result.bytes_used,
            "frame_hits": s.frame_hits,
            "frame_misses": s.frame_misses,
            "frame_evictions": s.frame_evictions,
            "frame_items": len(self.frames),
            "frame_bytes": self.frames.bytes_used,
            "device_hits": s.device_hits,
            "device_misses": s.device_misses,
            "device_evictions": s.device_evictions,
            "device_items": len(self.device),
            "device_bytes": self.device.bytes_used,
            "source_hits": s.source_hits,
            "source_misses": s.source_misses,
            "source_evictions": s.source_evictions,
            "source_items": len(self.source),
            "source_bytes": self.source.bytes_used,
            "flight_executed": s.flight_executed,
            "flight_coalesced": s.flight_coalesced,
            "etag_304": s.etag_304,
            "pressure_shrinks": s.pressure_shrinks,
        }


class FrameCache:
    """Decoded-frame tier facade handed into the pipeline (pure dict-like
    surface so pipeline.py stays importable without the web layer). Keys
    are (digest, shrink, kind, ...) — shrink-on-load changes the pixels,
    so it is part of the identity; `kind` separates the RGB decode from
    the packed-YUV420 transport buffers."""

    def __init__(self, lru: ByteBudgetLRU, stats: CacheStats):
        self._lru = lru
        self._stats = stats

    @property
    def enabled(self) -> bool:
        return self._lru.enabled

    def get(self, key):
        try:
            got = self._lru.get(key)
        except Exception:
            got = None  # failing tier reads as a miss (see ByteBudgetLRU.get)
        if got is None:
            self._stats.frame_misses += 1
        else:
            self._stats.frame_hits += 1
        return got

    def put(self, key, value, nbytes: int) -> None:
        self._lru.put(key, value, nbytes)


class DeviceFrameCache:
    """Device-resident packed-frame tier facade registered with
    ops/chain.set_device_frame_cache. Keys are (the plan's frame_key, the
    device); values are what ops/chain stores (the staged device tensor
    and the CUDA event recorded after its copy). A hit makes the batch's
    H2D transfer for that item zero wire bytes — repeat requests against a
    hot source reuse resident device memory. Size is charged as the host
    buffer's nbytes (identical layout device-side); eviction drops the
    last reference and the caching allocator frees the block. Budget
    rides CacheSet.apply_pressure's brownout ladder (halved at elevated,
    disabled + drained at critical)."""

    def __init__(self, lru: ByteBudgetLRU, stats: CacheStats):
        self._lru = lru
        self._stats = stats

    @property
    def enabled(self) -> bool:
        return self._lru.enabled

    @property
    def bytes_used(self) -> int:
        return self._lru.bytes_used

    def __len__(self) -> int:
        return len(self._lru)

    def get(self, key):
        try:
            got = self._lru.get(key)
        except Exception:
            got = None  # failing tier reads as a miss (see ByteBudgetLRU.get)
        if got is None:
            self._stats.device_misses += 1
        else:
            self._stats.device_hits += 1
        return got

    def put(self, key, value, nbytes: int) -> None:
        self._lru.put(key, value, nbytes)

    def clear(self) -> None:
        self._lru.clear()
