"""Memory-pressure governor (the port's copy of
`imaginary_tpu/engine/pressure.py`): the sensing half of the
memory-pressure subsystem. The acting half, the brownout ladder, lives in
web/handlers.py (the critical rung's batch-class shed and pixel clamp),
qos/shed.py and the executor (the batch byte cap, oversize items forced
to the host, OOM bisection); the cache tiers' shrink waits for the
port's cache.

  * `MemoryGovernor` samples process RSS (web/health.py's /proc parser),
    host-pool in-flight bytes (work admitted but not yet materialized —
    imminent RSS) and the executor's estimated device bytes in flight
    (its owed wire-MB ledger, `device_owed_mb`), and folds them into a
    pressure level {ok, elevated, critical} with hysteresis so the
    ladder cannot flap at a threshold.
  * Level transitions are recorded (per-rung counters + a bounded
    history ring) and fanned out to registered callbacks.
  * `release_memory()` is the working form of the reference's
    FreeOSMemory ticker: CPython's gc.collect alone returns freed pages
    to the allocator, not to the OS — glibc keeps the arena; malloc_trim
    actually gives it back (Linux best-effort, no-op elsewhere). The
    server's --mrelease ticker calls it.

Everything is DEFAULT OFF (rss_limit_mb = 0 builds no governor at all):
every consumer takes its plain path.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Optional

from imaginary_tpu_torch import failpoints

LEVEL_OK = 0
LEVEL_ELEVATED = 1
LEVEL_CRITICAL = 2
LEVEL_NAMES = ("ok", "elevated", "critical")


@dataclasses.dataclass
class PressureConfig:
    """Knobs for the governor + the brownout ladder (CLI --pressure-*,
    env IMAGINARY_TPU_PRESSURE_*; web/config.ServerOptions mirrors)."""

    # RSS ceiling in MB. 0 = the whole subsystem is OFF (no governor is
    # constructed; every consumer takes its parity path).
    rss_limit_mb: float = 0.0
    # Estimated device-HBM budget in MB; 0 skips the device signal (the
    # executor's wire-byte ledger is an estimate, not an allocator view,
    # so this is an explicit operator opt-in).
    hbm_limit_mb: float = 0.0
    # Pressure-ratio thresholds: elevated at 75% of a limit, critical at
    # 90%, with a 5-point hysteresis band on the way DOWN so the ladder
    # latches instead of flapping when RSS hovers at a threshold.
    elevated_frac: float = 0.75
    critical_frac: float = 0.90
    hysteresis_frac: float = 0.05
    # Sampling is lazy (level() re-reads /proc at most this often): the
    # admission path calls level() per request and must not pay a file
    # read each time.
    sample_interval_s: float = 0.25
    # Under pressure the executor caps ADMITTED batch bytes per device
    # call at this many wire-MB (halved at critical), so OOM bisects
    # become rare rather than routine. 0 = never cap.
    batch_mb: float = 32.0
    # Elevated rung: batch-class (or qos-off) items at least this many
    # source megapixels are forced to the host interpreter — big frames
    # stop transiting the device while memory is tight.
    oversize_mpix: float = 4.0
    # Critical rung: per-request pixel admission (source AND requested
    # output dims) clamps to this fraction of --max-allowed-resolution.
    pixel_frac: float = 0.25


def from_options(o) -> Optional["MemoryGovernor"]:
    """Build the governor from ServerOptions; None when the subsystem is
    off (the parity default)."""
    rss = float(getattr(o, "pressure_rss_mb", 0.0) or 0.0)
    if rss <= 0.0:
        return None
    cfg = PressureConfig(
        rss_limit_mb=rss,
        hbm_limit_mb=float(getattr(o, "pressure_hbm_mb", 0.0) or 0.0),
        elevated_frac=float(getattr(o, "pressure_elevated_frac", 0.75)),
        critical_frac=float(getattr(o, "pressure_critical_frac", 0.90)),
        batch_mb=float(getattr(o, "pressure_batch_mb", 32.0)),
        oversize_mpix=float(getattr(o, "pressure_oversize_mpix", 4.0)),
        pixel_frac=float(getattr(o, "pressure_pixel_frac", 0.25)),
    )
    return MemoryGovernor(cfg)


class MemoryGovernor:
    """Pressure level {ok, elevated, critical} with hysteresis.

    Thread-safe: level() is called from the event loop (admission), pool
    threads (Executor.submit), and the collector (batch-byte cap); the
    critical sections are a dict read and a float compare. Sampling
    happens at most every sample_interval_s regardless of call rate.
    """

    def __init__(self, config: PressureConfig,
                 rss_fn: Optional[Callable[[], float]] = None,
                 host_mb_fn: Optional[Callable[[], float]] = None,
                 device_mb_fn: Optional[Callable[[], float]] = None):
        self.config = config
        if rss_fn is None:
            from imaginary_tpu_torch.web.health import _rss_mb

            rss_fn = _rss_mb
        self._rss_fn = rss_fn
        self._host_mb_fn = host_mb_fn
        self._device_mb_fn = device_mb_fn
        self._lock = threading.Lock()
        self._level = LEVEL_OK
        self._last_sample_t = float("-inf")
        self._last: dict = {"rss_mb": 0.0, "host_mb": 0.0,
                            "device_mb": 0.0, "ratio": 0.0}
        # per-rung entry counters (the /metrics
        # imaginary_tpu_pressure_transitions_total{level=} families) + a
        # bounded transition history
        self._entries = [0, 0, 0]
        self._history: deque = deque(maxlen=64)
        self._callbacks: list = []
        # brownout-ladder action counters, bumped by the enforcement
        # sites (handlers/executor) so /health's pressure block tells the
        # whole story in one place
        self._sheds = 0
        self._pixel_clamps = 0
        self._start_t = time.time()

    @property
    def enabled(self) -> bool:
        return self.config.rss_limit_mb > 0.0

    def bind_sources(self, host_mb_fn: Optional[Callable[[], float]] = None,
                     device_mb_fn: Optional[Callable[[], float]] = None) -> None:
        """Late-bind the occupancy signals: the governor is constructed
        before the executor that feeds them (ExecutorConfig carries the
        governor, so the dependency points this way)."""
        if host_mb_fn is not None:
            self._host_mb_fn = host_mb_fn
        if device_mb_fn is not None:
            self._device_mb_fn = device_mb_fn

    def on_transition(self, cb: Callable[[int, int], None]) -> None:
        """Register cb(old_level, new_level), fired outside the lock on
        every rung change."""
        self._callbacks.append(cb)

    # -- sampling ---------------------------------------------------------

    def _ratio(self) -> float:
        """One sample of the pressure ratio: max over the configured
        signals of used/limit. Host-pool in-flight bytes count WITH RSS —
        they are admitted work about to become resident pages."""
        forced = False
        try:
            # failpoint site: an injected error simulates RSS at the
            # ceiling (`memory.rss=error`), so the whole ladder — shed,
            # clamp, batch cap — can be exercised without actually
            # exhausting the host
            failpoints.hit("memory.rss")
        except Exception:
            forced = True
        rss = float(self._rss_fn() or 0.0)
        host = float(self._host_mb_fn()) if self._host_mb_fn else 0.0
        dev = float(self._device_mb_fn()) if self._device_mb_fn else 0.0
        r = 0.0
        if self.config.rss_limit_mb > 0:
            r = max(r, (rss + host) / self.config.rss_limit_mb)
        if self.config.hbm_limit_mb > 0 and dev > 0:
            r = max(r, dev / self.config.hbm_limit_mb)
        if forced:
            r = max(r, 1.0)
        self._last = {"rss_mb": round(rss, 2), "host_mb": round(host, 2),
                      "device_mb": round(dev, 2), "ratio": round(r, 4)}
        return r

    def _next_level(self, cur: int, r: float) -> int:
        """Hysteresis ladder: promotion at the threshold, demotion only
        below threshold - hysteresis (one band per rung)."""
        c = self.config
        if r >= c.critical_frac:
            return LEVEL_CRITICAL
        if cur == LEVEL_CRITICAL:
            if r >= c.critical_frac - c.hysteresis_frac:
                return LEVEL_CRITICAL
            return (LEVEL_ELEVATED if r >= c.elevated_frac - c.hysteresis_frac
                    else LEVEL_OK)
        if r >= c.elevated_frac:
            return LEVEL_ELEVATED
        if cur == LEVEL_ELEVATED and r >= c.elevated_frac - c.hysteresis_frac:
            return LEVEL_ELEVATED
        return LEVEL_OK

    def level(self) -> int:
        """Current pressure rung, re-sampled at most every
        sample_interval_s."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_sample_t < self.config.sample_interval_s:
                return self._level
            self._last_sample_t = now
        # sample OUTSIDE the lock (/proc read + callables), then commit
        r = self._ratio()
        changed = False
        with self._lock:
            old = self._level
            new = self._next_level(old, r)
            if new != old:
                changed = True
                self._level = new
                self._entries[new] += 1
                self._history.append({
                    "t": round(time.time(), 3),
                    "from": LEVEL_NAMES[old], "to": LEVEL_NAMES[new],
                    "ratio": self._last["ratio"],
                })
            cbs = tuple(self._callbacks) if changed else ()
        for cb in cbs:
            try:
                cb(old, new)
            except Exception:  # itpu: allow[ITPU004] a broken listener must not break sampling
                pass
        if changed and new == LEVEL_CRITICAL:
            # entering critical: aggressively hand freed pages back to
            # the OS — the rung exists to create headroom NOW
            release_memory()
        return self._level

    def level_name(self) -> str:
        return LEVEL_NAMES[self.level()]

    # -- ladder helpers (read by the enforcement sites) -------------------

    def batch_cap_mb(self) -> float:
        """Admitted device-batch byte cap for the current rung: full
        batch_mb at elevated, half at critical, uncapped at ok."""
        lvl = self.level()
        if lvl == LEVEL_OK or self.config.batch_mb <= 0:
            return 0.0
        return (self.config.batch_mb if lvl == LEVEL_ELEVATED
                else self.config.batch_mb / 2.0)

    def note_shed(self) -> None:
        with self._lock:
            self._sheds += 1

    def note_pixel_clamp(self) -> None:
        with self._lock:
            self._pixel_clamps += 1

    # -- surfaces ---------------------------------------------------------

    def snapshot(self) -> dict:
        """The /health `pressure` block (also rendered into /metrics as
        imaginary_tpu_pressure_*)."""
        lvl = self.level()
        with self._lock:
            last = dict(self._last)
            entries = list(self._entries)
            sheds = self._sheds
            clamps = self._pixel_clamps
            history = list(self._history)
        return {
            "level": LEVEL_NAMES[lvl],
            "state": lvl,
            "rss_mb": last["rss_mb"],
            "rss_limit_mb": self.config.rss_limit_mb,
            "host_inflight_mb": last["host_mb"],
            "device_inflight_mb": last["device_mb"],
            "ratio": last["ratio"],
            "transitions": {
                "ok": entries[LEVEL_OK],
                "elevated": entries[LEVEL_ELEVATED],
                "critical": entries[LEVEL_CRITICAL],
            },
            "batch_sheds": sheds,
            "pixel_clamps": clamps,
            "recent_transitions": history[-8:],
        }


# -- returning memory to the OS (the --mrelease ticker's working half) ------

_libc = None
_libc_probed = False


def _malloc_trim() -> bool:
    """glibc malloc_trim(0) via ctypes: returns unused arena pages to the
    OS. Best-effort — absent libc/symbol (musl, macOS) is a no-op, not an
    error."""
    global _libc, _libc_probed
    if not _libc_probed:
        _libc_probed = True
        try:
            import ctypes

            lib = ctypes.CDLL("libc.so.6", use_errno=True)
            lib.malloc_trim.argtypes = [ctypes.c_size_t]
            lib.malloc_trim.restype = ctypes.c_int
            _libc = lib
        except (OSError, AttributeError):
            _libc = None
    if _libc is None:
        return False
    try:
        return bool(_libc.malloc_trim(0))
    except Exception:  # pragma: no cover - exotic libc
        return False


def release_memory() -> dict:
    """gc.collect + malloc_trim: the reference's debug.FreeOSMemory
    equivalent that actually lowers RSS. gc.collect alone frees objects
    into glibc's arena, where the pages stay resident; malloc_trim hands
    the arena's free tail back to the kernel."""
    import gc

    collected = gc.collect()
    trimmed = _malloc_trim()
    return {"collected": collected, "trimmed": trimmed}
