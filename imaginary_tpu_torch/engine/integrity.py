"""Output integrity (the port's copy of `imaginary_tpu/engine/integrity.py`,
with the reference's names): the correctness half of the fault domain.

The breakers (engine/devhealth.py) catch a card that crashes. This module
holds the state of three defences against one that answers with wrong
bytes, all off unless `--integrity` arms them:

  * the golden probe: a fixed input and a real resize chain whose
    reference output the host interpreter computes once
    (prewarm.golden_case); the executor's probe runs the chain on the
    entry under probe through the ported kernels and compares, and a
    mismatch is a corruption strike (devhealth.note_corruption);
  * sampled verification: a fraction of the card's chunks is recomputed
    on the host (or on another healthy entry) and compared before the
    answers leave; a mismatch is a corruption strike and the answer is
    re-served from the verified copy;
  * the poison list: digests of inputs that failed a launch alone (the
    executor's bisection), with a TTL and a cap, so such an input goes
    to the host (or answers 422) instead of failing every chunk it
    joins.

Comparisons against the host are bounded on two axes, the reference's
bars: a pixel off by more than `tolerance` (96) or a plane whose mean
absolute difference exceeds `mean_tolerance` (16) is a mismatch. The
corruption model (a flipped high bit) moves each corrupted byte by 128.
Entry against entry runs the same kernels and compares exactly.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np


@dataclasses.dataclass
class IntegrityConfig:
    enabled: bool = False
    # fraction of production device chunks recomputed + compared before
    # release (1/256 default; 1.0 = verify everything, the SDC-storm
    # chaos row's setting)
    sample: float = 1.0 / 256.0
    # consecutive clean golden probes required before a corruption-struck
    # device may re-admit (crash strikes need one)
    clean_probes: int = 3
    # poison quarantine list: entry lifetime and size cap
    poison_ttl_s: float = 300.0
    poison_cap: int = 256
    # host-reference comparison bars (chip references compare exact; see
    # module docstring for the measured basis): max per-pixel divergence
    # and per-plane mean absolute divergence
    tolerance: int = 96
    mean_tolerance: float = 16.0


# --- golden reference (module-level: shared by integrity-on probing and
# --- failslow-on probing, which can be armed independently) ------------------

_GOLDEN_LOCK = threading.Lock()
_GOLDEN: Optional[tuple] = None  # (input arr, plan, host reference output)


def golden(build=True) -> Optional[tuple]:
    """The (input, plan, host_reference) golden triple, built once on
    first use (prewarm.golden_case owns the construction — a real resize
    op-chain, not a device_put+add; a chip corrupting conv/resize
    kernels must fail this). The reference is the HOST interpreter's
    output: every comparison against it is tolerance-bounded."""
    global _GOLDEN
    if _GOLDEN is None and build:
        with _GOLDEN_LOCK:
            if _GOLDEN is None:
                from imaginary_tpu_torch.prewarm import golden_case

                _GOLDEN = golden_case()
    return _GOLDEN


def reset_golden() -> None:
    """Test hook: drop the cached triple (e.g. after monkeypatching)."""
    global _GOLDEN
    with _GOLDEN_LOCK:
        _GOLDEN = None


# --- comparison helpers -------------------------------------------------------


def _planes(out) -> list:
    """An output as a list of uint8 ndarrays (RGB = one; YuvPlanes =
    three). Unknown shapes yield [] and the caller skips the check."""
    if isinstance(out, np.ndarray):
        return [out]
    y = getattr(out, "y", None)
    if y is not None:
        return [out.y, out.u, out.v]
    return []


def outputs_match(got, ref, exact: bool, tol: int = 96,
                  mean_tol: float = 16.0) -> bool:
    """Compare a device output against a reference. `exact` (entry against
    entry, the same kernels) compares bytes; host references compare
    within the dual tolerance — max per-pixel `tol` AND per-plane mean
    `mean_tol` (the module docstring's bars). Shape mismatch is
    always a mismatch; un-comparable outputs count as matching (the
    caller should have skipped them)."""
    a, b = _planes(got), _planes(ref)
    if not a or not b:
        return True
    if len(a) != len(b):
        return False
    for pa, pb in zip(a, b):
        if pa.shape != pb.shape:
            return False
        if exact:
            if pa.tobytes() != pb.tobytes():
                return False
        else:
            d = np.abs(pa.astype(np.int16) - pb.astype(np.int16))
            if int(d.max()) > tol or float(d.mean()) > mean_tol:
                return False
    return True


def corrupt_copy(out):
    """Flip the high bit of a stripe of an output's bytes — the
    device.corrupt failpoint's SDC model (a mercurial core's wrong
    product, not a subtle LSB wiggle: ±128 clears any tolerance)."""
    planes = _planes(out)
    if not planes:
        return out
    first = planes[0].copy()
    flat = first.reshape(-1)
    n = max(1, flat.shape[0] // 4)
    flat[:n] ^= 0x80
    if isinstance(out, np.ndarray):
        return first
    from imaginary_tpu_torch.codecs import YuvPlanes

    return YuvPlanes(y=first, u=planes[1], v=planes[2])


def item_digest(arr: np.ndarray, key) -> str:
    """Content digest for the poison quarantine list: the decoded input
    bytes plus the chain signature (the same input under a different
    chain is a different failure). blake2b: ~1 GB/s, only ever computed
    when integrity is on AND (recording a poison verdict, or checking a
    non-empty list)."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    h.update(repr(key).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


# --- live state ---------------------------------------------------------------


class IntegrityState:
    """Counters + the poison list, shared by the executor's verify path,
    the submit-time poison check, and the /health `integrity` block."""

    def __init__(self, config: Optional[IntegrityConfig] = None):
        self.config = config or IntegrityConfig()
        self.enabled = self.config.enabled
        self._lock = threading.Lock()
        self._seen_chunks = 0
        # counters (the /metrics families)
        self.checks = 0  # item comparisons actually performed
        self.mismatches = 0  # comparisons that failed
        self.reserved = 0  # responses transparently re-served from the verified copy
        self.skipped = 0  # sampled items with no recompute path (host can't run, no peer chip)
        self.poison_hits = 0  # submits short-circuited by the quarantine list
        self.poison_isolated = 0  # inputs the bisect convicted in isolation
        self.poison_evictions = 0  # entries dropped by TTL sweep or cap
        self._poison: OrderedDict = OrderedDict()  # digest -> expiry (monotonic)

    # -- sampling ---------------------------------------------------------

    def should_sample(self) -> bool:
        """Deterministic 1-in-round(1/sample) chunk gate (a counter, not
        a coin flip: the SDC-storm bench at sample=1.0 must verify EVERY
        chunk, and tests want reproducible cadence)."""
        s = self.config.sample
        if not self.enabled or s <= 0.0:
            return False
        interval = max(1, round(1.0 / min(s, 1.0)))
        with self._lock:
            self._seen_chunks += 1
            return self._seen_chunks % interval == 0

    # -- counters ---------------------------------------------------------

    def note_check(self) -> None:
        with self._lock:
            self.checks += 1

    def note_mismatch(self) -> None:
        with self._lock:
            self.mismatches += 1

    def note_reserved(self) -> None:
        with self._lock:
            self.reserved += 1

    def note_skipped(self) -> None:
        with self._lock:
            self.skipped += 1

    # -- poison quarantine list -------------------------------------------

    def poison_active(self) -> bool:
        """Cheap pre-check so the submit hot path digests inputs only
        while the list is non-empty (the common case is empty)."""
        return bool(self._poison)

    def _sweep_locked(self, now: float) -> None:
        expired = [d for d, exp in self._poison.items() if now >= exp]
        for d in expired:
            del self._poison[d]
            self.poison_evictions += 1
        while len(self._poison) > max(1, self.config.poison_cap):
            self._poison.popitem(last=False)  # oldest entry
            self.poison_evictions += 1

    def poison_add(self, digest: str) -> None:
        now = time.monotonic()
        with self._lock:
            self.poison_isolated += 1
            self._poison[digest] = now + max(0.0, self.config.poison_ttl_s)
            self._poison.move_to_end(digest)
            self._sweep_locked(now)

    def poison_hit(self, digest: str) -> bool:
        now = time.monotonic()
        with self._lock:
            exp = self._poison.get(digest)
            if exp is None:
                return False
            if now >= exp:
                del self._poison[digest]
                self.poison_evictions += 1
                return False
            self.poison_hits += 1
            return True

    def poison_len(self) -> int:
        now = time.monotonic()
        with self._lock:
            self._sweep_locked(now)
            return len(self._poison)

    # -- surface ----------------------------------------------------------

    def snapshot(self) -> dict:
        """The /health `integrity` block (also rendered into /metrics as
        the imaginary_tpu_integrity_* families)."""
        with self._lock:
            self._sweep_locked(time.monotonic())
            return {
                "enabled": self.enabled,
                "sample": self.config.sample,
                "checks": self.checks,
                "mismatches": self.mismatches,
                "reserved": self.reserved,
                "skipped": self.skipped,
                "poison_entries": len(self._poison),
                "poison_hits": self.poison_hits,
                "poison_isolated": self.poison_isolated,
                "poison_evictions": self.poison_evictions,
            }


def from_options(o) -> Optional[IntegrityState]:
    """ServerOptions -> IntegrityState, or None when --integrity is off
    (the parity path: no state object exists, no check ever runs)."""
    if not getattr(o, "integrity", False):
        return None
    return IntegrityState(IntegrityConfig(
        enabled=True,
        sample=max(0.0, min(1.0, getattr(o, "integrity_sample", 1.0 / 256.0))),
        clean_probes=max(1, getattr(o, "integrity_clean_probes", 3)),
        poison_ttl_s=max(0.0, getattr(o, "integrity_poison_ttl", 300.0)),
        poison_cap=max(1, getattr(o, "integrity_poison_cap", 256)),
    ))
