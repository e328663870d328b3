"""Crash-safe shared result cache + worker-fencing epochs (mmap).

The port's copy of `imaginary_tpu/fleet/shmcache.py`: the file layout is
the reference's byte for byte, so a slot (and the header's host-
incarnation stamp at `_OFF_HOST_EPOCH`) one package writes the other
reads.

Every local worker process maps ONE file (tmpfs when available) holding
a content-addressed result cache, so a hot entry computed by any worker
serves the whole fleet — and a worker SIGKILLed mid-anything must never
be able to corrupt what its siblings serve. The design assumes a
process can die, lie, or lag at any byte boundary.

Layout (one header page, two coordination regions, then fixed-size
slots; the magic is versioned so a binary with a different layout
refuses to attach rather than misreading offsets):

    +--------------------------------------------------------------+
    | magic | nslots | slot_bytes | lru tick | worker epoch table  |
    +--------------------------------------------------------------+
    | claim table: in-flight (digest -> worker, epoch) claims      |
    +--------------------------------------------------------------+
    | qos table: per-tenant GCRA tat + per-worker in-flight shares |
    +--------------------------------------------------------------+
    | slot 0: state | epoch | tick | lens | key | checksum | data  |
    | slot 1: ...                                                  |
    +--------------------------------------------------------------+

Entries are direct-mapped by the first 8 bytes of the (sha256) key with
a small associative probe window; an entry larger than one slot is
simply not cached (the local LRU tier still holds it).

Crash safety is a two-phase write-then-publish protocol:

  1. `_slot_acquire`: take the slot's EXCLUSIVE byte-range lock
     (fcntl.lockf — the kernel releases it if the writer dies) and
     stamp the slot WRITING.
  2. deposit payload + header + blake2b checksum, then publish by
     flipping state to SEALED — the LAST write, so a reader can never
     observe a SEALED slot with a half-written body.
  3. `_slot_abandon` (always, in a `finally`): an unpublished slot is
     reset FREE and the lock released. itpucheck rule ITPU009 pins this
     acquire -> publish-or-abandon-in-finally shape statically.

A writer SIGKILLed between 1 and 2 leaves a WRITING slot whose lock the
kernel already released: readers skip it (state != SEALED) and the next
writer — or an explicit `sweep()` — reclaims it (`torn_reclaimed`).
Readers take the SHARED lock, so a checksum mismatch on a SEALED entry
is never a benign race: it is corruption (bit rot, a scribbler, a torn
page) and is counted, reclaimed, and served as a MISS — never as bytes
(`corrupt_served` exists as the tripwire counter the chaos row pins 0).

Worker fencing: the supervisor owns the epoch table. Every (re)spawn of
worker index i stamps `epochs[i]` with a fleet-monotonic epoch and
hands the same number to the child (env). A deposed worker — declared
hung, replacement already stamped+spawned — that wakes up finds the
table ahead of its own epoch: it MAY read (stale reads of sealed
immutable entries are safe) but may NOT publish, which closes the
zombie-writer race the spawn-first replacement policy opens.

Fleet singleflight (the claim table): an in-flight claim is the same
two-phase, kernel-released-lock discipline applied to WORK instead of
bytes. `claim_acquire` exclusive-locks the claim entry's byte, stamps
(CLAIMED, worker, epoch, key), and HOLDS the lock for the whole
pipeline execution; `claim_release` (always, in a `finally` — itpucheck
ITPU013) clears the entry and drops the lock. A holder SIGKILLed
mid-flight loses the lock to the kernel, so the next waiter's acquire
attempt simply wins and re-dispatches. A SIGSTOP zombie keeps the lock
but its stamped epoch no longer matches the supervisor table — waiters
treat that claim as STALE and execute locally (bounded duplicate work,
never a stall), and the zombie's own acquires are refused outright.

Fleet QoS (the qos table): per-tenant GCRA theoretical-arrival-time and
per-worker in-flight share columns, each entry under its own byte lock.
Share columns are epoch-tagged so a SIGKILLed worker's leaked in-flight
count stops being charged the moment its successor is stamped. Every
operation here is fail-open: lock contention or table overflow returns
None/True and the caller falls back to its process-local enforcement.
"""

from __future__ import annotations

import dataclasses
import hashlib
import mmap
import os
import struct
import tempfile
import threading
from typing import Optional

from imaginary_tpu_torch import failpoints

MAGIC = b"ITPUFLT2"  # v2: claim + qos regions between header and slots
HEADER_BYTES = 4096  # one page: magic/geometry/tick + the epoch table
MAX_WORKERS = 64
SLOT_BYTES = 128 * 1024  # entries above ~128 KB stay local-tier-only
ASSOC = 4  # direct-mapped with a 4-way probe window

# header field offsets
_OFF_MAGIC = 0
_OFF_NSLOTS = 8
_OFF_SLOT_BYTES = 12
_OFF_TICK = 16
_OFF_EPOCHS = 24  # MAX_WORKERS x u64
_OFF_HOST_EPOCH = _OFF_EPOCHS + MAX_WORKERS * 8  # u64, this HOST's incarnation

# claim table (fleet singleflight): [HEADER_BYTES, _QOS_OFF)
CLAIM_SLOTS = 64
_CLAIM_OFF = HEADER_BYTES
_CLAIM_BYTES = 64
_CLAIM_HDR = struct.Struct("<IIQ32s")  # state | worker | epoch | key
CLAIM_FREE, CLAIMED = 0, 1

# qos table (fleet-wide GCRA + in-flight shares): [_QOS_OFF, META_BYTES)
QOS_TENANTS = 32
_QOS_OFF = _CLAIM_OFF + CLAIM_SLOTS * _CLAIM_BYTES
_QOS_ENTRY_BYTES = 320
_QOS_HDR = struct.Struct("<8sd")  # tenant-name hash | GCRA tat (abs s)
_QOS_SHARE_OFF = 16  # then MAX_WORKERS u32 share columns
_QOS_PROBE = 4  # linear probe window before giving up (fail-open)

# slots start here. The three fcntl byte-lock ranges — claim entries,
# qos entries, slot first-bytes — are disjoint by construction.
META_BYTES = _QOS_OFF + 12288

# slot header: state u32 | epoch u64 | tick u64 | meta_len u32 |
# body_len u32 | key 32s | checksum 16s
_SLOT_HDR = struct.Struct("<IQQII32s16s")
_SLOT_DATA_OFF = 96  # header rounded up; payload starts here
FREE, WRITING, SEALED = 0, 1, 2

PATH_ENV = "IMAGINARY_TPU_FLEET_PATH"


@dataclasses.dataclass
class FleetStats:
    """Process-local counters for this process's traffic against the
    SHARED cache (each worker reports its own view; the slot scan in
    snapshot() is the shared ground truth)."""

    hits: int = 0
    misses: int = 0
    publishes: int = 0
    # publish attempts refused before any write: oversize payload, or
    # every candidate slot exclusively locked by a live writer
    publish_oversize: int = 0
    publish_contended: int = 0
    # publishes refused because this worker's epoch is fenced (a
    # replacement was stamped; this process is a deposed zombie)
    fenced_publishes: int = 0
    # WRITING slots whose writer died mid-deposit, reclaimed by a later
    # writer or sweep()
    torn_reclaimed: int = 0
    # SEALED entries whose checksum failed verification: counted,
    # reclaimed, degraded to a miss
    corrupt: int = 0
    # the tripwire: responses served from an entry that FAILED
    # verification. No code path increments it — the chaos harness pins
    # it 0 so any future bypass of verify-before-serve trips the gate.
    corrupt_served: int = 0
    evictions: int = 0
    # fleet singleflight (the claim table): won = this process became
    # the executor for a digest; busy = a LIVE sibling already held the
    # claim (we waited or failed open); stale = the holder's epoch was
    # deposed (SIGSTOP zombie) so we refused to honor its claim;
    # reclaimed = we won a claim entry a DEAD holder left CLAIMED
    # (the kernel freed its lock — the waiter re-dispatch path)
    claims_won: int = 0
    claims_busy: int = 0
    claims_stale: int = 0
    claims_reclaimed: int = 0
    # claim acquires refused because THIS process is fenced (deposed)
    fenced_claims: int = 0
    # bytes the hit path actually copied out of the mmap (the one
    # defensive snapshot per hit). The serving layer hands out views of
    # that snapshot, so bytes_copied / hit-bytes-served == 1.0 is the
    # zero-copy invariant bench_stages pins.
    bytes_copied: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Slot:
    """An acquired slot: index, the state it was taken over from, and
    whether the deposit was published."""

    __slots__ = ("idx", "prev_state", "published")

    def __init__(self, idx: int, prev_state: int):
        self.idx = idx
        self.prev_state = prev_state
        self.published = False


class FleetClaim:
    """Result of a claim_acquire attempt. Exactly one of `won`/`busy`
    may be set; neither set means execute locally without coordination
    (fenced, stale holder, hash collision, injected fault — all the
    fail-open outcomes). Always hand it back to claim_release in a
    `finally`, whatever the outcome (ITPU013)."""

    __slots__ = ("idx", "key", "won", "busy", "stale", "holder")

    def __init__(self, idx: int, key: bytes):
        self.idx = idx
        self.key = key
        self.won = False
        self.busy = False  # a live sibling is executing this digest
        self.stale = False  # a deposed zombie holds the entry
        self.holder = -1


def _checksum(key: bytes, epoch: int, meta: bytes, body: bytes) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(key)
    h.update(struct.pack("<QII", epoch, len(meta), len(body)))
    h.update(meta)
    h.update(body)
    return h.digest()


def default_path() -> str:
    """Fleet file location: tmpfs when the host has one (the whole point
    is page-cache-speed IPC), else the temp dir."""
    base = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()
    return os.path.join(base, f"imaginary-fleet-{os.getpid()}.shm")


class ShmCache:
    """One process's handle on the shared cache file.

    All lock traffic is fcntl byte-range locks on the slot's first byte:
    advisory, per-process, and — the property everything rests on —
    RELEASED BY THE KERNEL when the holder dies, however it dies. Within
    one process a plain mutex serializes access (POSIX record locks do
    not exclude threads of the same process)."""

    def __init__(self, path: str, *, create: bool, size_mb: float = 0.0,
                 worker: int = 0, epoch: int = 0, owner: bool = False):
        self.path = path
        self.worker = max(0, min(int(worker), MAX_WORKERS - 1))
        self.epoch = int(epoch)
        self.owner = owner
        self.stats = FleetStats()
        self._lock = threading.Lock()
        # claim entries THIS process currently holds (idx -> key):
        # fcntl locks don't exclude threads of one process, so sibling
        # threads consult this before touching the kernel lock
        self._owned_claims: dict = {}
        if create:
            nslots = max(8, int(size_mb * 1e6) // SLOT_BYTES)
            total = META_BYTES + nslots * SLOT_BYTES
            fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
            try:
                os.ftruncate(fd, total)
            except OSError:
                os.close(fd)
                raise
            self._fd = fd
            self._mm = mmap.mmap(fd, total)
            self._mm[_OFF_NSLOTS:_OFF_NSLOTS + 4] = struct.pack("<I", nslots)
            self._mm[_OFF_SLOT_BYTES:_OFF_SLOT_BYTES + 4] = struct.pack(
                "<I", SLOT_BYTES)
            self._mm[_OFF_TICK:_OFF_TICK + 8] = struct.pack("<Q", 1)
            # magic LAST: an attacher that raced the create never maps a
            # half-initialized header
            self._mm[_OFF_MAGIC:_OFF_MAGIC + 8] = MAGIC
            self.nslots = nslots
        else:
            fd = os.open(path, os.O_RDWR)
            size = os.fstat(fd).st_size
            self._fd = fd
            self._mm = mmap.mmap(fd, size)
            if self._mm[_OFF_MAGIC:_OFF_MAGIC + 8] != MAGIC:
                self._mm.close()
                os.close(fd)
                raise ValueError(
                    f"{path} is not an imaginary-tpu fleet cache file")
            (self.nslots,) = struct.unpack_from("<I", self._mm, _OFF_NSLOTS)
            (slot_bytes,) = struct.unpack_from(
                "<I", self._mm, _OFF_SLOT_BYTES)
            if slot_bytes != SLOT_BYTES:
                self._mm.close()
                os.close(fd)
                raise ValueError(
                    f"{path} slot geometry {slot_bytes} != {SLOT_BYTES} "
                    "(fleet processes must run the same build)")
        # the creator stamps its own epoch so a standalone single
        # process (no supervisor) is never fenced against itself; the
        # same for the host incarnation when the cross-host plane is armed
        if create:
            self.stamp_epoch(self.worker, self.epoch)
            from imaginary_tpu_torch.fleet import multihost

            he = multihost.host_epoch()
            if he:
                self.stamp_host_epoch(he)

    # -- constructors ----------------------------------------------------

    @classmethod
    def create_for_fleet(cls, size_mb: float,
                         path: Optional[str] = None) -> "ShmCache":
        """Supervisor-side create: builds the file before any worker
        spawns (children attach via PATH_ENV). The supervisor itself
        never publishes — it only stamps epochs."""
        path = path or os.environ.get(PATH_ENV, "") or default_path()
        return cls(path, create=True, size_mb=size_mb, owner=True)

    @classmethod
    def from_options(cls, o, worker: int = 0, epoch: int = 0) -> Optional["ShmCache"]:
        """Worker-side build: attach the supervisor's file when the env
        names one, else create a standalone file (single-process mode —
        the tier still works, it just has no siblings yet)."""
        size_mb = float(getattr(o, "fleet_cache_mb", 0.0) or 0.0)
        if size_mb <= 0:
            return None
        env_path = os.environ.get(PATH_ENV, "")
        if env_path:
            return cls(env_path, create=False, worker=worker, epoch=epoch)
        return cls(default_path(), create=True, size_mb=size_mb,
                   worker=worker, epoch=epoch, owner=True)

    def close(self) -> None:
        try:
            self._mm.close()
            os.close(self._fd)
        except (OSError, ValueError):  # itpu: allow[ITPU004] double-close during teardown races is benign
            pass
        if self.owner:
            try:
                os.unlink(self.path)
            except OSError:  # itpu: allow[ITPU004] another owner already unlinked; nothing to leak
                pass

    # -- locks -----------------------------------------------------------

    def _slot_off(self, idx: int) -> int:
        return META_BYTES + idx * SLOT_BYTES

    def _try_lock_off(self, off: int, exclusive: bool = True) -> bool:
        import fcntl

        kind = fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH
        try:
            fcntl.lockf(self._fd, kind | fcntl.LOCK_NB, 1, off)
            return True
        except OSError:
            return False

    def _unlock_off(self, off: int) -> None:
        import fcntl

        try:
            fcntl.lockf(self._fd, fcntl.LOCK_UN, 1, off)
        except OSError:  # itpu: allow[ITPU004] unlock of a lock lost to fd teardown; kernel already released it
            pass

    def _try_lock(self, idx: int, exclusive: bool) -> bool:
        return self._try_lock_off(self._slot_off(idx), exclusive)

    def _unlock(self, idx: int) -> None:
        self._unlock_off(self._slot_off(idx))

    # -- header ----------------------------------------------------------

    def _next_tick(self) -> int:
        (t,) = struct.unpack_from("<Q", self._mm, _OFF_TICK)
        struct.pack_into("<Q", self._mm, _OFF_TICK, t + 1)
        return t

    def stamp_epoch(self, idx: int, epoch: int) -> None:
        """Supervisor-side: record worker idx's CURRENT legitimate epoch.
        Stamped BEFORE the replacement spawns, so the deposed process is
        fenced from the instant its successor exists on paper."""
        idx = max(0, min(int(idx), MAX_WORKERS - 1))
        struct.pack_into("<Q", self._mm, _OFF_EPOCHS + idx * 8, int(epoch))

    def epoch_of(self, idx: int) -> int:
        idx = max(0, min(int(idx), MAX_WORKERS - 1))
        (e,) = struct.unpack_from("<Q", self._mm, _OFF_EPOCHS + idx * 8)
        return e

    def fenced(self) -> bool:
        """True when a successor for this worker index has been stamped:
        this process may read but must not publish."""
        return self.epoch_of(self.worker) != self.epoch

    def stamp_host_epoch(self, epoch: int) -> None:
        """Supervisor-side: record this HOST's current incarnation. After
        a host restart the new supervisor stamps a strictly larger epoch,
        so any process still mapping the old incarnation's view of this
        host is deposed wholesale, as a replaced worker is."""
        struct.pack_into("<Q", self._mm, _OFF_HOST_EPOCH, int(epoch))

    def host_epoch_stamp(self) -> int:
        (e,) = struct.unpack_from("<Q", self._mm, _OFF_HOST_EPOCH)
        return e

    def host_fenced(self) -> bool:
        """True when the header carries a NEWER host incarnation than this
        process was born into: a host-level zombie. Zero on either side
        means the cross-host plane is unarmed: never fenced."""
        stamped = self.host_epoch_stamp()
        if not stamped:
            return False
        from imaginary_tpu_torch.fleet import multihost

        mine = multihost.host_epoch()
        return bool(mine) and mine < stamped

    def live_workers(self) -> list:
        """(idx, epoch) for every stamped worker — the ownership ring's
        membership view. Empty in standalone epoch-0 mode ONLY when
        nothing was ever stamped non-zero; a standalone creator stamps
        itself, so its own table reads all-zero and the ring is empty
        (coherence degrades to plain local execution, which is parity)."""
        out = []
        for i in range(MAX_WORKERS):
            e = self.epoch_of(i)
            if e != 0:
                out.append((i, e))
        return out

    # -- claim table (fleet singleflight, the ITPU013 protocol) ----------

    def _claim_off(self, idx: int) -> int:
        return _CLAIM_OFF + idx * _CLAIM_BYTES

    def claim_index(self, key: bytes) -> int:
        # bytes [8:16) so the claim entry decorrelates from the slot
        # candidate window (which maps by bytes [0:8) of the same key)
        return int.from_bytes(key[8:16], "little") % CLAIM_SLOTS

    def _claim_hdr(self, idx: int) -> tuple:
        return _CLAIM_HDR.unpack_from(self._mm, self._claim_off(idx))

    def claim_acquire(self, key: bytes) -> FleetClaim:
        """Try to become the fleet-wide executor for `key`. The winner's
        exclusive byte lock is HELD until claim_release — holder death
        releases it in the kernel, which is how waiters detect it. Every
        outcome (won / busy / neither) must flow through claim_release
        in a `finally` (ITPU013)."""
        idx = self.claim_index(key)
        c = FleetClaim(idx, key)
        try:
            # chaos: error() = injected claim fault (caller fails open
            # to an uncoordinated local run); delay() = a SIGKILL window
            # while siblings are mid-protocol
            failpoints.hit("fleet.claim", key=self.worker)
        except failpoints.FailpointError:
            return c
        if self.fenced():
            # a deposed zombie must never become an executor its
            # successor's waiters would wait on
            self.stats.fenced_claims += 1
            return c
        with self._lock:
            held = self._owned_claims.get(idx)
            if held is not None:
                # a sibling THREAD of this process holds the entry:
                # same key = genuinely in flight here; different key =
                # hash collision, run locally without coordination
                if held == key:
                    c.busy = True
                    c.holder = self.worker
                    self.stats.claims_busy += 1
                return c
            if not self._try_lock_off(self._claim_off(idx)):
                state, w, e, k = self._claim_hdr(idx)
                if state == CLAIMED and k == key:
                    if self.epoch_of(w) == e:
                        c.busy = True
                        c.holder = w
                        self.stats.claims_busy += 1
                    else:
                        # lock held but epoch deposed: a SIGSTOP zombie.
                        # Refuse to wait on it — execute locally (a
                        # bounded duplicate beats an unbounded stall).
                        c.stale = True
                        self.stats.claims_stale += 1
                # different key / not CLAIMED: collision or a race that
                # just resolved — fail open, run locally
                return c
            # lock won. A CLAIMED entry under a freshly-won lock can
            # only mean its holder DIED mid-flight (the kernel freed the
            # lock) — we inherit the claim and re-dispatch the work.
            state = struct.unpack_from(
                "<I", self._mm, self._claim_off(idx))[0]
            if state == CLAIMED:
                self.stats.claims_reclaimed += 1
            _CLAIM_HDR.pack_into(self._mm, self._claim_off(idx),
                                 CLAIMED, self.worker, self.epoch, key)
            self._owned_claims[idx] = key
            c.won = True
            self.stats.claims_won += 1
            return c

    def claim_release(self, claim: Optional[FleetClaim]) -> None:
        """Always runs (finally): a won claim is cleared and its lock
        dropped — only holder DEATH may skip this, and the kernel covers
        that case. Non-won outcomes are no-ops, so every acquire can be
        released unconditionally."""
        if claim is None or not claim.won:
            return
        with self._lock:
            _CLAIM_HDR.pack_into(self._mm, self._claim_off(claim.idx),
                                 CLAIM_FREE, 0, 0, b"\0" * 32)
            self._unlock_off(self._claim_off(claim.idx))
            self._owned_claims.pop(claim.idx, None)
            claim.won = False

    def claim_scan(self) -> dict:
        """Claim-table ground truth: free / held-by-a-live-worker /
        dead (CLAIMED but the holder's lock is gone or its epoch is
        deposed). The chaos harness pins live == 0 at rest."""
        counts = {"free": 0, "live": 0, "dead": 0}
        with self._lock:
            for idx in range(CLAIM_SLOTS):
                state, w, e, _k = self._claim_hdr(idx)
                if state != CLAIMED:
                    counts["free"] += 1
                elif idx in self._owned_claims:
                    counts["live"] += 1
                elif self.epoch_of(w) != e:
                    counts["dead"] += 1
                elif self._try_lock_off(self._claim_off(idx)):
                    # lock winnable = the holder died without releasing
                    self._unlock_off(self._claim_off(idx))
                    counts["dead"] += 1
                else:
                    counts["live"] += 1
        return counts

    def claim_sweep(self) -> int:
        """Reclaim claim entries whose holder is dead or deposed (lock
        winnable, or epoch fenced). Waiters already reclaim these
        opportunistically on their next acquire; this full scan is for
        the maintenance ticker and the chaos harness's at-rest check."""
        reclaimed = 0
        with self._lock:
            for idx in range(CLAIM_SLOTS):
                state, w, e, _k = self._claim_hdr(idx)
                if state != CLAIMED or idx in self._owned_claims:
                    continue
                if not self._try_lock_off(self._claim_off(idx)):
                    if self.epoch_of(w) == e:
                        continue  # a live holder mid-flight; not ours
                    # deposed zombie still holding the kernel lock: the
                    # entry is unhonored either way; clear the state so
                    # the table reads at-rest (the lock dies with it)
                    _CLAIM_HDR.pack_into(
                        self._mm, self._claim_off(idx),
                        CLAIM_FREE, 0, 0, b"\0" * 32)
                    reclaimed += 1
                    continue
                try:
                    if struct.unpack_from(
                            "<I", self._mm, self._claim_off(idx))[0] \
                            == CLAIMED:
                        _CLAIM_HDR.pack_into(
                            self._mm, self._claim_off(idx),
                            CLAIM_FREE, 0, 0, b"\0" * 32)
                        reclaimed += 1
                finally:
                    self._unlock_off(self._claim_off(idx))
        return reclaimed

    # -- qos table (fleet-wide GCRA + in-flight shares) -------------------

    @staticmethod
    def qos_hash(tenant: str) -> bytes:
        return hashlib.blake2b(tenant.encode("utf-8"),
                               digest_size=8).digest()

    def _qos_entry_off(self, idx: int) -> int:
        return _QOS_OFF + (idx % QOS_TENANTS) * _QOS_ENTRY_BYTES

    def _qos_slot(self, h8: bytes) -> int:
        """Entry index for a tenant hash, claiming a zero entry on first
        use; -1 when the probe window is exhausted — the caller falls
        back to process-local enforcement (fail-open, never a stall)."""
        base = int.from_bytes(h8, "little") % QOS_TENANTS
        for j in range(min(_QOS_PROBE, QOS_TENANTS)):
            idx = (base + j) % QOS_TENANTS
            off = self._qos_entry_off(idx)
            cur = bytes(self._mm[off:off + 8])
            if cur == h8:
                return idx
            if cur != b"\0" * 8:
                continue
            if not self._try_lock_off(off):
                continue
            try:
                cur = bytes(self._mm[off:off + 8])
                if cur == b"\0" * 8:
                    self._mm[off:off + 8] = h8
                    return idx
                if cur == h8:
                    return idx
            finally:
                self._unlock_off(off)
        return -1

    def qos_gcra_allow(self, tenant: str, emission: float, tau: float,
                       now: float) -> Optional[tuple]:
        """Fleet-wide GCRA decision against the SHARED theoretical
        arrival time — same algorithm as the process-local
        GCRARateLimiter, state moved into the mmap so a tenant spraying
        connections across SO_REUSEPORT workers meets one budget, not N.
        Returns (allowed, retry_after) or None when the shared entry is
        unavailable (table overflow, or a peer holds the entry lock —
        holders never sleep, so contention is ns-scale, but a SIGSTOPped
        peer must not stall admission). `now` is wall clock (time.time,
        the one clock local workers share); injectable for tests."""
        idx = self._qos_slot(self.qos_hash(tenant))
        if idx < 0:
            return None
        off = self._qos_entry_off(idx)
        with self._lock:
            for _ in range(3):
                if self._try_lock_off(off):
                    break
            else:
                return None
            try:
                _h, tat = _QOS_HDR.unpack_from(self._mm, off)
                tat = max(tat, now)
                if tat - now > tau:
                    return False, tat - tau - now
                _QOS_HDR.pack_into(self._mm, off,
                                   self.qos_hash(tenant), tat + emission)
                return True, 0.0
            finally:
                self._unlock_off(off)

    def qos_share_charge(self, tenant: str, cap: int) -> Optional[bool]:
        """Charge one unit of fleet-wide in-flight share for `tenant`.
        True = charged (fleet total was below cap), False = fleet over
        cap (the caller sheds exactly as it would for its local cap),
        None = shared entry unavailable (fail open to local-only caps).
        Each worker owns one column tagged with its epoch's low 16 bits:
        a SIGKILLed worker's leaked count stops being summed the moment
        the supervisor stamps its successor's epoch."""
        idx = self._qos_slot(self.qos_hash(tenant))
        if idx < 0:
            return None
        off = self._qos_entry_off(idx)
        mytag = self.epoch & 0xffff
        with self._lock:
            for _ in range(3):
                if self._try_lock_off(off):
                    break
            else:
                return None
            try:
                col_off = off + _QOS_SHARE_OFF + self.worker * 4
                (own,) = struct.unpack_from("<I", self._mm, col_off)
                own_cnt = own & 0xffff if (own >> 16) == mytag else 0
                total = own_cnt
                for w in range(MAX_WORKERS):
                    if w == self.worker:
                        continue
                    (col,) = struct.unpack_from(
                        "<I", self._mm, off + _QOS_SHARE_OFF + w * 4)
                    if col == 0:
                        continue
                    if (col >> 16) == (self.epoch_of(w) & 0xffff):
                        total += col & 0xffff
                if total >= cap:
                    return False
                struct.pack_into("<I", self._mm, col_off,
                                 (mytag << 16) | min(own_cnt + 1, 0xffff))
                return True
            finally:
                self._unlock_off(off)

    def qos_share_release(self, tenant: str) -> None:
        """Decrement this worker's column. Best-effort: if the entry
        lock is contended past the retry budget the unit leaks until
        this worker's next charge observes its own column (same tag)
        or its epoch is re-stamped — never a stall on the release path."""
        idx = self._qos_slot(self.qos_hash(tenant))
        if idx < 0:
            return
        off = self._qos_entry_off(idx)
        mytag = self.epoch & 0xffff
        with self._lock:
            for _ in range(8):
                if self._try_lock_off(off):
                    break
            else:
                return
            try:
                col_off = off + _QOS_SHARE_OFF + self.worker * 4
                (own,) = struct.unpack_from("<I", self._mm, col_off)
                if (own >> 16) != mytag:
                    return
                cnt = own & 0xffff
                struct.pack_into(
                    "<I", self._mm, col_off,
                    (mytag << 16) | (cnt - 1) if cnt > 1 else 0)
            finally:
                self._unlock_off(off)

    def qos_share_total(self, tenant: str) -> int:
        """Fleet-wide in-flight units for `tenant` (live columns only)."""
        idx = self._qos_slot(self.qos_hash(tenant))
        if idx < 0:
            return 0
        off = self._qos_entry_off(idx)
        total = 0
        for w in range(MAX_WORKERS):
            (col,) = struct.unpack_from(
                "<I", self._mm, off + _QOS_SHARE_OFF + w * 4)
            if col != 0 and (col >> 16) == (self.epoch_of(w) & 0xffff):
                total += col & 0xffff
        return total

    # -- slot primitives (the ITPU009 protocol) --------------------------

    def _slot_hdr(self, idx: int) -> tuple:
        return _SLOT_HDR.unpack_from(self._mm, self._slot_off(idx))

    def _slot_state(self, idx: int) -> int:
        (s,) = struct.unpack_from("<I", self._mm, self._slot_off(idx))
        return s

    def _slot_acquire(self, idx: int) -> Optional[_Slot]:
        """Phase 1: exclusive-lock the slot and mark it WRITING. Returns
        None when a live writer holds it. A WRITING state found UNDER a
        freshly-won lock can only mean the previous writer died
        mid-deposit — the kernel freed its lock — so the slot is
        reclaimed here."""
        if not self._try_lock(idx, exclusive=True):
            return None
        prev = self._slot_state(idx)
        if prev == WRITING:
            self.stats.torn_reclaimed += 1
        struct.pack_into("<I", self._mm, self._slot_off(idx), WRITING)
        return _Slot(idx, prev)

    def _slot_publish(self, slot: _Slot) -> None:
        """Phase 2: seal. The state flip is the LAST write of a deposit;
        everything under the checksum is already in place."""
        struct.pack_into("<I", self._mm, self._slot_off(slot.idx), SEALED)
        slot.published = True
        self.stats.publishes += 1

    def _slot_abandon(self, slot: _Slot) -> None:
        """Always runs (finally): an unpublished deposit is reset FREE —
        a deliberate abandon reclaims immediately; only a writer DEATH
        leaves WRITING behind for the sweeper. Releases the lock."""
        if not slot.published:
            struct.pack_into("<I", self._mm, self._slot_off(slot.idx), FREE)
        self._unlock(slot.idx)

    # -- cache operations ------------------------------------------------

    def _candidates(self, key: bytes) -> list:
        base = int.from_bytes(key[:8], "little") % self.nslots
        return [(base + j) % self.nslots for j in range(min(ASSOC,
                                                            self.nslots))]

    def get(self, key: bytes) -> Optional[tuple]:
        """(meta, body) for a sealed, checksum-verified entry; None on
        miss. A verification failure counts `corrupt`, reclaims the
        slot, and reads as a miss — corrupt bytes are never returned."""
        with self._lock:
            for idx in self._candidates(key):
                if self._slot_state(idx) != SEALED:
                    continue
                # shared lock: excludes live writers, so any checksum
                # mismatch past this point is real corruption, not a race
                if not self._try_lock(idx, exclusive=False):
                    continue
                try:
                    state, epoch, _tick, meta_len, body_len, skey, csum = \
                        self._slot_hdr(idx)
                    if state != SEALED or skey != key:
                        continue
                    off = self._slot_off(idx) + _SLOT_DATA_OFF
                    payload = bytes(self._mm[off:off + meta_len + body_len])
                finally:
                    self._unlock(idx)
                meta = payload[:meta_len]
                # zero-copy body: a view over the immutable snapshot, not
                # a second allocation — for large bodies the hit path
                # touches each byte exactly once (the snapshot above,
                # which a concurrent ring overwrite makes unavoidable).
                # Consumers (aiohttp payloads, LRU promotion, len()) all
                # take bytes-likes; bytes_copied books the one real copy
                # so the bench can pin the hit path's byte-touch count.
                body = memoryview(payload)[meta_len:]
                self.stats.bytes_copied += meta_len + body_len
                if _checksum(key, epoch, meta, body) != csum:
                    self.stats.corrupt += 1
                    self._reclaim(idx)
                    continue
                # LRU recency bump: racy u64 scribble, deliberately
                # unlocked — a torn tick mis-orders eviction, nothing else
                struct.pack_into("<Q", self._mm, self._slot_off(idx) + 12,
                                 self._next_tick())
                self.stats.hits += 1
                return meta, body
            self.stats.misses += 1
            return None

    def sealed_peek(self, key: bytes) -> bool:
        """Lock-free, stat-free probe: is a SEALED entry for `key`
        visible right now? Claim waiters poll THIS instead of get() so
        waiting never books misses; a True is always confirmed by a
        real checksum-verified get() before any byte is served."""
        for idx in self._candidates(key):
            state, _e, _t, _ml, _bl, skey, _c = self._slot_hdr(idx)
            if state == SEALED and skey == key:
                return True
        return False

    def put(self, key: bytes, meta: bytes, body: bytes) -> bool:
        """Two-phase deposit; best-effort (False = not cached, never an
        error a request should see)."""
        try:
            # chaos: simulate waking up deposed (the SIGSTOP zombie)
            # without needing a real supervisor replacement cycle
            failpoints.hit("worker.zombie", key=self.worker)
        except failpoints.FailpointError:
            self.stats.fenced_publishes += 1
            return False
        if self.fenced():
            self.stats.fenced_publishes += 1
            return False
        if _SLOT_DATA_OFF + len(meta) + len(body) > SLOT_BYTES:
            self.stats.publish_oversize += 1
            return False
        with self._lock:
            for idx in self._victim_order(key):
                slot = self._slot_acquire(idx)
                if slot is None:
                    continue
                try:
                    # chaos: a delay() here holds the slot in WRITING —
                    # SIGKILL the process now and the torn-write story
                    # (reader skip + sweeper reclaim) is exercised for
                    # real; an error() abandons the deposit cleanly
                    # (caught below — put never raises)
                    failpoints.hit("fleet.write", key=self.worker)
                    if slot.prev_state == SEALED \
                            and self._slot_hdr(idx)[5] != key:
                        self.stats.evictions += 1
                    off = self._slot_off(idx)
                    self._mm[off + _SLOT_DATA_OFF:
                             off + _SLOT_DATA_OFF + len(meta) + len(body)] = \
                        meta + body
                    _SLOT_HDR.pack_into(
                        self._mm, off, WRITING, self.epoch,
                        self._next_tick(), len(meta), len(body), key,
                        _checksum(key, self.epoch, meta, body))
                    self._slot_publish(slot)
                    return True
                except failpoints.FailpointError:
                    # injected deposit fault: the finally's abandon has
                    # already reset the slot; the entry just isn't cached
                    self.stats.publish_contended += 1
                    return False
                finally:
                    self._slot_abandon(slot)
            self.stats.publish_contended += 1
            return False

    def _victim_order(self, key: bytes) -> list:
        """Candidate slots in replacement-preference order: same key
        (refresh), FREE, torn WRITING, then oldest-tick SEALED."""
        cands = self._candidates(key)
        same, free, torn, sealed = [], [], [], []
        for idx in cands:
            state, _e, tick, _ml, _bl, skey, _c = self._slot_hdr(idx)
            if state == SEALED and skey == key:
                same.append(idx)
            elif state == FREE:
                free.append(idx)
            elif state == WRITING:
                torn.append(idx)
            else:
                sealed.append((tick, idx))
        return same + free + torn + [i for _, i in sorted(sealed)]

    def _reclaim(self, idx: int) -> None:
        """Reset a corrupt/torn slot to FREE, if no live writer holds it."""
        if not self._try_lock(idx, exclusive=True):
            return
        try:
            struct.pack_into("<I", self._mm, self._slot_off(idx), FREE)
        finally:
            self._unlock(idx)

    def sweep(self) -> int:
        """Reclaim every torn slot (WRITING with no live lock holder).
        Writers reclaim opportunistically on collision; this full scan is
        for the maintenance ticker and the chaos harness."""
        reclaimed = 0
        with self._lock:
            for idx in range(self.nslots):
                if self._slot_state(idx) != WRITING:
                    continue
                if not self._try_lock(idx, exclusive=True):
                    continue  # a live writer is mid-deposit; not torn
                try:
                    if self._slot_state(idx) == WRITING:
                        struct.pack_into("<I", self._mm,
                                         self._slot_off(idx), FREE)
                        reclaimed += 1
                finally:
                    self._unlock(idx)
        self.stats.torn_reclaimed += reclaimed
        return reclaimed

    # -- introspection ---------------------------------------------------

    def slot_scan(self) -> dict:
        """Shared ground truth: per-state slot counts + sealed bytes."""
        counts = {"free": 0, "writing": 0, "sealed": 0}
        sealed_bytes = 0
        for idx in range(self.nslots):
            state, _e, _t, meta_len, body_len, _k, _c = self._slot_hdr(idx)
            if state == SEALED:
                counts["sealed"] += 1
                sealed_bytes += meta_len + body_len
            elif state == WRITING:
                counts["writing"] += 1
            else:
                counts["free"] += 1
        counts["sealed_bytes"] = sealed_bytes
        return counts

    def snapshot(self) -> dict:
        """The /health `fleet` block."""
        out = {
            "worker": self.worker,
            "epoch": self.epoch,
            "stamped_epoch": self.epoch_of(self.worker),
            "fenced": self.fenced(),
            "slots": self.nslots,
            "slot_bytes": SLOT_BYTES,
        }
        out.update(self.slot_scan())
        out.update(self.stats.to_dict())
        out["claims"] = self.claim_scan()
        return out

    def debug_snapshot(self) -> dict:
        """The /debugz `fleet` block: snapshot + the epoch table."""
        out = self.snapshot()
        out["path"] = self.path
        out["epochs"] = {
            str(i): self.epoch_of(i) for i in range(MAX_WORKERS)
            if self.epoch_of(i) != 0
        }
        return out
