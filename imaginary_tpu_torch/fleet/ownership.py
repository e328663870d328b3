"""Digest ownership + fleet coherence (rendezvous ring, claim runner);
the port's copy of `imaginary_tpu/fleet/ownership.py`.

The shm tier makes the fleet crash-safe per BYTE; this module makes it
coherent per REQUEST. Three pieces, all armed only by `--fleet-coherence` (off =
byte parity with the uncoordinated build):

  * Rendezvous (highest-random-weight) ownership: every digest hashes
    against each live worker index from the shm epoch table, and the
    top-scoring worker OWNS it. Rendezvous over (key, index) — NOT the
    epoch — so a respawned worker keeps exactly its old digest set, and
    removing one worker moves only that worker's digests (minimal
    disruption, the groupcache property). Membership is read fresh per
    decision, so an epoch stamp (death, respawn, roll) re-elects with
    no protocol round.
  * The claim runner (`run_claimed`): fleet-wide singleflight on top of
    shmcache's claim table. The winner executes and DEPOSITS BEFORE
    releasing its claim, so waiters redeem from the sealed entry the
    moment the claim drops; a waiter whose holder is SIGKILLed wins the
    kernel-released lock on its next poll and re-dispatches; a SIGSTOP
    zombie's claim reads stale (epoch fenced) and is not honored.
    Every exit is fail-open: fault, stale, timeout, collision — run
    locally, bounded duplicate work, never a stall and never a 5xx.
  * Fleet QoS handle: the qos/limiter.py + qos/sched.py hook onto
    shmcache's shared GCRA/share tables, registered process-wide so the
    qos layer stays import-light (it never imports aiohttp OR fleet
    machinery unless a fleet armed one).

The failure ladder a request walks, owner side down:

    owner alive          -> forward hop, owner computes once
    owner dead/refusing  -> hop fails -> LOCAL execution (fail-open)
    claim holder killed  -> waiter wins freed lock -> re-dispatch
    claim holder zombie  -> claim reads stale -> LOCAL execution
    claim wait exhausted -> LOCAL execution (bounded duplicate)
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import time
from typing import Optional

from imaginary_tpu_torch import deadline as deadline_mod
from imaginary_tpu_torch import failpoints
from imaginary_tpu_torch.fleet import ipc

# how long a waiter trusts a LIVE holder's claim before failing open to
# a duplicate local run; re-checked every poll, so holder death or the
# seal landing always wins earlier
DEFAULT_CLAIM_WAIT_S = 10.0
CLAIM_POLL_S = 0.015


def rendezvous_owner(members, key: bytes) -> Optional[int]:
    """Highest-random-weight owner for `key` among (idx, epoch) pairs.
    Scored on (key, idx) only: epochs fence, they do not re-shard."""
    best, best_score = None, b""
    for idx, _epoch in members:
        score = hashlib.blake2b(key + idx.to_bytes(4, "little"),
                                digest_size=8).digest()
        if best is None or score > best_score:
            best, best_score = idx, score
    return best


@dataclasses.dataclass
class CoherenceStats:
    """This worker's view of the coherence machinery (/health fleet
    block, `coherence` sub-dict)."""

    # forward hop, client side
    forwards: int = 0  # answered by the owner
    forward_fails: int = 0  # dial/timeout/fenced/injected -> fell open
    # forward hop, server side
    serve_forwarded: int = 0
    serve_refused: int = 0  # fenced (or mid-shutdown) refusals
    # claim runner
    claim_waits: int = 0  # episodes spent waiting on a live sibling
    waiter_hits: int = 0  # waits redeemed from the sealed entry
    waiter_timeouts: int = 0  # wait budget exhausted -> local duplicate
    redispatches: int = 0  # waits ended by winning a DEAD holder's claim
    local_fallbacks: int = 0  # fail-open uncoordinated local runs

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class FleetCoherence:
    """One worker's handle on the ownership ring + claim runner.

    Owns no sockets itself — the IPC server is started by the web layer
    (it needs the running loop); this object only decides, claims, and
    forwards."""

    def __init__(self, shm, *, worker: int, hop_s: float,
                 claim_wait_s: float = DEFAULT_CLAIM_WAIT_S,
                 poll_s: float = CLAIM_POLL_S):
        self.shm = shm
        self.worker = int(worker)
        self.hop_s = max(0.001, float(hop_s))
        self.claim_wait_s = max(poll_s, float(claim_wait_s))
        self.poll_s = poll_s
        self.stats = CoherenceStats()

    # -- ring ------------------------------------------------------------

    def members(self) -> list:
        return self.shm.live_workers()

    def owner_of(self, skey: bytes) -> Optional[int]:
        """Owning worker index for a 32-byte shared key, or None when
        the ring is empty (standalone mode: nothing was ever stamped)."""
        return rendezvous_owner(self.members(), skey)

    def device_owner(self) -> Optional[int]:
        """The worker that owns what lives once per card: the lowest live
        index, deterministic from the same table every worker reads.
        Every worker of the port launches its kernels on the card (each
        with its own CUDA context); the owner alone stands up the lanes,
        the mesh and the device-resident frame tier, so the hot frames
        sit in device memory once. Owner death re-elects through the
        supervisor's epoch stamp for the replacement."""
        members = self.members()
        if not members:
            return None
        return min(idx for idx, _ in members)

    def is_device_owner(self) -> bool:
        own = self.device_owner()
        return own is None or own == self.worker

    # -- forward hop (client side) ---------------------------------------

    async def try_forward(self, op_name: str, query: dict,
                          body: bytes, skey: bytes) -> Optional[tuple]:
        """Forward to the digest's owner; (ProcessedImage, placement) on
        success, None when THIS worker should run locally (it owns the
        digest, the ring is empty, or the hop failed — fail-open)."""
        owner = self.owner_of(skey)
        if owner is None or owner == self.worker:
            return None
        try:
            await failpoints.ahit("fleet.forward", key=owner)
        except failpoints.FailpointError:
            self.stats.forward_fails += 1
            return None
        timeout = self.hop_s
        dl = deadline_mod.current()
        if dl is not None:
            rem = dl.remaining_s()
            if rem <= 0:
                self.stats.forward_fails += 1
                return None
            timeout = min(timeout, rem)
        header = {
            "op": op_name,
            "query": {str(k): str(v) for k, v in query.items()},
            "budget_ms": int(timeout * 1000),
        }
        try:
            resp, rbody = await ipc.forward_request(
                ipc.socket_path(self.shm.path, owner), header, body,
                timeout)
        except asyncio.CancelledError:
            raise
        except Exception:
            # dead owner, refused dial, torn frame, hop timeout — one
            # answer for all of them: run locally
            self.stats.forward_fails += 1
            return None
        if resp.get("status") != "ok":
            self.stats.forward_fails += 1
            return None
        self.stats.forwards += 1
        from imaginary_tpu_torch.pipeline import ProcessedImage

        return (ProcessedImage(body=rbody,
                               mime=resp.get("mime", "application/octet-stream")),
                resp.get("placement", ""))

    # -- claim runner (fleet singleflight) --------------------------------

    async def run_claimed(self, key: tuple, skey: bytes, produce, caches):
        """Execute-or-wait for `key` under the fleet claim table.
        `produce` is the request's pipeline closure returning
        (ProcessedImage, placement); `caches` is the CacheSet (for the
        shm deposit/lookup). The runner owns the deposit: the winner
        stores BEFORE its claim drops, so a released claim with no
        sealed entry always means the holder failed — waiters then
        re-dispatch instead of stalling."""
        shm = self.shm
        end = time.monotonic() + self.claim_wait_s
        waited = False
        while True:
            claim = shm.claim_acquire(skey)
            try:
                if claim.won:
                    if waited:
                        self.stats.redispatches += 1
                    out, placement = await produce()
                    caches.shm_store(key, out, placement)
                    return out, placement
                if not claim.busy:
                    # fenced / stale zombie holder / slot collision /
                    # injected fault: uncoordinated local run
                    self.stats.local_fallbacks += 1
                    out, placement = await produce()
                    caches.shm_store(key, out, placement)
                    return out, placement
            finally:
                shm.claim_release(claim)
            if not waited:
                waited = True
                self.stats.claim_waits += 1
            if time.monotonic() >= end:
                # the holder is alive but slower than the wait budget:
                # a bounded duplicate beats queueing behind a limper
                self.stats.waiter_timeouts += 1
                out, placement = await produce()
                caches.shm_store(key, out, placement)
                return out, placement
            await asyncio.sleep(self.poll_s)
            if shm.sealed_peek(skey):
                hit = caches.shm_lookup(key)
                if hit is not None:
                    self.stats.waiter_hits += 1
                    return hit
            # loop: the next claim_acquire re-dispatches if the holder
            # died (kernel freed its lock), else we keep waiting

    def snapshot(self) -> dict:
        out = self.stats.to_dict()
        out["device_owner"] = self.device_owner()
        out["is_device_owner"] = self.is_device_owner()
        out["members"] = [idx for idx, _ in self.members()]
        return out


# -- fleet QoS registry ----------------------------------------------------
# The qos layer (limiter.py, sched.py) consults this process-wide handle
# lazily so qos stays importable with zero fleet machinery; it is set by
# the web layer when --fleet-qos arms and CLEARED on service close (tests
# boot many apps per process).


class FleetQos:
    """Fail-open wrapper over shmcache's shared GCRA + share tables:
    every fault or contention answer is None/no-op, which the qos layer
    reads as 'enforce locally like before'."""

    def __init__(self, shm, clock=time.time):
        self.shm = shm
        self.clock = clock

    def gcra_allow(self, tenant: str, emission: float,
                   tau: float) -> Optional[tuple]:
        try:
            return self.shm.qos_gcra_allow(tenant, emission, tau,
                                           self.clock())
        except Exception:
            return None

    def share_charge(self, tenant: str, cap: int) -> Optional[bool]:
        try:
            return self.shm.qos_share_charge(tenant, cap)
        except Exception:
            return None

    def share_release(self, tenant: str) -> None:
        try:
            self.shm.qos_share_release(tenant)
        except Exception:  # itpu: allow[ITPU004] release is best-effort; the column self-heals on the next epoch stamp
            pass


_fleet_qos: Optional[FleetQos] = None


def set_fleet_qos(fq: Optional[FleetQos]) -> None:
    global _fleet_qos
    _fleet_qos = fq


def fleet_qos() -> Optional[FleetQos]:
    return _fleet_qos
