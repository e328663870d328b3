"""Cross-host fleet tier: host identity, host epochs and peer gossip (the
port's copy of `imaginary_tpu/fleet/multihost.py`).

The shm cache, the claim table and the worker ring all ride one mmap'd
file on one machine, and the supervisor's /fleetz aggregates one host's
workers. This module crosses the machine boundary with the same
vocabulary:

* **host identity**: ``(host_id, host_epoch)`` promotes the worker
  fencing epochs one level up. The supervisor mints a fresh host epoch at
  every boot (milliseconds since the Unix epoch: strictly greater across
  restarts without a persisted counter), stamps it into the shm header
  and the child environment, and advertises it on /fleetz and on every
  serving response. A peer holding an answer stamped with an OLD host
  epoch is talking to a deposed incarnation and discards it, as
  ``ShmCache.fenced()`` does per worker.

* **peer table and gossip**: each participant bootstraps a static peer
  list from ``--peers`` (CSV or ``@file``) naming the OTHER hosts'
  fleet-admin bases, and a gossip thread polls each peer's ``/fleetz`` on
  a fixed cadence. The fetch is injectable (as in
  ``obs/aggregate.scrape_fleet``) so every staleness and failure path is
  testable without sockets. A failed poll marks the peer dead at once:
  the table's consumer (fleet/router.py) fails open to local execution,
  so a false-dead verdict costs a hop, never a request.

* **host rendezvous**: ``rendezvous_host`` extends the worker ring's HRW
  hashing to host ids, with the same blake2b scoring as
  ``ownership.rendezvous_owner``, so a host joining or leaving moves only
  its 1/N share of the keys (epochs fence; they do not re-shard).

Everything here is stdlib-only: the supervisor imports it and never
touches the card. With ``--peers`` unset none of it is constructed: no
peer table, no gossip thread, no new /health block, no new header.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import socket
import threading
import time
import urllib.request
from typing import Callable, Iterable, List, Optional

from imaginary_tpu_torch import failpoints

# env contract with web/workers.py and cli.main: the supervisor (or a
# standalone process arming the tier) resolves identity ONCE and stamps
# it into the environment; every child inherits it, exactly like
# IMAGINARY_TPU_WORKER / IMAGINARY_TPU_WORKER_EPOCH.
HOST_ID_ENV = "IMAGINARY_TPU_HOST_ID"
HOST_EPOCH_ENV = "IMAGINARY_TPU_HOST_EPOCH"

# the peer-probe constant: every outbound peer HTTP call bounds its wait
# explicitly; gossip probes use this, routed hops derive theirs from the
# request deadline instead
PEER_PROBE_TIMEOUT_S = 1.0


def host_id() -> str:
    """This process's host identity; empty when the multi-host tier is
    unarmed (the empty string IS the parity signal — no default here)."""
    return os.environ.get(HOST_ID_ENV, "")


def host_epoch() -> int:
    """This process's host fencing epoch; 0 when unarmed."""
    try:
        return int(os.environ.get(HOST_EPOCH_ENV, "0"))
    except ValueError:
        return 0


def mint_host_epoch(clock: Callable[[], float] = time.time) -> int:
    """A host epoch strictly greater than any a previous incarnation of
    this host minted: wall-clock milliseconds. No persisted counter —
    the previous supervisor is dead and took its state with it; the
    clock is the one monotone that survives."""
    return max(1, int(clock() * 1000.0))


def ensure_host_identity(flag_id: str = "",
                         clock: Callable[[], float] = time.time) -> tuple:
    """Resolve and env-stamp (host_id, host_epoch) exactly once per host
    incarnation. Children inherit the stamps; re-entry (a worker
    re-running cli.main) keeps the supervisor's values. Returns the
    resolved pair."""
    hid = os.environ.get(HOST_ID_ENV, "") or flag_id or socket.gethostname()
    os.environ[HOST_ID_ENV] = hid
    if not os.environ.get(HOST_EPOCH_ENV, ""):
        os.environ[HOST_EPOCH_ENV] = str(mint_host_epoch(clock))
    return hid, host_epoch()


def parse_peers(spec: str) -> List[str]:
    """``--peers`` grammar: a CSV/whitespace list of peer fleet-admin
    base URLs, or ``@path`` naming a file with one per line (blank
    lines and ``#`` comments ignored). A bare host:port gets http://.
    Raises ValueError on an unreadable @file — boot must refuse, not
    silently serve with no peers."""
    spec = (spec or "").strip()
    if not spec:
        return []
    if spec.startswith("@"):
        path = spec[1:]
        try:
            with open(path, encoding="utf-8") as f:
                raw = f.read()
        except OSError as e:
            raise ValueError(f"--peers file {path!r}: {e}") from None
        entries = raw.splitlines()
    else:
        entries = spec.replace(",", " ").split()
    out: List[str] = []
    for e in entries:
        e = e.split("#", 1)[0].strip().rstrip("/")
        if not e:
            continue
        if "://" not in e:
            e = "http://" + e
        if e not in out:
            out.append(e)
    return out


def rendezvous_host(host_ids: Iterable[str], key: bytes) -> Optional[str]:
    """Highest-random-weight owner host for `key`. Same scoring shape as
    ownership.rendezvous_owner — blake2b over (key, member identity) —
    so join/leave moves only the departing/arriving host's key share.
    Host EPOCHS fence stale answers; they are deliberately not part of
    the score (a host restart must not re-shard the whole cluster)."""
    best, best_score = None, b""
    for hid in sorted(set(host_ids)):
        score = hashlib.blake2b(key + hid.encode("utf-8"),
                                digest_size=8).digest()
        if best is None or score > best_score:
            best, best_score = hid, score
    return best


@dataclasses.dataclass
class PeerState:
    """One remote host as gossip last saw it. ``base`` is the peer's
    fleet-admin base URL (the bootstrap address); everything else is
    learned from its /fleetz host block."""

    base: str
    host_id: str = ""
    host_epoch: int = 0
    serve_url: str = ""
    alive: bool = False
    last_seen: float = 0.0  # table clock stamp of the last good poll
    workers: int = 0
    est_queue_ms: float = 0.0
    pressure_level: int = 0
    epoch_bumps: int = 0  # restarts observed (host_epoch increased)
    failures: int = 0  # consecutive failed polls
    raw: Optional[dict] = None  # the peer's last full /fleetz payload

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("raw", None)
        return d


class PeerTable:
    """The gossip-maintained cross-host membership view.

    Thread-safe: the gossip thread writes via observe(), request
    handlers read via alive()/least_loaded()/lookup(). Staleness is a
    READ-side judgement (``now - last_seen > staleness_s``) so a wedged
    gossip thread degrades every peer to dead instead of freezing a
    live-looking table."""

    def __init__(self, bases: Iterable[str], *, staleness_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.staleness_s = max(0.1, staleness_s)
        self._lock = threading.Lock()
        self._peers = {b: PeerState(base=b) for b in bases}

    @property
    def bases(self) -> List[str]:
        return list(self._peers)

    def observe(self, base: str, payload: Optional[dict],
                now: Optional[float] = None) -> None:
        """Fold one poll result in. ``payload`` is the peer's /fleetz
        JSON (its ``host`` block carries identity/capacity); None marks
        a failed poll — the peer reads dead until it answers again."""
        now = self._clock() if now is None else now
        with self._lock:
            p = self._peers.get(base)
            if p is None:
                return
            if payload is None or not isinstance(payload, dict):
                p.failures += 1
                p.alive = False
                return
            host = payload.get("host") or {}
            epoch = int(host.get("epoch", 0) or 0)
            if p.host_epoch and epoch > p.host_epoch:
                # the peer restarted: a new incarnation took the
                # identity, exactly like a worker respawn bumping its
                # fencing epoch — answers stamped with the old epoch
                # are now refusable
                p.epoch_bumps += 1
            p.host_id = str(host.get("id", "") or p.host_id)
            p.host_epoch = epoch or p.host_epoch
            p.serve_url = str(host.get("serve_url", "") or p.serve_url)
            p.workers = int(host.get("workers_alive",
                                     host.get("workers", 0)) or 0)
            p.est_queue_ms = float(host.get("est_queue_ms", 0.0) or 0.0)
            p.pressure_level = int(host.get("pressure_level", 0) or 0)
            p.failures = 0
            p.alive = True
            p.last_seen = now
            p.raw = payload

    def peers(self) -> List[PeerState]:
        with self._lock:
            return [dataclasses.replace(p) for p in self._peers.values()]

    def _fresh(self, p: PeerState, now: float) -> bool:
        return p.alive and p.host_id != "" \
            and (now - p.last_seen) <= self.staleness_s

    def alive(self, now: Optional[float] = None) -> List[PeerState]:
        now = self._clock() if now is None else now
        return [p for p in self.peers() if self._fresh(p, now)]

    def lookup(self, hid: str,
               now: Optional[float] = None) -> Optional[PeerState]:
        now = self._clock() if now is None else now
        for p in self.peers():
            if p.host_id == hid and self._fresh(p, now):
                return p
        return None

    def least_loaded(self, now: Optional[float] = None,
                     exclude_critical: bool = True) -> Optional[PeerState]:
        """Spillover target: the alive peer with the smallest estimated
        queue, skipping peers themselves at critical pressure (shipping
        batch work to a host that would shed it buys one wasted hop)."""
        from imaginary_tpu_torch.engine.pressure import LEVEL_CRITICAL

        cands = [p for p in self.alive(now) if p.serve_url
                 and not (exclude_critical
                          and p.pressure_level >= LEVEL_CRITICAL)]
        if not cands:
            return None
        return min(cands, key=lambda p: (p.est_queue_ms, p.base))

    def snapshot(self) -> dict:
        return {p.base: p.to_dict() for p in self.peers()}


def _default_peer_fetch(url: str, timeout: float) -> str:
    """One gossip probe. Connection: close — every probe is an
    independent liveness sample, never a kept-alive pipe that would
    outlive the peer it proves."""
    req = urllib.request.Request(url, headers={"Connection": "close"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read().decode("utf-8", "replace")


class GossipAgent:
    """The peer-polling thread: every ``interval_s`` it fetches each
    peer's /fleetz and folds the answer into the table. One thread per
    participant (supervisor and each worker run their own — the table
    is process-local state, like every other cache in this tree)."""

    def __init__(self, table: PeerTable, *, interval_s: float = 2.0,
                 timeout_s: float = PEER_PROBE_TIMEOUT_S, fetch=None):
        self.table = table
        self.interval_s = max(0.05, interval_s)
        self.timeout_s = timeout_s
        self._fetch = fetch or _default_peer_fetch
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.polls = 0

    def poll_once(self) -> None:
        for base in self.table.bases:
            payload = None
            try:
                # chaos site: an injected error is a failed probe — the
                # peer reads dead and every consumer fails open
                failpoints.hit("peer.health", key=base)
                payload = json.loads(self._fetch(
                    base + "/fleetz", self.timeout_s))
            except Exception:
                payload = None
            self.table.observe(base, payload)
        self.polls += 1

    def _run(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self.interval_s)

    def start(self) -> "GossipAgent":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            name="peer-gossip", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def build_cluster_view(local_fleetz: dict, table: PeerTable,
                       now: Optional[float] = None) -> dict:
    """The merged ``/fleetz?scope=cluster`` payload: this host's own
    fleetz plus each gossiped peer's last-known fleetz side by side,
    with a hosts summary table on top. Degrades exactly like
    build_fleetz: a dead/stale peer still appears (bootstrap address +
    last identity) with ``alive: false`` — partial data beats a 500."""
    now = time.time() if now is None else now
    local_host = (local_fleetz or {}).get("host") or {}
    hosts = {}
    lid = str(local_host.get("id", "") or "")
    if lid:
        hosts[lid] = {
            "epoch": int(local_host.get("epoch", 0) or 0),
            "alive": True,
            "local": True,
            "workers": int(local_host.get("workers_alive", 0) or 0),
        }
    peers_out = {}
    for p in table.peers():
        fresh = p.alive and (table._clock() - p.last_seen) \
            <= table.staleness_s
        if p.host_id:
            hosts[p.host_id] = {
                "epoch": p.host_epoch,
                "alive": fresh,
                "local": False,
                "workers": p.workers,
                "epoch_bumps": p.epoch_bumps,
            }
        peers_out[p.base] = {
            "state": p.to_dict(),
            "fleetz": p.raw if fresh else None,
        }
    return {
        "ts": round(now, 3),
        "scope": "cluster",
        "hosts": hosts,
        "local": local_fleetz,
        "peers": peers_out,
    }
