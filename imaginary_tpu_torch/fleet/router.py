"""Cross-host digest routing and pressure spillover (the port's copy of
`imaginary_tpu/fleet/router.py`).

fleet/ownership.py elects one OWNER WORKER per digest inside a host; this
module elects one OWNER HOST per digest across the cluster and ships
non-owned work exactly one HTTP hop there. The hop mirrors the intra-host
forward point for point:

* **one hop, ever**: a forwarded request carries
  ``X-Imaginary-Route: fwd=<host_id>`` and the receiver never forwards it
  again (no routing loops, no hop chains);
* **the fail-open ladder**: a dead host, a refused dial, the hop's
  timeout, an answer other than 200, a fenced (stale host epoch) or
  unstamped answer, an injected ``peer.forward`` fault: each returns None
  and the caller runs locally. The tier can move work; it never mints a
  new 5xx;
* **deadline-clamped budgets**: the hop's timeout is
  ``min(--fleet-hop-ms, deadline.remaining_s())``, so a routed request
  never outspends the client's clock.

Spillover is the peer table's second consumer: when the local pressure
governor is critical and batch-class work is about to be shed with a
503, the request is first OFFERED, verbatim, to the least-loaded
non-critical peer from gossip. A failed offer falls through to the 503
the request was owed anyway.

Constructed only with ``--peers``; routing every request also needs
``--router`` (or a client's ``X-Imaginary-Route: route`` hint). Off: no
instance, no gossip thread, no header, no surface. The hop's forwarded
request runs the owner host's kernels on its own card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from imaginary_tpu_torch import deadline as deadline_mod
from imaginary_tpu_torch import failpoints
from imaginary_tpu_torch.fleet import multihost

# request headers of the hop protocol. ROUTE carries the hop marker /
# client hints; HOST_EPOCH stamps every armed response with the
# answering incarnation's identity so a forwarder can refuse answers
# from a deposed host generation (the cross-host analogue of the UDS
# hop's status="fenced").
ROUTE_HEADER = "X-Imaginary-Route"
HOST_EPOCH_HEADER = "X-Imaginary-Host-Epoch"


@dataclasses.dataclass
class RouterStats:
    """This process's view of the cross-host plane (/health multihost
    block; every counter is monotonic)."""

    forwards: int = 0  # routed hops that served the request
    forward_fails: int = 0  # hops that failed open to local execution
    fenced_answers: int = 0  # answers refused on a stale host epoch
    spills: int = 0  # critical-pressure offers a peer absorbed
    spill_fails: int = 0  # offers that fell through to the local 503
    served_for_peer: int = 0  # requests this host served under a fwd marker
    local_fallbacks: int = 0  # route decisions that stayed local (no owner/peer)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


async def _default_hop(method: str, url: str, body, headers: dict,
                       timeout_s: float) -> tuple:
    """One cross-host hop. A session per call: forwards are one-shot by
    design (a dead peer fails the dial instead of poisoning a pool),
    matching fleet/ipc.py's connection-per-forward stance."""
    import aiohttp

    async with aiohttp.request(
            method, url, data=body, headers=headers,
            timeout=aiohttp.ClientTimeout(total=max(0.001, timeout_s))) as r:
        rbody = await r.read()
        return r.status, dict(r.headers), rbody


class HostRouter:
    """The worker-side cross-host plane: a peer table + gossip thread,
    the rendezvous route decision, and the fail-open forward/spill
    hops. ``hop`` is injectable (tests drive every rung of the ladder
    without sockets); the default is an aiohttp one-shot request."""

    def __init__(self, table: multihost.PeerTable, *, self_id: str,
                 self_epoch: int, route_all: bool = False,
                 hop_s: float = 0.25, probe_interval_s: float = 2.0,
                 gossip_fetch=None, hop=None,
                 clock=time.monotonic):
        self.table = table
        self.self_id = self_id
        self.self_epoch = self_epoch
        self.route_all = route_all
        self.hop_s = max(0.001, hop_s)
        self.stats = RouterStats()
        self._hop = hop or _default_hop
        self._clock = clock
        self.gossip = multihost.GossipAgent(
            table, interval_s=probe_interval_s, fetch=gossip_fetch)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "HostRouter":
        self.gossip.start()
        return self

    def close(self) -> None:
        self.gossip.close()

    @property
    def identity_header(self) -> str:
        """The value every armed response stamps into
        ``X-Imaginary-Host-Epoch``: who answered, and which incarnation."""
        return f"{self.self_id}:{self.self_epoch}"

    # -- route decision ----------------------------------------------------

    def owner_host(self, skey: bytes) -> Optional[str]:
        """Rendezvous owner among this host + alive gossiped peers; None
        when the cluster is effectively single-host."""
        hosts = {self.self_id}
        hosts.update(p.host_id for p in self.table.alive())
        if len(hosts) < 2:
            return None
        return multihost.rendezvous_host(hosts, skey)

    def note_hop_marker(self, headers) -> bool:
        """True when the request arrived OVER the hop (fwd marker): it
        must be served locally, whatever the ring says."""
        hint = str(headers.get(ROUTE_HEADER, ""))
        if hint.startswith("fwd"):
            self.stats.served_for_peer += 1
            return True
        return False

    def route_target(self, headers, skey: bytes) -> Optional[multihost.PeerState]:
        """The peer that owns `skey`, when this request should take the
        hop; None = run locally. Client hints: ``route`` opts a single
        request in without --router, ``local`` pins it here."""
        hint = str(headers.get(ROUTE_HEADER, ""))
        if hint.startswith("fwd") or hint == "local":
            return None
        if not (self.route_all or hint == "route"):
            return None
        owner = self.owner_host(skey)
        if owner is None or owner == self.self_id:
            return None
        peer = self.table.lookup(owner)
        if peer is None or not peer.serve_url:
            # the ring elected a host gossip can no longer vouch for:
            # the same fail-open answer as every other fault — local
            self.stats.local_fallbacks += 1
            return None
        return peer

    # -- the hops ----------------------------------------------------------

    def _budget_s(self) -> Optional[float]:
        """min(hop budget, request deadline remainder); None = no time
        left, don't even dial."""
        timeout = self.hop_s
        dl = deadline_mod.current()
        if dl is not None:
            rem = dl.remaining_s()
            if rem <= 0:
                return None
            timeout = min(timeout, rem)
        return timeout

    def _fenced(self, peer: multihost.PeerState, headers: dict) -> bool:
        """An answer missing the identity stamp, naming a different
        host, or stamped with an OLDER epoch than gossip knows came
        from a deposed incarnation (or not from the owner at all)."""
        raw = ""
        for k, v in headers.items():
            if str(k).lower() == HOST_EPOCH_HEADER.lower():
                raw = str(v)
                break
        hid, _, es = raw.partition(":")
        try:
            epoch = int(es)
        except ValueError:
            return True
        if hid != peer.host_id:
            return True
        return bool(peer.host_epoch) and epoch < peer.host_epoch

    async def try_forward(self, peer: multihost.PeerState, op_name: str,
                          query: dict, body: bytes,
                          content_type: str) -> Optional[tuple]:
        """Route one request to its owner host: POST the source bytes +
        resolved params (the same ship-the-inputs shape as the UDS hop
        — the owner re-fetches nothing). (ProcessedImage, placement) on
        success, None on ANY fault — fail-open, the caller runs locally."""
        try:
            await failpoints.ahit("peer.forward", key=peer.host_id)
        except failpoints.FailpointError:
            self.stats.forward_fails += 1
            return None
        timeout = self._budget_s()
        if timeout is None:
            self.stats.forward_fails += 1
            return None
        from urllib.parse import urlencode

        url = (f"{peer.serve_url}/{op_name}?"
               f"{urlencode({str(k): str(v) for k, v in query.items()})}")
        headers = {
            ROUTE_HEADER: f"fwd={self.self_id}",
            "Content-Type": content_type or "application/octet-stream",
            "Connection": "close",
        }
        try:
            status, rheaders, rbody = await self._hop(
                "POST", url, body, headers, timeout)
        except BaseException as e:
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            import asyncio

            if isinstance(e, asyncio.CancelledError):
                raise
            # dead host, refused dial, TLS/frame fault, hop timeout —
            # one answer for all of them: run locally
            self.stats.forward_fails += 1
            return None
        if status != 200 or not rbody:
            self.stats.forward_fails += 1
            return None
        if self._fenced(peer, rheaders):
            self.stats.fenced_answers += 1
            return None
        self.stats.forwards += 1
        from imaginary_tpu_torch.pipeline import ProcessedImage

        mime = ""
        for k, v in rheaders.items():
            if str(k).lower() == "content-type":
                mime = str(v).split(";")[0].strip()
                break
        placement = ""
        for k, v in rheaders.items():
            if str(k).lower() == "x-imaginary-backend":
                placement = str(v)
                break
        return (ProcessedImage(body=rbody,
                               mime=mime or "application/octet-stream"),
                placement)

    # -- spillover ---------------------------------------------------------

    def spill_target(self) -> Optional[multihost.PeerState]:
        """The least-loaded alive non-critical peer, or None (then the
        request takes the 503 it was already owed)."""
        return self.table.least_loaded()

    async def try_spill(self, peer: multihost.PeerState, method: str,
                        path_qs: str, body: bytes,
                        headers: dict) -> Optional[tuple]:
        """Offer one about-to-shed request to `peer` verbatim (the peer
        runs its own fetch/admission — it may shed too). (status, mime,
        body) only for an authoritative 200; anything else falls back
        to the local shed."""
        try:
            await failpoints.ahit("peer.forward", key=peer.host_id)
        except failpoints.FailpointError:
            self.stats.spill_fails += 1
            return None
        timeout = self._budget_s()
        if timeout is None:
            self.stats.spill_fails += 1
            return None
        fwd_headers = {k: v for k, v in headers.items()
                       if str(k).lower() in ("content-type", "accept",
                                             "authorization")}
        fwd_headers[ROUTE_HEADER] = f"fwd={self.self_id}"
        fwd_headers["Connection"] = "close"
        url = peer.serve_url + path_qs
        try:
            status, rheaders, rbody = await self._hop(
                method, url, body, fwd_headers, timeout)
        except BaseException as e:
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            import asyncio

            if isinstance(e, asyncio.CancelledError):
                raise
            self.stats.spill_fails += 1
            return None
        if status != 200 or not rbody or self._fenced(peer, rheaders):
            self.stats.spill_fails += 1
            return None
        self.stats.spills += 1
        mime = "application/octet-stream"
        for k, v in rheaders.items():
            if str(k).lower() == "content-type":
                mime = str(v).split(";")[0].strip()
                break
        return status, mime, rbody

    # -- observability -----------------------------------------------------

    def snapshot(self) -> dict:
        out = self.stats.to_dict()
        out["host_id"] = self.self_id
        out["host_epoch"] = self.self_epoch
        out["router"] = self.route_all
        out["peers"] = self.table.snapshot()
        return out
