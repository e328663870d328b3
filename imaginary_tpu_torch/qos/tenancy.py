"""Tenant identity: who is asking, and what class of service they bought
(the port's copy of `imaginary_tpu/qos/tenancy.py`).

A tenant is resolved per request from the API-Key header (or ?key= query
param, the same credential surface the auth middleware reads), falling
back to the client IP, falling back to the DEFAULT tenant — so anonymous
traffic is a first-class (usually `standard` or `batch`) tenant rather
than an unaccounted hole. The resolved TenantSpec is stamped onto the
RequestTrace contextvar by the trace middleware, which is how every later
layer — the throttle, the admission gate, the executor scheduler (via
pool-thread copy_context) and the trace's fields — reads tenant and class
without new plumbing.

The tenant table comes from `--qos-config` (inline JSON when the value
starts with '{', else a file path):

    {
      "default": {"class": "standard"},
      "tenants": [
        {"name": "acme", "class": "interactive",
         "api_keys": ["k-acme-1"], "ips": ["10.2.0.7"],
         "rate": 50, "burst": 10, "max_share": 0.5}
      ],
      "queue_cap": 256,
      "aging_dispatches": {"standard": 4, "batch": 8},
      "shed_fractions": {"interactive": 1.0, "standard": 0.75, "batch": 0.5}
    }

Per-tenant knobs: `class` in {interactive, standard, batch}; `rate`/
`burst` override the global --concurrency/--burst for the per-tenant
GCRA (0 / -1 = inherit); `max_share` caps the fraction of the executor
intake queue (`queue_cap` items) one tenant may occupy (1.0 = uncapped).
A malformed config fails the boot loudly — an operator typo must not
silently serve with no isolation.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from imaginary_tpu_torch import deadline as deadline_mod
from imaginary_tpu_torch.obs import trace as obs_trace
from imaginary_tpu_torch.qos import CLASS_INDEX, CLASSES, DEFAULT_CLASS
from imaginary_tpu_torch.qos.shed import DEFAULT_SHED_FRACTIONS, QosStats

DEFAULT_QUEUE_CAP = 256
# Dispatches a non-empty class may be bypassed before it is force-served
# (sched.py aging), index-aligned with CLASSES; 0 = never bypassed-aged
# (the top class can't starve under strict priority).
DEFAULT_AGING = (0, 4, 8)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's service contract (immutable; rides the trace)."""

    name: str
    klass: str = DEFAULT_CLASS
    rate: float = 0.0     # req/s GCRA override; 0 = inherit --concurrency
    burst: int = -1       # GCRA burst override; -1 = inherit --burst
    max_share: float = 1.0  # fraction of queue_cap this tenant may occupy

    @property
    def class_index(self) -> int:
        return CLASS_INDEX[self.klass]


DEFAULT_TENANT = TenantSpec(name="default")


def _parse_tenant(raw: dict, where: str) -> TenantSpec:
    if not isinstance(raw, dict):
        raise ValueError(f"qos config: {where} must be an object")
    known = {"name", "class", "rate", "burst", "max_share", "api_keys", "ips"}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(
            f"qos config: unknown key(s) {sorted(unknown)} in {where} "
            f"(known: {sorted(known)})")
    klass = raw.get("class", DEFAULT_CLASS)
    if klass not in CLASSES:
        raise ValueError(
            f"qos config: {where} has unknown class {klass!r} "
            f"(want one of {', '.join(CLASSES)})")
    rate = float(raw.get("rate", 0.0))
    burst = int(raw.get("burst", -1))
    max_share = float(raw.get("max_share", 1.0))
    if rate < 0:
        raise ValueError(f"qos config: {where} rate must be >= 0")
    if not 0.0 < max_share <= 1.0:
        raise ValueError(f"qos config: {where} max_share must be in (0, 1]")
    return TenantSpec(name=str(raw.get("name", "default")), klass=klass,
                      rate=rate, burst=burst, max_share=max_share)


class QosPolicy:
    """The parsed --qos-config: tenant table + scheduler/shed knobs + the
    shared QosStats counter block. One per server process; handed to the
    trace middleware, the throttle, the admission gate, and the executor
    at assembly (web/app.py)."""

    def __init__(self, default: TenantSpec, tenants: tuple,
                 by_key: dict, by_ip: dict,
                 queue_cap: int = DEFAULT_QUEUE_CAP,
                 aging_dispatches: tuple = DEFAULT_AGING,
                 shed_fractions: tuple = DEFAULT_SHED_FRACTIONS):
        self.default = default
        self.tenants = tenants
        self._by_key = by_key
        self._by_ip = by_ip
        self.queue_cap = queue_cap
        self.aging_dispatches = aging_dispatches
        self.shed_fractions = shed_fractions
        self.stats = QosStats()

    # -- per-request resolution (trace middleware) -------------------------

    def resolve(self, request) -> TenantSpec:
        """API-Key header, else ?key=, else client IP, else default."""
        key = request.headers.get("API-Key") or request.query.get("key", "")
        if key:
            ten = self._by_key.get(key)
            if ten is not None:
                return ten
        ip = request.remote or ""
        if ip:
            ten = self._by_ip.get(ip)
            if ten is not None:
                return ten
        return self.default

    def tenant_names(self) -> tuple:
        """Every configured tenant name, default first."""
        return (self.default.name,) + tuple(t.name for t in self.tenants)

    # -- knob lookups ------------------------------------------------------

    def any_rate(self) -> bool:
        """Whether any tenant (default included) carries its own GCRA
        rate — decides whether the throttle middleware installs when the
        global --concurrency is 0."""
        return self.default.rate > 0 or any(t.rate > 0 for t in self.tenants)

    def shed_threshold_ms(self, kidx: int, base_ms: float) -> float:
        """The class-graded --max-queue-ms threshold (lowest class gets
        the smallest budget, so it sheds first as backlog builds)."""
        return base_ms * self.shed_fractions[kidx]

    # -- surfaces ----------------------------------------------------------

    def snapshot(self) -> dict:
        """The policy's (secret-free) view: the tenant table plus the live
        counter block. API keys are reported as COUNTS only — a surface
        must never echo a credential."""
        return {
            "default": {"class": self.default.klass,
                        "rate": self.default.rate,
                        "max_share": self.default.max_share},
            "tenants": [
                {"name": t.name, "class": t.klass, "rate": t.rate,
                 "burst": t.burst, "max_share": t.max_share,
                 "api_keys": sum(1 for k in self._by_key.values() if k is t),
                 "ips": sum(1 for k in self._by_ip.values() if k is t)}
                for t in self.tenants
            ],
            "queue_cap": self.queue_cap,
            "aging_dispatches": dict(zip(CLASSES, self.aging_dispatches)),
            "shed_fractions": dict(zip(CLASSES, self.shed_fractions)),
            "stats": self.stats.to_dict(),
        }


def _class_map(raw, name: str, defaults: tuple, minimum: float) -> tuple:
    """Parse a per-class override map like {"batch": 8} over `defaults`."""
    if raw is None:
        return defaults
    if not isinstance(raw, dict):
        raise ValueError(f"qos config: {name} must be an object")
    unknown = set(raw) - set(CLASSES)
    if unknown:
        raise ValueError(
            f"qos config: {name} has unknown class(es) {sorted(unknown)}")
    out = list(defaults)
    for cls, v in raw.items():
        v = float(v)
        if v < minimum:
            raise ValueError(f"qos config: {name}[{cls}] must be >= {minimum}")
        out[CLASS_INDEX[cls]] = v
    return tuple(out)


def parse_policy(text: str) -> QosPolicy:
    """Parse a qos config JSON document; raises ValueError on anything
    malformed (the boot must fail loudly, not serve unisolated)."""
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"qos config: invalid JSON ({e})") from None
    if not isinstance(doc, dict):
        raise ValueError("qos config: top level must be an object")
    known = {"default", "tenants", "queue_cap", "aging_dispatches",
             "shed_fractions"}
    unknown = set(doc) - known
    if unknown:
        raise ValueError(
            f"qos config: unknown top-level key(s) {sorted(unknown)} "
            f"(known: {sorted(known)})")
    default_raw = dict(doc.get("default", {}))
    default_raw.setdefault("name", "default")
    for forbidden in ("api_keys", "ips"):
        if forbidden in default_raw:
            raise ValueError(
                f"qos config: default tenant cannot carry {forbidden} "
                "(it is the fallback for unmatched requests)")
    default = _parse_tenant(default_raw, "default")
    tenants = []
    by_key: dict = {}
    by_ip: dict = {}
    seen = {default.name}
    for i, raw in enumerate(doc.get("tenants", [])):
        where = f"tenants[{i}]"
        if not isinstance(raw, dict) or "name" not in raw:
            raise ValueError(f"qos config: {where} needs a name")
        ten = _parse_tenant(raw, where)
        if ten.name in seen:
            raise ValueError(f"qos config: duplicate tenant name {ten.name!r}")
        seen.add(ten.name)
        keys = raw.get("api_keys", [])
        ips = raw.get("ips", [])
        if not keys and not ips:
            raise ValueError(
                f"qos config: {where} ({ten.name!r}) matches nothing — "
                "give it api_keys and/or ips")
        for k in keys:
            if k in by_key:
                raise ValueError(f"qos config: api key mapped twice ({where})")
            by_key[str(k)] = ten
        for ip in ips:
            if ip in by_ip:
                raise ValueError(
                    f"qos config: ip {ip!r} mapped twice ({where})")
            by_ip[str(ip)] = ten
        tenants.append(ten)
    queue_cap = int(doc.get("queue_cap", DEFAULT_QUEUE_CAP))
    if queue_cap < 1:
        raise ValueError("qos config: queue_cap must be >= 1")
    aging = tuple(int(v) for v in _class_map(
        doc.get("aging_dispatches"), "aging_dispatches", DEFAULT_AGING, 0))
    shed = _class_map(doc.get("shed_fractions"), "shed_fractions",
                      DEFAULT_SHED_FRACTIONS, 0.0)
    return QosPolicy(default, tuple(tenants), by_key, by_ip,
                     queue_cap=queue_cap, aging_dispatches=aging,
                     shed_fractions=shed)


def load_policy(value: str) -> Optional[QosPolicy]:
    """--qos-config entry point: '' -> qos off (None); a value starting
    with '{' is inline JSON, anything else is a file path."""
    value = (value or "").strip()
    if not value:
        return None
    if value.startswith("{"):
        return parse_policy(value)
    try:
        with open(value, encoding="utf-8") as f:
            text = f.read()
    except OSError as e:
        raise ValueError(f"qos config: cannot read {value!r}: {e}") from None
    return parse_policy(text)


def request_qos(policy: QosPolicy) -> tuple:
    """(tenant_name, class_index, max_share, deadline_t) for the current
    context — what the executor stamps onto each queue item. Reads the
    trace contextvar (copy_context carries it into pool threads), so the
    executor needs no new argument plumbing; outside a request (tests,
    benches driving the executor directly) everything defaults."""
    tr = obs_trace.current()
    ten = getattr(tr, "tenant", None) if tr is not None else None
    if ten is None:
        ten = policy.default
    dl = deadline_mod.current()
    deadline_t = (dl.t0 + dl.budget_s) if dl is not None else None
    return (ten.name, ten.class_index, ten.max_share, deadline_t)
