"""Per-tenant rate limiting: the web layer's GCRA, rekeyed by tenant.

The existing GCRARateLimiter (web/middleware.py) already carries the
key-flood discipline this needs — its MAX_KEYS eviction docstring was
written anticipating exactly this rekeying ("the structure must not
silently leak if a deployment rekeys it by client"): expired entries
sweep first, then the oldest-tat half evicts, so currently-throttled
tenants keep their state through a key flood. This module adds only the
per-tenant PARAMETERS: each tenant's `rate`/`burst` override the global
--concurrency/--burst, computed per call against one shared tat store.

A tenant with no rate of its own inherits the global limit; when neither
exists the tenant is unlimited and the call is free of limiter state
entirely (no key is minted — an unlimited anonymous flood must not churn
the tat store other tenants' throttle state lives in).

The port's copy of `imaginary_tpu/qos/limiter.py`, without the fleet's
shared table (`--fleet-qos` waits for the fleet's port): the decision
runs against this process's store.
"""

from __future__ import annotations

from imaginary_tpu_torch.qos.tenancy import TenantSpec


class TenantLimiter:
    """GCRA with per-tenant emission/tau over one shared key store."""

    def __init__(self, global_rate: int, global_burst: int):
        # the store's own emission/tau are the global fallback params;
        # import here (not module top) to keep qos importable without
        # aiohttp for executor-only consumers
        from imaginary_tpu_torch.web.middleware import GCRARateLimiter

        self._gcra = GCRARateLimiter(max(int(global_rate), 1),
                                     max(int(global_burst), 0))
        self._global_rate = max(int(global_rate), 0)
        self._global_burst = max(int(global_burst), 0)

    def allow(self, tenant: TenantSpec):
        """(allowed, retry_after_seconds) for one request from `tenant`."""
        rate = tenant.rate if tenant.rate > 0 else float(self._global_rate)
        if rate <= 0:
            return True, 0.0  # unlimited: no key minted, no state touched
        burst = tenant.burst if tenant.burst >= 0 else self._global_burst
        emission = 1.0 / rate
        tau = emission * max(burst, 0)
        return self._gcra.allow("tenant:" + tenant.name, emission=emission,
                                tau=tau)
