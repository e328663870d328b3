"""Rule registry for itpucheck.

Each rule module exposes:
  RULE_ID  "ITPUxxx"
  TITLE    one-line summary
  run(index) -> iterable of (rel_path, lineno, message)
"""

from imaginary_tpu_torch.tools.rules import (
    async_blocking,
    claim_protocol,
    config_surface,
    context_propagation,
    failpoint_registry,
    future_guard,
    label_cardinality,
    lane_ledger,
    ledger,
    metrics_exposition,
    obs_registry,
    peer_timeout,
    silent_except,
    slot_protocol,
)

RULES = (
    async_blocking,
    future_guard,
    ledger,
    lane_ledger,
    silent_except,
    config_surface,
    failpoint_registry,
    metrics_exposition,
    context_propagation,
    slot_protocol,
    claim_protocol,
    obs_registry,
    label_cardinality,
    peer_timeout,
)
