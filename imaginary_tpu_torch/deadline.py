"""End-to-end per-request deadlines (the port's copy of
`imaginary_tpu/deadline.py`; "The Tail at Scale" deadline propagation).

The trace middleware (web/middleware.py) mints one Deadline per request
when `--request-timeout` is set. It rides the request trace
(obs/trace.py RequestTrace), which `contextvars.copy_context()` already
carries into the host pool, so every hop reads the remaining budget
from one place:

  admission      a 503 when the estimated queue delay exceeds the budget
  source fetch   each attempt's origin timeout clipped to the budget
  coalesce wait  a singleflight follower stops waiting when its own
                 budget runs out (a 504 at stage `queue`); the leader's
                 shared run is never cancelled
  executor queue a future whose deadline passed while queued is
                 cancelled, and the executor drops it before launch and
                 releases its owed MB
  host pool      a worker that dequeues an expired request bails before
                 decoding a single byte
  encode         the last stage boundary checks before paying the encoder

Expiry after admission is a 504 carrying the elapsed time and the budget
(errors.DeadlineExceeded); the stage checkpoints land in the trace's
fields through the middleware's final annotate.

Everything here is a no-op while `--request-timeout` is 0 (the default):
`current()` returns None and the call sites skip.
"""

from __future__ import annotations

import time
from typing import Optional

from imaginary_tpu_torch.errors import DeadlineExceeded
from imaginary_tpu_torch.obs import trace as obs_trace

_MAX_CHECKPOINTS = 32  # a retry loop must not grow a deadline unbounded


class Deadline:
    """A monotonic budget for one request. The handler path touches it
    one hop at a time (the async task, or the one pool thread that owns
    the request at that moment)."""

    __slots__ = ("t0", "budget_s", "checkpoints")

    def __init__(self, budget_s: float, t0: Optional[float] = None):
        self.t0 = time.monotonic() if t0 is None else t0
        self.budget_s = float(budget_s)
        self.checkpoints: list = []  # (stage, remaining_ms) in arrival order

    def elapsed_s(self) -> float:
        return time.monotonic() - self.t0

    def remaining_s(self) -> float:
        return self.budget_s - self.elapsed_s()

    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def note(self, stage: str) -> float:
        """Record the remaining budget at a stage boundary; returns the
        remaining seconds (possibly negative)."""
        rem = self.remaining_s()
        if len(self.checkpoints) < _MAX_CHECKPOINTS:
            self.checkpoints.append((stage, round(rem * 1000.0, 1)))
        return rem

    def check(self, stage: str) -> None:
        """Raise the 504 if the budget is spent; otherwise checkpoint."""
        if self.note(stage) <= 0.0:
            raise self.error(stage)

    def error(self, stage: str) -> DeadlineExceeded:
        return DeadlineExceeded(stage, self.elapsed_s() * 1000.0,
                                self.budget_s * 1000.0)

    def stages_dict(self) -> dict:
        """Remaining ms at each stage (the last note of a stage wins, e.g.
        fetch retries)."""
        return dict(self.checkpoints)


def resolve_budget(server_max_s: float, header_value: str) -> float:
    """The minting rule: `--request-timeout` is both the default budget
    and the ceiling of the per-request `X-Request-Timeout` header
    (seconds). 0 turns deadlines off: a header cannot enable what the
    operator left off. An invalid or non-positive header value falls back
    to the server default."""
    if server_max_s <= 0.0:
        return 0.0
    if header_value:
        try:
            v = float(header_value)
        except ValueError:
            v = 0.0
        if v > 0.0:
            return min(v, server_max_s)
    return server_max_s


def current() -> Optional[Deadline]:
    """The current request's deadline, or None (no trace, or deadlines
    off)."""
    tr = obs_trace.current()
    return tr.deadline if tr is not None else None


def check(stage: str) -> None:
    """Module-level convenience: a no-op without an active deadline."""
    dl = current()
    if dl is not None:
        dl.check(stage)
