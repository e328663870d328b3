"""ITPU013 — fleet claim acquires need release-or-abandon in a `finally`.

The fleet singleflight (fleet/ownership.py + shmcache's claim table)
rests on the same discipline ITPU009 enforces for slots: `claim_acquire`
may take a claim entry's exclusive lock and stamp it CLAIMED; every path
out of the critical section must end in `claim_release` (equivalently
`claim_abandon`), sitting in a `finally:` so an exception between
acquire and release cannot strand the claim. A leaked claim is worse
than a leaked slot: every sibling worker with the same digest parks on
it for the full claim-wait budget before failing open — one bug turns a
one-worker fault into a fleet-wide latency cliff on that digest, repeated
on every occurrence until the holder process dies and the kernel frees
the lock.

Only process DEATH may skip the release; that is the crash case the
waiters' re-dispatch path exists for. Code must not.
"""

from __future__ import annotations

import ast

from imaginary_tpu_torch.tools import astutil

RULE_ID = "ITPU013"
TITLE = "fleet claim acquired without release-or-abandon in a finally"

ACQUIRE = "claim_acquire"
_RELEASES = ("claim_release", "claim_abandon")
_PRIMITIVES = {ACQUIRE, *_RELEASES}


def _calls_in(nodes, names) -> bool:
    for stmt in nodes:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call):
                cn = astutil.call_name(n)
                if cn is not None and cn.split(".")[-1] in names:
                    return True
    return False


def run(index):
    for sf in index.files:
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name in _PRIMITIVES:
                continue  # the protocol primitives themselves
            body_nodes = list(astutil.walk_function_body(fn))
            tries = [n for n in body_nodes if isinstance(n, ast.Try)]
            for call in body_nodes:
                if not isinstance(call, ast.Call):
                    continue
                cn = astutil.call_name(call)
                if cn is None or cn.split(".")[-1] != ACQUIRE:
                    continue
                ok = any(
                    t.finalbody and _calls_in(t.finalbody, _RELEASES)
                    and (t.end_lineno or t.lineno) >= call.lineno
                    for t in tries
                )
                if not ok:
                    yield (sf.rel, call.lineno,
                           f"`{ACQUIRE}()` without a `claim_release()`/"
                           "`claim_abandon()` in a `finally:` after the "
                           "acquire — an exception between acquire and "
                           "release strands the claim, parking every "
                           "sibling on this digest for the full claim-"
                           "wait budget")
