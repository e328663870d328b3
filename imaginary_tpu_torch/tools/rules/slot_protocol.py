"""ITPU009 — shm slot acquires need publish-or-abandon in a `finally`.

The fleet shared cache's crash safety (fleet/shmcache.py) rests on one
protocol: `_slot_acquire` takes the slot's exclusive lock and marks it
WRITING; the deposit must end in `_slot_publish` (seal) or
`_slot_abandon` (reset FREE + unlock) — and the abandon must sit in a
`finally:` so EVERY exception path between acquire and seal releases the
slot. An acquire whose abandon can be skipped leaks a locked WRITING
slot for the lifetime of the process: readers skip it forever, the
sweeper cannot reclaim it (the lock looks live), and one slot of the
shared cache is gone until restart — the fleet-cache analogue of the
ITPU003 ledger-leak class, with the same failure signature (a resource
that drains monotonically under errors and never refills).

Only process DEATH may skip the abandon; the kernel releases the lock
then, which is what makes the torn slot reclaimable. Code must not.
"""

from __future__ import annotations

import ast

from imaginary_tpu_torch.tools import astutil

RULE_ID = "ITPU009"
TITLE = "shm slot acquired without publish-or-abandon in a finally"

ACQUIRE = "_slot_acquire"
ABANDON = "_slot_abandon"
_PRIMITIVES = {ACQUIRE, ABANDON, "_slot_publish"}


def _calls_in(nodes, name: str) -> bool:
    for stmt in nodes:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call):
                cn = astutil.call_name(n)
                if cn is not None and cn.split(".")[-1] == name:
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
                    t.finalbody and _calls_in(t.finalbody, ABANDON)
                    and (t.end_lineno or t.lineno) >= call.lineno
                    for t in tries
                )
                if not ok:
                    yield (sf.rel, call.lineno,
                           f"`{ACQUIRE}()` without a `{ABANDON}()` in a "
                           "`finally:` after the acquire — an exception "
                           "between acquire and seal leaks a locked "
                           "WRITING slot no sweeper can ever reclaim")
