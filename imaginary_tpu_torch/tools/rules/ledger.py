"""ITPU003 — ledger charges must be balanced on every failure path.

The owed-work ledgers (`_owed_ms`/`_device_owed_mb` via `_charge_owed`,
`_host_owed_mpix` via `_host_charge`) drive admission shedding and the
spill cost model. A charge that leaks on an exception path permanently
inflates the estimated queue: the --max-queue-ms gate latches shut and
the server sheds traffic forever while idle. Two balancing protocols
are accepted, matching the executor's:

  * `_host_charge(x)` ... try: ... finally: `_host_release(x)` — the
    release must sit in a `finally` AFTER the charge, so every raise
    between them still balances.
  * `_charge_owed(item)` is released by the future's done-callback, so
    the caller's obligation is the ENQUEUE failure path: any `put()`
    after the charge that can raise must cancel the charged future in
    its `except` handler (cancel fires the callback and refunds).
"""

from __future__ import annotations

import ast

from imaginary_tpu_torch.tools import astutil

RULE_ID = "ITPU003"
TITLE = "ledger charge without a balancing release on failure paths"

# charge-call name -> release-call name that must appear in a finally
FINALLY_PAIRS = {"_host_charge": "_host_release"}
# charge-call names released via done-callback; callers must cancel on
# enqueue failure
CALLBACK_CHARGES = {"_charge_owed"}

_PRIMITIVES = set(FINALLY_PAIRS) | set(FINALLY_PAIRS.values()) \
    | CALLBACK_CHARGES


def _calls_in(nodes, name: str) -> bool:
    for stmt in nodes:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call):
                cn = astutil.call_name(n)
                if cn is not None and cn.split(".")[-1] == name:
                    return True
    return False


def _method_name(call: ast.Call):
    cn = astutil.call_name(call)
    return cn.split(".")[-1] if cn else None


def run(index):
    for sf in index.files:
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name in _PRIMITIVES:
                continue  # the ledger primitives themselves
            body_nodes = list(astutil.walk_function_body(fn))
            tries = [n for n in body_nodes if isinstance(n, ast.Try)]
            handlers = [h for n in tries for h in n.handlers]
            for call in body_nodes:
                if not isinstance(call, ast.Call):
                    continue
                name = _method_name(call)
                if name in FINALLY_PAIRS:
                    release = FINALLY_PAIRS[name]
                    ok = any(
                        t.finalbody and _calls_in(t.finalbody, release)
                        and (t.end_lineno or t.lineno) >= call.lineno
                        for t in tries
                    )
                    if not ok:
                        yield (sf.rel, call.lineno,
                               f"`{name}()` without a `{release}()` in a "
                               "`finally:` after the charge — an exception "
                               "between them leaks the occupancy ledger "
                               "and latches admission shut")
                elif name in CALLBACK_CHARGES:
                    ok = any(
                        h.lineno > call.lineno
                        and _calls_in(h.body, "cancel")
                        for h in handlers
                    )
                    if not ok:
                        yield (sf.rel, call.lineno,
                               f"`{name}()` without a `.cancel()` in a "
                               "later `except` handler — a failed enqueue "
                               "(qos share cap) strands the charge; "
                               "cancelling the future refunds it via the "
                               "done-callback")
