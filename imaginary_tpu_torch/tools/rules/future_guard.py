"""ITPU002 — future.set_result/set_exception without a completion guard.

The collector-crash class: the deadline path CANCELS queued futures, and
`set_exception` on a cancelled concurrent.futures.Future raises
InvalidStateError — on the collector/fetcher thread that kills the
thread and strands every queued request behind it. Every resolution site
must either check `done()`/`cancelled()` first or handle
InvalidStateError (the lock-held race-window idiom).
"""

from __future__ import annotations

import ast

from imaginary_tpu_torch.tools import astutil

RULE_ID = "ITPU002"
TITLE = "unguarded future.set_result/set_exception (InvalidStateError)"

_RESOLVERS = {"set_result", "set_exception"}
_GUARD_TESTS = {"done", "cancelled"}


def _if_test_guards(test: ast.AST) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in _GUARD_TESTS:
            return True
    return False


def _is_guarded(call: ast.Call, parents: dict) -> bool:
    for anc, child in astutil.ancestors(call, parents):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False  # scope boundary: guards outside don't count
        if isinstance(anc, ast.If) and _if_test_guards(anc.test):
            return True
        if isinstance(anc, ast.Try) and anc.handlers \
                and child in anc.body:
            return True
    return False


def run(index):
    for sf in index.files:
        parents = astutil.build_parents(sf.tree)
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _RESOLVERS):
                continue
            if _is_guarded(node, parents):
                continue
            recv = astutil.dotted_name(node.func.value) or "<future>"
            yield (sf.rel, node.lineno,
                   f"`{recv}.{node.func.attr}()` without a done()/"
                   "cancelled() guard or InvalidStateError handler — a "
                   "deadline-cancelled future raises InvalidStateError "
                   "here and kills the resolving thread")
