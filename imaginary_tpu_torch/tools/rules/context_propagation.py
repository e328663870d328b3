"""ITPU008 — pool submissions must carry the request context.

The request's identity rides ONE contextvar vehicle (obs/trace.py
RequestTrace): trace spans, the deadline, the tenant stamp, and the
bomb-gate pixel cap are all slots on it. A thread-pool submission
that doesn't wrap the callable in `contextvars.copy_context().run`
silently drops ALL of them — the work still completes, but deadlines
stop being enforced, spans vanish from wide events, and the bomb cap
disarms, exactly on the offloaded (i.e. expensive) path.

`asyncio.to_thread` propagates context by itself and is exempt; the
flagged shapes are `<pool>.submit(fn, ...)` where fn is not a
`ctx.run`-style attribute, and `loop.run_in_executor(..., fn, ...)`
(which never propagates).
"""

from __future__ import annotations

import ast

from imaginary_tpu_torch.tools import astutil

RULE_ID = "ITPU008"
TITLE = "pool submission without contextvars.copy_context()"


def _is_ctx_run(node: ast.AST) -> bool:
    """fn argument shapes that carry context: `ctx.run`,
    `contextvars.copy_context().run`, `functools.partial(ctx.run, ...)`."""
    if isinstance(node, ast.Attribute) and node.attr == "run":
        return True
    if isinstance(node, ast.Call):
        name = astutil.call_name(node)
        if name and name.split(".")[-1] == "partial" and node.args:
            return _is_ctx_run(node.args[0])
    return False


def run(index):
    for sf in index.files:
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            if attr == "submit":
                recv = astutil.dotted_name(node.func.value) or ""
                leaf = recv.split(".")[-1].lower()
                if "pool" not in leaf or not node.args:
                    continue  # micro-batch Executor.submit carries its
                    # own trace stamp; only thread POOLS lose context
                if not _is_ctx_run(node.args[0]):
                    yield (sf.rel, node.lineno,
                           f"`{recv}.submit()` without contextvars."
                           "copy_context().run — the trace/deadline/"
                           "tenant/bomb-cap contextvars are dropped on "
                           "the pool thread")
            elif attr == "run_in_executor" and len(node.args) >= 2:
                if not _is_ctx_run(node.args[1]):
                    yield (sf.rel, node.lineno,
                           "`run_in_executor()` never propagates "
                           "contextvars — wrap the callable in "
                           "contextvars.copy_context().run (or use "
                           "asyncio.to_thread)")
