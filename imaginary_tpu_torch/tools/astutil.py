"""Small shared AST helpers for the itpucheck rules (stdlib only).

Every rule works on the same parsed-file index, so the common questions —
"what dotted name is being called", "which statements enclose this node",
"what string literals live under this call" — are answered here once.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional


def dotted_name(node: ast.AST) -> Optional[str]:
    """Render a Name/Attribute chain as 'a.b.c'; None for anything whose
    base is not a plain name chain (calls, subscripts, literals)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted_name(call.func)


def build_parents(tree: ast.AST) -> dict:
    """child-node -> parent-node map for ancestor walks."""
    parents: dict = {}
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent
    return parents


def ancestors(node: ast.AST, parents: dict) -> Iterator[tuple]:
    """Yield (ancestor, child-we-came-through) pairs from the node's
    immediate parent up to the module, so a caller can test WHICH field of
    a Try/If the node sits in (body vs handler vs finally)."""
    child = node
    cur = parents.get(node)
    while cur is not None:
        yield cur, child
        child = cur
        cur = parents.get(cur)


def enclosing_function(node: ast.AST, parents: dict):
    for anc, _ in ancestors(node, parents):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def walk_function_body(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function's own statements, NOT descending into nested
    function/class definitions (a nested def runs in a different execution
    context — a thread target, a callback — so rules about 'inside an
    async def' or 'in this function' must stop at the boundary)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def string_constants(node: ast.AST) -> Iterator[tuple]:
    """(value, lineno) for every string literal under `node`."""
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            yield n.value, n.lineno


def first_str_arg(call: ast.Call) -> Optional[str]:
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def keyword_arg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def literal_prefix(node: ast.AST) -> Optional[str]:
    """Best-effort leading literal text of a metric/family name expression:
    a Constant gives the whole name, an f-string or 'lit' + expr
    concatenation gives the constant prefix, anything else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        if node.values and isinstance(node.values[0], ast.Constant) \
                and isinstance(node.values[0].value, str):
            return node.values[0].value
        return ""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return literal_prefix(node.left)
    return None


def full_literal(node: ast.AST) -> Optional[str]:
    """The complete string value, only when statically known."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
