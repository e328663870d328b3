"""ITPU012 — tenant/op/route metric labels ride the cardinality normalizer.

/metrics label values derived from tenant, op, or route identifiers are
unbounded input: a fleet minting API keys (or a client spraying paths)
can grow a label set until the exposition — and every scraper behind it
— falls over. obs/cost.py owns the bounded-cardinality normalizer
(`normalize_label`, backed by the top-K space-saving sketch; identity
when cost attribution is off), so the invariant is mechanical and
checked in both directions:

  * direction 1: every f-string label fragment in a metrics.py that
    writes a guarded key (`tenant="`, `op="`, `route="`) must fill the
    value from a normalize_label() call chain — inline, or via a
    variable assigned from one;
  * direction 2: every normalize_label()/plane.normalize() call site
    with a literal kind must name a kind declared in _LABEL_KINDS
    (obs/cost.py) — an undeclared kind raises at runtime, on the
    metrics-render path.
"""

from __future__ import annotations

import ast
import re

from imaginary_tpu_torch.tools import astutil

RULE_ID = "ITPU012"
TITLE = "tenant/op/route metric label bypasses the cardinality normalizer"

# Label keys whose values derive from unbounded identifiers. `class=`
# (the fixed qos class set), `lane=`/`device=`/`stage=` (small bounded
# enums) stay unguarded on purpose.
_GUARDED_KEYS = ("tenant", "op", "route")

_KEY_RE = re.compile(r'(?:^|[,{])(' + "|".join(_GUARDED_KEYS) + r')="$')

_NORMALIZER = "normalize_label"


def _label_kinds(index):
    """(declared kinds, cost.py SourceFile) from obs/cost.py, or
    (None, None) on a partial scan without the registry module."""
    for sf in index.by_basename("cost.py"):
        for node in sf.tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, (ast.Tuple, ast.List)):
                targets = [t.id for t in node.targets
                           if isinstance(t, ast.Name)]
                if "_LABEL_KINDS" in targets:
                    kinds = {e.value for e in node.value.elts
                             if isinstance(e, ast.Constant)
                             and isinstance(e.value, str)}
                    return kinds, sf
    return None, None


def _is_normalizer_call(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = astutil.call_name(node) or ""
    return name == _NORMALIZER or name.endswith("." + _NORMALIZER)


def _normalized_names(sf) -> set:
    """Variable names assigned (anywhere in the file) from an expression
    that routes through normalize_label — e.g.
    `rlab = escape_label_value(normalize_label("route", route))`."""
    out: set = set()
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Assign):
            continue
        if any(_is_normalizer_call(sub) for sub in ast.walk(node.value)):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name))
    return out


def run(index):
    kinds, cost_sf = _label_kinds(index)

    # direction 1: guarded f-string label fragments in metrics renderers
    for sf in index.by_basename("metrics.py"):
        normalized = _normalized_names(sf)
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.JoinedStr):
                continue
            values = node.values
            for i, part in enumerate(values):
                if not (isinstance(part, ast.Constant)
                        and isinstance(part.value, str)):
                    continue
                m = _KEY_RE.search(part.value)
                if m is None or i + 1 >= len(values):
                    continue
                filler = values[i + 1]
                if not isinstance(filler, ast.FormattedValue):
                    continue
                ok = any(_is_normalizer_call(sub)
                         for sub in ast.walk(filler.value))
                if not ok and isinstance(filler.value, ast.Name):
                    ok = filler.value.id in normalized
                if not ok:
                    yield (sf.rel, node.lineno,
                           f"`{m.group(1)}=` label value does not route "
                           f"through {_NORMALIZER}() (obs/cost.py) — an "
                           "unbounded identifier becomes unbounded "
                           "metric cardinality")
                if ok and kinds is None:
                    yield (sf.rel, node.lineno,
                           f"{_NORMALIZER}() used but obs/cost.py "
                           "declares no _LABEL_KINDS registry — the "
                           "normalizer contract has no owner")

    # direction 2: literal kinds at normalizer call sites are declared
    for sf in index.files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = astutil.call_name(node) or ""
            is_norm = name == _NORMALIZER \
                or name.endswith("." + _NORMALIZER) \
                or name.endswith(".normalize")
            if not is_norm:
                continue
            kind = astutil.first_str_arg(node)
            if kind is None:
                continue
            if kinds is None:
                if name.endswith(".normalize"):
                    continue  # unrelated .normalize() on a partial scan
                yield (sf.rel, node.lineno,
                       f"{_NORMALIZER}({kind!r}, …) but no _LABEL_KINDS "
                       "registry found in obs/cost.py — partial tree or "
                       "deleted normalizer")
                continue
            if kind not in kinds:
                yield (sf.rel, node.lineno,
                       f"label kind {kind!r} is not declared in "
                       "_LABEL_KINDS (obs/cost.py) — this raises "
                       "ValueError on the metrics-render path")
