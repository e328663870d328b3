"""ITPU010 — sampled_reason literals and SLO metric names <-> registries.

The tail-sampling verdicts (`sampled_reason`) and the SLO metric family
names are string protocol between layers: obs/events.classify mints the
verdicts, the middleware/bench/docs compare against them, and
web/metrics.py renders the imaginary_tpu_slo_* families the README and
dashboards name. A typo'd literal on either side is silent drift — a
comparison that never matches, a metric the docs promise that nothing
emits. Same shape as ITPU006 (failpoint sites): a declared registry in
the owning module, every use-site cross-checked against it, both
directions (undeclared-used AND declared-unused) are findings.
"""

from __future__ import annotations

import ast

RULE_ID = "ITPU010"
TITLE = "sampled_reason / SLO metric literal not in its declared registry"

_SLO_PREFIX = "imaginary_tpu_slo_"


def _declared_tuple(sf, var_name):
    """(values, lineno) from a top-level `VAR = ("a", ...)` assignment."""
    if sf is None:
        return None, 0
    for node in sf.tree.body:
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets
                       if isinstance(t, ast.Name)]
            if var_name in targets and isinstance(
                    node.value, (ast.Tuple, ast.List)):
                vals = [e.value for e in node.value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)]
                return vals, node.lineno
    return None, 0


def _find_module(index, basename, var_name):
    for sf in index.by_basename(basename):
        vals, line = _declared_tuple(sf, var_name)
        if vals is not None:
            return sf, set(vals), line
    return None, None, 0


def _mentions_sampled_reason(node) -> bool:
    """Does this expression reference the sampled_reason field — as a
    dict subscript (event["sampled_reason"]), attribute, or variable?"""
    if isinstance(node, ast.Subscript):
        sl = node.slice
        return isinstance(sl, ast.Constant) and sl.value == "sampled_reason"
    if isinstance(node, ast.Attribute):
        return node.attr == "sampled_reason"
    if isinstance(node, ast.Name):
        return node.id == "sampled_reason"
    if isinstance(node, ast.Call):
        # event.get("sampled_reason")
        return (isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and any(isinstance(a, ast.Constant)
                        and a.value == "sampled_reason"
                        for a in node.args))
    return False


def _classify_returns(sf):
    """str constants returned by classify() in the registry module."""
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.FunctionDef) and node.name == "classify":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Return) \
                        and isinstance(sub.value, ast.Constant) \
                        and isinstance(sub.value.value, str):
                    yield sub.value.value, sub.lineno
            return


def run(index):
    ev_sf, reasons, ev_line = _find_module(
        index, "events.py", "SAMPLED_REASONS")
    slo_sf, slo_metrics, slo_line = _find_module(
        index, "slo.py", "SLO_METRICS")

    used_reasons: set = set()
    if ev_sf is not None:
        # direction 1a: every verdict classify() can mint is declared
        for value, lineno in _classify_returns(ev_sf):
            used_reasons.add(value)
            if value not in reasons:
                yield (ev_sf.rel, lineno,
                       f"classify() returns `{value}`, which is not "
                       "declared in SAMPLED_REASONS — consumers comparing "
                       "against the registry will never see it")
        # direction 1b: every literal COMPARED against sampled_reason
        # anywhere in the tree is a declared verdict
        for sf in index.files:
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Compare):
                    continue
                sides = [node.left] + list(node.comparators)
                if not any(_mentions_sampled_reason(s) for s in sides):
                    continue
                for s in sides:
                    if isinstance(s, ast.Constant) \
                            and isinstance(s.value, str):
                        used_reasons.add(s.value)
                        if s.value not in reasons:
                            yield (sf.rel, node.lineno,
                                   f"compares sampled_reason against "
                                   f"`{s.value}`, which classify() can "
                                   "never return (not in "
                                   "SAMPLED_REASONS) — dead branch")
        # direction 1c: a declared verdict nothing mints or checks is
        # registry rot
        for value in sorted(reasons - used_reasons):
            yield (ev_sf.rel, ev_line,
                   f"declared sampled_reason `{value}` is never returned "
                   "by classify() nor compared against anywhere — stale "
                   "registry entry")

    if slo_sf is not None:
        used_metrics: set = set()
        # direction 2a: every imaginary_tpu_slo_* literal outside the
        # registry module is a declared family name
        for sf in index.files:
            if sf is slo_sf:
                continue
            for node in ast.walk(sf.tree):
                if not (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)
                        and node.value.startswith(_SLO_PREFIX)):
                    continue
                used_metrics.add(node.value)
                if node.value not in slo_metrics:
                    yield (sf.rel, node.lineno,
                           f"SLO metric name `{node.value}` is not "
                           "declared in SLO_METRICS (obs/slo.py) — "
                           "the docs/dashboards and the exposition "
                           "will drift")
        # direction 2b: a declared family nothing renders is a metric
        # the README promises that never exists
        for name in sorted(slo_metrics - used_metrics):
            yield (slo_sf.rel, slo_line,
                   f"declared SLO metric `{name}` is never rendered "
                   "anywhere in the tree — stale registry entry")
