"""ITPU006 — failpoint sites used in code <-> the declared registry.

`failpoints.hit("typo.site")` is a silent no-op: parse() rejects unknown
sites when ARMING, but a hit() on a name nobody can arm is dead chaos
coverage that looks alive in the source. The inverse — a SITES entry no
code path hits — is a /debugz/failpoints row operators can arm that
fires nothing. Both directions are drift between the registry the chaos
harness surfaces and the sites the code actually exercises.
"""

from __future__ import annotations

import ast

from imaginary_tpu_torch.tools import astutil

RULE_ID = "ITPU006"
TITLE = "failpoint site not in the declared SITES registry (or unused)"

_HIT_NAMES = {"hit", "ahit"}


def _declared_sites(sf):
    """(sites, lineno) from a `SITES = ("a", ...)` assignment."""
    for node in sf.tree.body:
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets
                       if isinstance(t, ast.Name)]
            if "SITES" in targets and isinstance(
                    node.value, (ast.Tuple, ast.List)):
                vals = [e.value for e in node.value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)]
                return vals, node.lineno
    return None, 0


def run(index):
    registry = None
    for sf in index.by_basename("failpoints.py"):
        sites, line = _declared_sites(sf)
        if sites is not None:
            registry = (sf, set(sites), line)
            break
    if registry is None:
        return  # nothing to check against (partial tree)
    reg_sf, declared, reg_line = registry
    used: dict = {}  # site -> first (sf.rel, line)
    for sf in index.files:
        if sf is reg_sf:
            continue
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _HIT_NAMES
                    and (astutil.dotted_name(node.func.value) or "")
                    .split(".")[-1] == "failpoints"):
                continue
            site = astutil.first_str_arg(node)
            if site is None:
                continue
            used.setdefault(site, (sf.rel, node.lineno))
            if site not in declared:
                yield (sf.rel, node.lineno,
                       f"failpoint site `{site}` is not declared in the "
                       "SITES registry — it can never be armed "
                       "(IMAGINARY_TPU_FAILPOINTS/PUT /debugz/failpoints "
                       "reject unknown sites)")
    for site in sorted(declared - set(used)):
        yield (reg_sf.rel, reg_line,
               f"declared failpoint site `{site}` is never hit anywhere "
               "in the tree — dead chaos coverage in the "
               "/debugz/failpoints registry")
