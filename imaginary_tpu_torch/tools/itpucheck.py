"""itpucheck — the project-invariant static analyzer (stdlib `ast` only).

Generic linters catch generic bugs; the invariants this service keeps
re-breaking are PROJECT invariants: a `time.sleep` in an async handler
hangs the event loop the supervisor probes, an unguarded
`future.set_exception` after a deadline cancellation kills the collector
thread, an owed-ms charge that leaks on an exception path latches the
admission gate shut. Each rule here encodes one of those bug classes as
an AST check with a file:line finding, so the next rewrite of the
concurrency-heavy code (continuous batching, multi-chip sharding) trips
the gate instead of a chaos soak much later.

It is the same analyzer as `imaginary_tpu.tools.itpucheck`: the same rule
ids, titles, messages and suppression grammar, run over
`imaginary_tpu_torch/`. The rules read the service's names as data (the
`imaginary_tpu_` metric namespace, the `IMAGINARY_TPU_*` env spellings),
which both packages share.

Unlike the ruff gate, this one has no "unavailable - SKIPPED" escape
hatch: it is part of the package, imports nothing third-party, and
`make check` always runs it.

Rules (one thin module per rule under tools/rules/):

  ITPU001  blocking call inside `async def` (event-loop hang class)
  ITPU002  future.set_result/set_exception without a done() guard or
           InvalidStateError handler (collector-crash class)
  ITPU003  ledger charge without a balancing release on failure paths
           (owed-ms/owed-mpix leak class)
  ITPU004  `except Exception: pass` / bare `except:` without an
           annotation naming why (silent-swallow class)
  ITPU005  config-surface consistency: flag <-> IMAGINARY_TPU_* env <->
           README, cross-checked from the parsed trees
  ITPU006  failpoint site names used in code <-> the declared SITES
           registry surfaced at /debugz/failpoints
  ITPU007  metrics exposition: imaginary_tpu_* namespace, counters end
           _total, every family carries HELP text
  ITPU008  pool submissions that carry a request must ride
           contextvars.copy_context() (trace/deadline/bomb-cap loss class)
  ITPU009  shm slot acquire without publish-or-abandon in a `finally`
           (locked-WRITING-slot leak class, the fleet-cache analogue of
           the ITPU003 ledger rule)
  ITPU010  sampled_reason literals and imaginary_tpu_slo_* metric names
           <-> their declared registries (SAMPLED_REASONS in
           obs/events.py, SLO_METRICS in obs/slo.py)
  ITPU011  lane ledger charges balance (per-lane owed accounting, the
           multi-chip analogue of ITPU003)
  ITPU012  tenant/op/route-derived metric label values route through
           the bounded-cardinality normalizer (normalize_label in
           obs/cost.py), and every literal label kind is declared in
           _LABEL_KINDS

Suppression grammar (same-line, or a standalone comment covering the
next code line); the reason is REQUIRED — a blanket suppression is
itself a finding (ITPU000):

    failpoints.hit("worker.hang")  # itpu: allow[ITPU001] deliberate sync block

Usage:

    python -m imaginary_tpu_torch.tools.itpucheck            # scan the package
    python -m imaginary_tpu_torch.tools.itpucheck --json     # + _build/itpucheck.json
    python -m imaginary_tpu_torch.tools.itpucheck path/ ...  # scan explicit paths

Exit status: 0 clean, 1 unsuppressed findings, 2 bad invocation.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
import sys
from typing import Optional

META_RULE = "ITPU000"  # the suppression grammar's own integrity rule

_SUPPRESS_RE = re.compile(
    r"#\s*itpu:\s*allow\[([A-Za-z0-9_,\s]*)\]\s*(.*)$")


@dataclasses.dataclass
class Finding:
    rule: str
    path: str  # root-relative
    line: int
    message: str
    suppressed: bool = False
    reason: str = ""

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{tag}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}


class Suppression:
    __slots__ = ("rules", "reason", "line", "covers", "used")

    def __init__(self, rules, reason, line, covers):
        self.rules = rules      # set of rule ids
        self.reason = reason
        self.line = line        # where the comment sits
        self.covers = covers    # the code line it applies to
        self.used = False


class SourceFile:
    """One parsed python file: text, AST, and its suppression table."""

    def __init__(self, path: str, rel: str):
        self.path = path
        self.rel = rel
        with open(path, "r", encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=path)
        self.suppressions: list = self._parse_suppressions()

    def _parse_suppressions(self) -> list:
        out = []
        for i, raw in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(raw)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            reason = m.group(2).strip()
            before = raw[: m.start()].strip()
            covers = i
            if not before:
                # standalone comment: covers the next code line
                for j in range(i + 1, len(self.lines) + 1):
                    s = self.lines[j - 1].strip()
                    if s and not s.startswith("#"):
                        covers = j
                        break
            out.append(Suppression(rules, reason, i, covers))
        return out

    def suppression_for(self, rule: str, line: int) -> Optional[Suppression]:
        for sup in self.suppressions:
            if line == sup.covers and rule in sup.rules:
                return sup
        return None


class TreeIndex:
    """The whole scanned tree, parsed once, plus the docs the cross-file
    rules check against (README.md at the root)."""

    def __init__(self, files: list, root: str):
        self.files = files
        self.root = root
        self._readme: Optional[str] = None

    def find(self, rel: str) -> Optional[SourceFile]:
        for sf in self.files:
            if sf.rel == rel or sf.rel.endswith("/" + rel):
                return sf
        return None

    def by_basename(self, basename: str) -> list:
        return [sf for sf in self.files
                if os.path.basename(sf.rel) == basename]

    def readme_text(self) -> str:
        if self._readme is None:
            path = os.path.join(self.root, "README.md")
            try:
                with open(path, "r", encoding="utf-8") as f:
                    self._readme = f.read()
            except OSError:
                self._readme = ""
        return self._readme


def _load_rules() -> list:
    from imaginary_tpu_torch.tools.rules import RULES

    return list(RULES)


def rule_table() -> dict:
    return {mod.RULE_ID: mod.TITLE for mod in _load_rules()}


# Scanned by default: the serving package. The analyzer's own tree is
# excluded — rule modules carry pattern fragments (env-var spellings,
# blocking-call names) as data, which would read as findings.
_DEFAULT_EXCLUDE_PARTS = {"tools", "__pycache__"}


def iter_py_files(paths: list) -> list:
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _DEFAULT_EXCLUDE_PARTS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return out


def default_paths() -> tuple:
    """(paths, root) for a bare invocation: the imaginary_tpu_torch package,
    rooted at the repo checkout that contains it."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [pkg], os.path.dirname(pkg)


# --json with no path writes into the package's gitignored build directory
DEFAULT_JSON = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build",
    "itpucheck.json")


def run_checks(paths: Optional[list] = None, root: Optional[str] = None,
               rules: Optional[list] = None) -> tuple:
    """Parse, run every rule, apply suppressions.

    Returns (findings, suppressed) — two lists of Finding. Syntax errors
    in scanned files surface as findings too (a tree the analyzer cannot
    parse is a tree the invariants cannot protect)."""
    if paths is None:
        paths, droot = default_paths()
        root = root or droot
    root = os.path.abspath(root or os.path.commonpath(
        [os.path.abspath(p) for p in paths]))
    files = []
    broken: list = []
    for path in iter_py_files(paths):
        rel = os.path.relpath(os.path.abspath(path), root)
        try:
            files.append(SourceFile(path, rel))
        except SyntaxError as e:
            broken.append(Finding(META_RULE, rel, e.lineno or 0,
                                  f"syntax error: {e.msg}"))
    index = TreeIndex(files, root)
    mods = _load_rules()
    if rules:
        wanted = set(rules)
        mods = [m for m in mods if m.RULE_ID in wanted]
    raw: list = []
    for mod in mods:
        for rel, line, message in mod.run(index):
            raw.append(Finding(mod.RULE_ID, rel, line, message))
    suppressed: list = []
    out: list = list(broken)
    by_rel = {sf.rel: sf for sf in files}
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        sf = by_rel.get(f.path)
        sup = sf.suppression_for(f.rule, f.line) if sf else None
        if sup is not None and sup.reason:
            sup.used = True
            f.suppressed = True
            f.reason = sup.reason
            suppressed.append(f)
        else:
            out.append(f)
    # suppression-grammar integrity: every annotation needs a reason and
    # real rule ids; these findings are themselves unsuppressable
    for sf in files:
        for sup in sf.suppressions:
            if not sup.reason:
                out.append(Finding(
                    META_RULE, sf.rel, sup.line,
                    "suppression without a reason — say WHY the invariant "
                    "does not apply here"))
            for rid in sup.rules:
                if not re.fullmatch(r"ITPU\d{3}", rid):
                    out.append(Finding(
                        META_RULE, sf.rel, sup.line,
                        f"suppression names unknown rule id {rid!r}"))
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out, suppressed


def to_json(findings: list, suppressed: list) -> dict:
    per_rule: dict = {}
    for f in findings:
        per_rule[f.rule] = per_rule.get(f.rule, 0) + 1
    return {
        "tool": "itpucheck",
        "version": 1,
        "rules": rule_table(),
        "counts": {
            "findings": len(findings),
            "suppressed": len(suppressed),
            "per_rule": per_rule,
        },
        "findings": [f.to_dict() for f in findings],
        "suppressed_findings": [
            dict(f.to_dict(), reason=f.reason) for f in suppressed],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="itpucheck",
        description="project-invariant static analyzer (stdlib ast, "
                    "always runs — no skip path)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to scan (default: the imaginary_tpu_torch "
                         "package)")
    ap.add_argument("--root", default=None,
                    help="tree root for relative paths and README.md "
                         "lookup (default: inferred)")
    ap.add_argument("--json", nargs="?", const=DEFAULT_JSON,
                    default=None, metavar="PATH",
                    help="also write machine-readable findings JSON "
                         "(default path: imaginary_tpu_torch/_build/"
                         "itpucheck.json)")
    ap.add_argument("--rules", default="",
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="findings only, no summary line")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, title in sorted(rule_table().items()):
            print(f"{rid}  {title}")
        return 0

    rules = [r.strip() for r in args.rules.split(",") if r.strip()] or None
    try:
        findings, suppressed = run_checks(
            paths=args.paths or None, root=args.root, rules=rules)
    except OSError as e:
        print(f"itpucheck: {e}", file=sys.stderr)
        return 2

    for f in findings:
        print(f.render())
    if args.json:
        path = args.json
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as fp:
            json.dump(to_json(findings, suppressed), fp, indent=2,
                      sort_keys=True)
            fp.write("\n")
    if not args.quiet:
        state = "FAIL" if findings else "OK"
        print(f"itpucheck: {state} — {len(findings)} finding(s), "
              f"{len(suppressed)} suppressed")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
