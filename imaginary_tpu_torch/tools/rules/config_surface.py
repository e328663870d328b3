"""ITPU005 — config-surface consistency: flag <-> env <-> README.

Three surfaces describe one knob: the argparse flag, its
`IMAGINARY_TPU_*` env override, and the README. They drift — a flag
gains an env read under a historical name, a new env var never reaches
the docs, a flag ships undocumented — and every drift is an operator
who cannot find or script the knob. Cross-checked from the parsed
trees:

  * every `add_argument("--x")` must read its CANONICAL env
    (`IMAGINARY_TPU_X`, dashes -> underscores, upper) somewhere in the
    call (the `default=` expression), so flags are always scriptable
    without a wrapper;
  * every long flag must appear in README.md;
  * every `IMAGINARY_TPU_*` string literal in the tree must appear in
    README.md.

Meta-flags that terminate the process before serving (--version) are
exempt. Historical env spellings (IMAGINARY_TPU_DEBUG for
--enable-debug) carry an explicit allow annotation instead of a rename
— renaming a deployed env var breaks fleets for tidiness.
"""

from __future__ import annotations

import ast
import re

from imaginary_tpu_torch.tools import astutil

RULE_ID = "ITPU005"
TITLE = "flag/env/README config-surface drift"

EXEMPT_FLAGS = {"--version", "--help"}
_ENV_RE = re.compile(r"^IMAGINARY_TPU_[A-Z0-9_]+$")


def canonical_env(flag: str) -> str:
    return "IMAGINARY_TPU_" + flag.lstrip("-").replace("-", "_").upper()


def _flag_of(call: ast.Call):
    for a in call.args:
        if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                and a.value.startswith("--"):
            return a.value
    return None


def run(index):
    readme = index.readme_text()
    for sf in index.files:
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_argument"):
                continue
            flag = _flag_of(node)
            if flag is None or flag in EXEMPT_FLAGS:
                continue
            env = canonical_env(flag)
            literals = {v for v, _ in astutil.string_constants(node)}
            if env not in literals:
                yield (sf.rel, node.lineno,
                       f"flag `{flag}` does not read its canonical env "
                       f"override `{env}` in its default= — every knob "
                       "must be scriptable without a wrapper")
            if flag not in readme:
                yield (sf.rel, node.lineno,
                       f"flag `{flag}` is not mentioned in README.md — "
                       "undocumented knobs don't exist for operators")
        # every env literal anywhere must reach the docs
        for value, line in astutil.string_constants(sf.tree):
            if _ENV_RE.match(value) and value not in readme:
                yield (sf.rel, line,
                       f"env var `{value}` is not mentioned in README.md")
