"""ITPU007 — metrics exposition stays strict (the exposition contract).

/metrics is format-0.0.4-strict and promtool-parseable; the runtime
parser test (tests/test_obs.py) catches malformed OUTPUT, but only for
families the test run happens to emit. This rule checks the EMIT CALLS
in web/metrics.py statically, so a family added behind a flag the suite
never flips still obeys the contract:

  * family names live in the `imaginary_tpu_` namespace (statically
    checkable down to the literal prefix of f-string names);
  * counters end `_total` (checked when both the full name and the
    mtype are literals);
  * every family carries HELP text (the `help_text=` argument).
"""

from __future__ import annotations

import ast

from imaginary_tpu_torch.tools import astutil

RULE_ID = "ITPU007"
TITLE = "metrics family off-namespace, counter without _total, or no HELP"

NAMESPACE = "imaginary_tpu_"


def run(index):
    for sf in index.by_basename("metrics.py"):
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "emit"
                    and node.args):
                continue
            name_arg = node.args[0]
            prefix = astutil.literal_prefix(name_arg)
            if prefix is not None and not prefix.startswith(NAMESPACE):
                yield (sf.rel, node.lineno,
                       f"metric family `{prefix}…` is outside the "
                       f"`{NAMESPACE}*` namespace")
            full = astutil.full_literal(name_arg)
            mtype = node.args[3] if len(node.args) > 3 else \
                astutil.keyword_arg(node, "mtype")
            mtype_lit = astutil.full_literal(mtype) if mtype is not None \
                else "gauge"
            if full is not None and mtype_lit == "counter" \
                    and not full.endswith("_total"):
                yield (sf.rel, node.lineno,
                       f"counter family `{full}` must end `_total` "
                       "(Prometheus counter naming; sum(rate()) "
                       "dashboards key on it)")
            help_arg = node.args[4] if len(node.args) > 4 else \
                astutil.keyword_arg(node, "help_text")
            if help_arg is None or astutil.full_literal(help_arg) == "":
                yield (sf.rel, node.lineno,
                       "metric emitted without help_text — every family "
                       "needs a `# HELP` line (strict exposition)")
