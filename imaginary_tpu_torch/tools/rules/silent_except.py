"""ITPU004 — silent exception swallowing needs a named reason.

`except Exception: pass` hides real faults (a ledger leak, a codec bug, a
dead backend) behind "best effort"; bare `except:` additionally eats
KeyboardInterrupt/SystemExit and can make a worker unkillable. Sites
where swallowing IS the contract (a fallback chain, a best-effort
diagnostic) must say so with `# itpu: allow[ITPU004] <reason>` — the
reason is the review record for why silence is safe HERE.
"""

from __future__ import annotations

import ast

RULE_ID = "ITPU004"
TITLE = "except Exception: pass / bare except without a reason"

_BROAD = {"Exception", "BaseException"}


def _is_pass_only(handler: ast.ExceptHandler) -> bool:
    return len(handler.body) == 1 and isinstance(handler.body[0], ast.Pass)


def run(index):
    for sf in index.files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield (sf.rel, node.lineno,
                       "bare `except:` also catches KeyboardInterrupt/"
                       "SystemExit — name the exception (at least "
                       "`except Exception`)")
                continue
            if isinstance(node.type, ast.Name) and node.type.id in _BROAD \
                    and _is_pass_only(node):
                yield (sf.rel, node.lineno,
                       f"`except {node.type.id}: pass` swallows every "
                       "fault silently — narrow the exception, handle "
                       "it, or annotate why silence is safe")
