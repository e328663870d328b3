"""ITPU014 — every outbound peer HTTP call carries an explicit timeout.

A cross-host hop with no timeout inherits the socket default (often
infinite): one wedged peer then pins a gossip thread, a scrape pool
slot, or a request's whole remaining deadline. Every urlopen / session
get/post/request in this tree must pass ``timeout=`` explicitly —
derived from the request deadline (fleet/router.py), the peer-probe
constant (fleet/multihost.py), or the scrape budget (obs/aggregate.py).
``timeout=None`` is the same bug spelled honestly, and trips too.
"""

from __future__ import annotations

import ast

from imaginary_tpu_torch.tools import astutil

RULE_ID = "ITPU014"
TITLE = "outbound peer HTTP call without an explicit bounded timeout"

# attribute spellings that perform an HTTP round trip on a client/session
# object (urllib.request.urlopen, aiohttp/requests session.get/post/...)
_VERBS = {"get", "post", "request"}


def _is_http_call(node: ast.Call) -> bool:
    name = astutil.call_name(node) or ""
    if name.split(".")[-1] == "urlopen":
        return True
    if isinstance(node.func, ast.Attribute) and node.func.attr in _VERBS:
        recv = (astutil.dotted_name(node.func.value) or "").lower()
        # receiver must look like an HTTP client: a bare obj.get() on a
        # dict/cache must not trip (the rule is about sockets, not maps)
        return "session" in recv or recv.endswith("aiohttp")
    return False


def run(index):
    for sf in index.files:
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call) and _is_http_call(node)):
                continue
            kw = astutil.keyword_arg(node, "timeout")
            if kw is None:
                yield (sf.rel, node.lineno,
                       "outbound HTTP call without an explicit timeout= "
                       "— a wedged peer pins this caller forever; bound "
                       "it with the request deadline's remaining_s(), "
                       "the peer-probe constant, or the scrape budget")
            elif isinstance(kw, ast.Constant) and kw.value is None:
                yield (sf.rel, node.lineno,
                       "timeout=None on an outbound HTTP call is an "
                       "explicit unbounded wait — pass a finite budget "
                       "derived from the deadline or a probe constant")
