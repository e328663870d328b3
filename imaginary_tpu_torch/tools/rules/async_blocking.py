"""ITPU001 — blocking call inside an `async def`.

The hung-worker bug class: a synchronous block on the event loop
wedges EVERY request the worker owns, including the /health probe the
supervisor uses to decide the worker is alive — "process alive, loop
wedged" is the failure the liveness probe exists to catch, and one
`time.sleep` (or a sync failpoint, or a blocking urllib fetch) in a
handler creates it. Offload to asyncio.to_thread / the pool, or use the
async counterpart (`failpoints.ahit`, `asyncio.sleep`).
"""

from __future__ import annotations

import ast

from imaginary_tpu_torch.tools import astutil

RULE_ID = "ITPU001"
TITLE = "blocking call inside async def (event-loop hang)"

# dotted call name -> what to use instead
BLOCKING_CALLS = {
    "time.sleep": "asyncio.sleep",
    "failpoints.hit": "failpoints.ahit",
    "subprocess.run": "asyncio.create_subprocess_exec",
    "subprocess.call": "asyncio.create_subprocess_exec",
    "subprocess.check_call": "asyncio.create_subprocess_exec",
    "subprocess.check_output": "asyncio.create_subprocess_exec",
    "urllib.request.urlopen": "an executor thread (asyncio.to_thread)",
    "socket.create_connection": "asyncio.open_connection",
    "open": "asyncio.to_thread around the file read",
}

# blocking METHODS on sockets/files reached through any receiver; method
# names chosen to be unambiguous (plain `.read()` would false-positive on
# aiohttp's awaited coroutines, so it is not in this set)
BLOCKING_METHODS = {
    "recv", "recv_into", "sendall", "accept", "makefile",
}


def run(index):
    for sf in index.files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            for inner in astutil.walk_function_body(node):
                if not isinstance(inner, ast.Call):
                    continue
                name = astutil.call_name(inner)
                if name in BLOCKING_CALLS:
                    yield (sf.rel, inner.lineno,
                           f"blocking `{name}()` inside `async def "
                           f"{node.name}` wedges the event loop; use "
                           f"{BLOCKING_CALLS[name]}")
                elif (isinstance(inner.func, ast.Attribute)
                      and inner.func.attr in BLOCKING_METHODS):
                    yield (sf.rel, inner.lineno,
                           f"blocking `.{inner.func.attr}()` inside "
                           f"`async def {node.name}` wedges the event "
                           "loop; use the asyncio stream/thread APIs")
