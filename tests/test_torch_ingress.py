"""The port's --read-timeout guard (imaginary_tpu_torch/web/ingress.py)
against the reference's (`tests/test_fleet.py::TestReadTimeoutGuard`).

The guard's cases run on a bare protocol behind it: a stalled header
read and a stalled body are closed and counted, a flowing slow body and
an idle keep-alive connection live. Then the port's server with
`read_timeout_s` set, on the CPU: a slowloris connection is closed and
counted in /health's `ingress` block (the reference's keys) and in
/metrics' imaginary_tpu_ingress_read_timeouts_total, while a request on
another connection is served; with the guard off there is no block.
"""

from __future__ import annotations

import asyncio
import json
import socket
import threading
import time
import urllib.request

import pytest

from imaginary_tpu_torch.web.config import ServerOptions


class _Echo(asyncio.Protocol):
    """A minimal inner protocol that never answers."""

    def connection_made(self, transport):
        self.transport = transport

    def data_received(self, data):
        pass

    def connection_lost(self, exc):
        pass

    def eof_received(self):
        return False


def _guarded(timeout_s: float):
    from imaginary_tpu_torch.web.ingress import IngressStats, ReadTimeoutGuard

    stats = IngressStats()

    async def start():
        loop = asyncio.get_running_loop()
        server = await loop.create_server(
            lambda: ReadTimeoutGuard(_Echo(), timeout_s, stats=stats), "127.0.0.1", 0)
        return server, server.sockets[0].getsockname()[1]

    return stats, start


# (id, what the client sends, seconds it then waits, closed by the guard)
CASES = [
    ("stalled-header", [b"POST /resize HTTP/1.1\r\nHost: x\r\n"], 0.0, True),
    ("stalled-body", [b"POST /x HTTP/1.1\r\nHost: x\r\nContent-Length: 1000\r\n\r\n"
                      b"only-a-little"], 0.0, True),
    ("flowing-slow-body", [b"POST /x HTTP/1.1\r\nHost: x\r\nContent-Length: 50\r\n\r\n"]
     + [b"AAAAA"] * 10, 0.9, False),
    ("idle-keepalive", [b"GET / HTTP/1.1\r\nHost: x\r\n\r\n"], 0.9, False),
]


@pytest.mark.parametrize("case,chunks,wait_s,closed", CASES, ids=[c[0] for c in CASES])
def test_guard_cases_match_the_reference(case, chunks, wait_s, closed):
    """Each case behaves as under the reference's guard: the same bytes,
    the same timeout, the same outcome and count."""
    from imaginary_tpu.web.ingress import IngressStats as RefStats
    from imaginary_tpu.web.ingress import ReadTimeoutGuard as RefGuard

    def drive(start):
        async def fn():
            server, port = await start()
            try:
                r, w = await asyncio.open_connection("127.0.0.1", port)
                for i, chunk in enumerate(chunks):
                    w.write(chunk)
                    await w.drain()
                    if i and len(chunks) > 2:  # a trickle under the deadline
                        await asyncio.sleep(0.1)
                if closed:
                    got = await asyncio.wait_for(r.read(), timeout=3.0)
                    assert got == b""  # the server closed on us
                else:
                    await asyncio.sleep(wait_s)
                    assert not w.transport.is_closing()
                    w.close()
            finally:
                server.close()
                await server.wait_closed()

        asyncio.run(fn())

    timeout_s = 0.4 if case == "flowing-slow-body" else 0.3
    stats, start = _guarded(timeout_s)
    drive(start)
    ref_stats = RefStats()

    async def ref_start():
        loop = asyncio.get_running_loop()
        server = await loop.create_server(
            lambda: RefGuard(_Echo(), timeout_s, stats=ref_stats), "127.0.0.1", 0)
        return server, server.sockets[0].getsockname()[1]

    drive(ref_start)
    assert stats.to_dict() == ref_stats.to_dict()
    assert stats.read_timeouts == int(closed)
    assert stats.guarded_connections == 1


def test_read_timeout_off_by_default():
    assert ServerOptions().read_timeout_s == 0.0


def _health(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as r:
        return json.loads(r.read())


def _serving(**options):
    from imaginary_tpu_torch.web.app import make_server

    srv = make_server("127.0.0.1", 0, device="cpu", **options)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()

    def stop():
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)

    return srv.server_address[1], stop


def test_server_closes_slowloris_and_counts_it(testdata):
    from imaginary_tpu.web.ingress import IngressStats as RefStats

    from imaginary_tpu_torch.web.ingress import STATS

    port, stop = _serving(read_timeout_s=0.5, mount=testdata)
    try:
        before = _health(port)["ingress"]
        assert set(before) == set(RefStats().to_dict())
        sl = socket.create_connection(("127.0.0.1", port), 5)
        sl.sendall(b"GET /health HTTP/1.1\r\nHost: x\r\n")  # never finished
        sl.settimeout(5.0)
        t0 = time.monotonic()
        assert sl.recv(4096) == b""  # closed on us
        assert 0.4 <= time.monotonic() - t0 < 3.0
        sl.close()
        # a request on another connection is served, and the close counted
        url = f"http://127.0.0.1:{port}/resize?width=100&file=imaginary.jpg"
        with urllib.request.urlopen(url, timeout=60) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "image/jpeg"
        after = _health(port)["ingress"]
        assert after["read_timeouts"] == before["read_timeouts"] + 1
        assert after["read_timeouts"] == STATS.to_dict()["read_timeouts"]
        assert after["guarded_connections"] >= before["guarded_connections"] + 2
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            text = r.read().decode()
        assert "# TYPE imaginary_tpu_ingress_read_timeouts_total counter" in text
        assert f"imaginary_tpu_ingress_read_timeouts_total {after['read_timeouts']}" in text
    finally:
        stop()


def test_no_ingress_block_without_the_guard():
    port, stop = _serving()
    try:
        assert "ingress" not in _health(port)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            assert "imaginary_tpu_ingress_" not in r.read().decode()
    finally:
        stop()
