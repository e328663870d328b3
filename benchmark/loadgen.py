"""The load generator: one asyncio loop in one thread, HTTP/1.1 over
keep-alive connections to 127.0.0.1.

A traffic mix (`benchmark/traffic/<name>.json`) says:

- `routes`: [{"path": "/resize?width=300&height=200", "weight": 1}, ...];
- `loop`: "closed" with `clients` (each sends its next request when its
  last is answered), or "open" with `rate` (requests a second, Poisson
  arrivals on a fixed schedule);
- `pool`: how many distinct source images the run makes;
- `warmup_s`: seconds of the same load before the window.

Every seed gets the same work in another order: the same count of each
route, the same set of inter-arrival gaps (exponential quantiles), the
same images; the seed shuffles them.
"""

from __future__ import annotations

import asyncio
import dataclasses
import math
import time

import numpy as np

CONNECT_TIMEOUT_S = 10.0
REQUEST_TIMEOUT_S = 120.0  # an answer later than this counts as none


@dataclasses.dataclass
class Record:
    """One request: what was sent and when, and what came back."""

    route: int  # index into the mix's routes
    image: int  # index into the pool
    due: float  # perf_counter seconds: when the schedule wanted it sent
    sent: float = math.nan
    done: float = math.nan
    status: int = 0  # 0: no answer
    content_type: str = ""
    body: bytes = b""
    error: str = ""

    @property
    def ok(self) -> bool:
        return self.status == 200 and self.content_type.startswith("image/")

    @property
    def latency_s(self) -> float:
        """From due to answered; infinite for a request that failed."""
        return self.done - self.due if self.ok else math.inf


def percentile(values: list, p: float) -> float:
    """Nearest-rank percentile: the smallest value with p % at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


def route_sequence(traffic: dict, n: int, pool: int, rng: np.random.Generator) -> list:
    """n (route, image) pairs: routes in proportion to their weights and
    images in equal shares, each list shuffled by the seed."""
    weights = np.array([r.get("weight", 1) for r in traffic["routes"]], dtype=np.float64)
    counts = np.floor(weights / weights.sum() * n).astype(int)
    counts[: n - counts.sum()] += 1
    routes = np.repeat(np.arange(len(weights)), counts)
    images = np.arange(n) % pool
    rng.shuffle(routes)
    rng.shuffle(images)
    return list(zip(routes.tolist(), images.tolist()))


def poisson_gaps(rate: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """n inter-arrival gaps of a Poisson process at `rate`: the
    exponential distribution's n mid-quantiles, in the seed's order."""
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng.shuffle(gaps)
    return gaps


class Client:
    """HTTP/1.1 on one keep-alive connection."""

    def __init__(self, port: int):
        self.port = port
        self.reader = self.writer = None

    async def _connect(self):
        self.reader, self.writer = await asyncio.wait_for(
            asyncio.open_connection("127.0.0.1", self.port), CONNECT_TIMEOUT_S)

    async def close(self):
        if self.writer is not None:
            self.writer.close()
            try:
                await self.writer.wait_closed()
            except OSError:
                pass
            self.writer = None

    async def post(self, path: str, body: bytes, content_type: str) -> tuple:
        """(status, content type, body)."""
        if self.writer is None:
            await self._connect()
        head = (f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1:{self.port}\r\n"
                f"Content-Type: {content_type}\r\nContent-Length: {len(body)}\r\n\r\n")
        try:
            self.writer.write(head.encode() + body)
            await self.writer.drain()
            status_line = await self.reader.readuntil(b"\r\n")
            status = int(status_line.split()[1])
            headers = {}
            while True:
                line = await self.reader.readuntil(b"\r\n")
                if line == b"\r\n":
                    break
                k, _, v = line.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            payload = await self.reader.readexactly(int(headers.get("content-length", 0)))
            if headers.get("connection", "").lower() == "close":
                await self.close()
            return status, headers.get("content-type", ""), payload
        except BaseException:
            await self.close()
            raise


async def _send(client: Client, rec: Record, path: str, body: bytes, ctype: str,
                keep_body: bool, timeout_s: float = REQUEST_TIMEOUT_S) -> None:
    rec.sent = time.perf_counter()
    try:
        rec.status, rec.content_type, payload = await asyncio.wait_for(
            client.post(path, body, ctype), timeout_s)
        if keep_body:
            rec.body = payload
    except (OSError, asyncio.IncompleteReadError, asyncio.LimitOverrunError,
            asyncio.TimeoutError, ValueError, IndexError) as e:
        rec.error = f"{type(e).__name__}: {e}"
    rec.done = time.perf_counter()


async def closed_loop(port: int, paths: list, images: list, ctype: str, clients: int,
                      seq: list, t0: float, seconds: float, keep_body: bool) -> list:
    """Each client sends the sequence's next request until t0 + seconds;
    a request sent before then is waited for. `seq` must outlast the
    window (it is cycled otherwise)."""
    records: list = []
    it = iter(range(10 ** 12))

    async def one(client: Client):
        while time.perf_counter() < t0 + seconds:
            route, image = seq[next(it) % len(seq)]
            rec = Record(route, image, due=time.perf_counter())
            records.append(rec)
            await _send(client, rec, paths[route], images[image], ctype, keep_body)

    pool = [Client(port) for _ in range(clients)]
    while time.perf_counter() < t0:
        await asyncio.sleep(min(0.01, t0 - time.perf_counter()))
    try:
        await asyncio.gather(*(one(c) for c in pool))
    finally:
        await asyncio.gather(*(c.close() for c in pool))
    return records


async def open_loop(port: int, paths: list, images: list, ctype: str, seq: list,
                    gaps: np.ndarray, t0: float, keep_body: bool, grace_s: float) -> list:
    """Request i is due at t0 + the sum of the first i gaps and sent then
    on an idle connection (a new one when none is idle); every request is
    waited for until grace_s after the last is due."""
    due = t0 + np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    idle: list = []
    records, tasks = [], []

    async def one(rec: Record):
        client = idle.pop() if idle else Client(port)
        await _send(client, rec, paths[rec.route], images[rec.image], ctype, keep_body)
        if client.writer is not None:
            idle.append(client)

    for (route, image), t in zip(seq, due):
        delay = t - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        rec = Record(route, image, due=float(t))
        records.append(rec)
        tasks.append(asyncio.ensure_future(one(rec)))
    _, pending = await asyncio.wait(tasks, timeout=max(0.0, due[-1] + grace_s
                                                       - time.perf_counter()))
    for task in pending:
        task.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    for rec in records:
        if math.isnan(rec.done):
            rec.error = rec.error or "no answer within the grace after the window"
    await asyncio.gather(*(c.close() for c in idle))
    return records
