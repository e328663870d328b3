"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It boots the port (`python -m
imaginary_tpu_torch`) on 127.0.0.1 on the card, makes the cell's inputs
from the seed, warms the cell's own routes under the cell's own load,
drives the window from its own load generator, stops the server, judges a
seeded sample of the answers against the plain reference
(`benchmark/ops`, `benchmark/judges/`), and prints one JSON line: the
cell's end-to-end metrics (`--trace 0`) or its per-layer metrics read
from the server's counters and a torch.profiler capture of part of the
window (`--trace 1`). Exit 0 only with a result; a host without a card
gets none.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import io  # noqa: E402
import urllib.parse  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import numpy as np  # noqa: E402

from benchmark import inputs, loadgen, server, spec, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "imaginary_tpu")  # top-level module names
BOOT_TIMEOUT_S = 600.0
FIRST_REQUEST_TIMEOUT_S = 900.0  # the first run in a checkout builds the kernels
OPEN_LOOP_GRACE_S = 60.0
SEQUENCE = 200_000  # closed-loop requests drawn per run: more than any window sends
JUDGE_THREADS = 4
CONTENT_TYPES = {"jpeg": "image/jpeg"}
OUT_ROOT = os.path.join(spec.HERE, "_out")  # server logs, the memory readings, the trace


class NoResult(Exception):
    """A run that must end without a result line."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card(chips: int) -> dict:
    """The `device` of the result, or NoResult without enough cards."""
    import torch

    if not torch.cuda.is_available():
        raise NoResult("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoResult(f"the cell needs {chips} cards, torch sees "
                       f"{torch.cuda.device_count()}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


@dataclasses.dataclass
class Window:
    """What a metric reader reads (`benchmark/metrics/<name>.py`)."""

    cell: str
    loop: str  # "closed" or "open"
    seconds: float
    t0: float  # perf_counter at the window's start
    records: list  # loadgen.Record of every request of the window
    routes: list  # per route: (operation, query, geometry, work)
    metrics_before: dict
    metrics_after: dict
    cpu_s: float  # the server's CPU seconds over the window's requests
    setup_s: float
    capture: dict = None  # trace.summarize of the profiler capture, with its requests

    def ok(self) -> list:
        return [r for r in self.records if r.ok]

    def delta(self, name: str, **labels) -> float:
        key = (name, tuple(sorted(labels.items())))
        return self.metrics_after.get(key, 0.0) - self.metrics_before.get(key, 0.0)

    def stage_ms(self, stage: str) -> float:
        """Mean ms of one executor stage over the window (its histogram's
        sum and count deltas); nan where none ran."""
        n = self.delta("imaginary_tpu_stage_duration_seconds_count", stage=stage)
        s = self.delta("imaginary_tpu_stage_duration_seconds_sum", stage=stage)
        return s / n * 1e3 if n > 0 else math.nan


def counters_moved(before: dict, after: dict) -> str:
    """The server's counters (`*_total`, the executor's) that moved
    between two readings of /metrics, for the run's log."""
    moved = []
    for (name, labels), value in sorted(after.items()):
        if name.endswith("_total") or name.startswith("imaginary_tpu_executor_"):
            d = value - before.get((name, labels), 0.0)
            if d:
                tag = ",".join(f"{k}={v}" for k, v in labels)
                moved.append(f"{name}{'{' + tag + '}' if tag else ''} {d:g}")
    return ", ".join(moved)


def route_table(mix: dict, src_hw: tuple) -> list:
    out = []
    for r in mix["routes"]:
        parsed = urllib.parse.urlsplit(r["path"])
        op = parsed.path.strip("/")
        query = dict(urllib.parse.parse_qsl(parsed.query))
        mod = spec.route_reference(op)
        g = mod.geometry(query, *src_hw)
        out.append((op, query, g, mod.work(query, g)))
    return out


def _profile(srv, seconds: float, trace_dir: str, holder: dict) -> None:
    """GET /debugz/profile: a torch.profiler capture of the server for
    `seconds`, exported into trace_dir; the reply or the error in holder."""
    holder["t_get"] = time.perf_counter()
    try:
        q = urllib.parse.urlencode({"seconds": f"{seconds:.3f}", "dir": trace_dir})
        holder["reply"] = json.loads(srv.get(f"/debugz/profile?{q}", timeout=600))
    except (OSError, ValueError) as e:
        holder["error"] = f"{type(e).__name__}: {e}"
    holder["t_reply"] = time.perf_counter()


def _split_and_profile(srv, seconds: float, trace_dir: str, holder: dict) -> None:
    """The counters at the traced window's split, then the capture."""
    try:
        holder.update(metrics=srv.metrics(), cpu=srv.cpu_seconds())
    except (OSError, ValueError) as e:
        holder["error"] = f"{type(e).__name__}: {e}"
        return
    holder["at"] = time.perf_counter()
    _profile(srv, seconds, trace_dir, holder)


def drive(srv, mix: dict, pool: list, ctype: str, rng, seconds: float, keep_body: bool) -> list:
    paths = [r["path"] for r in mix["routes"]]
    t0 = time.perf_counter() + 0.05
    if mix["loop"] == "closed":
        seq = loadgen.route_sequence(mix, SEQUENCE, len(pool), rng)
        return asyncio.run(loadgen.closed_loop(srv.port, paths, pool, ctype, mix["clients"],
                                               seq, t0, seconds, keep_body)), t0
    n = max(1, round(mix["rate"] * seconds))
    seq = loadgen.route_sequence(mix, n, len(pool), rng)
    gaps = loadgen.poisson_gaps(mix["rate"], n, rng)
    return asyncio.run(loadgen.open_loop(srv.port, paths, pool, ctype, seq, gaps, t0,
                                         keep_body, OPEN_LOOP_GRACE_S)), t0


def warm(srv, mix: dict, pool: list, ctype: str, rng, parts: dict, prime_dir=None) -> None:
    """Each route once alone (the first run in a checkout builds the
    kernels here), then the cell's own load for `warmup_s`. With
    `prime_dir`, a short profiler capture runs inside that load: a
    process's first capture can miss the card's activity, so the traced
    window's is never the first."""

    async def alone():
        client = loadgen.Client(srv.port)
        try:
            for r in mix["routes"]:
                rec = loadgen.Record(0, 0, time.perf_counter())
                await loadgen._send(client, rec, r["path"], pool[0], ctype, False,
                                    FIRST_REQUEST_TIMEOUT_S)
                if not rec.ok:
                    raise NoResult(f"warm-up {r['path']}: status {rec.status} {rec.error}")
        finally:
            await client.close()

    t = time.perf_counter()
    asyncio.run(alone())
    parts["first_requests"] = time.perf_counter() - t
    t = time.perf_counter()
    primed: dict = {}
    timer = None
    if prime_dir is not None:
        timer = threading.Timer(0.3 * mix["warmup_s"], _profile,
                                (srv, min(1.0, 0.5 * mix["warmup_s"]), prime_dir, primed))
        timer.start()
    records, _ = drive(srv, mix, pool, ctype, rng, mix["warmup_s"], False)
    if timer is not None:
        timer.join()
        shutil.rmtree(prime_dir, ignore_errors=True)
        if "reply" not in primed:
            raise NoResult(f"the priming capture failed: {primed.get('error')}")
    parts["warm_load"] = time.perf_counter() - t
    bad = [r for r in records if not r.ok]
    if bad:
        raise NoResult(f"warm-up: {len(bad)} of {len(records)} requests failed, "
                       f"first: {bad[0].status} {bad[0].error}")


def answer_format(body: bytes):
    """(format, width, height) of an answer, or None if no image."""
    from PIL import Image

    try:
        with Image.open(io.BytesIO(body)) as im:
            return (im.format or "").lower(), im.size[0], im.size[1]
    except (OSError, ValueError):
        return None


def judge_sample(records: list, routes: list, cfg: dict, pool: list, rng) -> dict:
    """The compared numbers, each {"value", "limit"}: requests of the
    window never answered or answered with no image; sampled answers of
    the wrong format or size; and the worst sampled answer's gap to the
    reference (`benchmark/judges/<gap>.py`)."""
    limits = cfg["limits"]
    failed = [r for r in records if not r.ok]
    per_route = cfg["judge"]["per_route"]
    chosen = []
    for i in range(len(routes)):
        mine = [r for r in records if r.ok and r.route == i]
        take = rng.choice(len(mine), size=min(per_route, len(mine)), replace=False)
        chosen += [mine[j] for j in sorted(take)]
    gap_name = cfg["judge"]["gap"]
    judge = spec.judge(gap_name)

    def one(rec):
        op, query, g, _ = routes[rec.route]
        want_fmt, frame = spec.route_reference(op).reference(query, pool[rec.image])
        oh, ow = g["out"]
        if answer_format(rec.body) != (want_fmt, ow, oh):
            return 1, 0.0
        try:
            return 0, judge.gap(judge.read(rec.body), frame, cfg["judge"])
        except (ValueError, IndexError, KeyError):
            return 0, math.inf

    with ThreadPoolExecutor(max_workers=JUDGE_THREADS) as ex:
        verdicts = list(ex.map(one, chosen))
    return {
        "unanswered": {"value": len(failed), "limit": limits["unanswered"]},
        "wrong_size": {"value": sum(v[0] for v in verdicts), "limit": limits["wrong_size"]},
        gap_name: {"value": max((v[1] for v in verdicts), default=math.inf),
                   "limit": limits[gap_name]},
    }


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", out_root: str = OUT_ROOT) -> dict:
    bench = spec.load()
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    if not os.path.isdir(os.path.join(spec.ROOT, "imaginary_tpu_torch")):
        raise NoResult("no imaginary_tpu_torch beside the benchmark: nothing to run")
    seed = int(seed) % (1 << 63)
    rng = np.random.default_rng(seed)
    out_dir = os.path.join(out_root, cell_name)
    trace_dir = os.path.join(out_dir, "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    os.makedirs(out_dir, exist_ok=True)
    sampler = server.MemorySampler(os.path.join(out_dir, "memory.csv")) \
        if device == "cuda" else None
    flags = list(cfg["flags"]) + (["--enable-debug"] if traced else [])
    srv = server.Server(flags, out_dir, device, BOOT_TIMEOUT_S)
    win = None
    parts = {"spawn": time.perf_counter() - T_START}
    try:
        with ThreadPoolExecutor(max_workers=1) as ex:
            made = ex.submit(inputs.make_pool, seed, cfg["inputs"], mix["pool"])
            # the card is checked while the server boots; without one the
            # server is stopped and the run ends with no result
            dev_info = card(cell["chips"]) if device == "cuda" else \
                {"platform": device, "kind": device, "count": 1}
            parts["card_check"] = time.perf_counter() - T_START - sum(parts.values())
            srv.wait_listening()
            parts["boot"] = time.perf_counter() - T_START - sum(parts.values())
            pool = made.result()
            parts["inputs_after_boot"] = time.perf_counter() - T_START - sum(parts.values())
        ctype = CONTENT_TYPES[cfg["inputs"]["format"]]
        warm(srv, mix, pool, ctype, np.random.default_rng(rng.integers(1 << 62)), parts,
             os.path.join(trace_dir, "prime") if traced else None)
        before = (srv.metrics(), srv.cpu_seconds())
        setup_s = time.perf_counter() - T_START
        log("setup: " + ", ".join(f"{k} {v:.2f} s" for k, v in parts.items())
            + f"; setup_s {setup_s:.2f} s")
        split: dict = {}
        timer = None
        if traced:
            # counters over the window's first half; the capture after it
            cap_s = min(mix.get("capture_s", 4.0), 0.4 * seconds)
            timer = threading.Timer(0.5 * seconds, _split_and_profile,
                                    (srv, cap_s, trace_dir, split))
            timer.start()
        records, t0 = drive(srv, mix, pool, ctype, rng, seconds, True)
        after = (srv.metrics(), srv.cpu_seconds())
        log("counters over the window: " + counters_moved(before[0], after[0]))
        routes = route_table(mix, (cfg["inputs"]["height"], cfg["inputs"]["width"]))
        if timer is None:
            win = Window(cell_name, mix["loop"], seconds, t0, records, routes, before[0],
                         after[0], after[1] - before[1], setup_s)
        else:
            timer.join()
            if "at" not in split:
                raise NoResult(f"the split of the traced window failed: {split.get('error')}")
            first = [r for r in records if r.done <= split["at"]]
            win = Window(cell_name, mix["loop"], split["at"] - t0, t0, first, routes,
                         before[0], split["metrics"], split["cpu"] - before[1], setup_s)
            win.capture = read_capture(split, records, trace_dir)
            from benchmark import yardstick

            log("roofline terms: " + ", ".join(
                f"{op} %.6f ms (%s)" % yardstick.bound_ms(*work)
                for op, _, _, work in routes))
    finally:
        srv.stop()
        if sampler is not None:
            sampler.stop()
    peak = sampler.peak_bytes() if sampler is not None else 0
    checks = judge_sample(records, win.routes, cfg, pool,
                          np.random.default_rng(rng.integers(1 << 62)))
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in spec.metrics_for(bench, cell_name, traced):
        value = spec.metric_reader(m["name"])(win)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_out = dict(dev_info, memory_peak_bytes=peak)
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": sum(1 for r in records if not r.ok), "metrics": metrics,
              "device": device_out}
    if traced and win.capture:
        device_out["busy_s"] = win.capture["busy_s"]
        device_out["window_s"] = win.capture["window_s"]
        result["breakdown"] = {"device_ops": win.capture["device_ops"],
                               "idle_gaps": win.capture["idle_gaps"]}
    result["checks"] = checks
    return result


def read_capture(holder: dict, records: list, trace_dir: str) -> dict:
    """The capture's summary, with `window_s` (its requested length) and
    `requests`: the answered requests whose answer came inside the
    capture, placed on the harness's clock by the trace's epoch (by the
    request for it, where the two clocks disagree)."""
    if "reply" not in holder:
        raise NoResult(f"the profiler capture failed: {holder.get('error')}")
    reply = holder["reply"]
    path = reply["trace_file"]
    cap = trace.summarize(trace.load(path))
    os.remove(path)
    cap["window_s"] = float(reply["seconds"])
    offset = time.time() - time.perf_counter()
    a, b = ((cap["base_ns"] * 1e-3 + t) * 1e-6 - offset for t in cap["span_us"])
    log(f"capture: {cap['device_events']} device events, {cap['busy_s'] * 1e3:.3f} ms busy, "
        f"{cap['kernel_s'] * 1e3:.3f} ms of kernels; its span starts "
        f"{a - holder['t_get']:+.3f} s from the request for it and lasts {b - a:.3f} s")
    if not (holder["t_get"] - 2.0 <= a and b <= holder["t_reply"] + 2.0):
        a = holder["t_get"]
        b = a + cap["window_s"]
    cap["requests"] = [r for r in records if r.ok and a <= r.done <= b]
    return cap


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoResult as e:
        log(f"no result: {e}")
        return 3
    found = forbidden_modules()
    if found:
        log(f"no result: the process holds {', '.join(found)}")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
