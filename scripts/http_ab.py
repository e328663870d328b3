"""Serve config 1 and phase 6's mix from an earlier tree and from this one
on one card, in turns (earlier, this, this, earlier, earlier, this, ...),
and print what each run measured.

Run from the repository root on a machine with the card:

    python3 scripts/http_ab.py --parent DIR [--pairs 2] [--serial N] [--config3]

DIR is a checkout of the earlier tree. Each run is its own process,
started in its tree with that tree's `chip_smoke.py` and
`imaginary_tpu_torch` (kernels and codec built by the tree's own build
into its `_build/`). A run:

- builds the kernels and the native codecs;
- runs `chip_smoke.main_path_phase()` (phase 4: config 1's six counted
  requests and a profiled window);
- serves config 1 one request at a time, N times (200 by default),
  `GET /resize?width=300&height=200&file=large.jpg` against the tree's
  `make_server(device="cuda", mount=tests/testdata)` with its defaults,
  after five untimed requests: p50, p99 and mean latency on the client's
  clock;
- runs `chip_smoke.config2_phase()` (phase 6: 32 clients, three timed
  windows and a profiled fourth): req/s (median of the windows), p50,
  p99, mean and largest batch, and the card's busy share;
- with `--config3`, runs `chip_smoke.config3_phase()` on the seeded 4K
  PNG (phase 7: one client, then 8 clients in three windows): the one
  client's p50 and latencies, req/s (median of the windows), p50 and p99
  under load, and the host steps of one request (the PNG decode, the
  plan, the chain, the WEBP encode; median of 5 on the host clock).

Each run prints one JSON line; all of them are also written to
chip_smoke_out/http_ab.json. The card's name and power limit lead the
output.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(tree: str, serial: int, config3: bool = False) -> dict:
    """One run in `tree` (this process's cwd and first sys.path entry)."""
    import threading
    import urllib.request

    import numpy as np

    import chip_smoke as cs
    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.native import build as native_build
    from imaginary_tpu_torch.web.app import make_server

    t0 = time.perf_counter()
    kernels.load_all()
    native_build.build()
    build_s = time.perf_counter() - t0
    phase4 = cs.main_path_phase()
    srv = make_server("127.0.0.1", 0, device="cuda",
                      mount=os.path.join(tree, "tests", "testdata"))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = (f"http://127.0.0.1:{srv.server_address[1]}"
           "/resize?width=300&height=200&file=large.jpg")
    lat = []
    try:
        for i in range(5 + serial):
            t = time.perf_counter()
            with urllib.request.urlopen(url, timeout=60) as r:
                if r.status != 200 or r.headers["Content-Type"] != "image/jpeg":
                    raise AssertionError(f"config 1: {r.status}")
                r.read()
            if i >= 5:
                lat.append((time.perf_counter() - t) * 1e3)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
    phase6 = cs.config2_phase()
    extra = {}
    if config3:
        p7 = cs.config3_phase(cs.make_4k_png())
        extra["phase7"] = {"p50_ms_one_client": p7["p50_ms_one_client"],
                           "rps": p7["load"]["rps"],
                           "rps_by_window": p7["load"]["rps_by_window"],
                           "p50_ms": p7["load"]["p50_ms"], "p99_ms": p7["load"]["p99_ms"],
                           "serial_ms": p7["serial_ms"]["config3"],
                           "host_steps_ms": p7["host_steps_ms"]}
    return {
        "tree": tree, "build_s": build_s,
        "config1_serial": {"n": serial, "p50_ms": float(np.percentile(lat, 50)),
                           "p99_ms": float(np.percentile(lat, 99)),
                           "mean_ms": float(np.mean(lat))},
        "phase4": {"latency_ms": phase4["latency_ms"],
                   "busy_share": phase4["profile"]["busy_share"]},
        "phase6": {"rps": phase6["rps"], "rps_by_window": phase6["rps_by_window"],
                   "p50_ms": phase6["p50_ms"], "p99_ms": phase6["p99_ms"],
                   "mean_batch": phase6["mean_batch"],
                   "max_group_seen": phase6["max_group_seen"],
                   "busy_share": phase6["profiled"]["busy_share"],
                   "profiled_rps": phase6["profiled"]["rps"]},
        **extra,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="checkout of the earlier tree")
    ap.add_argument("--serial", type=int, default=200,
                    help="config 1 requests served one at a time per run")
    ap.add_argument("--pairs", type=int, default=2,
                    help="pairs of runs, the earlier tree first in the even ones")
    ap.add_argument("--config3", action="store_true",
                    help="also run phase 7 (config 3 on the seeded 4K PNG)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        tree = os.path.abspath(args.child)
        os.chdir(tree)
        sys.path.insert(0, tree)
        out = child(tree, args.serial, args.config3)
        print("HTTP_AB " + json.dumps(out), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent DIR is required")
    parent = os.path.abspath(args.parent)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = []
    order = []
    for i in range(args.pairs):
        pair = [("parent", parent), ("change", ROOT)]
        order += pair if i % 2 == 0 else pair[::-1]
    for label, tree in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                               "--serial", str(args.serial)]
                              + (["--config3"] if args.config3 else []),
                              capture_output=True, text=True, cwd=tree)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("HTTP_AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            raise SystemExit(f"the {label} run failed ({proc.returncode})")
        run = {"label": label, **json.loads(lines[-1][len("HTTP_AB "):])}
        runs.append(run)
        print(json.dumps(run), flush=True)
    os.makedirs(os.path.join(ROOT, "chip_smoke_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chip_smoke_out", "http_ab.json"), "w") as f:
        json.dump({"smi": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
