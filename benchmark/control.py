"""The control of the comparison that decides `correct`: the plain
reference put in the program's place and computed one precision below
the configuration's, its frames encoded as the service encodes its
answers, and judged exactly as a run judges the program's answers. A
comparison that cannot tell this control from the reference cannot see
such a change in the program.

The configurations state float32 arithmetic between 8-bit samples, so
the control is the reference with every stage stored in bfloat16.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3

prints, for each seed, the cell's compared gap over the same sample of
routes and pool images a run draws (the worst, as a run reports it, and
the least), beside the configuration's limit. The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from benchmark import inputs, run, spec

PRECISION = torch.bfloat16


def control_gap(op: str, query: dict, body: bytes, judge: dict) -> float:
    """The compared gap of the control's answer to one request."""
    ref = spec.route_reference(op)
    frame = ref.reference(query, body)[1]
    low = ref.reference(query, body, PRECISION)[1].double()
    mod = spec.judge(judge["gap"])
    return mod.gap(mod.encode(low, judge), frame, judge)


def readings(cell_name: str, seed: int, per_route=None, pool=None) -> list:
    """The control's gap for each answer a run on this seed would judge:
    `per_route` pool images of each route (the configuration's count by
    default)."""
    bench = spec.load()
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    pool = pool or inputs.make_pool(seed, cfg["inputs"], mix["pool"])
    routes = run.route_table(mix, (cfg["inputs"]["height"], cfg["inputs"]["width"]))
    rng = np.random.default_rng(seed)
    n = per_route or cfg["judge"]["per_route"]
    return [control_gap(op, query, pool[image], cfg["judge"])
            for op, query, _, _ in routes
            for image in rng.choice(len(pool), size=min(n, len(pool)), replace=False)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args(argv)
    bench = spec.load()
    cfg = spec.config(bench, spec.cell(bench, args.workload)["config"])
    gap = cfg["judge"]["gap"]
    for seed in (int(s) for s in args.seeds.split(",")):
        got = readings(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed, "precision": str(PRECISION),
                          gap: max(got), "least": min(got), "limit": cfg["limits"][gap]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
