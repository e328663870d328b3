"""`/health` stats (the port's copy of `imaginary_tpu/web/health.py`;
ref: health.go:17-63).

The reference's keys for what the port has: process RSS, threads, GC
collections, the serving process (`worker` and `epoch`: a single process
is worker 0 of epoch 0), the device inventory, the executor's block (with
the link ledger `wire_bytes`/`wire_transfers`, donation and the pressure
rungs' counts), the fault domains (`deviceHealth`), integrity's counters
with `--integrity`, the qos block with `--qos-config`, the pressure
governor's with `--pressure-rss-mb`, the SLO burn rates with
`--slo-config` (`slo`, obs/slo.py), the cost and capacity plane with
`--cost-attribution` (`capacity`, obs/cost.py), the native codec's
scratch `arena`, the stage times, the estimated queueing delay, the
cache tiers' counters (`cache`, always present, as in the reference),
the read guard's counters with `--read-timeout` (`ingress`,
web/ingress.py) and the event-loop lag probe's last sample (`eventLoop`,
obs/looplag.py, once it has taken one). Beside them, the port's own: the
device, each kernel's launch count, the codec route of each format and
the dct transport's switches. Each optional block's presence is its
plane's armed signal.
"""

from __future__ import annotations

import gc
import os
import threading
import time

import torch

from imaginary_tpu_torch import codecs, kernels, pipeline
from imaginary_tpu_torch.codecs import native_backend
from imaginary_tpu_torch.engine.timing import TIMES
from imaginary_tpu_torch.obs import looplag
from imaginary_tpu_torch.web.ingress import STATS as INGRESS_STATS


def _rss_mb() -> float:
    """The process's resident set in MB, from /proc (0.0 where there is none)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 2)
    except OSError:
        pass
    return 0.0


def get_health_stats(service) -> dict:
    device = service.device
    cuda = device.type == "cuda"
    executor = service.executor
    stats = {
        "uptime": round(time.time() - service.started, 2),
        "allocatedMemoryMb": _rss_mb(),
        "threads": threading.active_count(),
        "cpus": os.cpu_count() or 1,
        "gcCollections": sum(s["collections"] for s in gc.get_stats()),
        "pid": os.getpid(),
        "worker": 0,
        "epoch": 0,
        "devices": torch.cuda.device_count() if cuda else 1,
        "backend": device.type,
        "device": str(device),
        "kernelLaunches": kernels.launch_counts(),
        "codecs": codecs.routes(),
        "dctTransport": {"ingress": pipeline.transport_dct_enabled(),
                         "egress": pipeline.transport_dct_egress_enabled(),
                         **pipeline.dct_counts()},
        "executor": executor.stats.to_dict(),
        # the fault domains: state, strikes, fail-slow and probe latency
        "deviceHealth": executor.devhealth.snapshot(),
    }
    if executor.integrity is not None:  # --integrity's counters
        stats["integrity"] = executor.integrity.snapshot()
    if service.qos is not None:  # per-class counters and queue depths
        stats["qos"] = service.qos.stats.to_dict()
    if service.pressure is not None:  # the rung, its signals and its actions
        stats["pressure"] = service.pressure.snapshot()
    if service.slo is not None:  # burn rates per route and window
        stats["slo"] = service.slo.snapshot()
    if service.cost is not None:  # cost windows, utilization, bound_by
        stats["capacity"] = service.cost.snapshot()
    arena = native_backend.arena_stats()
    if arena is not None:  # the native codec's scratch arenas
        stats["arena"] = arena
    if cuda:
        stats["deviceName"] = torch.cuda.get_device_name(device)
        stats["allocatedDeviceMb"] = round(
            torch.cuda.memory_allocated(device) / (1 << 20), 2)
    stage_times = TIMES.snapshot()
    if stage_times:
        stats["stageTimesMs"] = stage_times
    # the queueing delay a new request would meet: host-pool backlog plus
    # the executor's owed device work
    stats["estimatedQueueMs"] = round(service.estimated_queue_ms(), 2)
    # the cache tiers' hits, misses, evictions, occupancy and coalescing
    stats["cache"] = service.caches.to_dict()
    if service.options.read_timeout_s > 0:  # the read guard's counters
        stats["ingress"] = INGRESS_STATS.to_dict()
    loop_lag = looplag.snapshot()
    if loop_lag is not None:
        stats["eventLoop"] = loop_lag
    return stats
