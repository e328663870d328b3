"""Fleet metrics aggregation: the supervisor's admin plane (the port's
copy of `imaginary_tpu/obs/aggregate.py`).

Runs inside the *supervisor* process (web/workers.py), which never
touches the card and never serves aiohttp — so this module is
stdlib-only: urllib for scraping, ThreadingHTTPServer for serving,
threading for locks.

The problem it solves: under ``--workers N`` the fleet shares one
SO_REUSEPORT socket, so a Prometheus scrape lands on ONE random worker
and reports 1/N of the truth; worse, a crash-respawned worker restarts
its counters at zero, so naive summing makes fleet totals go
*backwards* — which Prometheus interprets as a counter reset and
mis-extrapolates rates from. Three pieces fix this:

* ``scrape_fleet`` repeatedly samples the shared port and buckets
  responses by the self-identifying ``imaginary_tpu_worker`` /
  ``imaginary_tpu_epoch`` gauges (every worker stamps its own /metrics
  and /health — see web/health.py) until every expected index has been
  seen or the deadline lapses. There is no way to address worker k
  directly; the kernel load-balances, so we sample until coverage.

* ``Aggregator`` applies monotonic counter-reset correction to
  COUNTERS AND HISTOGRAMS ONLY: a per-(worker, series) high-water mark
  keyed by the supervisor-minted fencing epoch. When a worker respawns
  its epoch advances (epochs are fleet-monotonic, minted in
  run_supervisor), so the dead epoch's last value is folded into a
  retained base and the fresh zeroed counter adds on top — fleet
  totals never decrease. Same-epoch regressions (shouldn't happen;
  torn scrape) are clamped with max(); scrapes from an *older* epoch
  than the recorded one (a zombie's last gasp racing its replacement)
  are ignored outright. Gauges never enter this machinery — a gauge
  moves both ways (queues drain, caches evict), so clamping or base
  folding would pin it at a high-water mark and inflate it across
  respawns; summable gauges are served as latest-snapshot sums instead.
  ``prune`` evicts state for worker indices the supervisor no longer
  tracks (gauges drop with the snapshot; counter contributions fold
  into a retired base so fleet totals stay monotonic).

* ``render`` re-emits a strict Prometheus 0.0.4 exposition (the strict
  parser in tests/test_obs.py is the contract): counters and
  histograms sum across workers; gauges do NOT sum by default —
  summing ``imaginary_tpu_fleet_slots`` over N workers that each
  report the SAME shared shm file would N-x double-count — so gauges
  get a ``worker="k"`` label unless the family is in SUMMABLE_GAUGES
  (per-process quantities like queue depth where the fleet total is
  meaningful).
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit

# ---------------------------------------------------------------------------
# exposition parsing (scrape side)
# ---------------------------------------------------------------------------

# Prometheus text format 0.0.4 sample line. The label block is matched
# as a sequence of quoted label pairs — NOT a lazy wildcard up to '}' —
# because the format only requires escaping '"', '\' and newline inside
# a label value, so a legal value may contain a literal '}' that a lazy
# match would stop at, silently dropping the sample from the fleet
# view. The optional trailing " # {...} v" clause is an
# OpenMetrics-style exemplar (our workers only attach them when asked
# via /metrics?exemplars=1, but tolerate them).
_LABEL_VAL = r'(?:[^"\\]|\\["\\n]|\\\\)*'
_LABEL_PAIR = r'[a-zA-Z_][a-zA-Z0-9_]*="' + _LABEL_VAL + '"'
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{((?:" + _LABEL_PAIR + r"(?:," + _LABEL_PAIR + r")*,?)?)\})?"
    r" (-?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|\+?Inf|NaN))"
    r"(?: # \{.*\} .*)?$"
)
_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="(' + _LABEL_VAL + r')"')

_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


class Family:
    """One metric family: metadata + every sample seen for it."""

    __slots__ = ("name", "mtype", "help", "samples")

    def __init__(self, name: str, mtype: str = "untyped", help_text: str = ""):
        self.name = name
        self.mtype = mtype
        self.help = help_text
        # (sample_name, labels_tuple) -> float; labels_tuple preserves
        # the worker's emission order so render round-trips byte-stably
        self.samples: dict[tuple, float] = {}


def _parse_value(raw: str) -> float:
    if raw in ("+Inf", "Inf"):
        return float("inf")
    if raw == "-Inf":
        return float("-inf")
    return float(raw)


def parse_exposition(text: str) -> dict[str, Family]:
    """Parse one worker's /metrics body into {family_name: Family}.

    Histogram ``_bucket``/``_sum``/``_count`` samples fold into their
    base family (mirroring the strict parser's suffix folding) so the
    aggregator sums whole histograms as a unit.
    """
    families: dict[str, Family] = {}
    typed: dict[str, str] = {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            families.setdefault(name, Family(name)).help = help_text
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE "):]
            name, _, mtype = rest.partition(" ")
            fam = families.setdefault(name, Family(name))
            fam.mtype = mtype.strip()
            typed[name] = fam.mtype
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue  # tolerate: the strict gate lives in tests, not here
        sample_name, labels_raw, raw_value = m.group(1), m.group(2), m.group(3)
        base = sample_name
        for suffix in _HIST_SUFFIXES:
            cand = sample_name[: -len(suffix)] if sample_name.endswith(suffix) else None
            if cand and typed.get(cand) == "histogram":
                base = cand
                break
        fam = families.setdefault(base, Family(base))
        labels = tuple(
            (k, v) for k, v in _LABEL_RE.findall(labels_raw or "")
        )
        fam.samples[(sample_name, labels)] = _parse_value(raw_value)
    return families


# ---------------------------------------------------------------------------
# merge policy
# ---------------------------------------------------------------------------

# Gauges where the per-worker values are independent per-process
# quantities and a fleet-wide sum is the number an operator wants
# (queue depth, bytes in per-process caches, live threads...). Every
# gauge family NOT listed here gets a worker="k" label instead of being
# summed — the safe default, because families like imaginary_tpu_fleet_*
# describe ONE shared shm file that every worker reports identically
# (summing would N-x double count), and state/info gauges
# (device_state, backend_info, pressure_state) are categorical.
SUMMABLE_GAUGES = frozenset({
    "imaginary_tpu_executor_queue_depth",
    "imaginary_tpu_executor_host_inflight",
    "imaginary_tpu_executor_host_owed_mpix",
    "imaginary_tpu_executor_device_owed_mb",
    "imaginary_tpu_executor_compile_cache_size",
    "imaginary_tpu_cache_result_items",
    "imaginary_tpu_cache_result_bytes",
    "imaginary_tpu_cache_frame_items",
    "imaginary_tpu_cache_frame_bytes",
    "imaginary_tpu_cache_source_items",
    "imaginary_tpu_cache_source_bytes",
    "imaginary_tpu_qos_queued",
    "imaginary_tpu_integrity_poison_entries",
    "imaginary_tpu_threads",
    "imaginary_tpu_allocated_memory_mb",
})

# Per-worker identity/clock gauges that are meaningless in a merged
# view with a worker label (the label carries the index already and the
# admin endpoint re-derives liveness in /fleetz); dropped from render.
_IDENTITY_GAUGES = frozenset({
    "imaginary_tpu_worker",
})


def merge_mode(name: str, mtype: str) -> str:
    """'sum' (fleet total: reset-corrected accumulation for counters
    and histograms, latest-snapshot sum for allowlisted gauges) or
    'per_worker' (labeled)."""
    if mtype in ("counter", "histogram"):
        return "sum"
    if name in SUMMABLE_GAUGES:
        return "sum"
    return "per_worker"


# ---------------------------------------------------------------------------
# reset-correcting aggregator
# ---------------------------------------------------------------------------


def _esc(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt(value: float) -> str:
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    if value != value:  # NaN
        return "NaN"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _sample_sort_key(item):
    """Stable family-internal ordering that keeps histograms strict:
    per label-group, buckets ascending by le (+Inf last), then _sum,
    then _count — the cumulative-monotone file order the strict parser
    checks."""
    (sample_name, labels), _value = item
    non_le = tuple((k, v) for k, v in labels if k != "le")
    rank = 0
    le = -1.0
    if sample_name.endswith("_bucket"):
        le_raw = dict(labels).get("le", "+Inf")
        le = float("inf") if le_raw in ("+Inf", "Inf") else float(le_raw)
    elif sample_name.endswith("_sum"):
        rank = 1
    elif sample_name.endswith("_count"):
        rank = 2
    return (non_le, rank, le, sample_name)


class Aggregator:
    """Accumulates worker snapshots; renders a merged exposition.

    Persistent across scrapes (the admin endpoint keeps ONE instance
    alive) — that persistence IS the monotonicity guarantee: the
    high-water table outlives any individual worker incarnation.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # (worker, family, sample_key) -> [epoch, last_value, base]
        # merged value for a reset-corrected series = base + last_value.
        # Counters/histograms ONLY: a gauge moves both ways, so the
        # monotone clamp/base-folding below would pin it at its
        # high-water mark and inflate it across respawns — gauges
        # (summable or not) are served straight from _last.
        self._hw: dict[tuple, list] = {}
        # (family, sample_key) -> folded final values of PRUNED worker
        # indices: evicting a departed worker must not regress totals
        self._retired: dict[tuple, float] = {}
        # worker -> (epoch, families) latest full snapshot (gauges)
        self._last: dict[int, tuple] = {}

    def observe(self, worker: int, epoch: int, families: dict[str, Family]):
        with self._lock:
            prev = self._last.get(worker)
            if prev is not None and epoch < prev[0]:
                return  # a zombie's stale scrape racing its replacement
            self._last[worker] = (epoch, families)
            for fam in families.values():
                if fam.mtype not in ("counter", "histogram"):
                    continue  # gauges: snapshot state, no reset correction
                for sample_key, value in fam.samples.items():
                    hw_key = (worker, fam.name, sample_key)
                    rec = self._hw.get(hw_key)
                    if rec is None:
                        self._hw[hw_key] = [epoch, value, 0.0]
                    elif epoch > rec[0]:
                        # respawn: fold the dead incarnation's final
                        # value into the base, start fresh
                        rec[2] += rec[1]
                        rec[0] = epoch
                        rec[1] = value
                    elif epoch == rec[0]:
                        # same incarnation: counters only move forward;
                        # clamp a torn/regressed read
                        rec[1] = max(rec[1], value)
                    # epoch < rec[0]: ignore (older incarnation)

    def workers_seen(self) -> dict[int, int]:
        with self._lock:
            return {w: ef[0] for w, ef in self._last.items()}

    def prune(self, tracked) -> None:
        """Evict state for worker indices the supervisor no longer
        tracks. Without this a departed worker's per-worker gauges
        would re-render forever (the admin plane re-emits them fresh on
        every scrape, so Prometheus staleness handling never kicks in)
        and its summable-gauge contribution would sit in the fleet
        total indefinitely. Gauges simply drop with the snapshot; a
        reset-corrected series' contribution folds into a per-series
        retired base so fleet counter totals stay monotonic after the
        index disappears. Callers must stop observe()-ing a pruned
        index (FleetAdmin filters scrapes by the supervisor view), or
        each observe+prune cycle would re-fold its value."""
        tracked = set(tracked)
        with self._lock:
            for worker in [w for w in self._last if w not in tracked]:
                del self._last[worker]
            for key in [k for k in self._hw if k[0] not in tracked]:
                _worker, fam_name, sample_key = key
                rec = self._hw.pop(key)
                rkey = (fam_name, sample_key)
                self._retired[rkey] = (
                    self._retired.get(rkey, 0.0) + rec[1] + rec[2])

    def render(self, per_worker: bool = False, extra_gauges=None) -> str:
        """Merged strict-exposition text.

        per_worker=True additionally labels every *summed* series with
        worker="k" instead of summing (debug view — pruned workers'
        retired counter bases have no index, so they appear only in the
        fleet-total view); the default serves the fleet-total view.
        extra_gauges is [(name, help, value)] for synthetic
        supervisor-side families (worker counts etc).
        """
        with self._lock:
            last = dict(self._last)
            hw = {k: list(v) for k, v in self._hw.items()}
            retired = dict(self._retired)

        # family metadata: first writer wins (workers agree anyway)
        meta: dict[str, tuple] = {}
        for _epoch, families in last.values():
            for fam in families.values():
                if fam.name not in meta:
                    meta[fam.name] = (fam.mtype, fam.help)

        lines: list[str] = []

        def emit_family(name, mtype, help_text, samples):
            if not samples:
                return
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {mtype}")
            for (sample_name, labels), value in sorted(
                samples.items(), key=_sample_sort_key
            ):
                if labels:
                    lbl = ",".join(f'{k}="{_esc(v)}"' for k, v in labels)
                    lines.append(f"{sample_name}{{{lbl}}} {_fmt(value)}")
                else:
                    lines.append(f"{sample_name} {_fmt(value)}")

        for name in sorted(meta):
            if name in _IDENTITY_GAUGES:
                continue
            mtype, help_text = meta[name]
            mode = merge_mode(name, mtype)
            corrected = mtype in ("counter", "histogram")
            merged: dict[tuple, float] = {}
            if mode == "sum" and corrected and not per_worker:
                for (worker, fam_name, sample_key), rec in hw.items():
                    if fam_name != name:
                        continue
                    merged[sample_key] = merged.get(sample_key, 0.0) \
                        + rec[2] + rec[1]
                for (fam_name, sample_key), base in retired.items():
                    if fam_name != name:
                        continue
                    merged[sample_key] = merged.get(sample_key, 0.0) + base
            elif mode == "sum" and corrected:
                for (worker, fam_name, sample_key), rec in hw.items():
                    if fam_name != name:
                        continue
                    sample_name, labels = sample_key
                    merged[(sample_name, labels + (("worker", str(worker)),))] \
                        = rec[2] + rec[1]
            elif mode == "sum" and not per_worker:
                # summable gauge: each live worker's LATEST value,
                # summed — never the high-water table, so a queue that
                # drains or a cache that evicts is reflected downward,
                # and a respawn replaces (not inflates) the old value
                for worker, (_epoch, families) in last.items():
                    fam = families.get(name)
                    if fam is None:
                        continue
                    for sample_key, value in fam.samples.items():
                        merged[sample_key] = merged.get(sample_key, 0.0) \
                            + value
            else:
                # per-worker labeled straight from each latest snapshot
                # (never-summed gauges, and every gauge in the
                # per_worker debug view)
                for worker, (_epoch, families) in sorted(last.items()):
                    fam = families.get(name)
                    if fam is None:
                        continue
                    for (sample_name, labels), value in fam.samples.items():
                        merged[(sample_name,
                                labels + (("worker", str(worker)),))] = value
            emit_family(name, mtype, help_text, merged)

        for name, help_text, value in (extra_gauges or ()):
            emit_family(name, "gauge", help_text, {(name, ()): float(value)})

        return "\n".join(lines) + "\n" if lines else "\n"


# ---------------------------------------------------------------------------
# shared-port fleet scraping
# ---------------------------------------------------------------------------


def _default_fetch(url: str, timeout: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8", "replace")


def _identity_from_metrics(families: dict[str, Family]):
    """(worker, epoch) self-stamped in the exposition, or None."""
    try:
        wfam = families["imaginary_tpu_worker"]
        efam = families["imaginary_tpu_epoch"]
        worker = int(next(iter(wfam.samples.values())))
        epoch = int(next(iter(efam.samples.values())))
        return worker, epoch
    except (KeyError, StopIteration, ValueError):
        return None


def scrape_fleet(metrics_url: str, health_url: str, expect,
                 deadline_s: float = 2.5, per_request_timeout: float = 1.0,
                 fetch=None, clock=time.monotonic):
    """Sample the shared SO_REUSEPORT port until every expected worker
    index has answered (or the deadline lapses).

    Returns (metrics_by_worker, health_by_worker, missed) where
    metrics_by_worker maps index -> (epoch, families) and missed is the
    set of expected indices never seen. fetch is injectable for tests:
    fetch(url, timeout) -> body text (raise on failure).
    """
    fetch = fetch or _default_fetch
    expect = set(expect)
    metrics_by: dict[int, tuple] = {}
    health_by: dict[int, dict] = {}
    t_end = clock() + deadline_s
    # a couple of extra probes per wave: the kernel's reuseport pick is
    # random, so coverage of N workers needs >N samples with high odds
    wave = max(2, 2 * len(expect))
    while clock() < t_end and (
        expect - set(metrics_by) or expect - set(health_by)
    ):
        with ThreadPoolExecutor(max_workers=wave * 2) as pool:
            # itpu: allow[ITPU008] supervisor-side scrape: no request context exists to carry
            m_futs = [pool.submit(fetch, metrics_url, per_request_timeout)
                      for _ in range(wave)] if expect - set(metrics_by) else []
            # itpu: allow[ITPU008] supervisor-side scrape: no request context exists to carry
            h_futs = [pool.submit(fetch, health_url, per_request_timeout)
                      for _ in range(wave)] if expect - set(health_by) else []
            for fut in m_futs:
                try:
                    families = parse_exposition(fut.result())
                except Exception:
                    continue
                ident = _identity_from_metrics(families)
                if ident is None:
                    continue
                worker, epoch = ident
                prev = metrics_by.get(worker)
                if prev is None or epoch >= prev[0]:
                    metrics_by[worker] = (epoch, families)
            for fut in h_futs:
                try:
                    payload = json.loads(fut.result())
                except Exception:
                    continue
                worker = payload.get("worker")
                if isinstance(worker, int):
                    prev = health_by.get(worker)
                    if prev is None or payload.get("epoch", 0) \
                            >= prev.get("epoch", 0):
                        health_by[worker] = payload
    missed = (expect - set(metrics_by)) | (expect - set(health_by))
    return metrics_by, health_by, missed


# ---------------------------------------------------------------------------
# /fleetz assembly
# ---------------------------------------------------------------------------


def build_fleetz(supervisor_view: dict, health_by_worker: dict,
                 missed, now=None, host=None) -> dict:
    """Merge the supervisor's authoritative process table with each
    worker's self-reported /health into one JSON view.

    Degrades gracefully: a worker the scrape missed still appears (the
    supervisor knows its pid/epoch/restarts) with ``stale: true`` and
    ``health: null`` — partial data beats a 500.

    `host` (the cross-host identity dict minted at boot) adds the
    ``host`` block peers gossip on: identity and the host's load signals
    (alive workers, the worst queue estimate, the worst pressure rung).
    Absent when --peers is off: the block's presence is the armed signal.
    """
    now = time.time() if now is None else now
    workers = {}
    for idx, sup in sorted(supervisor_view.items()):
        h = health_by_worker.get(idx)
        entry = dict(sup)
        entry["stale"] = idx in missed or h is None
        entry["health"] = h
        workers[str(idx)] = entry
    out = {
        "ts": round(now, 3),
        "workers": workers,
        "scraped": sorted(set(health_by_worker)),
        "missed": sorted(missed),
    }
    if host:
        est_q = 0.0
        plevel = 0
        for h in health_by_worker.values():
            if not isinstance(h, dict):
                continue
            q = h.get("estimatedQueueMs")
            if isinstance(q, (int, float)):
                est_q = max(est_q, float(q))
            press = h.get("pressure")
            if isinstance(press, dict):
                s = press.get("state")
                if isinstance(s, int):
                    plevel = max(plevel, s)
        out["host"] = {
            "id": str(host.get("id", "")),
            "epoch": int(host.get("epoch", 0)),
            "serve_url": str(host.get("serve_url", "")),
            "workers_alive": sum(
                1 for rec in supervisor_view.values()
                if rec.get("alive", False)),
            "est_queue_ms": round(est_q, 1),
            "pressure_level": plevel,
        }
    # fleet-merged capacity summary (obs/cost.py): window cost totals
    # summed across workers + each worker's live bound_by verdict side
    # by side. Present only when some worker is running with
    # --cost-attribution — the per-worker block's presence propagates
    # the armed/parity signal up to /fleetz.
    caps = {
        idx: h["capacity"] for idx, h in sorted(health_by_worker.items())
        if isinstance(h, dict) and isinstance(h.get("capacity"), dict)
    }
    if caps:
        fleet_windows: dict = {}
        verdicts: dict = {}
        folds = 0
        for idx, cap in caps.items():
            folds += int(cap.get("folds", 0) or 0)
            for label, vec in (cap.get("windows") or {}).items():
                agg = fleet_windows.setdefault(label, {})
                for k, v in vec.items():
                    if isinstance(v, (int, float)):
                        agg[k] = round(agg.get(k, 0) + v, 3)
            bound = cap.get("bound_by") or {}
            verdicts[str(idx)] = bound.get("verdict", "unknown")
        out["capacity"] = {
            "workers": sorted(caps),
            "folds": folds,
            "windows": fleet_windows,
            "bound_by": verdicts,
        }
    return out


# ---------------------------------------------------------------------------
# the admin HTTP server (supervisor-side)
# ---------------------------------------------------------------------------


class FleetAdmin:
    """Tiny threaded HTTP server exposing the merged fleet view.

    Binds 127.0.0.1 only — this is an operator/scraper plane, not a
    public surface; no auth, no TLS, mirrors /debugz's posture. Routes:

    * ``/metrics``           merged strict exposition (``?per_worker=1``
      labels summed series by worker instead of summing)
    * ``/fleetz``            JSON: supervisor process table + per-worker
      /health side by side, ``stale`` on scrape misses

    One persistent Aggregator lives for the server's lifetime, which is
    what makes fleet counter totals monotonic across worker respawns.
    """

    def __init__(self, port: int, metrics_url: str, health_url: str,
                 supervisor_view, scrape_deadline_s: float = 2.5,
                 per_request_timeout: float = 1.0, fetch=None,
                 host: str = "127.0.0.1", host_info=None, peer_table=None):
        self._agg = Aggregator()
        self._metrics_url = metrics_url
        self._health_url = health_url
        self._view = supervisor_view  # callable -> {idx: {...}}
        self._deadline = scrape_deadline_s
        self._timeout = per_request_timeout
        self._fetch = fetch
        # the cross-host plane (fleet/multihost.py): the identity dict and
        # the gossiped peer table; both None when --peers is off, and then
        # /fleetz is byte-equal to the single-host build
        self._host_info = host_info
        self._peer_table = peer_table
        admin = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: supervisor stdout is a log
                pass

            def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
                try:
                    admin._handle(self)
                except BrokenPipeError:
                    pass
                except Exception as exc:
                    try:
                        body = json.dumps({"error": str(exc)}).encode()
                        self.send_response(500)
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    # itpu: allow[ITPU004] best-effort 500 write: the client hung up mid-error — nothing left to tell it
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-admin", daemon=True
        )

    def start(self) -> "FleetAdmin":
        self._thread.start()
        return self

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        # itpu: allow[ITPU004] idempotent teardown: double-close during supervisor shutdown is benign
        except Exception:
            pass

    # -- request handling -------------------------------------------------

    def _scrape(self):
        view = self._view() or {}
        expect = {idx for idx, rec in view.items() if rec.get("alive", True)}
        metrics_by, health_by, missed = scrape_fleet(
            self._metrics_url, self._health_url, expect,
            deadline_s=self._deadline,
            per_request_timeout=self._timeout, fetch=self._fetch,
        )
        for worker, (epoch, families) in metrics_by.items():
            # the supervisor view is authoritative: a zombie answering
            # under an index the supervisor dropped must not resurrect
            # its series (and must not re-fold into the retired base
            # on every scrape)
            if worker in view:
                self._agg.observe(worker, epoch, families)
        self._agg.prune(view)
        return view, health_by, missed

    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        parts = urlsplit(req.path)
        if parts.path == "/metrics":
            view, _health_by, missed = self._scrape()
            per_worker = "per_worker=1" in (parts.query or "")
            body = self._agg.render(
                per_worker=per_worker,
                extra_gauges=[
                    ("imaginary_tpu_fleet_admin_workers",
                     "Worker processes the supervisor currently tracks.",
                     len(view)),
                    ("imaginary_tpu_fleet_admin_workers_unscraped",
                     "Expected workers the last fleet scrape missed.",
                     len(missed)),
                ],
            ).encode("utf-8")
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif parts.path == "/fleetz":
            view, health_by, missed = self._scrape()
            local = build_fleetz(view, health_by, missed, host=self._host_info)
            if self._peer_table is not None and "scope=cluster" in (parts.query or ""):
                from imaginary_tpu_torch.fleet import multihost

                local = multihost.build_cluster_view(local, self._peer_table)
            body = json.dumps(local, indent=2, default=str).encode("utf-8")
            ctype = "application/json"
        else:
            body = b"not found\n"
            req.send_response(404)
            req.send_header("Content-Type", "text/plain")
            req.send_header("Content-Length", str(len(body)))
            req.end_headers()
            req.wfile.write(body)
            return
        req.send_response(200)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)
