"""The port's fleet admin plane (`imaginary_tpu_torch/obs/aggregate.py`)
held against the reference's (`imaginary_tpu/obs/aggregate.py`).

A port copy of `tests/test_aggregate.py` (its classes by name: the
exposition parser, the merge policy, the reset-correcting aggregator,
summable gauges, pruning, the merged render, the shared-port scrape,
/fleetz, and the FleetAdmin HTTP server end to end) and of
`tests/test_obs.py::TestFleetCapacityMerge`. Then the two modules on the
same seeded inputs: `build_fleetz` gives the reference's JSON for random
supervisor views, /health bodies (capacity blocks included) and missed
sets, and the aggregator's merged exposition (the fleet total and the
per-worker view) is the reference's byte for byte after the same
sequence of scrapes, respawns and prunes.

Everything here is supervisor-side and stdlib-only: no torch, no live
fleet (tests/test_torch_workers.py boots real workers).
"""

import http.client
import itertools
import json
import threading

import pytest

from imaginary_tpu_torch.obs.aggregate import (
    Aggregator,
    FleetAdmin,
    build_fleetz,
    merge_mode,
    parse_exposition,
    scrape_fleet,
)
from tests.test_obs import check_histograms, parse_exposition_strict


def worker_exposition(worker: int, epoch: int, requests: float,
                      bucket_01: float, threads: float = 7,
                      fleet_slots: float = 128.0) -> str:
    """A minimal but representative worker /metrics body: identity
    gauges, a RED counter, a histogram, a summable gauge, and the
    shared-shm slot gauge every worker reports identically."""
    dur_sum = requests * 0.05
    return (
        "# HELP imaginary_tpu_worker Worker index of the serving process.\n"
        "# TYPE imaginary_tpu_worker gauge\n"
        f"imaginary_tpu_worker {worker}\n"
        "# HELP imaginary_tpu_epoch Supervisor-minted fencing epoch.\n"
        "# TYPE imaginary_tpu_epoch gauge\n"
        f"imaginary_tpu_epoch {epoch}\n"
        "# HELP imaginary_tpu_requests_total Requests by route and class.\n"
        "# TYPE imaginary_tpu_requests_total counter\n"
        f'imaginary_tpu_requests_total{{route="resize",code="2xx"}} '
        f"{requests}\n"
        "# HELP imaginary_tpu_request_duration_seconds End-to-end latency.\n"
        "# TYPE imaginary_tpu_request_duration_seconds histogram\n"
        f'imaginary_tpu_request_duration_seconds_bucket{{le="0.1"}} '
        f"{bucket_01}\n"
        f'imaginary_tpu_request_duration_seconds_bucket{{le="+Inf"}} '
        f"{requests}\n"
        f"imaginary_tpu_request_duration_seconds_sum {dur_sum}\n"
        f"imaginary_tpu_request_duration_seconds_count {requests}\n"
        "# HELP imaginary_tpu_threads Live threads in this process.\n"
        "# TYPE imaginary_tpu_threads gauge\n"
        f"imaginary_tpu_threads {threads}\n"
        "# HELP imaginary_tpu_fleet_slots Slots in the shared shm cache.\n"
        "# TYPE imaginary_tpu_fleet_slots gauge\n"
        f"imaginary_tpu_fleet_slots {fleet_slots}\n"
        "# HELP imaginary_tpu_rss_mb Resident set size.\n"
        "# TYPE imaginary_tpu_rss_mb gauge\n"
        f"imaginary_tpu_rss_mb {100 + worker}\n"
    )


def health_body(worker: int, epoch: int) -> str:
    return json.dumps({"worker": worker, "epoch": epoch,
                       "uptime": 12.5, "backend": "cpu"})


class TestParseExposition:
    def test_histogram_samples_fold_into_base_family(self):
        fams = parse_exposition(worker_exposition(0, 1, 10, 8))
        hist = fams["imaginary_tpu_request_duration_seconds"]
        assert hist.mtype == "histogram"
        sample_names = {name for name, _ in hist.samples}
        assert sample_names == {
            "imaginary_tpu_request_duration_seconds_bucket",
            "imaginary_tpu_request_duration_seconds_sum",
            "imaginary_tpu_request_duration_seconds_count",
        }

    def test_labels_and_values(self):
        fams = parse_exposition(worker_exposition(0, 1, 10, 8))
        red = fams["imaginary_tpu_requests_total"]
        ((name, labels),) = [k for k in red.samples]
        assert name == "imaginary_tpu_requests_total"
        assert dict(labels) == {"route": "resize", "code": "2xx"}
        assert red.samples[(name, labels)] == 10.0

    def test_tolerates_openmetrics_exemplar_clause(self):
        text = (
            "# TYPE imaginary_tpu_request_duration_seconds histogram\n"
            'imaginary_tpu_request_duration_seconds_bucket{le="0.1"} 8'
            ' # {trace_id="abc",request_id="rid"} 0.07\n'
        )
        fams = parse_exposition(text)
        hist = fams["imaginary_tpu_request_duration_seconds"]
        assert list(hist.samples.values()) == [8.0]

    def test_label_value_containing_brace(self):
        # Prometheus only requires escaping '"', '\' and newline in a
        # label value, so a literal '}' (think templated route labels)
        # is legal and must not truncate the label block
        text = (
            "# TYPE imaginary_tpu_requests_total counter\n"
            'imaginary_tpu_requests_total'
            '{route="/v1/{spec}/resize",code="2xx"} 3\n'
        )
        fams = parse_exposition(text)
        red = fams["imaginary_tpu_requests_total"]
        ((name, labels),) = list(red.samples)
        assert dict(labels) == {"route": "/v1/{spec}/resize", "code": "2xx"}
        assert red.samples[(name, labels)] == 3.0


class TestMergeMode:
    def test_counters_and_histograms_sum(self):
        assert merge_mode("imaginary_tpu_requests_total", "counter") == "sum"
        assert merge_mode(
            "imaginary_tpu_request_duration_seconds", "histogram") == "sum"

    def test_shared_shm_gauges_never_sum(self):
        # every worker reports the SAME shm file: summing double-counts
        assert merge_mode("imaginary_tpu_fleet_slots", "gauge") == "per_worker"
        assert merge_mode("imaginary_tpu_fleet_used_bytes",
                          "gauge") == "per_worker"

    def test_per_process_quantities_sum_only_when_allowlisted(self):
        assert merge_mode("imaginary_tpu_executor_queue_depth",
                          "gauge") == "sum"
        assert merge_mode("imaginary_tpu_threads", "gauge") == "sum"
        # categorical / identity / per-process state: labeled, not summed
        assert merge_mode("imaginary_tpu_rss_mb", "gauge") == "per_worker"
        assert merge_mode("imaginary_tpu_pressure_state",
                          "gauge") == "per_worker"


class TestAggregatorMonotonicity:
    def test_two_workers_sum(self):
        agg = Aggregator()
        agg.observe(0, 1, parse_exposition(worker_exposition(0, 1, 100, 80)))
        agg.observe(1, 2, parse_exposition(worker_exposition(1, 2, 40, 30)))
        types, samples = parse_exposition_strict(agg.render())
        red = {tuple(sorted(labels.items())): v for n, labels, v in samples
               if n == "imaginary_tpu_requests_total"}
        assert list(red.values()) == [140.0]

    def test_respawn_reset_never_goes_backwards(self):
        # worker 1 crashes at 40 requests and respawns (epoch 2 -> 5)
        # with counters back at zero; the merged total must never dip
        agg = Aggregator()
        agg.observe(0, 1, parse_exposition(worker_exposition(0, 1, 100, 80)))
        agg.observe(1, 2, parse_exposition(worker_exposition(1, 2, 40, 30)))

        def fleet_total():
            _, samples = parse_exposition_strict(agg.render())
            return next(v for n, _l, v in samples
                        if n == "imaginary_tpu_requests_total")

        assert fleet_total() == 140.0
        agg.observe(1, 5, parse_exposition(worker_exposition(1, 5, 0, 0)))
        assert fleet_total() == 140.0  # dead epoch folded into the base
        agg.observe(1, 5, parse_exposition(worker_exposition(1, 5, 7, 5)))
        assert fleet_total() == 147.0
        # histogram counts ride the same correction
        _, samples = parse_exposition_strict(agg.render())
        count = next(v for n, _l, v in samples
                     if n == "imaginary_tpu_request_duration_seconds_count")
        assert count == 147.0

    def test_same_epoch_regression_clamped(self):
        agg = Aggregator()
        agg.observe(0, 1, parse_exposition(worker_exposition(0, 1, 50, 40)))
        agg.observe(0, 1, parse_exposition(worker_exposition(0, 1, 44, 40)))
        _, samples = parse_exposition_strict(agg.render())
        total = next(v for n, _l, v in samples
                     if n == "imaginary_tpu_requests_total")
        assert total == 50.0

    def test_older_epoch_scrape_ignored(self):
        # a deposed zombie's last gasp racing its replacement
        agg = Aggregator()
        agg.observe(0, 3, parse_exposition(worker_exposition(0, 3, 10, 8)))
        agg.observe(0, 2, parse_exposition(
            worker_exposition(0, 2, 9999, 9999)))
        _, samples = parse_exposition_strict(agg.render())
        total = next(v for n, _l, v in samples
                     if n == "imaginary_tpu_requests_total")
        assert total == 10.0


class TestSummableGaugeSnapshots:
    """Summable gauges are latest-snapshot sums, never reset-corrected:
    the counter machinery's max() clamp and base folding would pin a
    draining queue at its high-water mark and inflate fleet totals on
    every respawn."""

    def _gauge(self, agg, name="imaginary_tpu_threads"):
        _, samples = parse_exposition_strict(agg.render())
        return next(v for n, _l, v in samples if n == name)

    def test_gauge_decrease_tracks_snapshot(self):
        agg = Aggregator()
        agg.observe(0, 1, parse_exposition(
            worker_exposition(0, 1, 10, 8, threads=9)))
        agg.observe(1, 2, parse_exposition(
            worker_exposition(1, 2, 10, 8, threads=7)))
        assert self._gauge(agg) == 16.0
        # worker 0's pool shrinks: the fleet total must follow DOWN
        agg.observe(0, 1, parse_exposition(
            worker_exposition(0, 1, 12, 9, threads=3)))
        assert self._gauge(agg) == 10.0

    def test_gauge_not_inflated_across_respawn(self):
        agg = Aggregator()
        agg.observe(0, 1, parse_exposition(
            worker_exposition(0, 1, 10, 8, threads=9)))
        # respawn (epoch 1 -> 4): the new incarnation's gauge REPLACES
        # the dead one's — no permanent base from the old value
        agg.observe(0, 4, parse_exposition(
            worker_exposition(0, 4, 0, 0, threads=5)))
        assert self._gauge(agg) == 5.0
        # ...while the counter DID fold the dead incarnation's total
        _, samples = parse_exposition_strict(agg.render())
        total = next(v for n, _l, v in samples
                     if n == "imaginary_tpu_requests_total")
        assert total == 10.0

    def test_per_worker_view_serves_snapshots_too(self):
        agg = Aggregator()
        agg.observe(0, 1, parse_exposition(
            worker_exposition(0, 1, 10, 8, threads=9)))
        agg.observe(0, 1, parse_exposition(
            worker_exposition(0, 1, 11, 9, threads=2)))
        _, samples = parse_exposition_strict(agg.render(per_worker=True))
        threads = {labels["worker"]: v for n, labels, v in samples
                   if n == "imaginary_tpu_threads"}
        assert threads == {"0": 2.0}


class TestPrune:
    def _agg(self):
        agg = Aggregator()
        agg.observe(0, 1, parse_exposition(worker_exposition(0, 1, 100, 80)))
        agg.observe(1, 2, parse_exposition(worker_exposition(1, 2, 40, 30)))
        return agg

    def test_departed_worker_state_evicted(self):
        agg = self._agg()
        agg.prune({0})
        assert agg.workers_seen() == {0: 1}
        _, samples = parse_exposition_strict(agg.render())
        # per-worker series for the departed index are gone
        assert {labels["worker"] for n, labels, _v in samples
                if n == "imaginary_tpu_rss_mb"} == {"0"}
        # its summable-gauge contribution drops out of the fleet total
        threads = next(v for n, _l, v in samples
                       if n == "imaginary_tpu_threads")
        assert threads == 7.0
        # but counter totals stay monotonic: the retired index's final
        # value folds into a per-series base
        total = next(v for n, _l, v in samples
                     if n == "imaginary_tpu_requests_total")
        assert total == 140.0
        count = next(v for n, _l, v in samples
                     if n == "imaginary_tpu_request_duration_seconds_count")
        assert count == 140.0

    def test_retired_base_survives_later_observes(self):
        agg = self._agg()
        agg.prune({0})
        agg.observe(0, 1, parse_exposition(worker_exposition(0, 1, 107, 85)))
        _, samples = parse_exposition_strict(agg.render())
        total = next(v for n, _l, v in samples
                     if n == "imaginary_tpu_requests_total")
        assert total == 147.0

    def test_prune_noop_when_all_tracked(self):
        agg = self._agg()
        agg.prune({0, 1})
        _, samples = parse_exposition_strict(agg.render())
        total = next(v for n, _l, v in samples
                     if n == "imaginary_tpu_requests_total")
        assert total == 140.0
        assert agg.workers_seen() == {0: 1, 1: 2}


class TestMergedRender:
    def _agg(self):
        agg = Aggregator()
        agg.observe(0, 1, parse_exposition(worker_exposition(0, 1, 100, 80)))
        agg.observe(1, 2, parse_exposition(worker_exposition(1, 2, 40, 30)))
        return agg

    def test_strict_parse_and_histogram_consistency(self):
        types, samples = parse_exposition_strict(self._agg().render())
        check_histograms(types, samples)
        assert types["imaginary_tpu_requests_total"] == "counter"
        assert types["imaginary_tpu_request_duration_seconds"] == "histogram"

    def test_gauge_discipline_in_merged_view(self):
        _, samples = parse_exposition_strict(self._agg().render())
        by_name: dict = {}
        for n, labels, v in samples:
            by_name.setdefault(n, []).append((labels, v))
        # allowlisted gauge summed into one series
        ((labels, v),) = by_name["imaginary_tpu_threads"]
        assert "worker" not in labels and v == 14.0
        # shared-shm gauge split per worker, never summed
        slots = by_name["imaginary_tpu_fleet_slots"]
        assert sorted(labels["worker"] for labels, _ in slots) == ["0", "1"]
        assert all(v == 128.0 for _, v in slots)
        # identity gauge dropped from the merged view entirely
        assert "imaginary_tpu_worker" not in by_name
        # per-process gauge labeled by worker
        rss = {labels["worker"]: v
               for labels, v in by_name["imaginary_tpu_rss_mb"]}
        assert rss == {"0": 100.0, "1": 101.0}

    def test_per_worker_debug_view(self):
        text = self._agg().render(per_worker=True)
        types, samples = parse_exposition_strict(text)
        red = [(labels, v) for n, labels, v in samples
               if n == "imaginary_tpu_requests_total"]
        assert {labels["worker"]: v for labels, v in red} \
            == {"0": 100.0, "1": 40.0}

    def test_extra_gauges_appended(self):
        text = self._agg().render(extra_gauges=[
            ("imaginary_tpu_fleet_admin_workers", "tracked workers", 2)])
        types, samples = parse_exposition_strict(text)
        assert types["imaginary_tpu_fleet_admin_workers"] == "gauge"
        assert any(n == "imaginary_tpu_fleet_admin_workers" and v == 2.0
                   for n, _l, v in samples)


# --- shared-port scraping -----------------------------------------------------


def round_robin_fetch(bodies_by_kind):
    """fetch(url, timeout) that cycles each URL kind through a list of
    bodies — models the kernel's SO_REUSEPORT pick landing on successive
    workers. A body of None raises TimeoutError (worker not answering)."""
    counters = {kind: itertools.cycle(bodies)
                for kind, bodies in bodies_by_kind.items()}
    lock = threading.Lock()

    def fetch(url, timeout):
        kind = "metrics" if "/metrics" in url else "health"
        with lock:
            body = next(counters[kind])
        if body is None:
            raise TimeoutError("worker did not answer")
        return body

    return fetch


class TestScrapeFleet:
    def test_full_coverage(self):
        fetch = round_robin_fetch({
            "metrics": [worker_exposition(0, 1, 10, 8),
                        worker_exposition(1, 1, 20, 15)],
            "health": [health_body(0, 1), health_body(1, 1)],
        })
        metrics_by, health_by, missed = scrape_fleet(
            "http://x/metrics", "http://x/health", {0, 1},
            deadline_s=2.0, fetch=fetch)
        assert missed == set()
        assert set(metrics_by) == {0, 1} and set(health_by) == {0, 1}
        assert metrics_by[0][0] == 1  # epoch rode along
        assert health_by[1]["worker"] == 1

    def test_unresponsive_worker_reported_missed(self):
        # worker 1 never answers: every sample lands on worker 0 or
        # times out; the scrape must return partial data, not hang or 500
        fetch = round_robin_fetch({
            "metrics": [worker_exposition(0, 1, 10, 8), None],
            "health": [health_body(0, 1), None],
        })
        metrics_by, health_by, missed = scrape_fleet(
            "http://x/metrics", "http://x/health", {0, 1},
            deadline_s=0.3, per_request_timeout=0.05, fetch=fetch)
        assert missed == {1}
        assert set(metrics_by) == {0} and set(health_by) == {0}

    def test_higher_epoch_wins_within_one_scrape(self):
        # zombie + replacement both answering during a roll: keep the new
        fetch = round_robin_fetch({
            "metrics": [worker_exposition(0, 4, 3, 2),
                        worker_exposition(0, 3, 900, 900)],
            "health": [health_body(0, 4), health_body(0, 3)],
        })
        metrics_by, health_by, missed = scrape_fleet(
            "http://x/metrics", "http://x/health", {0},
            deadline_s=0.3, fetch=fetch)
        assert metrics_by[0][0] == 4
        assert health_by[0]["epoch"] == 4


class TestFleetz:
    def test_stale_flag_on_missed_worker(self):
        view = {
            0: {"pid": 11, "alive": True, "epoch": 1, "restarts": 0},
            1: {"pid": 12, "alive": True, "epoch": 3, "restarts": 2},
        }
        payload = build_fleetz(view, {0: json.loads(health_body(0, 1))},
                               missed={1}, now=123.0)
        w = payload["workers"]
        assert w["0"]["stale"] is False
        assert w["0"]["health"]["backend"] == "cpu"
        # the missed worker still appears with supervisor truth
        assert w["1"]["stale"] is True and w["1"]["health"] is None
        assert w["1"]["pid"] == 12 and w["1"]["restarts"] == 2
        assert payload["missed"] == [1]
        assert payload["scraped"] == [0]


# --- the admin HTTP server, end to end ----------------------------------------


@pytest.fixture
def admin():
    fetch = round_robin_fetch({
        "metrics": [worker_exposition(0, 1, 100, 80),
                    worker_exposition(1, 2, 40, 30)],
        "health": [health_body(0, 1), health_body(1, 2)],
    })

    def view():
        return {0: {"pid": 11, "alive": True, "epoch": 1, "restarts": 0},
                1: {"pid": 12, "alive": True, "epoch": 2, "restarts": 1}}

    srv = FleetAdmin(0, "http://shared/metrics", "http://shared/health",
                     view, scrape_deadline_s=1.0, fetch=fetch).start()
    try:
        yield srv
    finally:
        srv.close()


def _get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode("utf-8")
    finally:
        conn.close()


class TestFleetAdminHTTP:
    def test_merged_metrics_strict_and_summed(self, admin):
        status, text = _get(admin.port, "/metrics")
        assert status == 200
        types, samples = parse_exposition_strict(text)
        check_histograms(types, samples)
        total = next(v for n, _l, v in samples
                     if n == "imaginary_tpu_requests_total")
        assert total == 140.0
        # the synthetic supervisor gauges ride along
        assert any(n == "imaginary_tpu_fleet_admin_workers" and v == 2.0
                   for n, _l, v in samples)
        assert any(n == "imaginary_tpu_fleet_admin_workers_unscraped"
                   and v == 0.0 for n, _l, v in samples)

    def test_per_worker_query(self, admin):
        status, text = _get(admin.port, "/metrics?per_worker=1")
        assert status == 200
        _, samples = parse_exposition_strict(text)
        red = {labels["worker"]: v for n, labels, v in samples
               if n == "imaginary_tpu_requests_total"}
        assert red == {"0": 100.0, "1": 40.0}

    def test_fleetz_shape(self, admin):
        status, text = _get(admin.port, "/fleetz")
        assert status == 200
        payload = json.loads(text)
        assert set(payload["workers"]) == {"0", "1"}
        assert payload["workers"]["1"]["restarts"] == 1
        assert payload["workers"]["1"]["health"]["epoch"] == 2
        assert payload["missed"] == []

    def test_unknown_path_404(self, admin):
        status, _ = _get(admin.port, "/nope")
        assert status == 404

    def test_scaled_down_worker_evicted_but_totals_hold(self):
        # the supervisor stops tracking index 1 between two admin
        # requests; its zombie keeps answering the shared port. The
        # merged view must drop its gauges (no stale series forever)
        # without regressing fleet counter totals — and without
        # re-folding the zombie's answers into the base every scrape.
        fetch = round_robin_fetch({
            "metrics": [worker_exposition(0, 1, 100, 80),
                        worker_exposition(1, 2, 40, 30)],
            "health": [health_body(0, 1), health_body(1, 2)],
        })
        tracked = {0: {"pid": 11, "alive": True, "epoch": 1, "restarts": 0},
                   1: {"pid": 12, "alive": True, "epoch": 2, "restarts": 1}}

        srv = FleetAdmin(0, "http://shared/metrics", "http://shared/health",
                         lambda: dict(tracked), scrape_deadline_s=1.0,
                         fetch=fetch).start()
        try:
            _, text = _get(srv.port, "/metrics")
            _, samples = parse_exposition_strict(text)
            assert next(v for n, _l, v in samples
                        if n == "imaginary_tpu_requests_total") == 140.0
            del tracked[1]
            for _ in range(2):  # two scrapes: retired base must not grow
                _, text = _get(srv.port, "/metrics")
            _, samples = parse_exposition_strict(text)
            assert {labels["worker"] for n, labels, _v in samples
                    if n == "imaginary_tpu_rss_mb"} == {"0"}
            assert next(v for n, _l, v in samples
                        if n == "imaginary_tpu_threads") == 7.0
            assert next(v for n, _l, v in samples
                        if n == "imaginary_tpu_requests_total") == 140.0
        finally:
            srv.close()

    def test_totals_monotonic_across_admin_requests(self, admin):
        # the persistent Aggregator means a second scrape that catches a
        # freshly-respawned worker cannot regress the merged totals
        _, text1 = _get(admin.port, "/metrics")
        _, samples1 = parse_exposition_strict(text1)
        _, text2 = _get(admin.port, "/metrics")
        _, samples2 = parse_exposition_strict(text2)
        t1 = next(v for n, _l, v in samples1
                  if n == "imaginary_tpu_requests_total")
        t2 = next(v for n, _l, v in samples2
                  if n == "imaginary_tpu_requests_total")
        assert t2 >= t1


# --- the reference's TestFleetCapacityMerge (tests/test_obs.py) ------------


class TestFleetCapacityMerge:
    def test_fleetz_merges_capacity_across_workers(self):
        from imaginary_tpu_torch.obs.aggregate import build_fleetz

        def health(verdict, device_ms, folds=0):
            return {
                "worker": 0, "epoch": 1,
                "capacity": {
                    "folds": folds,
                    "windows": {"10s": {"device_ms": device_ms,
                                        "requests": 2}},
                    "bound_by": {"verdict": verdict},
                },
            }

        view = {0: {"pid": 10, "alive": True}, 1: {"pid": 11, "alive": True}}
        out = build_fleetz(
            view,
            {0: health("chip", 10.0, folds=1),
             1: health("link", 5.0, folds=2)},
            missed=set(), now=123.0)
        cap = out["capacity"]
        assert cap["workers"] == [0, 1]
        assert cap["folds"] == 3
        assert cap["windows"]["10s"]["device_ms"] == pytest.approx(15.0)
        assert cap["windows"]["10s"]["requests"] == 4
        assert cap["bound_by"] == {"0": "chip", "1": "link"}

    def test_fleetz_parity_without_capacity(self):
        from imaginary_tpu_torch.obs.aggregate import build_fleetz

        out = build_fleetz({0: {"pid": 10}}, {0: {"worker": 0}},
                           missed=set(), now=123.0)
        assert "capacity" not in out


# --- the port against the reference on the same inputs ---------------------


def _seeded_health(rng, worker: int) -> dict:
    h = {"worker": worker, "epoch": int(rng.integers(1, 50)), "pid": int(rng.integers(100, 9999)),
         "estimatedQueueMs": float(rng.integers(0, 500)) / 4.0}
    if rng.random() < 0.6:
        h["capacity"] = {
            "folds": int(rng.integers(0, 9)),
            "windows": {label: {"device_ms": float(rng.integers(0, 10000)) / 8.0,
                                "requests": int(rng.integers(0, 50)),
                                "host_ms": float(rng.integers(0, 999)) / 3.0}
                        for label in ("10s", "1m")[: int(rng.integers(1, 3))]},
            "bound_by": {"verdict": str(rng.choice(["chip", "link", "host-codecs"]))},
        }
    return h


def test_build_fleetz_equals_the_references():
    import numpy as np

    from imaginary_tpu.obs import aggregate as jaggregate

    rng = np.random.default_rng(31)
    for _ in range(200):
        n = int(rng.integers(1, 9))
        view = {i: {"pid": int(rng.integers(100, 9999)), "alive": bool(rng.random() < 0.8),
                    "epoch": int(rng.integers(1, 50)), "restarts": int(rng.integers(0, 5)),
                    "spawned_s_ago": float(rng.integers(0, 999)) / 10.0,
                    "liveness_age_s": None if rng.random() < 0.2
                    else float(rng.integers(0, 99)) / 10.0}
                for i in range(n)}
        health = {i: _seeded_health(rng, i) for i in range(n) if rng.random() < 0.8}
        missed = {i for i in range(n) if i not in health or rng.random() < 0.1}
        now = float(rng.integers(1_000_000, 2_000_000))
        assert build_fleetz(view, health, missed, now=now) == \
            jaggregate.build_fleetz(view, health, missed, now=now)


def test_merged_exposition_equals_the_references():
    """The same scrapes (two workers, a respawn with reset counters, a
    zombie's stale scrape, a scaled-down index) through both aggregators
    render the same text, fleet total and per worker."""
    import numpy as np

    from imaginary_tpu.obs import aggregate as jaggregate

    rng = np.random.default_rng(47)
    port, ref = Aggregator(), jaggregate.Aggregator()
    epochs = {0: 1, 1: 2, 2: 3}
    counts = {0: 0.0, 1: 0.0, 2: 0.0}
    for step in range(40):
        w = int(rng.choice(sorted(epochs)))
        if rng.random() < 0.1:
            epochs[w] += 3  # a respawn: counters start again
            counts[w] = 0.0
        counts[w] += float(rng.integers(0, 20))
        epoch = epochs[w] - (1 if rng.random() < 0.05 else 0)  # a zombie's last scrape
        text = worker_exposition(w, epoch, counts[w], counts[w] // 2,
                                 threads=float(rng.integers(2, 30)))
        port.observe(w, epoch, parse_exposition(text))
        ref.observe(w, epoch, jaggregate.parse_exposition(text))
        if step == 30:
            port.prune({0, 1})
            ref.prune({0, 1})
            epochs.pop(2)
            counts.pop(2)
        extra = [("imaginary_tpu_fleet_admin_workers", "tracked", len(epochs))]
        for per_worker in (False, True):
            got = port.render(per_worker=per_worker, extra_gauges=extra)
            assert got == ref.render(per_worker=per_worker, extra_gauges=extra)
    assert port.workers_seen() == ref.workers_seen()
    types, samples = parse_exposition_strict(port.render())
    check_histograms(types, samples)
    for name in ("imaginary_tpu_requests_total", "imaginary_tpu_threads",
                 "imaginary_tpu_fleet_slots"):
        assert merge_mode(name, types[name]) == jaggregate.merge_mode(name, types[name])
