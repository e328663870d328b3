"""The port's HTTP layer held against the reference's, request by request.

The same requests go to the reference's `create_app` (the JAX package,
on the CPU) and to the port's (`device="cpu"`), each app built from the
same ServerOptions fields, and the answers are compared:

- status and content type: equal;
- body: byte-equal for JSON and HTML, and for images at most 1 LSB apart
  after decoding (the bound of ROADMAP.md's ground rules);
- the set of header names: equal, and the metric names of Server-Timing
  equal in order.

What may differ, and why:
- the values of `Date`, `X-Request-ID` and `Server`, and the durations
  in Server-Timing (each server's own clock and name);
- `/`'s body: the reference reports {imaginary_tpu, jax, backend}, the
  port {imaginary_tpu_torch, torch, backend} (each names its own stack;
  the keys' count and `backend` agree);
- `/health`'s body: live runtime values. The port's keys hold every key
  of the reference's (`eventLoop` too, once each app's loop-lag probe has
  sampled); with `--qos-config` and `--pressure-rss-mb` armed (the
  `admission` group) the `qos`, `pressure` and `arena` blocks have the
  reference's keys and the executor's keys are a subset of its; with
  every cache tier armed (the `cache` group) the `cache` block has the
  reference's keys and its hit and miss counts;
- `/metrics`'s body: live values. Every family the reference renders for
  a subsystem the port has is in the port's exposition, with the same
  type (the `admission` group adds the qos, pressure, link and arena
  families, the `cache` group the `imaginary_tpu_cache_*` families);
- the cache group's `ETag` values are equal too (the same request key);
- nothing: `/watermarkimage` and the `?url=` source are sent too, both
  apps with `enable_url_source` fetching from one shared local origin on
  127.0.0.1 (the `url` group), whose 404, an invalid URL, an origin off
  the allow-list and a body past --max-allowed-size get the reference's
  statuses and JSON messages;
- a placeholder answer's Server-Timing: the port resizes the placeholder
  through its executor (on the card in production), so it also carries
  the executor's batch_form, dispatch_wait and drain, where the
  reference calls its chain directly; the other names agree in order.

The reference app runs with `host_spill=False`, the port's default (its
`--host-spill` is off where the reference's is auto): a reference
request that spilled to the host would carry host_gate/host_spill spans
and `X-Imaginary-Backend: host`. /flop,
/zoom and the watermark image on a JPEG ask for PNG: a JPEG /flop's or
watermark's planes, 1 LSB apart before the encode, come back up to 5 LSB
apart through the encoder's quantization (the chain's planes are held at
1 LSB in tests/test_torch_pipeline.py), and a GIF's palette differs by
design (ROADMAP.md queue 3, "Palette output").
"""

from __future__ import annotations

import asyncio
import dataclasses
import io
import json
import socket
import urllib.parse

import numpy as np
import pytest
from aiohttp import FormData
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from tests.conftest import FIXTURES, fixture_bytes
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

LARGE = "large.jpg"
# the `url` group's origin: "{origin}" in a path is its base URL and
# "{other}" the same origin by another host name, off the allow-list
URL_CAP = 2_000_000  # --max-allowed-size of the url group
MARK_SEED = 14
PNG = "test.png"
_OPS = urllib.parse.quote(json.dumps([
    {"operation": "crop", "params": {"width": 300, "height": 260}},
    {"operation": "convert", "params": {"type": "webp"}},
]))

# (id, method, path, source, headers): source is a fixture name (raw
# POST body), "form:<name>" (multipart `file` field), bytes, or None
ROUTES = [
    ("resize", "POST", "/resize?width=300&height=200", LARGE, {}),
    ("fit", "POST", "/fit?width=300&height=300", LARGE, {}),
    ("enlarge", "POST", "/enlarge?width=2400&height=1400", LARGE, {}),
    ("extract", "POST", "/extract?top=10&left=20&areawidth=300&areaheight=200", LARGE, {}),
    ("crop", "POST", "/crop?width=300&height=200", LARGE, {}),
    ("smartcrop", "POST", "/smartcrop?width=300&height=200", LARGE, {}),
    ("rotate", "POST", "/rotate?rotate=90", "exif-orient-6.jpg", {}),
    ("autorotate", "POST", "/autorotate", "exif-orient-6.jpg", {}),
    ("flip", "POST", "/flip", "exif-orient-6.jpg", {}),
    ("flop", "POST", "/flop?type=png", "exif-orient-6.jpg", {}),
    ("thumbnail", "POST", "/thumbnail?width=300&height=200", LARGE, {}),
    ("zoom", "POST", "/zoom?factor=2&type=png", "test.gif", {}),
    ("convert", "POST", "/convert?type=png", "imaginary.jpg", {}),
    ("blur", "POST", "/blur?sigma=2", PNG, {}),
    ("watermark", "POST", "/watermark?text=port&opacity=0.5", "test.webp", {}),
    ("info", "GET", "/info?file=large.jpg", None, {}),
    ("pipeline", "POST", "/pipeline?operations=" + _OPS, "form:imaginary.jpg", {}),
    ("get-mounted", "GET", "/resize?width=300&height=200&file=large.jpg", None, {}),
    ("type-auto", "POST", "/resize?width=100&type=auto", LARGE,
     {"Accept": "image/webp,*/*"}),
    ("bw", "POST", "/resize?width=300&colorspace=bw", LARGE, {}),
]
PUBLIC = [
    ("index", "GET", "/", None, {}),
    ("form", "GET", "/form", None, {}),
    ("health", "GET", "/health", None, {}),
    ("metrics", "GET", "/metrics", None, {}),
]
ERRORS = [
    ("405-delete", "DELETE", "/resize?width=300", None, {}),
    ("405-put-index", "PUT", "/", None, {}),
    ("404-unknown", "GET", "/nope", None, {}),
    ("404-nested", "GET", "/resize/x?width=300", None, {}),
    ("400-bad-param", "POST", "/resize?width=bogus", LARGE, {}),
    ("400-missing-param", "POST", "/resize", LARGE, {}),
    ("400-bad-type", "POST", "/resize?width=300&type=bogus", LARGE, {}),
    ("400-empty-body", "POST", "/resize?width=300", b"", {}),
    ("400-bad-file", "GET", "/resize?width=300&file=../../etc/passwd", None, {}),
    ("400-no-source", "GET", "/resize?width=300", None, {}),
    ("400-wrong-field", "POST", "/resize?width=100", "form-photo:imaginary.jpg", {}),
    ("406-not-an-image", "POST", "/resize?width=300", b"clearly not an image", {}),
    ("400-pipeline-empty", "POST", "/pipeline", PNG, {}),
]
# (group, ServerOptions fields, cases)
GROUPS = {
    "mount": ({"mount": FIXTURES}, ROUTES + PUBLIC + ERRORS),
    "guard": ({"max_allowed_pixels": 0.1}, [
        ("422-resolution", "POST", "/resize?width=100", LARGE, {})]),
    "no-mount": ({}, [("405-get-without-mount", "GET", "/resize?width=300&file=large.jpg",
                       None, {})]),
    "key": ({"api_key": "s3cret"}, [
        ("401-no-key", "POST", "/resize?width=100", LARGE, {}),
        ("401-metrics", "GET", "/metrics", None, {}),
        ("200-key-header", "POST", "/resize?width=100", LARGE, {"API-Key": "s3cret"}),
        ("200-key-query", "POST", "/resize?width=100&key=s3cret", LARGE, {})]),
    "signature": ({"enable_url_signature": True, "url_signature_key": "x" * 32}, [
        ("400-bad-signature", "POST", "/crop?width=100&sign=invalid!!", LARGE, {}),
        ("403-signature-mismatch", "POST",
         "/crop?width=100&sign=Xl8cFe7ybcjOpCdxcGVo6SuNg1bVR1H1dwTiFPJZmRw", LARGE, {})]),
    "throttle": ({"concurrency": 1, "burst": 0}, [
        ("200-first", "GET", "/health", None, {}),
        ("429-second", "GET", "/health", None, {})]),
    "admission": ({"qos_config": json.dumps({
        "default": {"class": "standard"},
        "tenants": [{"name": "gold", "class": "interactive", "api_keys": ["gold-key"]},
                    {"name": "lim", "class": "standard", "api_keys": ["lim-key"],
                     "rate": 1, "burst": 0}]}),
        "pressure_rss_mb": 1e6, "mount": FIXTURES}, [
        ("admission-resize", "POST", "/resize?width=300&height=200", LARGE,
         {"API-Key": "gold-key"}),
        ("admission-lim-first", "GET", "/form", None, {"API-Key": "lim-key"}),
        ("admission-429-lim", "GET", "/form", None, {"API-Key": "lim-key"}),
        ("admission-health", "GET", "/health", None, {}),
        ("admission-metrics", "GET", "/metrics", None, {})]),
    "cache": ({"cache_result_mb": 8.0, "cache_frame_mb": 64.0, "cache_device_mb": 64.0,
               "cache_coalesce": True, "cache_source_ttl": 60.0, "transport_dct": True,
               "mount": FIXTURES}, [
        ("cache-miss", "GET", "/resize?width=300&height=200&file=large.jpg", None, {}),
        ("cache-hit", "GET", "/resize?width=300&height=200&file=large.jpg", None, {}),
        ("cache-negotiated", "POST", "/resize?width=100&type=auto", LARGE,
         {"Accept": "image/png"}),
        ("cache-health", "GET", "/health", None, {}),
        ("cache-metrics", "GET", "/metrics", None, {})]),
    "pressure-guard": ({"max_allowed_pixels": 0.1, "pressure_rss_mb": 1e6}, [
        ("413-pressure-resolution", "POST", "/resize?width=100", LARGE, {})]),
    "placeholder": ({"enable_placeholder": True}, [
        ("placeholder-406", "POST", "/resize?width=300&height=200", b"not an image", {}),
        ("placeholder-400", "POST", "/resize?width=120&height=90&type=png", b"", {})]),
    "placeholder-status": ({"enable_placeholder": True, "placeholder_status": 202}, [
        ("placeholder-202", "POST", "/resize?width=60&height=60", b"junk", {})]),
    "prefix": ({"path_prefix": "/img", "mount": FIXTURES}, [
        ("prefix-resize", "POST", "/img/resize?width=300&height=200", LARGE, {}),
        ("prefix-index", "GET", "/img/", None, {}),
        ("prefix-health", "GET", "/img/health", None, {}),
        ("prefix-form", "GET", "/img/form", None, {}),
        ("prefix-unprefixed-404", "POST", "/resize?width=300", LARGE, {})]),
    "extras": ({"cors": True, "http_cache_ttl": 60, "return_size": True,
                "endpoints": ("blur",), "mount": FIXTURES}, [
        ("extras-get", "GET", "/resize?width=300&height=200&file=large.jpg", None, {}),
        ("extras-post", "POST", "/crop?width=120&height=90", LARGE, {}),
        ("extras-options", "OPTIONS", "/crop", None, {}),
        ("extras-501-disabled", "POST", "/blur?sigma=2", LARGE, {})]),
}

def _url_ops(*ops) -> str:
    return urllib.parse.quote(json.dumps(list(ops)))


_RESIZE_1280 = {"operation": "resize", "params": {"width": 1280}}
_MARK_OP = {"operation": "watermarkImage",
            "params": {"image": "{origin}/mark.png", "top": 10, "left": 10}}
GROUPS["url"] = ({"enable_url_source": True, "allowed_origins": "{origin}",
                  "max_allowed_size": URL_CAP}, [
    ("ok", "GET", "/resize?width=300&height=200&url={origin}/large.jpg", None, {}),
    ("502-origin-404", "GET", "/resize?width=300&url={origin}/gone.jpg", None, {}),
    ("400-bad-url", "GET", "/resize?width=300&url=not-a-url", None, {}),
    ("400-restricted", "GET", "/resize?width=300&url={other}/large.jpg", None, {}),
    ("413-oversize", "GET", "/resize?width=300&url={origin}/big.jpg", None, {}),
    ("watermarkimage", "GET", "/watermarkimage?url={origin}/large.jpg"
     "&image={origin}/mark.png&top=40&left=1500&opacity=0.6&type=png", None, {}),
    ("watermarkimage-post", "POST", "/watermarkimage?image={origin}/mark.png"
     "&top=10&left=10&type=png", "imaginary.jpg", {}),
    ("400-watermark-restricted", "POST", "/watermarkimage?image={other}/mark.png",
     "imaginary.jpg", {}),
    ("pipeline-watermark-jpeg", "GET", "/pipeline?url={origin}/large.jpg&operations="
     + _url_ops(_RESIZE_1280, {**_MARK_OP, "params": {**_MARK_OP["params"], "type": "png"}}),
     None, {}),
    ("pipeline-watermark-png", "GET", "/pipeline?url={origin}/test.png&operations="
     + _url_ops({"operation": "resize", "params": {"width": 200}}, _MARK_OP), None, {}),
])
CASES = [(g, *c) for g, (_, cases) in GROUPS.items() for c in cases]


def make_mark() -> bytes:
    """A seeded 240x96 RGBA PNG with a real alpha ramp."""
    rng = np.random.default_rng(MARK_SEED)
    rgb = rng.integers(0, 256, size=(96, 240, 3), dtype=np.uint8)
    alpha = np.tile(np.linspace(0, 255, 240).astype(np.uint8), (96, 1))[..., None]
    out = io.BytesIO()
    Image.fromarray(np.concatenate([rgb, alpha], axis=2), "RGBA").save(out, "PNG")
    return out.getvalue()


async def _start_origin():
    """The url group's origin: fixtures by name, the mark, a 404 and a
    body one byte over the cap."""
    from aiohttp import web

    mark = make_mark()

    async def handler(request):
        name = request.path.lstrip("/")
        if name == "mark.png":
            return web.Response(body=mark, content_type="image/png")
        if name == "big.jpg":
            return web.Response(body=b"\xff\xd8" + b"\0" * (URL_CAP - 1),
                                content_type="image/jpeg")
        if name in ("large.jpg", "imaginary.jpg"):
            return web.Response(body=fixture_bytes(name), content_type="image/jpeg")
        if name == "test.png":
            return web.Response(body=fixture_bytes(name), content_type="image/png")
        return web.Response(status=404, text="not here")

    oapp = web.Application()
    oapp.router.add_route("*", "/{tail:.*}", handler)
    origin = TestServer(oapp, host="127.0.0.1")
    await origin.start_server()
    return origin


def _request_args(src, headers):
    if src is None:
        return None, dict(headers)
    if isinstance(src, bytes):
        return src, {"Content-Type": "image/jpeg", **headers}
    if src.startswith("form"):
        field = "photo" if src.startswith("form-photo:") else "file"
        form = FormData()
        form.add_field(field, fixture_bytes(src.split(":", 1)[1]),
                       filename="x.jpg", content_type="image/jpeg")
        return form, dict(headers)
    return fixture_bytes(src), {"Content-Type": "image/jpeg", **headers}


def _raw_oversize(port: int) -> tuple:
    """A POST that declares a body past the 64 MB cap and sends none of
    it: (status, content type, body)."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(b"POST /resize?width=300 HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
                  b"Content-Type: image/jpeg\r\nContent-Length: 67108865\r\n\r\n")
        got = b""
        while data := s.recv(65536):
            got += data
    head, _, body = got.partition(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    fields = dict(ln.split(b": ", 1) for ln in lines[1:] if b": " in ln)
    return int(lines[0].split(b" ", 2)[1]), fields.get(b"Content-Type"), body


def _at(text: str, port: int) -> str:
    """`text` with its placeholders, plain or URL-quoted, filled in."""
    for name, url in (("{origin}", f"http://127.0.0.1:{port}"),
                      ("{other}", f"http://localhost:{port}")):
        text = text.replace(name, url).replace(urllib.parse.quote(name),
                                               urllib.parse.quote(url))
    return text


async def _serve(create_app, options_cls, fields, cases, origin_port, **extra):
    if fields.get("allowed_origins") == "{origin}":
        fields = {**fields, "allowed_origins": ((f"127.0.0.1:{origin_port}", ""),)}
    app = create_app(options_cls(**fields, **extra), log_stream=io.StringIO())
    client = TestClient(TestServer(app))
    await client.start_server()
    out = {}
    try:
        for cid, method, path, src, headers in cases:
            data, hdrs = _request_args(src, headers)
            r = await client.request(method, _at(path, origin_port), data=data,
                                     headers=hdrs)
            out[cid] = (r.status, dict(r.headers), await r.read())
        if cases is GROUPS["mount"][1]:
            out["413-oversize"] = await asyncio.to_thread(_raw_oversize, client.port)
    finally:
        await client.close()
    return out


@pytest.fixture(scope="module")
def answers(testdata):
    """{group: ({case: reference answer}, {case: port answer})}."""
    from imaginary_tpu.web import placeholder as ref_placeholder
    from imaginary_tpu.web.app import create_app as ref_app
    from imaginary_tpu.web.config import ServerOptions as RefOptions
    from imaginary_tpu_torch.web.app import create_app as port_app
    from imaginary_tpu_torch.web.config import ServerOptions as PortOptions

    from imaginary_tpu.engine.timing import WIRE as REF_WIRE
    from imaginary_tpu_torch.engine.timing import WIRE

    # the reference keeps each resized placeholder for the process, so a
    # placeholder an earlier test file rendered in this worker would come
    # back without its spans; the port renders it every time
    ref_placeholder._resized_placeholder.cache_clear()
    # each process's link ledger starts empty: bytes an earlier test file
    # moved over several devices in this worker add `wire_bytes_by_device`
    # to one app's /health and not the other's
    WIRE.reset()
    REF_WIRE.reset()

    async def run():
        out = {}
        origin = await _start_origin()
        try:
            for group, (fields, cases) in GROUPS.items():
                ref = await _serve(ref_app, RefOptions, fields, cases, origin.port,
                                   host_spill=False)
                got = await _serve(port_app, PortOptions, fields, cases, origin.port,
                                   device="cpu")
                out[group] = (ref, got)
        finally:
            await origin.close()
        return out

    return asyncio.run(run())


def _decoded(body: bytes) -> np.ndarray:
    im = Image.open(io.BytesIO(body))
    return np.asarray(im.convert("RGBA" if "A" in im.getbands() else "RGB"), dtype=np.int16)


def _timing_names(headers: dict) -> list:
    value = headers.get("Server-Timing", "")
    return [p.split(";")[0] for p in value.split(", ")] if value else []


EXECUTOR_SPANS = ("batch_form", "dispatch_wait", "drain")
UNPORTED_HEALTH_KEYS: set = set()
CACHE_COUNTS = ("result_hits", "result_misses", "frame_hits", "frame_misses",
                "device_hits", "device_misses", "flight_executed", "etag_304")


def _check_body(cid: str, ctype: str, want: bytes, got: bytes) -> None:
    if cid in ("index", "prefix-index"):
        w, g = json.loads(want), json.loads(got)
        assert len(g) == len(w) and g["backend"] == w["backend"]
    elif cid in ("health", "prefix-health", "200-first"):
        w, g = json.loads(want), json.loads(got)
        assert set(w) - UNPORTED_HEALTH_KEYS <= set(g)
    elif cid == "admission-health":
        w, g = json.loads(want), json.loads(got)
        assert set(w) - UNPORTED_HEALTH_KEYS <= set(g)
        for block in ("pressure", "arena"):
            assert set(g[block]) == set(w[block]), block
        assert set(g["qos"]["classes"]) == set(w["qos"]["classes"])
        for cls, counters in w["qos"]["classes"].items():
            assert set(g["qos"]["classes"][cls]) == set(counters), cls
        assert g["qos"]["classes"]["interactive"]["admitted"] == \
            w["qos"]["classes"]["interactive"]["admitted"] == 1
        assert set(g["executor"]) <= set(w["executor"])
        for k in ("wire_bytes", "wire_transfers", "donation_enabled", "donation_rejected",
                  "pressure_host_forced", "pressure_capped_batches"):
            assert k in g["executor"], k
    elif cid == "cache-health":
        w, g = json.loads(want), json.loads(got)
        assert set(w) - UNPORTED_HEALTH_KEYS <= set(g)
        assert set(g["cache"]) == set(w["cache"])
        assert {k: g["cache"][k] for k in CACHE_COUNTS} == \
            {k: w["cache"][k] for k in CACHE_COUNTS}
        assert set(g["executor"]) <= set(w["executor"])
    elif cid == "cache-metrics":
        _check_metrics(want.decode(), got.decode())
        w, g = _families(want.decode()), _families(got.decode())
        armed = {n for n in w if n.startswith("imaginary_tpu_cache_")}
        assert armed and armed <= set(g)
        for name in armed:
            assert g[name] == w[name], name
    elif cid in ("metrics",):
        _check_metrics(want.decode(), got.decode())
    elif cid == "admission-metrics":
        _check_metrics(want.decode(), got.decode())
        w, g = _families(want.decode()), _families(got.decode())
        armed = {n for n in w if n.startswith(("imaginary_tpu_qos_", "imaginary_tpu_pressure_",
                                                "imaginary_tpu_wire_", "imaginary_tpu_arena_"))}
        armed |= {"imaginary_tpu_oom_splits_total"}
        assert {n for n in armed if n != "imaginary_tpu_wire_device_bytes_total"} <= set(g)
        for name in armed & set(g):
            assert g[name] == w[name], name
    elif ctype.startswith("image/"):
        a, b = _decoded(want), _decoded(got)
        assert a.shape == b.shape
        assert int(np.abs(a - b).max()) <= 1
    else:
        assert got == want


def _families(text: str) -> dict:
    return dict(ln.split()[2:4] for ln in text.splitlines() if ln.startswith("# TYPE "))


def _check_metrics(want: str, got: str) -> None:
    """Every family the reference renders for a subsystem the port has is
    in the port's exposition, with the same type."""
    w, g = _families(want), _families(got)
    shared = {"imaginary_tpu_uptime", "imaginary_tpu_allocated_memory_mb",
              "imaginary_tpu_threads", "imaginary_tpu_cpus",
              "imaginary_tpu_gc_collections", "imaginary_tpu_pid",
              "imaginary_tpu_worker", "imaginary_tpu_epoch", "imaginary_tpu_devices",
              "imaginary_tpu_backend_info", "imaginary_tpu_estimated_queue_ms",
              "imaginary_tpu_executor_items", "imaginary_tpu_executor_batches",
              "imaginary_tpu_executor_groups", "imaginary_tpu_executor_avg_batch",
              "imaginary_tpu_executor_max_group", "imaginary_tpu_executor_queue_depth",
              "imaginary_tpu_executor_device_failures",
              "imaginary_tpu_executor_device_owed_mb",
              "imaginary_tpu_executor_batch_form_p99_ms",
              "imaginary_tpu_executor_dispatch_wait_p99_ms",
              "imaginary_tpu_stage_total", "imaginary_tpu_stage_ms",
              "imaginary_tpu_request_duration_seconds",
              "imaginary_tpu_stage_duration_seconds", "imaginary_tpu_requests_total"}
    for name in shared:
        assert name in w, name
        assert g.get(name) == w[name], name


@pytest.mark.parametrize("group,cid,method,path,src,headers", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_answer_equals_the_reference_apps(answers, group, cid, method, path, src,
                                          headers):
    ref, port = answers[group]
    (ws, wh, wb), (gs, gh, gb) = ref[cid], port[cid]
    assert gs == ws
    assert gh.get("Content-Type") == wh.get("Content-Type")
    assert set(gh) == set(wh)
    assert gh.get("ETag") == wh.get("ETag")
    got_names = _timing_names(gh)
    if cid.startswith("placeholder"):
        got_names = [n for n in got_names if n not in EXECUTOR_SPANS]
    assert got_names == _timing_names(wh)
    _check_body(cid, wh.get("Content-Type", ""), wb, gb)


def test_oversize_body_is_413_like_the_reference(answers):
    ref, port = answers["mount"]
    assert ref["413-oversize"][0] == 413
    assert port["413-oversize"] == ref["413-oversize"]


def test_the_matrix_covers_every_route():
    from imaginary_tpu.pipeline import ALL_OPERATIONS

    from imaginary_tpu_torch.web.app import ALL_OPERATIONS as PORT_OPERATIONS

    assert PORT_OPERATIONS == ALL_OPERATIONS
    sent = {path.split("?")[0].strip("/") for _, _, _, path, _, _ in CASES}
    assert {n.lower() for n in ALL_OPERATIONS} <= sent
    assert {"", "form", "health", "metrics"} <= sent
    statuses = {tok for c in CASES for tok in c[1].split("-") if tok.isdigit()}
    assert {"405", "404", "400", "401", "403", "413", "422", "429", "406", "501",
            "502"} <= statuses
    assert any("url=" in c[3] for c in CASES)


def test_options_of_both_apps_share_their_field_names():
    """Every field the port's ServerOptions has, but the port's device
    and its executor knobs without a reference field, is a field of the
    reference's ServerOptions (the groups above build both from one dict)."""
    from imaginary_tpu.web.config import ServerOptions as RefOptions
    from imaginary_tpu_torch.web.config import ServerOptions as PortOptions

    ours = {f.name for f in dataclasses.fields(PortOptions)}
    theirs = {f.name for f in dataclasses.fields(RefOptions)}
    assert ours - theirs == {"device", "devices", "shard_min_items",
                             "breaker_threshold", "breaker_cooldown_s"}
