"""The port's command line against the reference's (`imaginary_tpu/cli.py`).

Every flag the port takes parses from argv and from its
`IMAGINARY_TPU_<FLAG>` variable, and its default equals the reference
parser's default. `--device` is the port's own flag (the torch device of
the kernels) and has no counterpart. The historical variables PORT,
URL_SIGNATURE_KEY and LOG_LEVEL still win, as in the reference.

The surface as a whole: the port's parser takes every option string of
the reference's (its list of exceptions is empty), each under the same
dest, kind and type, with the reference's default and choices but for
the recorded differences named below, and both parsers read the same
value from each option's variable. The cross-host flags refuse the boot
as the reference's do.

The environment beyond the flags: every IMAGINARY_TPU_* name the
reference's source reads is read by the port's, or is in
UNREAD_VARIABLES with its reason; IMAGINARY_TPU_TRACE, IMAGINARY_TPU_HOST_GATE
and IMAGINARY_TPU_PLATFORM=cpu act as in the reference, and JAX_PLATFORMS
moves nothing.
"""

from __future__ import annotations

import os

import pytest

from imaginary_tpu_torch import cli
from tests.test_torch_refnative import reference_native  # noqa: F401

# (option, dest, kind, a value other than the default)
FLAGS = [
    ("--port", "port", int, 9123),
    ("--addr", "addr", str, "127.0.0.2"),
    ("--path-prefix", "path_prefix", str, "/img"),
    ("--cors", "cors", bool, True),
    ("--gzip", "gzip", bool, True),
    ("--key", "key", str, "s3cret"),
    ("--mount", "mount", str, "/srv/images"),
    ("--http-cache-ttl", "http_cache_ttl", int, 60),
    ("--http-read-timeout", "http_read_timeout", int, 30),
    ("--http-write-timeout", "http_write_timeout", int, 45),
    ("--enable-placeholder", "enable_placeholder", bool, True),
    ("--enable-url-signature", "enable_url_signature", bool, True),
    ("--url-signature-key", "url_signature_key", str, "k" * 32),
    ("--max-allowed-size", "max_allowed_size", int, 1023),
    ("--max-allowed-resolution", "max_allowed_resolution", float, 2.5),
    ("--certfile", "certfile", str, "/tmp/c.crt"),
    ("--keyfile", "keyfile", str, "/tmp/c.key"),
    ("--require-device", "require_device", bool, True),
    ("--placeholder", "placeholder", str, "/tmp/p.jpg"),
    ("--placeholder-status", "placeholder_status", int, 202),
    ("--concurrency", "concurrency", int, 20),
    ("--burst", "burst", int, 5),
    ("--mrelease", "mrelease", int, 10),
    ("--cpus", "cpus", int, 3),
    ("--log-level", "log_level", str, "warning"),
    ("--return-size", "return_size", bool, True),
    ("--disable-endpoints", "disable_endpoints", str, "blur,crop"),
    ("--disable-tracing", "disable_tracing", bool, True),
    ("--max-batch", "max_batch", int, 32),
    ("--batch-form-ms", "batch_form_ms", float, 2.5),
    ("--max-inflight", "max_inflight", int, 8),
    ("--devices", "devices", int, 2),
    ("--spatial", "spatial", int, 4),
    ("--spatial-threshold-px", "spatial_threshold_px", int, 1000),
    ("--mesh-policy", "mesh_policy", str, "lanes"),
    ("--spatial-mpix", "spatial_mpix", float, 8.3),
    ("--lane-form-ms", "lane_form_ms", float, 2.0),
    ("--lane-inflight", "lane_inflight", int, 3),
    ("--transport-dct", "transport_dct", bool, True),
    ("--transport-dct-egress", "transport_dct_egress", bool, True),
    ("--enable-url-source", "enable_url_source", bool, True),
    ("--allowed-origins", "allowed_origins", str, "http://127.0.0.1:8001"),
    ("--enable-auth-forwarding", "enable_auth_forwarding", bool, True),
    ("--authorization", "authorization", str, "Bearer origin-token"),
    ("--forward-headers", "forward_headers", str, "X-Custom,X-Other"),
    ("--source-retries", "source_retries", int, 5),
    ("--source-connect-timeout", "source_connect_timeout", float, 1.5),
    ("--source-read-timeout", "source_read_timeout", float, 7.5),
    ("--request-timeout", "request_timeout", float, 0.25),
    ("--prewarm", "prewarm", bool, True),
    # admission: the depth gate, the pressure governor, qos, the batch
    # policy, donation, the codec arena and the dct decoder arm
    ("--max-queue-ms", "max_queue_ms", float, 150.0),
    ("--pressure-rss-mb", "pressure_rss_mb", float, 4096.0),
    ("--pressure-hbm-mb", "pressure_hbm_mb", float, 60000.0),
    ("--pressure-elevated-frac", "pressure_elevated_frac", float, 0.6),
    ("--pressure-critical-frac", "pressure_critical_frac", float, 0.8),
    ("--pressure-batch-mb", "pressure_batch_mb", float, 8.0),
    ("--pressure-oversize-mpix", "pressure_oversize_mpix", float, 2.0),
    ("--pressure-pixel-frac", "pressure_pixel_frac", float, 0.5),
    ("--qos-config", "qos_config", str, '{"default": {"class": "batch"}}'),
    ("--batch-policy", "batch_policy", str, "convoy"),
    ("--batch-window-ms", "batch_window_ms", float, 7.5),
    ("--donation", "donation", str, "off"),
    ("--arena-mb", "arena_mb", float, 64.0),
    ("--dct-native", "dct_native", str, "python"),
    # the cache tiers
    ("--cache-result-mb", "cache_result_mb", float, 64.0),
    ("--cache-frame-mb", "cache_frame_mb", float, 32.0),
    ("--cache-device-mb", "cache_device_mb", float, 256.0),
    ("--cache-coalesce", "cache_coalesce", bool, True),
    ("--cache-source-ttl", "cache_source_ttl", float, 60.0),
    ("--cache-source-mb", "cache_source_mb", float, 16.0),
    # the observability planes, the h2 switch and the read guard
    ("--wide-events", "wide_events", bool, True),
    ("--wide-events-sample", "wide_events_sample", float, 0.25),
    ("--slo-config", "slo_config", str, '{"*": {"latency_ms": 250}}'),
    ("--enable-debug", "enable_debug", bool, True),
    ("--cost-attribution", "cost_attribution", bool, True),
    ("--cost-topk", "cost_topk", int, 7),
    ("--cost-windows", "cost_windows", str, "30s,5m"),
    ("--disable-http2", "disable_http2", bool, True),
    ("--read-timeout", "read_timeout", float, 1.5),
]
IDS = [f[0].lstrip("-") for f in FLAGS]
# the egress rides on the ingress: set with it in argv and the environment
NEEDS = {"transport_dct_egress": ("--transport-dct", "IMAGINARY_TPU_TRANSPORT_DCT")}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """No IMAGINARY_TPU_* variable (or historical name) from the caller."""
    for name in list(os.environ):
        if name.startswith("IMAGINARY_TPU_") or name in ("PORT", "URL_SIGNATURE_KEY",
                                                         "LOG_LEVEL"):
            monkeypatch.delenv(name)


def _env_name(option: str) -> str:
    return "IMAGINARY_TPU_" + option.lstrip("-").replace("-", "_").upper()


@pytest.mark.parametrize("option,dest,kind,value", FLAGS, ids=IDS)
def test_default_equals_the_reference_parsers(option, dest, kind, value):
    from imaginary_tpu.cli import build_parser as reference_parser

    want = reference_parser().parse_args([])
    got = cli.parse_args([])
    assert getattr(got, dest) == getattr(want, dest)
    assert getattr(got, dest) != value


@pytest.mark.parametrize("option,dest,kind,value", FLAGS, ids=IDS)
def test_flag_parses_from_argv(option, dest, kind, value):
    argv = [option] if kind is bool else [option, str(value)]
    if dest in NEEDS:
        argv.append(NEEDS[dest][0])
    assert getattr(cli.parse_args(argv), dest) == value


@pytest.mark.parametrize("option,dest,kind,value", FLAGS, ids=IDS)
def test_flag_reads_its_environment_variable(monkeypatch, option, dest, kind, value):
    monkeypatch.setenv(_env_name(option), "1" if kind is bool else str(value))
    if dest in NEEDS:
        monkeypatch.setenv(NEEDS[dest][1], "1")
    assert getattr(cli.parse_args([]), dest) == value


def test_every_flag_is_the_reference_flag_of_its_name():
    """The port adds no flag the reference lacks, but its own --device;
    the short forms -p and -a are the reference's."""
    from imaginary_tpu.cli import build_parser as reference_parser

    def options(parser):
        return {s for a in parser._actions for s in a.option_strings}

    ours = options(cli.build_parser()) - {"--device"}
    assert ours <= options(reference_parser())
    assert {"-p", "-a", "--version"} <= ours
    assert {f[0] for f in FLAGS} <= ours


def test_device_reads_its_environment_variable(monkeypatch):
    assert cli.parse_args([]).device == "cuda"
    monkeypatch.setenv("IMAGINARY_TPU_DEVICE", "cpu")
    assert cli.parse_args([]).device == "cpu"


def test_short_forms():
    args = cli.parse_args(["-p", "9001", "-a", "127.0.0.1"])
    assert (args.port, args.addr) == (9001, "127.0.0.1")


def test_historical_variables_win(monkeypatch):
    """ref: options_from_args, cli.py:633-640."""
    monkeypatch.setenv("PORT", "9555")
    monkeypatch.setenv("URL_SIGNATURE_KEY", "u" * 32)
    monkeypatch.setenv("LOG_LEVEL", "error")
    o = cli.options_from_args(cli.parse_args(["--port", "9001"]))
    assert (o.port, o.url_signature_key, o.log_level) == (9555, "u" * 32, "error")


def test_options_carry_every_flag(tmp_path):
    """options_from_args maps the flags onto ServerOptions as the
    reference's does (endpoints parsed, tracing inverted, the lane cap
    negative as None)."""
    args = cli.parse_args(["--disable-endpoints", "Blur, crop", "--disable-tracing",
                           "--max-allowed-resolution", "2.5", "--key", "k",
                           "--mount", str(tmp_path), "--device", "cpu",
                           "--devices", "2", "--lane-form-ms", "-1"])
    o = cli.options_from_args(args)
    assert o.endpoints == ("blur", "crop") and not o.trace_enabled
    assert (o.max_allowed_pixels, o.api_key, o.mount) == (2.5, "k", str(tmp_path))
    assert (o.device, o.n_devices, o.lane_form_ms) == ("cpu", 2, None)


URL_SOURCE_FIELDS = ("enable_url_source", "allowed_origins", "auth_forwarding",
                     "authorization", "forward_headers", "source_retries",
                     "source_connect_timeout_s", "source_read_timeout_s",
                     "max_allowed_size")


@pytest.mark.parametrize("argv", [
    [],
    ["--enable-url-source", "--allowed-origins",
     "http://127.0.0.1:8001, https://*.example.org/assets,s3.example.com/bucket*",
     "--enable-auth-forwarding", "--authorization", "Bearer origin-token",
     "--forward-headers", "X-Custom, X-Other", "--source-retries", "5",
     "--source-connect-timeout", "1.5", "--source-read-timeout", "7.5",
     "--max-allowed-size", "4000000"],
    ["--source-retries", "-3", "--source-connect-timeout", "0",
     "--source-read-timeout", "-1"],
], ids=["defaults", "every-flag", "clamped"])
def test_url_source_options_equal_the_references(argv):
    """The eight URL-source flags and --max-allowed-size map onto
    ServerOptions as the reference's options_from_args maps them (origins
    parsed into (host, path prefix) pairs, headers split, the retry
    budget and timeouts clamped)."""
    from imaginary_tpu.cli import build_parser as reference_parser
    from imaginary_tpu.cli import options_from_args as reference_options

    want = reference_options(reference_parser().parse_args(argv))
    got = cli.options_from_args(cli.parse_args(argv))
    for field in URL_SOURCE_FIELDS:
        assert getattr(got, field) == getattr(want, field), field


ADMISSION_FIELDS = ("max_queue_ms", "qos_config", "pressure_rss_mb", "pressure_hbm_mb",
                    "pressure_elevated_frac", "pressure_critical_frac",
                    "pressure_batch_mb", "pressure_oversize_mpix", "pressure_pixel_frac",
                    "batch_policy", "batch_window_ms", "batch_form_ms", "max_inflight",
                    "donation", "arena_mb", "dct_native")


@pytest.mark.parametrize("argv", [
    [],
    ["--max-queue-ms", "150", "--qos-config", '{"default": {"class": "batch"}}',
     "--pressure-rss-mb", "4096", "--pressure-hbm-mb", "60000",
     "--pressure-elevated-frac", "0.6", "--pressure-critical-frac", "0.8",
     "--pressure-batch-mb", "8", "--pressure-oversize-mpix", "2",
     "--pressure-pixel-frac", "0.5", "--batch-policy", "convoy",
     "--batch-window-ms", "7.5", "--donation", "off", "--arena-mb", "64",
     "--dct-native", "native"],
    ["--max-queue-ms", "-5", "--pressure-rss-mb", "-1", "--pressure-elevated-frac", "3",
     "--pressure-critical-frac", "0", "--pressure-batch-mb", "-2",
     "--pressure-oversize-mpix", "-1", "--pressure-pixel-frac", "0", "--arena-mb", "-8",
     "--batch-form-ms", "-1", "--max-inflight", "0"],
], ids=["defaults", "every-flag", "clamped"])
def test_admission_options_equal_the_references(argv):
    """The admission flags map onto ServerOptions as the reference's
    options_from_args maps them (fractions and sizes clamped, donation
    on/off as a bool)."""
    from imaginary_tpu.cli import build_parser as reference_parser
    from imaginary_tpu.cli import options_from_args as reference_options

    want = reference_options(reference_parser().parse_args(argv))
    got = cli.options_from_args(cli.parse_args(argv))
    for field in ADMISSION_FIELDS:
        assert getattr(got, field) == getattr(want, field), field


CACHE_FIELDS = ("cache_result_mb", "cache_frame_mb", "cache_device_mb", "cache_coalesce",
                "cache_source_ttl", "cache_source_mb")


@pytest.mark.parametrize("argv", [
    [],
    ["--cache-result-mb", "64", "--cache-frame-mb", "32", "--cache-device-mb", "256",
     "--cache-coalesce", "--cache-source-ttl", "60", "--cache-source-mb", "16"],
    ["--cache-result-mb", "-1", "--cache-frame-mb", "-2", "--cache-device-mb", "-3",
     "--cache-source-ttl", "-4", "--cache-source-mb", "-5"],
], ids=["defaults", "every-flag", "clamped"])
def test_cache_options_equal_the_references(argv):
    """The six cache flags map onto ServerOptions as the reference's
    options_from_args maps them (each size and the TTL clamped at 0)."""
    from imaginary_tpu.cli import build_parser as reference_parser
    from imaginary_tpu.cli import options_from_args as reference_options

    want = reference_options(reference_parser().parse_args(argv))
    got = cli.options_from_args(cli.parse_args(argv))
    for field in CACHE_FIELDS:
        assert getattr(got, field) == getattr(want, field), field


OBS_FIELDS = ("wide_events", "wide_events_sample", "slo_config", "enable_debug",
              "cost_attribution", "cost_topk", "cost_windows", "http2", "read_timeout_s")


@pytest.mark.parametrize("argv", [
    [],
    ["--wide-events", "--wide-events-sample", "0.25", "--slo-config",
     '{"*": {"latency_ms": 250}}', "--enable-debug", "--cost-attribution",
     "--cost-topk", "7", "--cost-windows", "30s,5m", "--disable-http2",
     "--read-timeout", "1.5"],
    ["--wide-events-sample", "3", "--cost-topk", "0", "--read-timeout", "-2"],
    ["--wide-events-sample", "-1"],
], ids=["defaults", "every-flag", "clamped", "clamped-low"])
def test_observability_options_equal_the_references(argv):
    """The nine flags map onto ServerOptions as the reference's
    options_from_args maps them (the sample clamped to [0, 1], the sketch
    width to >= 1, the read timeout to >= 0, --disable-http2 inverted)."""
    from imaginary_tpu.cli import build_parser as reference_parser
    from imaginary_tpu.cli import options_from_args as reference_options

    want = reference_options(reference_parser().parse_args(argv))
    got = cli.options_from_args(cli.parse_args(argv))
    for field in OBS_FIELDS:
        assert getattr(got, field) == getattr(want, field), field


def _reference_actions() -> dict:
    """{option string: action} of the reference parser (-h and --version
    aside)."""
    from imaginary_tpu.cli import build_parser as reference_parser

    return {o: a for a in reference_parser()._actions for o in a.option_strings
            if a.dest not in ("help", "version")}


def _reference_long_options() -> list:
    from imaginary_tpu.cli import build_parser as reference_parser

    return sorted(a.option_strings[-1] for a in reference_parser()._actions
                  if a.dest not in ("help", "version"))


# The reference's option strings the port's parser does not take, each with
# its reason in ROADMAP.md ("recorded differences"): none.
MISSING_OPTIONS: dict = {}
# Options whose default or choices differ, each a recorded difference in
# ROADMAP.md: the port's --host-spill defaults to off (the card serves
# every request unless asked). Every option takes the reference's choices.
DEFAULT_DIFFERENCES = {"--host-spill": ("auto", "off")}
CHOICE_DIFFERENCES: dict = {}


def _env_value(action, default) -> str:
    """A value for the action's variable other than its default."""
    if not action.option_strings or action.nargs == 0:
        return "1"
    if action.choices:
        return str(next(c for c in action.choices if c != default))
    if action.type is int:
        return "7"
    if action.type is float:
        return "2.5"
    return "x-value"


def test_the_port_takes_every_reference_option_string():
    ours = {s for a in cli.build_parser()._actions for s in a.option_strings}
    missing = set(_reference_actions()) - ours
    assert missing == set(MISSING_OPTIONS)
    assert not MISSING_OPTIONS


@pytest.mark.parametrize("option", _reference_long_options())
def test_reference_option_parses_and_reads_its_variable_like_the_reference(
        monkeypatch, option):
    """Every option of the reference's parser: the port's has it under the
    same dest, kind and type, with the reference's default and choices but
    for the recorded differences, and both parsers read the same value
    from its IMAGINARY_TPU_<FLAG> variable."""
    from imaginary_tpu.cli import build_parser as reference_parser

    ref = _reference_actions()[option]
    ours = {o: a for a in cli.build_parser()._actions for o in a.option_strings}[option]
    assert (ours.dest, type(ours), ours.type, ours.nargs) == (
        ref.dest, type(ref), ref.type, ref.nargs)
    for short in ref.option_strings:
        assert short in ours.option_strings
    want = getattr(reference_parser().parse_args([]), ref.dest)
    got = getattr(cli.build_parser().parse_args([]), ours.dest)
    assert (want, got) == DEFAULT_DIFFERENCES.get(option, (want, want))
    if ref.choices is not None:
        assert set(ref.choices) - set(ours.choices) == CHOICE_DIFFERENCES.get(option, set())
        assert set(ours.choices) <= set(ref.choices)
    value = _env_value(ref, want)
    monkeypatch.setenv(_env_name(option), value)
    want_env = getattr(reference_parser().parse_args([]), ref.dest)
    got_env = getattr(cli.build_parser().parse_args([]), ours.dest)
    assert got_env == want_env
    assert got_env != want or option in DEFAULT_DIFFERENCES


@pytest.mark.parametrize("argv,message", [
    (["--router"], "--router requires --peers"),
    (["--peers", " , "], "empty peer list"),
    (["--peers", "@/nonexistent/peers.txt"], "--peers file"),
], ids=["router-without-peers", "empty-peers", "unreadable-peers-file"])
def test_cross_host_flags_refuse_the_boot_like_the_reference(argv, message):
    from imaginary_tpu.cli import build_parser as reference_parser
    from imaginary_tpu.cli import options_from_args as reference_options

    with pytest.raises(SystemExit, match=message):
        cli.options_from_args(cli.parse_args(argv))
    with pytest.raises(SystemExit, match=message):
        reference_options(reference_parser().parse_args(argv))


def test_cross_host_options_equal_the_references(tmp_path):
    from imaginary_tpu.cli import build_parser as reference_parser
    from imaginary_tpu.cli import options_from_args as reference_options

    peers = tmp_path / "peers.txt"
    peers.write_text("# the other host\n127.0.0.1:9101\n")
    argv = ["--peers", "@" + str(peers), "--router", "--host-id", "host-a",
            "--peer-probe-interval", "0.01"]
    got = cli.options_from_args(cli.parse_args(argv))
    want = reference_options(reference_parser().parse_args(argv))
    for field in ("peers", "router", "host_id", "peer_probe_interval"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.peer_probe_interval == 0.05


def test_enable_debug_reads_the_short_variable(monkeypatch):
    """IMAGINARY_TPU_DEBUG arms --enable-debug too, as in the reference."""
    monkeypatch.setenv("IMAGINARY_TPU_DEBUG", "1")
    assert cli.parse_args([]).enable_debug is True


@pytest.mark.parametrize("argv,message", [
    (["--slo-config", "{nope"], "not valid JSON"),
    (["--slo-config", '{"*": {"latency_target": 1.5}}'], "latency_target"),
    (["--cost-attribution", "--cost-windows", "10x"], "bad window"),
    (["--cost-attribution", "--cost-windows", "1m,10s"], "not ascending"),
], ids=["slo-json", "slo-target", "cost-window", "cost-order"])
def test_malformed_planes_refuse_the_boot_like_the_reference(argv, message):
    from imaginary_tpu.cli import build_parser as reference_parser
    from imaginary_tpu.cli import options_from_args as reference_options

    with pytest.raises(SystemExit, match=message):
        cli.options_from_args(cli.parse_args(argv))
    with pytest.raises(SystemExit, match=message):
        reference_options(reference_parser().parse_args(argv))


def test_a_malformed_qos_config_refuses_the_boot():
    with pytest.raises(SystemExit, match="unknown class"):
        cli.options_from_args(cli.parse_args(["--qos-config",
                                              '{"default": {"class": "gold"}}']))


@pytest.mark.parametrize("argv,message", [
    (["--enable-url-signature", "--url-signature-key", "short"], "at least 32"),
    (["--mount", "/nonexistent/dir"], "mount directory does not exist"),
    (["--http-cache-ttl", "-5"], "31556926"),
], ids=["short-signature-key", "missing-mount", "bad-ttl"])
def test_boot_checks_refuse_like_the_reference(argv, message):
    with pytest.raises(SystemExit, match=message):
        cli.options_from_args(cli.parse_args(argv))


def test_version_prints_and_exits(capsys):
    from imaginary_tpu_torch import Version

    assert cli.main(["--version"]) == 0
    assert capsys.readouterr().out.strip() == Version


# --- the reference's other environment spellings --------------------------------

# The IMAGINARY_TPU_* variables the reference reads and the port does not,
# each with its reason (ROADMAP.md, "recorded differences").
UNREAD_VARIABLES = {
    # the XLA compile cache's directory (imaginary_tpu/prewarm.py): the port
    # compiles its kernels with nvcc once a process and keeps no XLA cache
    "IMAGINARY_TPU_CACHE": "XLA's persistent compile cache; the port has no XLA",
}
# The port's own variables, which the reference does not read.
PORT_ONLY_VARIABLES = {"IMAGINARY_TPU_DEVICE"}


def _variables_read(package: str) -> set:
    """The IMAGINARY_TPU_* names a package's source spells as a string
    constant (a docstring names, it does not read)."""
    import ast
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parent.parent / package
    names = set()
    for path in root.rglob("*.py"):
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                  ast.AsyncFunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        for n in ast.walk(tree):
            if (isinstance(n, ast.Constant) and isinstance(n.value, str)
                    and id(n) not in docs
                    and re.fullmatch(r"IMAGINARY_TPU_[A-Z0-9_]+", n.value)):
                names.add(n.value)
    return names


def test_the_port_reads_every_reference_variable():
    ref, ours = _variables_read("imaginary_tpu"), _variables_read("imaginary_tpu_torch")
    assert {"IMAGINARY_TPU_FAILPOINTS", "IMAGINARY_TPU_TRACE", "IMAGINARY_TPU_HOST_GATE",
            "IMAGINARY_TPU_PLATFORM"} <= ref & ours
    assert ref - ours == set(UNREAD_VARIABLES)
    assert ours - ref == PORT_ONLY_VARIABLES


@pytest.mark.parametrize("value,disabled", [
    ("0", True), ("off", True), ("false", True), ("OFF", True), ("1", False), ("", False),
])
def test_trace_variable_sets_disable_tracing_like_the_reference(monkeypatch, value, disabled):
    from imaginary_tpu.cli import build_parser as reference_parser

    monkeypatch.setenv("IMAGINARY_TPU_TRACE", value)
    assert cli.parse_args([]).disable_tracing is disabled
    assert reference_parser().parse_args([]).disable_tracing is disabled
    assert cli.options_from_args(cli.parse_args([])).trace_enabled is not disabled


@pytest.mark.usefixtures("testdata", "reference_native")
def test_trace_0_answers_carry_no_server_timing_like_the_references(monkeypatch):
    """Both apps built from their command lines: Server-Timing on an
    answer by default, none with IMAGINARY_TPU_TRACE=0; X-Request-ID
    either way."""
    import asyncio
    import dataclasses
    import io

    from aiohttp.test_utils import TestClient, TestServer

    from imaginary_tpu.cli import build_parser as reference_parser
    from imaginary_tpu.cli import options_from_args as reference_options
    from imaginary_tpu.web.app import create_app as reference_app
    from imaginary_tpu_torch.web.app import create_app
    from tests.conftest import fixture_bytes

    async def headers(app):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            res = await client.post("/resize?width=100",
                                    data=fixture_bytes("imaginary.jpg"))
            assert res.status == 200
            return dict(res.headers)
        finally:
            await client.close()

    def answers():
        ref = dataclasses.replace(reference_options(reference_parser().parse_args([])),
                                  host_spill=False)
        port = dataclasses.replace(cli.options_from_args(cli.parse_args([])), device="cpu")
        return [asyncio.run(headers(factory(o, log_stream=io.StringIO())))
                for factory, o in ((reference_app, ref), (create_app, port))]

    for h in answers():
        assert "Server-Timing" in h and "X-Request-ID" in h
    monkeypatch.setenv("IMAGINARY_TPU_TRACE", "0")
    for h in answers():
        assert "Server-Timing" not in h and "X-Request-ID" in h


@pytest.mark.parametrize("value,permits", [("3", 3), ("1", 1), ("0", None), ("-2", None),
                                           ("", None)])
def test_host_gate_variable_sets_the_permits(monkeypatch, value, permits):
    from imaginary_tpu_torch.engine import Executor, ExecutorConfig
    from imaginary_tpu_torch.engine import executor as executor_mod

    monkeypatch.setenv("IMAGINARY_TPU_HOST_GATE", value)
    want = permits or max(1, executor_mod._available_cpus())
    assert executor_mod.host_gate_permits(executor_mod._available_cpus()) == want
    ex = Executor(ExecutorConfig(device="cpu"))
    try:
        assert ex._host_gate._value == want
    finally:
        ex.shutdown()


@pytest.mark.parametrize("env,device", [
    ({}, "cuda"),
    ({"IMAGINARY_TPU_PLATFORM": "cpu"}, "cpu"),
    ({"IMAGINARY_TPU_PLATFORM": " CPU "}, "cpu"),
    ({"IMAGINARY_TPU_PLATFORM": "tpu"}, "cuda"),
    ({"IMAGINARY_TPU_PLATFORM": "cpu", "IMAGINARY_TPU_DEVICE": "cuda:1"}, "cuda:1"),
    ({"JAX_PLATFORMS": "cpu"}, "cuda"),
], ids=["none", "platform-cpu", "platform-cpu-spaced", "platform-tpu",
        "device-wins", "jax-platforms-ignored"])
def test_platform_variable_asks_for_the_cpu(monkeypatch, env, device):
    for name in ("IMAGINARY_TPU_PLATFORM", "IMAGINARY_TPU_DEVICE", "JAX_PLATFORMS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert cli.parse_args([]).device == device
    assert cli.parse_args(["--device", "cpu"]).device == "cpu"
