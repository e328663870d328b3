"""The port's project-invariant analyzer, `imaginary_tpu_torch.tools.itpucheck`.

It is rooted at the repository, so the config-surface rule (ITPU005)
reads the README that documents the flags. Every finding in the port
must be repaired or suppressed with the grammar
`# itpu: allow[ITPUnnn] <reason>`; a suppression without a reason is a
finding of its own.

The rule classes below are copies of `tests/test_itpucheck.py`'s, each
rule's tripping and clean snippet, run through the port's analyzer. The
JAX package's analyzer (`imaginary_tpu.tools.itpucheck`) is kept only as
a parity oracle: every snippet scan, and the scans of both packages'
trees, must give equal (rule, path, line, message) findings and equal
suppressions from both.
"""

import functools
import json
import os

import pytest

from imaginary_tpu.tools import itpucheck as ref_itpucheck
from imaginary_tpu_torch.tools import itpucheck
from imaginary_tpu_torch.tools.itpucheck import (
    main,
    run_checks,
    to_json,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _key(result) -> tuple:
    findings, suppressed = result
    return ([(f.rule, f.path, f.line, f.message) for f in findings],
            [(f.rule, f.path, f.line, f.message, f.reason) for f in suppressed])


def _both(**kw):
    """The port's result, after asserting the reference's is the same."""
    got = run_checks(**kw)
    assert _key(got) == _key(ref_itpucheck.run_checks(**kw))
    return got


def _scan(tmp_path, sources, rules=None, readme=""):
    """Write {name: code} files under tmp_path, run both analyzers there."""
    for name, code in sources.items():
        path = tmp_path / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(code)
    if readme:
        (tmp_path / "README.md").write_text(readme)
    return _both(paths=[str(tmp_path)], root=str(tmp_path), rules=rules)


def _rules_hit(findings):
    return {f.rule for f in findings}


@functools.lru_cache(maxsize=None)
def _tree(package: str, analyzer=itpucheck):
    """One analyzer's scan of one package, rooted at the repository."""
    return analyzer.run_checks(paths=[os.path.join(ROOT, package)], root=ROOT)


def _run():
    return _tree("imaginary_tpu_torch")


def test_the_port_has_no_unsuppressed_finding():
    findings, _ = _run()
    assert not findings, "\n".join(
        f"{f.path}:{f.line}: {f.rule} {f.message}" for f in findings)


def test_every_suppression_states_its_reason():
    _, suppressed = _run()
    assert suppressed, "the port's annotated sites were not read"
    for f in suppressed:
        assert f.path.startswith("imaginary_tpu_torch" + os.sep)
        assert len(f.reason.split()) >= 3, f"{f.path}:{f.line}: {f.reason!r}"


@pytest.mark.parametrize("package", ["imaginary_tpu_torch", "imaginary_tpu"])
def test_both_analyzers_agree_over_each_package(package):
    findings, suppressed = _tree(package)
    assert _key((findings, suppressed)) == _key(_tree(package, ref_itpucheck))
    assert suppressed and all(f.path.startswith(package + os.sep) for f in suppressed)
    assert all(os.sep + "tools" + os.sep not in f.path for f in findings + suppressed)


def test_the_rule_tables_are_the_references():
    assert itpucheck.rule_table() == ref_itpucheck.rule_table()
    assert itpucheck.META_RULE == ref_itpucheck.META_RULE
    assert itpucheck._SUPPRESS_RE.pattern == ref_itpucheck._SUPPRESS_RE.pattern


def test_a_bare_run_scans_the_port_rooted_at_the_repository():
    paths, root = itpucheck.default_paths()
    assert paths == [os.path.join(ROOT, "imaginary_tpu_torch")] and root == ROOT
    assert os.path.isfile(os.path.join(root, "README.md"))
    assert _key(run_checks()) == _key(_run())


def test_bare_json_writes_into_the_build_directory(monkeypatch, tmp_path):
    """`--json` with no path never writes the reference's
    artifacts/itpucheck.json: it writes under the gitignored _build/."""
    assert itpucheck.DEFAULT_JSON == os.path.join(ROOT, "imaginary_tpu_torch", "_build",
                                                  "itpucheck.json")
    out = tmp_path / "b" / "itpucheck.json"
    monkeypatch.setattr(itpucheck, "DEFAULT_JSON", str(out))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "m.py").write_text("x = 1\n")
    rc = main([str(tmp_path / "m.py"), "--root", str(tmp_path), "-q", "--json"])
    assert rc == 0 and json.loads(out.read_text())["counts"]["findings"] == 0
    assert not (tmp_path / "artifacts").exists()


# -- one fixture pair per rule ------------------------------------------------


class TestAsyncBlocking:
    def test_trips_on_sleep_and_sync_hit(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "import time\n"
            "from imaginary_tpu import failpoints\n"
            "async def handler(request):\n"
            "    time.sleep(1)\n"
            "    failpoints.hit('x')\n"
        )}, rules=["ITPU001"])
        assert [f.line for f in findings] == [4, 5]
        assert _rules_hit(findings) == {"ITPU001"}

    def test_clean_async_and_sync_sleep_pass(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "import asyncio, time\n"
            "from imaginary_tpu import failpoints\n"
            "async def handler(request):\n"
            "    await asyncio.sleep(1)\n"
            "    await failpoints.ahit('x')\n"
            "def sync_worker():\n"
            "    time.sleep(1)  # fine: not on the event loop\n"
            "async def offloaded():\n"
            "    def work():\n"
            "        time.sleep(1)  # nested def runs on a pool thread\n"
            "    return work\n"
        )}, rules=["ITPU001"])
        assert findings == []


class TestFutureGuard:
    def test_trips_unguarded(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "def resolve(fut, out):\n"
            "    fut.set_result(out)\n"
            "def fail(fut, e):\n"
            "    fut.set_exception(e)\n"
        )}, rules=["ITPU002"])
        assert [f.line for f in findings] == [2, 4]

    def test_done_guard_and_try_pass(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "from concurrent.futures import InvalidStateError\n"
            "def resolve(fut, out):\n"
            "    if not fut.done():\n"
            "        fut.set_result(out)\n"
            "def fail(fut, e):\n"
            "    try:\n"
            "        fut.set_exception(e)\n"
            "    except InvalidStateError:\n"
            "        pass\n"
        )}, rules=["ITPU002"])
        assert findings == []

    def test_guard_does_not_cross_function_boundary(self, tmp_path):
        # a done() check in the OUTER function must not bless a nested
        # callback's unguarded resolution
        findings, _ = _scan(tmp_path, {"m.py": (
            "def outer(fut):\n"
            "    if not fut.done():\n"
            "        def cb(f):\n"
            "            fut.set_result(1)\n"
            "        return cb\n"
        )}, rules=["ITPU002"])
        assert [f.line for f in findings] == [4]


class TestLedger:
    def test_trips_charge_without_finally(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "class Ex:\n"
            "    def submit(self, item):\n"
            "        self._host_charge(item.mpix)\n"
            "        out = self.run(item)\n"
            "        self._host_release(item.mpix)\n"  # not in a finally
            "        return out\n"
        )}, rules=["ITPU003"])
        assert [f.line for f in findings] == [3]

    def test_finally_release_passes(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "class Ex:\n"
            "    def submit(self, item):\n"
            "        self._host_charge(item.mpix)\n"
            "        try:\n"
            "            return self.run(item)\n"
            "        finally:\n"
            "            self._host_release(item.mpix)\n"
        )}, rules=["ITPU003"])
        assert findings == []

    def test_trips_owed_charge_without_cancel(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "class Ex:\n"
            "    def submit(self, item):\n"
            "        self._charge_owed(item)\n"
            "        self._queue.put(item)\n"  # a raising put leaks
            "        return item.future\n"
        )}, rules=["ITPU003"])
        assert [f.line for f in findings] == [3]

    def test_cancel_on_enqueue_failure_passes(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "class Ex:\n"
            "    def submit(self, item):\n"
            "        self._charge_owed(item)\n"
            "        try:\n"
            "            self._queue.put(item)\n"
            "        except Exception:\n"
            "            item.future.cancel()\n"
            "            raise\n"
            "        return item.future\n"
        )}, rules=["ITPU003"])
        assert findings == []


class TestLaneLedger:
    def test_trips_lane_charge_without_finally(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "class Ex:\n"
            "    def _lane_fetch(self, lane):\n"
            "        _lane_charge(lane, 4)\n"
            "        outs = self.drain(lane)\n"
            "        _lane_release(lane, 4)\n"  # not in a finally
            "        return outs\n"
        )}, rules=["ITPU011"])
        assert [f.line for f in findings] == [3]

    def test_finally_release_passes(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "class Ex:\n"
            "    def _lane_fetch(self, lane):\n"
            "        _lane_charge(lane, 4)\n"
            "        try:\n"
            "            return self.drain(lane)\n"
            "        finally:\n"
            "            _lane_release(lane, 4)\n"
        )}, rules=["ITPU011"])
        assert findings == []

    def test_trips_owe_without_cancel(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "class Ex:\n"
            "    def submit(self, item, lane):\n"
            "        _lane_owe(lane, item)\n"
            "        lane.put(item)\n"  # a raising put strands the charge
            "        return item.future\n"
        )}, rules=["ITPU011"])
        assert [f.line for f in findings] == [3]

    def test_cancel_on_enqueue_failure_passes(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "class Ex:\n"
            "    def submit(self, item, lane):\n"
            "        _lane_owe(lane, item)\n"
            "        try:\n"
            "            lane.put(item)\n"
            "        except Exception:\n"
            "            item.future.cancel()\n"
            "            raise\n"
            "        return item.future\n"
        )}, rules=["ITPU011"])
        assert findings == []


class TestSilentExcept:
    def test_trips_both_shapes(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "def f():\n"
            "    try:\n"
            "        g()\n"
            "    except Exception:\n"
            "        pass\n"
            "def h():\n"
            "    try:\n"
            "        g()\n"
            "    except:\n"
            "        return None\n"
        )}, rules=["ITPU004"])
        assert [f.line for f in findings] == [4, 9]

    def test_narrow_or_handled_passes(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "def f():\n"
            "    try:\n"
            "        g()\n"
            "    except ValueError:\n"
            "        pass\n"  # narrowed: fine
            "    try:\n"
            "        g()\n"
            "    except Exception as e:\n"
            "        log(e)\n"  # handled: fine
        )}, rules=["ITPU004"])
        assert findings == []


class TestConfigSurface:
    def test_trips_missing_env_and_readme(self, tmp_path):
        findings, _ = _scan(tmp_path, {"cli.py": (
            "import argparse, os\n"
            "p = argparse.ArgumentParser()\n"
            "p.add_argument('--shiny-knob', default='')\n"
            "SECRET = os.environ.get('IMAGINARY_TPU_UNDOCUMENTED', '')\n"
        )}, rules=["ITPU005"], readme="# docs\nnothing relevant\n")
        msgs = "\n".join(f.message for f in findings)
        assert "IMAGINARY_TPU_SHINY_KNOB" in msgs       # env default missing
        assert "--shiny-knob" in msgs                   # README mention missing
        assert "IMAGINARY_TPU_UNDOCUMENTED" in msgs     # env not in README
        assert len(findings) == 3

    def test_consistent_surface_passes(self, tmp_path):
        findings, _ = _scan(tmp_path, {"cli.py": (
            "import argparse, os\n"
            "p = argparse.ArgumentParser()\n"
            "p.add_argument('--shiny-knob',\n"
            "               default=os.environ.get('IMAGINARY_TPU_SHINY_KNOB', ''))\n"
        )}, rules=["ITPU005"],
            readme="`--shiny-knob` / `IMAGINARY_TPU_SHINY_KNOB`\n")
        assert findings == []


class TestFailpointRegistry:
    _REGISTRY = "SITES = (\n    'source.fetch',\n    'codec.decode',\n)\n"

    def test_trips_unknown_and_unused(self, tmp_path):
        findings, _ = _scan(tmp_path, {
            "failpoints.py": self._REGISTRY,
            "m.py": (
                "from imaginary_tpu import failpoints\n"
                "def f():\n"
                "    failpoints.hit('source.fetch')\n"
                "    failpoints.hit('typo.site')\n"
            ),
        }, rules=["ITPU006"])
        msgs = "\n".join(f.message for f in findings)
        assert "typo.site" in msgs          # used but undeclared
        assert "codec.decode" in msgs       # declared but never hit
        assert len(findings) == 2

    def test_registry_in_sync_passes(self, tmp_path):
        findings, _ = _scan(tmp_path, {
            "failpoints.py": self._REGISTRY,
            "m.py": (
                "from imaginary_tpu import failpoints\n"
                "async def f():\n"
                "    await failpoints.ahit('source.fetch')\n"
                "def g():\n"
                "    failpoints.hit('codec.decode')\n"
            ),
        }, rules=["ITPU006"])
        assert findings == []


class TestMetricsExposition:
    def test_trips_all_three_contracts(self, tmp_path):
        findings, _ = _scan(tmp_path, {"web/metrics.py": (
            "def render(x, v):\n"
            "    x.emit('myapp_requests', v, help_text='h')\n"
            "    x.emit('imaginary_tpu_errors', v, mtype='counter',\n"
            "           help_text='h')\n"
            "    x.emit('imaginary_tpu_depth', v)\n"
        )}, rules=["ITPU007"])
        msgs = "\n".join(f.message for f in findings)
        assert "namespace" in msgs          # myapp_ prefix
        assert "_total" in msgs             # counter naming
        assert "help_text" in msgs          # HELP line
        assert len(findings) == 3

    def test_strict_families_pass(self, tmp_path):
        findings, _ = _scan(tmp_path, {"web/metrics.py": (
            "def render(x, v, k):\n"
            "    x.emit('imaginary_tpu_errors_total', v, mtype='counter',\n"
            "           help_text='Errors.')\n"
            "    x.emit('imaginary_tpu_depth', v, help_text='Depth.')\n"
            "    x.emit(f'imaginary_tpu_exec_{k}', v, mtype=k,\n"
            "           help_text='Dynamic family.')\n"
        )}, rules=["ITPU007"])
        assert findings == []


class TestContextPropagation:
    def test_trips_bare_pool_submit_and_run_in_executor(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "async def handle(self, loop, work):\n"
            "    fut = self.pool.submit(work, 1)\n"
            "    await loop.run_in_executor(None, work)\n"
        )}, rules=["ITPU008"])
        assert [f.line for f in findings] == [2, 3]

    def test_copy_context_passes(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "import contextvars\n"
            "async def handle(self, loop, work):\n"
            "    ctx = contextvars.copy_context()\n"
            "    fut = self.pool.submit(ctx.run, work, 1)\n"
            "    await loop.run_in_executor(None, ctx.run, work)\n"
            "    self.executor.submit(work, 1)  # micro-batch executor, not a pool\n"
        )}, rules=["ITPU008"])
        assert findings == []


class TestSlotProtocol:
    def test_trips_acquire_without_finally_abandon(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "class Cache:\n"
            "    def put(self, idx, body):\n"
            "        slot = self._slot_acquire(idx)\n"
            "        self._write(slot, body)\n"  # a raise leaks the lock
            "        self._slot_publish(slot)\n"
        )}, rules=["ITPU009"])
        assert [f.line for f in findings] == [3]
        assert _rules_hit(findings) == {"ITPU009"}

    def test_trips_abandon_in_except_not_finally(self, tmp_path):
        # an except-only abandon misses the success path's unlock AND
        # non-Exception exits; the protocol demands a finally
        findings, _ = _scan(tmp_path, {"m.py": (
            "class Cache:\n"
            "    def put(self, idx, body):\n"
            "        slot = self._slot_acquire(idx)\n"
            "        try:\n"
            "            self._slot_publish(slot)\n"
            "        except Exception:\n"
            "            self._slot_abandon(slot)\n"
        )}, rules=["ITPU009"])
        assert [f.line for f in findings] == [3]

    def test_publish_then_abandon_in_finally_passes(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "class Cache:\n"
            "    def put(self, idx, body):\n"
            "        slot = self._slot_acquire(idx)\n"
            "        if slot is None:\n"
            "            return False\n"
            "        try:\n"
            "            self._write(slot, body)\n"
            "            self._slot_publish(slot)\n"
            "            return True\n"
            "        finally:\n"
            "            self._slot_abandon(slot)\n"
        )}, rules=["ITPU009"])
        assert findings == []

    def test_primitives_themselves_exempt(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "class Cache:\n"
            "    def _slot_acquire(self, idx):\n"
            "        return self._slot_acquire(idx - 1) if idx else None\n"
            "    def _slot_abandon(self, slot):\n"
            "        self._unlock(slot.idx)\n"
        )}, rules=["ITPU009"])
        assert findings == []


class TestClaimProtocol:
    def test_trips_acquire_without_finally_release(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "async def run(shm, key, produce):\n"
            "    claim = shm.claim_acquire(key)\n"
            "    out = await produce()\n"  # a raise strands the claim
            "    shm.claim_release(claim)\n"
            "    return out\n"
        )}, rules=["ITPU013"])
        assert [f.line for f in findings] == [2]
        assert _rules_hit(findings) == {"ITPU013"}

    def test_trips_release_in_except_not_finally(self, tmp_path):
        # an except-only release misses the success path AND
        # non-Exception exits (CancelledError on 3.8+ is BaseException);
        # the protocol demands a finally
        findings, _ = _scan(tmp_path, {"m.py": (
            "async def run(shm, key, produce):\n"
            "    claim = shm.claim_acquire(key)\n"
            "    try:\n"
            "        return await produce()\n"
            "    except Exception:\n"
            "        shm.claim_release(claim)\n"
            "        raise\n"
        )}, rules=["ITPU013"])
        assert [f.line for f in findings] == [2]

    def test_release_in_finally_passes(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "async def run(shm, key, produce):\n"
            "    claim = shm.claim_acquire(key)\n"
            "    try:\n"
            "        if claim.won:\n"
            "            return await produce()\n"
            "    finally:\n"
            "        shm.claim_release(claim)\n"
            "    return None\n"
        )}, rules=["ITPU013"])
        assert findings == []

    def test_abandon_in_finally_passes(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "def probe(shm, key):\n"
            "    claim = shm.claim_acquire(key)\n"
            "    try:\n"
            "        return claim.won\n"
            "    finally:\n"
            "        shm.claim_abandon(claim)\n"
        )}, rules=["ITPU013"])
        assert findings == []

    def test_primitives_themselves_exempt(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "class Shm:\n"
            "    def claim_acquire(self, key):\n"
            "        return self._claim(self.claim_index(key))\n"
            "    def claim_release(self, claim):\n"
            "        self._unlock(claim.idx)\n"
        )}, rules=["ITPU013"])
        assert findings == []


class TestObsRegistry:
    def test_trips_all_five_directions(self, tmp_path):
        findings, _ = _scan(tmp_path, {
            "events.py": (
                "SAMPLED_REASONS = (\n"
                "    'error',\n"
                "    'random',\n"
                "    'stale_entry',\n"
                ")\n"
                "def classify(event):\n"
                "    if event.get('status', 0) >= 400:\n"
                "        return 'error'\n"
                "    if event.get('typo'):\n"
                "        return 'typo_reason'\n"
                "    return 'random'\n"
            ),
            "slo.py": (
                "SLO_METRICS = (\n"
                "    'imaginary_tpu_slo_burn_rate',\n"
                "    'imaginary_tpu_slo_ghost',\n"
                ")\n"
            ),
            "m.py": (
                "def f(x, event, v):\n"
                "    if event['sampled_reason'] == 'nonsense':\n"
                "        return 1\n"
                "    x.emit('imaginary_tpu_slo_burn_rate', v)\n"
                "    x.emit('imaginary_tpu_slo_typo_total', v)\n"
            ),
        }, rules=["ITPU010"])
        msgs = "\n".join(f.message for f in findings)
        assert "typo_reason" in msgs         # classify mints undeclared
        assert "nonsense" in msgs            # compared-against undeclared
        assert "stale_entry" in msgs         # declared, never used
        assert "imaginary_tpu_slo_typo_total" in msgs  # rendered undeclared
        assert "imaginary_tpu_slo_ghost" in msgs       # declared, unrendered
        assert len(findings) == 5
        assert _rules_hit(findings) == {"ITPU010"}

    def test_registries_in_sync_pass(self, tmp_path):
        findings, _ = _scan(tmp_path, {
            "events.py": (
                "SAMPLED_REASONS = (\n"
                "    'error',\n"
                "    'random',\n"
                "    'unsampled',\n"
                ")\n"
                "def classify(event):\n"
                "    if event.get('status', 0) >= 400:\n"
                "        return 'error'\n"
                "    return 'random'\n"
            ),
            "slo.py": (
                "SLO_METRICS = (\n"
                "    'imaginary_tpu_slo_burn_rate',\n"
                ")\n"
            ),
            "m.py": (
                "def f(x, ev, v):\n"
                "    if ev.get('sampled_reason') != 'unsampled':\n"
                "        x.emit_line(ev)\n"
                "    x.emit('imaginary_tpu_slo_burn_rate', v)\n"
            ),
        }, rules=["ITPU010"])
        assert findings == []

    def test_silent_without_registry_modules(self, tmp_path):
        # a tree without the registries (e.g. a partial scan of one
        # subpackage) must not crash or spray findings
        findings, _ = _scan(tmp_path, {"m.py": (
            "def f(ev):\n"
            "    return ev.get('sampled_reason')\n"
        )}, rules=["ITPU010"])
        assert findings == []


class TestLabelCardinality:
    _COST = (
        "_LABEL_KINDS = ('tenant', 'op', 'route', 'qos_class')\n"
        "def normalize_label(kind, value):\n"
        "    return value\n"
    )

    def test_trips_unnormalized_guarded_label(self, tmp_path):
        findings, _ = _scan(tmp_path, {
            "obs/cost.py": self._COST,
            "web/metrics.py": (
                "def render(x, tenants, esc):\n"
                "    for t, v in tenants.items():\n"
                "        x.emit('imaginary_tpu_cost_requests_total', v,\n"
                "               f'tenant=\"{esc(t)}\"', mtype='counter',\n"
                "               help_text='h')\n"
            ),
        }, rules=["ITPU012"])
        assert _rules_hit(findings) == {"ITPU012"}
        assert "tenant=" in findings[0].message
        assert "normalize_label" in findings[0].message

    def test_trips_undeclared_kind(self, tmp_path):
        findings, _ = _scan(tmp_path, {
            "obs/cost.py": self._COST,
            "m.py": (
                "from obs.cost import normalize_label\n"
                "def f(v):\n"
                "    return normalize_label('flavor', v)\n"
            ),
        }, rules=["ITPU012"])
        assert _rules_hit(findings) == {"ITPU012"}
        assert "'flavor'" in findings[0].message
        assert "_LABEL_KINDS" in findings[0].message

    def test_normalized_chain_passes(self, tmp_path):
        # both spellings pass: inline call, and a variable assigned from
        # an escape(normalize_label(...)) chain — the live metrics.py
        # idiom for the slo route labels
        findings, _ = _scan(tmp_path, {
            "obs/cost.py": self._COST,
            "web/metrics.py": (
                "from obs.cost import normalize_label\n"
                "def render(x, tenants, routes, esc, v):\n"
                "    for t in tenants:\n"
                "        lab = esc(normalize_label('tenant', t))\n"
                "        x.emit('imaginary_tpu_cost_requests_total', v,\n"
                "               f'tenant=\"{lab}\"', mtype='counter',\n"
                "               help_text='h')\n"
                "    for r in routes:\n"
                "        x.emit('imaginary_tpu_slo_burn_rate', v,\n"
                "               f'route=\"{esc(normalize_label(\"route\", r))}\"',\n"
                "               help_text='h')\n"
            ),
        }, rules=["ITPU012"])
        assert findings == []

    def test_unguarded_keys_stay_free(self, tmp_path):
        # class=/lane=/stage= are bounded enums: no normalizer required
        findings, _ = _scan(tmp_path, {
            "obs/cost.py": self._COST,
            "web/metrics.py": (
                "def render(x, classes, esc, v):\n"
                "    for c in classes:\n"
                "        x.emit('imaginary_tpu_qos_shed_total', v,\n"
                "               f'class=\"{esc(c)}\"', mtype='counter',\n"
                "               help_text='h')\n"
            ),
        }, rules=["ITPU012"])
        assert findings == []

    def test_missing_registry_is_a_finding(self, tmp_path):
        # normalize_label used but no _LABEL_KINDS registry in the tree:
        # the contract has no owner
        findings, _ = _scan(tmp_path, {"m.py": (
            "from obs.cost import normalize_label\n"
            "def f(v):\n"
            "    return normalize_label('tenant', v)\n"
        )}, rules=["ITPU012"])
        assert _rules_hit(findings) == {"ITPU012"}


class TestPeerTimeout:
    def test_trips_urlopen_and_session_verbs_without_timeout(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "import urllib.request\n"
            "def gossip(url, session):\n"
            "    urllib.request.urlopen(url)\n"  # no timeout at all
            "    session.get(url, timeout=None)\n"  # unbounded, spelled out
            "    session.post(url)\n"
        )}, rules=["ITPU014"])
        assert [f.line for f in findings] == [3, 4, 5]
        assert _rules_hit(findings) == {"ITPU014"}

    def test_aiohttp_oneshot_request_trips(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "import aiohttp\n"
            "async def hop(url):\n"
            "    async with aiohttp.request('GET', url) as r:\n"
            "        return await r.read()\n"
        )}, rules=["ITPU014"])
        assert [f.line for f in findings] == [3]

    def test_bounded_calls_pass(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "import urllib.request\n"
            "import aiohttp\n"
            "async def hop(url, session, budget):\n"
            "    urllib.request.urlopen(url, timeout=1.0)\n"
            "    session.get(url, timeout=budget)\n"
            "    async with aiohttp.request('GET', url,\n"
            "            timeout=aiohttp.ClientTimeout(total=budget)) as r:\n"
            "        return await r.read()\n"
        )}, rules=["ITPU014"])
        assert findings == []

    def test_plain_dict_get_is_not_http(self, tmp_path):
        # the rule is about sockets, not maps: obj.get()/cache.get()
        # without timeout= must never trip
        findings, _ = _scan(tmp_path, {"m.py": (
            "def read(table, peers, key):\n"
            "    a = table.get(key)\n"
            "    b = peers.get(key, None)\n"
            "    return a or b\n"
        )}, rules=["ITPU014"])
        assert findings == []


# -- suppression grammar ------------------------------------------------------


class TestSuppression:
    _CODE = (
        "import time\n"
        "async def f():\n"
        "    time.sleep(1)  # itpu: allow[ITPU001] measured: must block here\n"
    )

    def test_same_line_suppression(self, tmp_path):
        findings, suppressed = _scan(tmp_path, {"m.py": self._CODE},
                                     rules=["ITPU001"])
        assert findings == []
        assert len(suppressed) == 1
        assert suppressed[0].reason == "measured: must block here"

    def test_standalone_comment_covers_next_code_line(self, tmp_path):
        findings, suppressed = _scan(tmp_path, {"m.py": (
            "import time\n"
            "async def f():\n"
            "    # itpu: allow[ITPU001] deliberate wedge simulation\n"
            "    time.sleep(1)\n"
        )}, rules=["ITPU001"])
        assert findings == []
        assert len(suppressed) == 1

    def test_reasonless_suppression_is_a_finding(self, tmp_path):
        findings, suppressed = _scan(tmp_path, {"m.py": (
            "import time\n"
            "async def f():\n"
            "    time.sleep(1)  # itpu: allow[ITPU001]\n"
        )}, rules=["ITPU001"])
        # the blanket suppression does NOT suppress, and is itself flagged
        rules = sorted(f.rule for f in findings)
        assert rules == ["ITPU000", "ITPU001"]
        assert suppressed == []

    def test_wrong_rule_id_does_not_suppress(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "import time\n"
            "async def f():\n"
            "    time.sleep(1)  # itpu: allow[ITPU004] wrong rule named\n"
        )}, rules=["ITPU001"])
        assert {f.rule for f in findings} == {"ITPU001"}

    def test_unknown_rule_id_is_a_finding(self, tmp_path):
        findings, _ = _scan(tmp_path, {"m.py": (
            "x = 1  # itpu: allow[BOGUS123] whatever\n"
        )})
        assert any(f.rule == "ITPU000" and "BOGUS123" in f.message
                   for f in findings)


# -- output surfaces ----------------------------------------------------------


class TestJsonOutput:
    def test_schema(self, tmp_path):
        (tmp_path / "m.py").write_text(
            "import time\nasync def f():\n    time.sleep(1)\n")
        out = tmp_path / "artifacts" / "itpucheck.json"
        rc = main([str(tmp_path / "m.py"), "--root", str(tmp_path),
                   "--json", str(out), "-q"])
        assert rc == 1
        doc = json.loads(out.read_text())
        assert doc["tool"] == "itpucheck"
        assert doc["version"] == 1
        assert set(doc["counts"]) == {"findings", "suppressed", "per_rule"}
        assert doc["counts"]["findings"] == len(doc["findings"]) == 1
        f = doc["findings"][0]
        assert set(f) == {"rule", "path", "line", "message"}
        assert f["rule"] == "ITPU001" and f["line"] == 3
        # all 14 rules are advertised in the rule table
        assert len([r for r in doc["rules"] if r != "ITPU000"]) == 14

    def test_to_json_counts_suppressed(self, tmp_path):
        findings, suppressed = _scan(tmp_path, {"m.py": (
            "import time\n"
            "async def f():\n"
            "    time.sleep(1)  # itpu: allow[ITPU001] fixture\n"
        )}, rules=["ITPU001"])
        doc = to_json(findings, suppressed)
        assert doc["counts"]["suppressed"] == 1
        assert doc["suppressed_findings"][0]["reason"] == "fixture"

    def test_exit_zero_and_artifact_on_clean_tree(self, tmp_path):
        (tmp_path / "m.py").write_text("x = 1\n")
        out = tmp_path / "r.json"
        rc = main([str(tmp_path / "m.py"), "--root", str(tmp_path),
                   "--json", str(out), "-q"])
        assert rc == 0
        assert json.loads(out.read_text())["counts"]["findings"] == 0


class TestSyntaxError:
    def test_unparseable_file_is_a_finding(self, tmp_path):
        (tmp_path / "m.py").write_text("def broken(:\n")
        findings, _ = _scan(tmp_path, {})
        assert [f.rule for f in findings] == ["ITPU000"]
        assert "syntax error" in findings[0].message
