"""The port's multi-process paths on gloo (the counterparts of the
reference's `tests/test_distributed.py`, with `device="cpu"`).

`parallel/mesh.init_distributed` joins a `torch.distributed` process group;
a group is process-wide, so each case drives it in subprocesses:

- a 1-process fleet whose coordinator is itself, joined twice (the second
  call is a no-op);
- a 2-process fleet: one `psum` over both processes, and one dp-sharded
  chain step (`sharded_chain_step`) whose whole batch is bit-equal to the
  single-device oracle (`chain.run_single`);
- both processes serving through the executor with `use_mesh`, on one and
  on two CPU entries each;
- a card's join never drops to gloo;
- the flags, threaded into ServerOptions, with the reference's
  `SystemExit` cases less the `--workers` one (the port has no
  `--workers`);
- two `python -m imaginary_tpu_torch --device cpu --mesh-hosts 2`
  servers, whose answers equal each other's and the reference app's.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from tests.conftest import fixture_bytes, free_port
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET_S = 200  # each subprocess case waits at most this long (the bound is 240 s)

_CHILD = r"""
import torch.distributed as dist

from imaginary_tpu_torch.parallel.mesh import (get_mesh, init_distributed,
                                               process_count, shutdown_distributed)

backend = init_distributed(coordinator_address="127.0.0.1:{port}",
                           num_processes=1, process_id=0, device="cpu")
assert init_distributed() == backend == "gloo"  # idempotent: a no-op
assert process_count() == 1
mesh = get_mesh(devices="cpu")
assert get_mesh(devices="cpu", local=True) == mesh
print("DIST_OK", process_count(), dict(zip(("batch", "spatial"), mesh.shape)))
shutdown_distributed()
assert not dist.is_initialized()
"""

_WORKER = r"""
import numpy as np
import torch

from imaginary_tpu_torch.ops import chain as chain_mod
from imaginary_tpu_torch.ops.plan import plan_operation
from imaginary_tpu_torch.options import ImageOptions
from imaginary_tpu_torch.parallel.mesh import (get_mesh, init_distributed,
                                               process_count, psum,
                                               sharded_chain_step)

PID = {pid}
init_distributed(coordinator_address="127.0.0.1:{port}", num_processes=2,
                 process_id=PID, device="cpu")
assert process_count() == 2, process_count()
mesh = get_mesh(2, devices="cpu", local=True)  # this process's two entries
n_local = mesh.shape[0]

# 1) one collective across the fleet: each process brings n_local shards
#    of value PID + 1
total = float(psum(torch.full((n_local,), float(PID + 1)).sum()).item())
assert total == n_local * (1.0 + 2.0), total
print("PSUM_OK", total == n_local * 3.0)

# 2) one dp-sharded chain step: each process runs its own images over its
#    mesh, and every process receives the whole batch's outputs
h_in, w_in = 32, 48
plan = plan_operation("resize", ImageOptions(width=16, height=12, force=True),
                      h_in, w_in, 0, 3)
def images(r):
    return [np.random.default_rng(1000 * r + j).integers(
        0, 256, (h_in, w_in, 3), dtype=np.uint8) for j in range(n_local)]
outs = sharded_chain_step(images(PID), [plan] * n_local, mesh)
assert len(outs) == 2 * n_local
for r in range(2):
    for j, img in enumerate(images(r)):
        want = chain_mod.run_single(img, plan, device="cpu")  # the oracle
        assert np.array_equal(outs[r * n_local + j], want), "sharded chain diverged"
print("CHAIN_OK", (plan.out_h, plan.out_w))
"""

_EXEC_WORKER = r"""
import threading

import numpy as np

from imaginary_tpu_torch.engine import Executor, ExecutorConfig
from imaginary_tpu_torch.ops import chain as chain_mod
from imaginary_tpu_torch.ops.plan import plan_operation
from imaginary_tpu_torch.options import ImageOptions
from imaginary_tpu_torch.parallel.mesh import init_distributed, process_count

PID = {pid}
init_distributed(coordinator_address="127.0.0.1:{port}", num_processes=2,
                 process_id=PID, device="cpu")
assert process_count() == 2
# the serving executor inside a live fleet: batch formation, then mesh
# dispatch over THIS process's entries, while the group stays up around it
ex = Executor(ExecutorConfig(window_ms={window}, max_batch=8, use_mesh=True,
                             device="cpu", n_devices={entries}))
assert ex._batch_mesh.shape[0] == {entries}, ex._batch_mesh.shape
h_in, w_in = 32, 48
plan = plan_operation("resize", ImageOptions(width=16, height=12, force=True),
                      h_in, w_in, 0, 3)
rng = np.random.default_rng({seed} + PID)
imgs = [rng.integers(0, 256, (h_in, w_in, 3), dtype=np.uint8) for _ in range(24)]
oracle = [chain_mod.run_single(a, plan, device="cpu") for a in imgs]

results = [None] * len(imgs)
def client(k):
    for j in range(k, len(imgs), 6):
        results[j] = ex.process(imgs[j], plan)

threads = [threading.Thread(target=client, args=(k,)) for k in range(6)]
for t in threads: t.start()
for t in threads: t.join()
ex.shutdown()
for got, want in zip(results, oracle):
    assert got is not None and np.array_equal(got, want), "fleet executor output diverged"
assert ex.stats.items == len(imgs)
assert ex.stats.sharded_batches == ex.stats.batches
if {entries} > 1:
    assert ex.stats.batches < len(imgs)  # batching formed groups
    assert all(n > 0 for n in ex.stats.mesh_dispatches), ex.stats.mesh_dispatches
print("{tag}", {entries}, ex.stats.items, ex.stats.batches)
"""


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _collect(procs: list, budget_s: float = BUDGET_S) -> list:
    """Poll the processes until all have exited (a dead one would leave its
    peer blocked in init_distributed: stop at the first failure); kill
    what is left. Returns [(rc, out, err)]."""
    outs = [None] * len(procs)
    deadline = time.monotonic() + budget_s
    try:
        while any(o is None for o in outs) and time.monotonic() < deadline:
            for i, p in enumerate(procs):
                if outs[i] is None and p.poll() is not None:
                    out, err = p.communicate()
                    outs[i] = (p.returncode, out, err)
            if any(o is not None and o[0] != 0 for o in outs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, p in enumerate(procs):
        if outs[i] is None:
            out, err = p.communicate()
            outs[i] = (p.returncode, out, err)
    fails = [err for rc, _, err in outs if rc != 0]
    assert not fails, "\n--- worker stderr ---\n".join(e[-2000:] for e in fails)
    return outs


def _run_pair(src: str, **fmt) -> list:
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", src.format(pid=i, port=port, **fmt)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=_ROOT, env=_env())
             for i in range(2)]
    return _collect(procs)


def test_init_distributed_single_process_fleet():
    r = subprocess.run([sys.executable, "-c", _CHILD.format(port=free_port())],
                       capture_output=True, text=True, timeout=BUDGET_S, cwd=_ROOT,
                       env=_env())
    assert r.returncode == 0, r.stderr[-2000:]
    assert "DIST_OK 1 {'batch': 1, 'spatial': 1}" in r.stdout


def test_two_process_fleet_psum_and_sharded_chain():
    for _rc, out, _err in _run_pair(_WORKER):
        assert "PSUM_OK True" in out
        assert "CHAIN_OK (12, 16)" in out


def test_two_process_fleet_serving_executors():
    for _rc, out, _err in _run_pair(_EXEC_WORKER, window=2.0, entries=1, seed=77,
                                    tag="EXEC_FLEET_OK"):
        assert "EXEC_FLEET_OK 1 24" in out


def test_two_process_fleet_sharded_serving_chain():
    """Two CPU entries a process: use_mesh splits every formed chunk over
    both, outputs bit-equal to the single-device oracle."""
    for _rc, out, _err in _run_pair(_EXEC_WORKER, window=4.0, entries=2, seed=900,
                                    tag="MESH_CHAIN_OK"):
        assert "MESH_CHAIN_OK 2 24" in out


def test_a_card_fleet_never_drops_to_gloo():
    """The backend follows the device: a card asks for nccl, and where it
    cannot have it (no card here) the join raises before any group
    exists; nothing falls back to gloo."""
    import torch
    import torch.distributed as dist

    from imaginary_tpu_torch.parallel import mesh as mesh_mod

    if torch.cuda.is_available():
        pytest.skip("a card is present: the nccl join would succeed")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_mod.init_distributed(coordinator_address=f"127.0.0.1:{free_port()}",
                                  num_processes=1, process_id=0, device="cuda")
    with pytest.raises(ValueError):
        mesh_mod.init_distributed(device="meta")
    assert not dist.is_initialized() and mesh_mod._dist_backend is None


def test_cli_flags_thread_through():
    from imaginary_tpu_torch.cli import options_from_args, parse_args

    o = options_from_args(parse_args([
        "--distributed", "--coordinator-address", "10.0.0.1:1234",
        "--num-processes", "4", "--process-id", "2", "--use-mesh"]))
    assert o.distributed and o.use_mesh
    assert o.coordinator_address == "10.0.0.1:1234"
    assert o.num_processes == 4
    assert o.process_id == 2


def test_mesh_hosts_flags_thread_through():
    from imaginary_tpu.cli import build_parser as ref_parser
    from imaginary_tpu.cli import options_from_args as ref_options
    from imaginary_tpu_torch.cli import options_from_args, parse_args

    o = options_from_args(parse_args([
        "--mesh-hosts", "2", "--coordinator-address", "10.0.0.1:1234",
        "--process-id", "1"]))
    assert o.mesh_hosts == 2
    assert o.process_id == 1
    # a serving mesh needs a coordinator and a pinned process id; each
    # refusal is the reference's (its --workers case has no port flag)
    for argv in (["--mesh-hosts", "2", "--process-id", "0"],
                 ["--mesh-hosts", "2", "--coordinator-address", "10.0.0.1:1"]):
        with pytest.raises(SystemExit) as got:
            options_from_args(parse_args(argv))
        with pytest.raises(SystemExit) as want:
            ref_options(ref_parser().parse_args(argv + ["--workers", "1"]))
        assert str(got.value) == str(want.value)


def _post(port: int, path: str, body: bytes) -> tuple:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST", headers={"Content-Type": "image/jpeg"})
    with urllib.request.urlopen(req, timeout=30.0) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _reference_answers(paths: list, body: bytes) -> dict:
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from imaginary_tpu.web.app import create_app
    from imaginary_tpu.web.config import ServerOptions

    async def run():
        client = TestClient(TestServer(create_app(ServerOptions(host_spill=False),
                                                  log_stream=io.StringIO())))
        await client.start_server()
        try:
            out = {}
            for path in paths:
                r = await client.post(path, data=body, headers={"Content-Type": "image/jpeg"})
                out[path] = (r.status, r.headers["Content-Type"], await r.read())
            return out
        finally:
            await client.close()

    return asyncio.run(run())


def test_mesh_hosts_serving_boot_two_hosts():
    """Two `python -m imaginary_tpu_torch --device cpu --mesh-hosts 2`
    processes meet as a 2-process gloo group at boot, then each serves:
    their answers are byte-equal to each other's and equal the reference
    app's (status, type and dims; a PNG within 1 LSB)."""
    import signal

    coord = free_port()
    ports = (free_port(), free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "imaginary_tpu_torch", "--device", "cpu", "--mesh-hosts", "2",
         "--coordinator-address", f"127.0.0.1:{coord}", "--process-id", str(i),
         "--addr", "127.0.0.1", "--port", str(port), "--log-level", "error"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=_ROOT, env=_env())
        for i, port in enumerate(ports)]
    paths = ["/resize?width=64", "/resize?width=64&type=png"]
    body = fixture_bytes("imaginary.jpg")
    try:
        answers: dict = {}
        deadline = time.monotonic() + BUDGET_S
        while time.monotonic() < deadline and len(answers) < 2:
            if any(p.poll() is not None for p in procs):
                break  # a host died: fail with its stderr
            for port in ports:
                if port in answers:
                    continue
                try:
                    answers[port] = [_post(port, path, body) for path in paths]
                except (urllib.error.URLError, ConnectionError, OSError):
                    time.sleep(0.5)
        dead = [p for p in procs if p.poll() is not None]
        if dead:
            raise AssertionError("mesh host died:\n" + dead[0].communicate()[1][-2000:])
        assert len(answers) == 2
        a, b = answers[ports[0]], answers[ports[1]]
        assert a == b  # identical pipeline on both hosts: byte-equal answers
        ref = _reference_answers(paths, body)
        for path, got in zip(paths, a):
            want = ref[path]
            assert got[:2] == want[:2] and got[0] == 200
            img, ref_img = (np.asarray(Image.open(io.BytesIO(x[2])), np.int16)
                            for x in (got, want))
            assert img.shape == ref_img.shape
            if got[1] == "image/png":
                assert np.abs(img - ref_img).max() <= 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.communicate(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
