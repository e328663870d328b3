"""The reference's native codec, built before the port's parity tests use it.

The reference (`imaginary_tpu.codecs`) chooses its codec backend once per
process and keeps it: its native extension when
`imaginary_tpu/native/_imaginary_codecs*.so` loads, else cv2. That library
is a build artifact (`*.so` is gitignored), and a reference module that
decodes at collection time (`tests/test_robustness.py` asks for the raw
codec in a `skipif`) makes every worker choose before any test ran. On a
fresh checkout the port's parity tests would then compare against cv2's
pixels, or against a codec that lacks the packed-YUV420 entry points,
depending on which worker ran which file.

`reference_native` is a module-scoped fixture for every port test file
whose reference side decodes through `imaginary_tpu.codecs`. It builds the
library with the reference's own `imaginary_tpu.native.build` when it does
not load, under an `fcntl` lock on a file in the gitignored
`imaginary_tpu_torch/_build/`, compiling under a temporary name that
`os.replace` moves into place (another worker may be loading the library,
or building it through `tests/test_native_codecs.py`'s fixture). It then
reloads `imaginary_tpu.codecs.native_backend` and clears the reference's
cached backend, so the reference chooses again.
"""

from __future__ import annotations

import contextlib
import fcntl
import importlib
import json
import os
import shutil
import subprocess
import sys
import sysconfig
import textwrap
from unittest import mock

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lock_path() -> str:
    import imaginary_tpu

    root = os.path.dirname(os.path.dirname(os.path.abspath(imaginary_tpu.__file__)))
    return os.path.join(root, "imaginary_tpu_torch", "_build", "refnative.lock")


@contextlib.contextmanager
def _locked(path: str):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


def _build_into_place(build) -> str:
    """The reference's cascade (`build`, then `build_no_webp`), each compile
    written under a temporary name; the first that links is moved onto
    the name the reference imports."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    tmp_name = f"_imaginary_codecs_tmp{os.getpid()}"
    real = build._compile

    def to_tmp(out_name, extra, verbose, src_name="codecs.cpp"):
        return real(tmp_name, extra, verbose, src_name)

    errors = []
    with mock.patch.object(build, "_compile", to_tmp):
        for step in (build.build, build.build_no_webp):
            try:
                tmp = step(verbose=False)
                break
            except (subprocess.CalledProcessError, OSError) as e:
                errors.append(f"{step.__name__}: {e}")
        else:
            with contextlib.suppress(FileNotFoundError):
                os.remove(os.path.join(build.HERE, tmp_name + suffix))
            raise RuntimeError("the reference's native codec did not build: "
                               + "; ".join(errors))
    out = os.path.join(build.HERE, "_imaginary_codecs" + suffix)
    os.replace(tmp, out)
    return out


def ensure_reference_native() -> bool:
    """Make the reference decode through its native codec in this process.

    Returns True when this call built the library, False when it loaded
    one that was there. Raises when the build fails."""
    from imaginary_tpu import codecs as jcodecs
    from imaginary_tpu.codecs import native_backend

    built = False
    if not native_backend.available():
        from imaginary_tpu.native import build

        with _locked(_lock_path()):
            importlib.invalidate_caches()
            importlib.reload(native_backend)
            if not native_backend.available():
                _build_into_place(build)
                built = True
                importlib.invalidate_caches()
                importlib.reload(native_backend)
        if not native_backend.available():
            raise RuntimeError("the reference's native codec built but does not load")
    if jcodecs._BACKEND is not native_backend:
        jcodecs._BACKEND = None
    return built


@pytest.fixture(scope="module")
def reference_native():
    ensure_reference_native()


def test_the_reference_decodes_natively_under_the_fixture(reference_native):
    from imaginary_tpu import codecs as jcodecs
    from imaginary_tpu.imgtype import ImageType
    from tests.conftest import fixture_bytes

    assert jcodecs.backend_name() == "native"
    assert jcodecs.yuv420_supported()
    d = jcodecs.decode(fixture_bytes("imaginary.jpg"), ImageType.JPEG)
    assert d.array.shape == (740, 550, 3)


def test_a_cached_fallback_backend_is_chosen_again(reference_native):
    """A worker that chose cv2 before the library existed decodes
    natively once the fixture has run."""
    from imaginary_tpu import codecs as jcodecs
    from imaginary_tpu.codecs import cv2_backend

    jcodecs._BACKEND = cv2_backend
    try:
        assert not ensure_reference_native()
        assert jcodecs.backend_name() == "native"
    finally:
        jcodecs._BACKEND = None


_RACER = textwrap.dedent("""
    import json, sys
    sys.path[:0] = [sys.argv[1], sys.argv[2]]
    from tests.test_torch_refnative import ensure_reference_native
    import imaginary_tpu
    from imaginary_tpu import codecs
    from imaginary_tpu.imgtype import ImageType
    built = ensure_reference_native()
    with open(sys.argv[3], "rb") as f:
        d = codecs.decode(f.read(), ImageType.JPEG)
    print(json.dumps({"built": built, "backend": codecs.backend_name(),
                      "shape": list(d.array.shape), "pkg": imaginary_tpu.__file__}))
""")


def test_two_processes_racing_the_build_both_load_a_whole_library(tmp_path):
    """Two processes start on a copy of the reference with no library: one
    builds, the other waits on the lock and loads what the first moved
    into place; both decode natively."""
    shutil.copytree(os.path.join(ROOT, "imaginary_tpu"), tmp_path / "imaginary_tpu",
                    ignore=shutil.ignore_patterns("*.so", "__pycache__"))
    racer = tmp_path / "racer.py"
    racer.write_text(_RACER)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    jpg = os.path.join(ROOT, "tests", "testdata", "imaginary.jpg")
    procs = [subprocess.Popen([sys.executable, str(racer), str(tmp_path), ROOT, jpg],
                              cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert all(g["pkg"].startswith(str(tmp_path)) for g in got)
    assert sorted(g["built"] for g in got) == [False, True]
    assert all(g["backend"] == "native" and g["shape"] == [740, 550, 3] for g in got)
    native = tmp_path / "imaginary_tpu" / "native"
    assert sorted(p.name for p in native.glob("*.so")) == [
        "_imaginary_codecs" + (sysconfig.get_config_var("EXT_SUFFIX") or ".so")]
    assert (tmp_path / "imaginary_tpu_torch" / "_build" / "refnative.lock").exists()
