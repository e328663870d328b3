"""Build the port's native extensions: the JPEG codec and the entropy codec.

Compiles `codecs.cpp` with g++ into
`imaginary_tpu_torch/_build/_itpu_torch_codecs-<digest>.so`, where the
digest covers the source, the flags and the libjpeg routes this host
offers. First use builds it (`codecs/native_backend.py`);
`python -m imaginary_tpu_torch.native.build` builds ahead. Concurrent
builders serialise on the build directory's lock and each writes under a
temporary name moved into place with `os.replace`.

The codec needs libjpeg-turbo with the libjpeg 6.2 ABI. Two ways to link
it, tried in this order, and the build reports which one it took:

1. the system's (`jpeglib.h` and `-ljpeg`, the libjpeg62-turbo dev
   package), where the loader knows a libjpeg;
2. on hosts without it, the libjpeg-turbo shared library that Python wheels
   ship beside their extensions (`<site-packages>/*.libs/libjpeg*.so.62*`,
   Pillow's for one), compiled against the libjpeg-turbo 6.2 headers kept
   in `native/libjpeg/` (see its LICENSE). libjpeg checks the caller's
   ABI version and struct sizes when a codec object is created, so a
   mismatched library fails loudly there.

Both are the same decoder; nothing else is ever substituted. When neither
links, the build raises with the compiler's output.

`build_entropy()` compiles `entropy.cpp` (the DCT transport's Huffman
scan decode and encode; CPython's C API only, no libraries) into
`_build/_itpu_torch_entropy-<digest>.so` the same way;
`build_resample()` compiles `resample.cpp` (the host interpreter's
separable resampler, a copy of the reference's; no libraries) into
`_build/_itpu_torch_resample-<digest>.so`;
`python -m imaginary_tpu_torch.native.build` builds all three.
"""

from __future__ import annotations

import contextlib
import ctypes.util
import glob
import hashlib
import os
import site
import subprocess
import sysconfig
import time

from imaginary_tpu_torch.kernels.build import BUILD_DIR, build_lock

HERE = os.path.dirname(os.path.abspath(__file__))
MODULE = "_itpu_torch_codecs"
ENTROPY_MODULE = "_itpu_torch_entropy"
RESAMPLE_MODULE = "_itpu_torch_resample"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
VENDORED_HEADERS = os.path.join(HERE, "libjpeg")


def _site_dirs() -> list:
    dirs = list(site.getsitepackages()) + [site.getusersitepackages()]
    dirs.append(sysconfig.get_path("purelib"))
    seen, out = set(), []
    for d in dirs:
        if d and d not in seen and os.path.isdir(d):
            seen.add(d)
            out.append(d)
    return out


def wheel_libjpeg() -> list:
    """libjpeg-turbo (6.2 ABI) libraries shipped inside installed wheels."""
    found = []
    for d in _site_dirs():
        found += sorted(glob.glob(os.path.join(d, "*.libs", "libjpeg*.so.62*")))
    return found


def link_routes() -> list:
    """(description, extra compile args, link args) in the order tried;
    the system route only where the loader knows a libjpeg."""
    routes = []
    if ctypes.util.find_library("jpeg"):
        routes.append(("system libjpeg (-ljpeg)", [], ["-ljpeg"]))
    for lib in wheel_libjpeg():
        routes.append((f"{lib} with the headers in native/libjpeg",
                       [f"-I{VENDORED_HEADERS}"],
                       [lib, f"-Wl,-rpath,{os.path.dirname(lib)}"]))
    return routes


def library_path(routes=None) -> str:
    """Build output path; the digest covers the source, the flags and this
    host's libjpeg routes, so a build made on another host (a copied build
    directory) is never loaded here."""
    with open(os.path.join(HERE, "codecs.cpp"), "rb") as f:
        src = f.read()
    routes = link_routes() if routes is None else routes
    key = src + " ".join(CXX_FLAGS).encode() + repr([r[0] for r in routes]).encode()
    tag = hashlib.sha256(key).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{MODULE}-{tag}.so")


def build() -> tuple:
    """Build the extension unless present.

    Returns (path, seconds spent, route): route says which libjpeg it was
    linked against ("" when the library already existed). Raises
    RuntimeError with every route's compiler output when none links."""
    routes = link_routes()
    out = library_path(routes)
    t0 = time.monotonic()
    with build_lock():
        if os.path.exists(out):
            return out, 0.0, ""
        tmp = f"{out}.tmp{os.getpid()}"
        errors = []
        for desc, cflags, libs in routes:
            cmd = ["g++", *CXX_FLAGS, *cflags, f"-I{sysconfig.get_path('include')}",
                   os.path.join(HERE, "codecs.cpp"), "-o", tmp, *libs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode == 0:
                os.replace(tmp, out)
                return out, time.monotonic() - t0, desc
            errors.append(f"[{desc}]\n{proc.stderr}")
            with contextlib.suppress(FileNotFoundError):
                os.remove(tmp)
    raise RuntimeError("native codec build failed on every libjpeg route "
                       f"({len(routes)} found):\n" + "\n".join(errors))


def _plain_path(source: str, module: str) -> str:
    with open(os.path.join(HERE, source), "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{module}-{tag}.so")


def _build_plain(source: str, module: str, what: str) -> tuple:
    """Build a library-free extension from `source` unless present.

    Returns (path, seconds spent); raises RuntimeError with the compiler's
    output when the build fails."""
    out = _plain_path(source, module)
    t0 = time.monotonic()
    with build_lock():
        if os.path.exists(out):
            return out, 0.0
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = ["g++", *CXX_FLAGS, f"-I{sysconfig.get_path('include')}",
               os.path.join(HERE, source), "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            with contextlib.suppress(FileNotFoundError):
                os.remove(tmp)
            raise RuntimeError(f"{what} build failed:\n{proc.stderr}")
        os.replace(tmp, out)
        return out, time.monotonic() - t0


def entropy_path() -> str:
    return _plain_path("entropy.cpp", ENTROPY_MODULE)


def build_entropy() -> tuple:
    """Build the entropy codec extension unless present: (path, seconds)."""
    return _build_plain("entropy.cpp", ENTROPY_MODULE, "entropy codec")


def build_resample() -> tuple:
    """Build the host resampler extension unless present: (path, seconds)."""
    return _build_plain("resample.cpp", RESAMPLE_MODULE, "host resampler")


if __name__ == "__main__":
    path, secs, route = build()
    print(f"built {path} ({secs:.1f} s) against {route or 'an earlier build'}")
    for fn in (build_entropy, build_resample):
        path, secs = fn()
        print(f"built {path} ({secs:.1f} s)")
