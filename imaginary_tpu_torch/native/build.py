"""Build the port's native extensions: the host codec and the entropy codec.

Compiles `codecs.cpp` with g++ into
`imaginary_tpu_torch/_build/_itpu_torch_codecs-<digest>.so`, where the
digest covers the source, the flags and each library's link routes on
this host, in the order tried (which fix the route the build takes).
First use builds it (`codecs/native_backend.py`);
`python -m imaginary_tpu_torch.native.build` builds ahead. Concurrent
builders serialise on the build directory's lock and each writes under a
temporary name moved into place with `os.replace`.

The codec links four libraries: libjpeg-turbo (6.2 ABI), libpng 1.6,
libwebp and libtiff 4 (GIF is in-tree). Each has two link routes, tried
in this order:

1. the system's (its header and the library the loader knows, linked by
   soname), where the loader knows it;
2. otherwise the shared library that Python wheels ship beside their
   extensions (`<site-packages>/*.libs/`, Pillow's first), linked by path
   and compiled against the headers kept in `native/libjpeg/`,
   `native/libpng/` and `native/libwebp/` (each with its LICENSE; libtiff
   needs none, its ABI is declared in `codecs.cpp`). The wheel's
   directory goes into the module's RPATH, which also finds the wheel
   libraries that these need (libwebp's libsharpyuv, libtiff's zstd).
   libjpeg checks the caller's ABI version and struct sizes, libpng its
   version string, libwebp its ABI's major byte, so a mismatched library
   fails loudly when a codec object is made.

A build takes the first combination of routes that links (the system
routes first), and the module reports the route of each library
(`LINKED`; `build()` returns it too). Nothing is ever substituted: when a
library has no route, or no combination links, the build raises. There
is no partial build that leaves a format to another codec.

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
import itertools
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

# (name, the name the loader knows it by, the wheel's file pattern, the
# header the system route needs, the vendored header directory)
LIBRARIES = (
    ("jpeg", "jpeg", "libjpeg*.so.62*", "jpeglib.h", "libjpeg"),
    ("png", "png16", "libpng16*.so.16*", "png.h", "libpng"),
    ("webp", "webp", "libwebp*.so.7*", "webp/encode.h", "libwebp"),
    ("tiff", "tiff", "libtiff*.so.6*", None, None),
)


def _site_dirs() -> list:
    dirs = list(site.getsitepackages()) + [site.getusersitepackages()]
    dirs.append(sysconfig.get_path("purelib"))
    seen, out = set(), []
    for d in dirs:
        if d and d not in seen and os.path.isdir(d):
            seen.add(d)
            out.append(d)
    return out


def wheel_libraries(pattern: str) -> list:
    """The libraries matching `pattern` inside installed wheels'
    `*.libs/` directories, Pillow's first."""
    found = []
    for d in _site_dirs():
        found += sorted(glob.glob(os.path.join(d, "*.libs", pattern)))
    return sorted(found, key=lambda p: os.path.basename(os.path.dirname(p)) != "pillow.libs")


def _system_header(header: str) -> bool:
    multiarch = sysconfig.get_config_var("MULTIARCH") or ""
    dirs = ("/usr/local/include", f"/usr/include/{multiarch}", "/usr/include")
    return any(os.path.exists(os.path.join(d, header)) for d in dirs)


def library_routes(lib: tuple) -> list:
    """One library's routes as (description, compile args, link args), in
    the order tried: the system's where the loader knows the library (and
    its header is installed), then each wheel's copy."""
    name, known_as, pattern, header, vendored = lib
    routes = []
    soname = ctypes.util.find_library(known_as)
    if soname and (header is None or _system_header(header)):
        routes.append((f"{name}: system {soname}", [], [f"-l:{soname}"]))
    for path in wheel_libraries(pattern):
        cflags = [f"-I{os.path.join(HERE, vendored)}"] if vendored else []
        routes.append((f"{name}: {path}", cflags,
                       [path, f"-Wl,-rpath,{os.path.dirname(path)}"]))
    return routes


def link_routes() -> list:
    """Every library's routes, in LIBRARIES' order."""
    return [library_routes(lib) for lib in LIBRARIES]


def library_path(routes=None) -> str:
    """Build output path; the digest covers the source, the flags and this
    host's routes, so a build made on another host (a copied build
    directory) is never loaded here."""
    with open(os.path.join(HERE, "codecs.cpp"), "rb") as f:
        src = f.read()
    routes = link_routes() if routes is None else routes
    key = (src + " ".join(CXX_FLAGS).encode()
           + repr([[r[0] for r in rs] for rs in routes]).encode())
    tag = hashlib.sha256(key).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{MODULE}-{tag}.so")


def build() -> tuple:
    """Build the extension unless present.

    Returns (path, seconds spent, routes): routes says which library each
    format links, "; "-joined ("" when the library already existed; the
    module's `LINKED` says it either way). Raises RuntimeError when a
    library has no route, or with every combination's compiler output
    when none links."""
    routes = link_routes()
    missing = [lib[0] for lib, rs in zip(LIBRARIES, routes) if not rs]
    if missing:
        raise RuntimeError(
            "native codec build: no route to " + ", ".join(missing) + " (neither a "
            "system library the loader knows nor one in a wheel's *.libs/)")
    out = library_path(routes)
    t0 = time.monotonic()
    with build_lock():
        if os.path.exists(out):
            return out, 0.0, ""
        tmp = f"{out}.tmp{os.getpid()}"
        errors = []
        for combo in itertools.product(*routes):
            desc = "; ".join(r[0] for r in combo)
            cflags = [f for r in combo for f in r[1]]
            libs = [a for r in combo for a in r[2]]
            cmd = ["g++", *CXX_FLAGS, *cflags, f"-I{sysconfig.get_path('include')}",
                   f'-DITPU_LINKED="{desc}"', os.path.join(HERE, "codecs.cpp"),
                   "-o", tmp, *libs, "-Wl,--disable-new-dtags"]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode == 0:
                os.replace(tmp, out)
                return out, time.monotonic() - t0, desc
            errors.append(f"[{desc}]\n{proc.stderr}")
            with contextlib.suppress(FileNotFoundError):
                os.remove(tmp)
    raise RuntimeError("native codec build failed on every combination of routes "
                       f"({len(errors)} tried):\n" + "\n".join(errors))


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
