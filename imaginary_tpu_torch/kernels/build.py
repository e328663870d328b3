"""Build the CUDA kernels into shared libraries with a plain C interface.

Each `csrc/<name>.cu` compiles on its own with nvcc for `sm_90a` into
`imaginary_tpu_torch/_build/k_<name>-<digest>.so`, where the digest covers
the source, the headers beside it (`csrc/*.cuh`) and the flags, so a
changed source or header never loads a stale build.
All sources build at once, one nvcc process each. The build is atomic
under concurrency (several test workers or server processes may race to
it): a file lock serialises builders, each library is written under a
temporary name and moved into place with `os.replace`.

Run `python -m imaginary_tpu_torch.kernels.build` to build ahead of first
use; otherwise the first CUDA launch builds. Importing this module needs
no nvcc.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
import shutil
import subprocess
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")

# One library per source; saliency.cu holds two kernels (K9 and K10).
KERNELS = ("resample", "yuv420_unpack", "yuv420_pack", "gather", "orient",
           "blur", "composite", "gray", "saliency", "from_dct", "to_dct",
           "blur_halo")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """nvcc from PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        cand = os.path.join(root, "bin", "nvcc") if root else ""
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(*parts: bytes) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
    return h.hexdigest()[:12]


def library_path(name: str) -> str:
    parts = []
    for fname in [name + ".cu"] + sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, fname), "rb") as f:
            parts.append(f.read())
    tag = _digest(*parts, " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"k_{name}-{tag}.so")


@contextlib.contextmanager
def build_lock():
    """Exclusive lock over the build directory (also used by the codec build)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


def build_all(names=KERNELS) -> dict:
    """Build every missing kernel library in parallel.

    Returns {name: {"path", "seconds", "log"}}; "log" holds nvcc's output
    (the -Xptxas -v register and shared-memory report) for libraries built
    by this call and "" for those already present. Raises RuntimeError with
    nvcc's output when any compile fails.
    """
    with build_lock():
        result = {}
        procs = {}
        for name in names:
            out = library_path(name)
            if os.path.exists(out):
                result[name] = {"path": out, "seconds": 0.0, "log": ""}
                continue
            tmp = f"{out}.tmp{os.getpid()}"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, name + ".cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT),
                           tmp, out, time.monotonic())
        failed = []
        for name, (proc, tmp, out, t0) in procs.items():
            log = proc.communicate()[0].decode(errors="replace")
            secs = time.monotonic() - t0
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                with contextlib.suppress(FileNotFoundError):
                    os.remove(tmp)
                continue
            os.replace(tmp, out)
            result[name] = {"path": out, "seconds": secs, "log": log}
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return result


if __name__ == "__main__":
    for kname, info in build_all().items():
        print(f"{kname}: {info['path']} ({info['seconds']:.1f} s)")
        if info["log"]:
            print(info["log"])
