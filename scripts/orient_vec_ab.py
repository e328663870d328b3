"""K5 against a variant with 16-byte vector loads and stores.

Builds scripts/orient_vec.cu (`itpu_orient_vec`: K5's f32 form with
float4 loads and stores where a row or tile starts 16-byte aligned) with
the package's nvcc flags, holds it (both of its rows kernels: 4-pixel
groups in registers, and a segment staged in shared memory) and the
shipped kernel
(`kernels.orient_run`) bit-equal to the plain version, and times the two
in turns (shipped, variant, variant, shipped; `kernel_ab.turns`) in the
three single modes and chip_smoke's ORIENT_RUNS, on /rotate's f32
[B, 1152, 2048, 3] bucket at B = 32 and 1 and on a C = 4 bucket
[8, 1152, 2048, 4], beside one library copy of the same bytes
(`Tensor.copy_`). Valid dims are chip_smoke's `valid_dims`: the widths
are multiples of 4, so every mirrored group of the variant's rows kernel
and every tile row inside the valid dims takes its vector path.

    python3 scripts/orient_vec_ab.py

One JSON line a case on stdout; all of them in
chip_smoke_out/orient_vec_ab.json.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as cs  # noqa: E402
from kernel_ab import turns  # noqa: E402

FORMS = (0, 1)  # the rows kernels: rows_vec, rows_smem
SHAPES = (("B32", (32, 1152, 2048, 3)), ("B1", (1, 1152, 2048, 3)),
          ("B8-C4", (8, 1152, 2048, 4)))


def build_variant():
    """The variant's library, built from scripts/orient_vec.cu; its entry
    point with ctypes' argument types set."""
    from imaginary_tpu_torch.kernels import build

    os.makedirs(cs.OUT_DIR, exist_ok=True)
    so = os.path.join(cs.OUT_DIR, "orient_vec.so")
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o", so,
           os.path.join(ROOT, "scripts", "orient_vec.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for orient_vec.cu:\n{done.stdout}{done.stderr}")
    cs.log("  orient_vec.cu: built\n" + done.stdout + done.stderr)
    fn = ctypes.CDLL(so).itpu_orient_vec
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    fn.restype = i
    return fn


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("orient_vec_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    cs.log(smi)
    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference

    kernels.load_all()
    variant = build_variant()
    dev = torch.device(cs.DEVICE)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 11)
    runs = [(m, (m,)) for m in reference.ORIENT_MODES] + list(cs.ORIENT_RUNS)
    rows = []
    for label, shape in SHAPES:
        bsz, hb, wb, c = shape
        x = torch.rand(shape, generator=gen, device=dev) * 255.0
        h, w = cs.valid_dims(bsz, hb, wb, dev)
        # the same bytes moved by one library copy: what the card reaches
        # moving data with no index arithmetic at all
        y = torch.empty_like(x)
        copy_ms = [cs.device_ms(lambda y=y: y.copy_(x)) for _ in range(2)]
        bound = cs.bound_ms(x.numel() * 8, 0.0)[0]
        row = {"case": f"{label}-copy", "shape": list(shape), "copy_ms": copy_ms,
               "bound_ms": bound, "copy_share": bound / min(copy_ms)}
        rows.append(row)
        cs.log(json.dumps(row))
        del y
        for name, names in runs:
            t, fy, fx = reference.compose_orient(names)
            want = reference.orient_run(x, h, w, names)
            out = torch.empty_like(want)

            def shipped(names=names):
                return kernels.orient_run(x, h, w, names)

            if not torch.equal(shipped(), want):
                raise AssertionError(f"orient [{label}-{name}]: differs from its plain version")
            # the modes that keep the axes in both rows forms; one tile form
            for form in FORMS if not t else FORMS[:1]:
                def vec(out=out, t=t, fy=fy, fx=fx, form=form):
                    rc = variant(x.data_ptr(), out.data_ptr(), h.data_ptr(), w.data_ptr(), t,
                                 fy, fx, bsz, hb, wb, c, form,
                                 torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"itpu_orient_vec: CUDA error {rc}")
                    return out

                out.zero_()
                if not torch.equal(vec(), want):
                    raise AssertionError(f"orient_vec [{label}-{name}, form {form}]: differs "
                                         "from the plain version")
                ta, tb = turns(shipped, vec)
                row = {"case": f"{label}-{name}", "shape": list(shape), "mode": [t, fy, fx],
                       "variant": "tiles_vec" if t else ("rows_vec", "rows_smem")[form],
                       "bit_equal": True, "ms": ta, "vec_ms": tb, "bound_ms": bound,
                       "share": bound / min(ta), "vec_share": bound / min(tb)}
                rows.append(row)
                cs.log(json.dumps(row))
            del want, out
        del x
    with open(os.path.join(cs.OUT_DIR, "orient_vec_ab.json"), "w") as f:
        json.dump({"smi": smi, "rows": rows}, f, indent=1)
    cs.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
