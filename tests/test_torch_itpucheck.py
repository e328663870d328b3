"""The reference's project-invariant analyzer (`imaginary_tpu.tools.itpucheck`)
run, unedited, over the port's tree.

It is rooted at the repository, so the config-surface rule (ITPU005)
reads the README that documents the flags. Every finding must be
repaired or suppressed with the reference's grammar,
`# itpu: allow[ITPUnnn] <reason>`; a suppression without a reason is a
finding of its own.
"""

from __future__ import annotations

import os

from imaginary_tpu.tools import itpucheck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run():
    return itpucheck.run_checks(paths=[os.path.join(ROOT, "imaginary_tpu_torch")], root=ROOT)


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
