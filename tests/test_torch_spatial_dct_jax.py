"""The port's spatial route on the DCT transport against the JAX executor's.

Both executors run W-sharded over a (2, 2) mesh (the JAX package's on the
conftest's virtual devices, the port's on cpu entries), `--transport-dct`
on, and serve the same JPEG bytes of each layout: /resize at k = 8 and at
k = 4, /rotate?rotate=90 and /smartcrop, egress off and on. Each request
crosses the spatial bar in both (`spatial_batches` rises by one) and the
port gathers nowhere (`spatial_gathers` unchanged). Tolerances, those of
`tests/test_torch_dct.py`: the output planes within 1 LSB; with the
egress, the drained coefficients within one quantization step, at most
0.1 % of them differing (a coefficient within rounding of a .5 tie can
round the other way).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from imaginary_tpu import pipeline as jpipeline
from imaginary_tpu.engine import Executor as JExecutor
from imaginary_tpu.engine import ExecutorConfig as JExecutorConfig
from imaginary_tpu.params import build_params_from_query as jquery
from imaginary_tpu_torch import pipeline as ppipeline
from imaginary_tpu_torch.engine import Executor, ExecutorConfig
from imaginary_tpu_torch.params import build_params_from_query as pquery
from tests.test_torch_spatial_dct import dct_jpeg
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")


@pytest.fixture(autouse=True, scope="module")
def _reference_wire_unlabelled():
    """The reference's lanes book its WIRE ledger by device; leave that
    process-wide ledger unlabelled for the next test file in this worker
    (the reference's exposition tests parse every label it renders)."""
    yield
    from imaginary_tpu.engine.timing import WIRE as reference_wire

    reference_wire.reset()


WAIT_S = 120
U8_TOL = 1
COEF_TOL = 1
COEF_SHARE = 1e-3
LAYOUTS = ["420", "422", "444", "gray"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def executors():
    """The JAX executor's spatial route on a (2, 2) mesh of the conftest's
    virtual devices, and the port's on a (2, 2) mesh of cpu entries."""
    import jax

    if len(jax.devices()) < 4:
        pytest.fail("the conftest's eight virtual devices are missing")
    jex = JExecutor(JExecutorConfig(mesh_policy="lanes", n_devices=4, spatial=2,
                                    spatial_threshold_px=1, window_ms=1.0))
    pex = Executor(ExecutorConfig(device="cpu", mesh_policy="lanes", n_devices=4,
                                  spatial=2, spatial_threshold_px=1, max_form_ms=1.0))
    try:
        yield jex, pex
    finally:
        jex.shutdown()
        pex.shutdown()


@pytest.fixture
def transport(request):
    """Both packages' dct transport on, the egress as the case asks."""
    egress = request.param
    for mod in (jpipeline, ppipeline):
        mod.set_transport_dct(True)
        mod.set_transport_dct_egress(egress)
    yield egress
    for mod in (jpipeline, ppipeline):
        mod.set_transport_dct(False)
        mod.set_transport_dct_egress(False)


# (name, op, query, k on the 150x420 JPEG)
CASES = [
    ("resize-k8", "resize", {"width": "400"}, 8),
    ("resize-k4", "resize", {"width": "120"}, 4),
    ("rotate90", "rotate", {"rotate": "90"}, 8),
    ("smartcrop", "smartcrop", {"width": "100", "height": "100"}, 8),
]


@pytest.mark.parametrize("transport", [False, True], ids=["egress-off", "egress-on"],
                         indirect=True)
@pytest.mark.parametrize("case,op,query,k", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_dct_spatial_route_matches_the_jax_spatial_route(executors, transport, layout, case,
                                                         op, query, k):
    jex, pex = executors
    egress = transport
    buf = dct_jpeg(layout, 150, 420, seed=11)
    jseen, pseen, plans = [], [], []
    j0, p0 = jex.stats.spatial_batches, pex.stats.spatial_batches
    g0 = dict(pex.stats.spatial_gathers)

    def jrun(arr, plan):
        jseen.append(jex.process(arr, plan))
        return jseen[-1]

    def prun(arr, plan):
        plans.append(plan)
        pseen.append(pex.process(arr, plan, timeout=WAIT_S))
        return pseen[-1]

    want = jpipeline.process_operation(op, buf, jquery(query), runner=jrun)
    got = ppipeline.process_operation(op, buf, pquery(query), device="cpu", runner=prun)
    assert (got.width, got.height, got.mime) == (want.width, want.height, want.mime)
    assert plans[0].transport == "dct" and plans[0].spec_key()[0].k == k
    assert plans[0].spec_key()[0].layout == layout
    assert jex.stats.spatial_batches - j0 == 1 and pex.stats.spatial_batches - p0 == 1
    assert pex.stats.spatial_gathers == g0
    assert len(jseen) == len(pseen) == 1
    assert type(pseen[0]).__name__ == ("QuantizedBlocks" if egress else "YuvPlanes")
    for key in ("y", "u", "v"):
        a, b = getattr(pseen[0], key), np.asarray(getattr(jseen[0], key))
        assert a.shape == b.shape
        d = np.abs(a.astype(int) - b.astype(int))
        if egress:
            assert int(d.max()) <= COEF_TOL and float((d > 0).mean()) <= COEF_SHARE
        else:
            assert int(d.max()) <= U8_TOL
