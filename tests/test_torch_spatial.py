"""The port's multi-GPU layer on the CPU: the device mesh
(`imaginary_tpu_torch/parallel/mesh.py`) and the W-sharded blur with its
input-halo exchange (`parallel/spatial.py`, through K13's plain version
in `kernels/reference.py`).

The same seeded numpy inputs go through JAX `sharded_blur` on the
conftest's eight virtual devices and through the port's `sharded_blur` on
a mesh of `cpu` entries of the same shape, (4, 2) and (2, 4), at radii 1,
8 and the largest the guard admits (local width - 1). Both are held
within 1e-3 absolute on the 0-255 scale (f32 sums in other orders), and
also against JAX `BlurSpec(radius).apply` and the port's own K6 plain
version on the unsharded image, which the sharded blur equals bit for
bit. Valid widths end mid-shard, exactly at a seam and one column past
one; sigma 0 (the delta) and uint8 input are covered, and the ValueError
guards of the call and of K13's wrapper.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from imaginary_tpu.ops.stages import BlurSpec
from imaginary_tpu.parallel import mesh as jmesh
from imaginary_tpu.parallel.spatial import sharded_blur as jsharded_blur
from imaginary_tpu_torch import kernels
from imaginary_tpu_torch.kernels import reference
from imaginary_tpu_torch.parallel import (
    get_mesh,
    healthy_mesh,
    mesh_devices,
    pad_batch_for_mesh,
    split_batch,
    split_width,
)
from imaginary_tpu_torch.parallel.spatial import sharded_blur

F32_TOL = 1e-3  # absolute, on the 0-255 scale
HB, WB = 32, 64
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(batch, spatial):
    if len(jax.devices()) < batch * spatial:
        pytest.fail("the conftest's eight virtual devices are missing")
    devs = np.array(jax.devices()[: batch * spatial]).reshape(batch, spatial)
    return JMesh(devs, ("batch", "spatial"))


def _pmesh(batch, spatial):
    return get_mesh(devices=[CPU] * (batch * spatial), spatial=spatial)


def _inputs(seed, bsz, spatial, c=3, sigma=3.0, u8=False):
    """bsz images in an HB x WB bucket whose valid widths end mid-shard, at
    a seam, one column past a seam and at the bucket's edge, with valid
    heights below the bucket and per-image sigma."""
    rng = np.random.default_rng(seed)
    lw = WB // spatial
    ends = [lw + lw // 2, 2 * lw, lw + 1, WB]
    x = rng.integers(0, 256, (bsz, HB, WB, c))
    x = x.astype(np.uint8) if u8 else x.astype(np.float32)
    h = np.array([HB - 3 * (i % 4) for i in range(bsz)], np.int32)
    w = np.array([ends[i % 4] for i in range(bsz)], np.int32)
    s = np.array([sigma * (1.0 + 0.25 * (i % 3)) for i in range(bsz)], np.float32)
    return x, h, w, s


def _port(x, h, w, s, radius, mesh):
    out = sharded_blur(torch.from_numpy(x), torch.from_numpy(h),
                       torch.from_numpy(w), torch.from_numpy(s), radius, mesh)
    assert out.dtype == torch.float32 and tuple(out.shape) == x.shape
    return out.numpy()


def _jax(x, h, w, s, radius, mesh):
    return np.asarray(jsharded_blur(jnp.asarray(x.astype(np.float32)), jnp.asarray(h),
                                    jnp.asarray(w), jnp.asarray(s), radius=radius,
                                    mesh=mesh))


MESHES = [(4, 2), (2, 4)]
CASES = [(m, r) for m in MESHES for r in (1, 8, WB // m[1] - 1)]


@pytest.mark.parametrize("shape,radius", CASES,
                         ids=[f"{b}x{s}-r{r}" for (b, s), r in CASES])
def test_sharded_blur_matches_jax_sharded_blur_and_blur_spec(shape, radius):
    batch, spatial = shape
    x, h, w, s = _inputs(10 * batch + radius, 2 * batch, spatial)
    got = _port(x, h, w, s, radius, _pmesh(batch, spatial))
    want = _jax(x, h, w, s, radius, _jmesh(batch, spatial))
    assert np.abs(got - want).max() <= F32_TOL
    local, _, _ = BlurSpec(radius=radius).apply(jnp.asarray(x), jnp.asarray(h),
                                                jnp.asarray(w), {"sigma": jnp.asarray(s)})
    assert np.abs(got - np.asarray(local)).max() <= F32_TOL
    k6 = reference.blur(torch.from_numpy(x), torch.from_numpy(h),
                        torch.from_numpy(w), torch.from_numpy(s), radius)
    assert np.array_equal(got, k6.numpy())
    # zero outside every image's valid region, bucket padding included
    for i in range(x.shape[0]):
        assert not got[i, h[i]:].any() and not got[i, :, w[i]:].any()


@pytest.mark.parametrize("shape", MESHES, ids=[f"{b}x{s}" for b, s in MESHES])
def test_sigma_zero_is_the_identity_inside_the_valid_region(shape):
    batch, spatial = shape
    x, h, w, s = _inputs(7, 2 * batch, spatial, sigma=0.0)
    got = _port(x, h, w, s, 8, _pmesh(batch, spatial))
    want = _jax(x, h, w, s, 8, _jmesh(batch, spatial))
    assert np.abs(got - want).max() <= F32_TOL
    for i in range(x.shape[0]):
        assert np.array_equal(got[i, :h[i], :w[i]], x[i, :h[i], :w[i]])


@pytest.mark.parametrize("c", [1, 4])
def test_uint8_input_matches_the_f32_reference(c):
    x, h, w, s = _inputs(3, 4, 4, c=c, sigma=2.0, u8=True)
    got = _port(x, h, w, s, 8, _pmesh(2, 4))
    want = _jax(x, h, w, s, 8, _jmesh(2, 4))
    assert np.abs(got - want).max() <= F32_TOL


def test_halo_radius_guard():
    x = torch.zeros((2, 16, 64, 3))
    i = torch.tensor([16, 16], dtype=torch.int32)
    with pytest.raises(ValueError, match="halo radius"):
        sharded_blur(x, i, i * 4, torch.tensor([1.0, 1.0]), 16, _pmesh(2, 4))


def test_uneven_width_is_refused():
    x = torch.zeros((2, 16, 66, 3))
    i = torch.tensor([16, 16], dtype=torch.int32)
    with pytest.raises(ValueError, match="does not split evenly"):
        sharded_blur(x, i, i, torch.tensor([1.0, 1.0]), 2, _pmesh(2, 4))


def test_halo_passes_leave_the_halos_to_the_exchange():
    """K13 reads the columns past its shard from the halos the exchange
    fills: a shard with its neighbours' columns as halos equals K6 on the
    whole image at its columns, bit for bit, in f32 and with the uint8
    epilogue; an outer halo may be None, an inner one may not; the
    shard must lie inside the bucket."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, (2, 20, 48, 3)).astype(np.float32))
    h = torch.tensor([20, 13], dtype=torch.int32)
    w = torch.tensor([48, 29], dtype=torch.int32)
    s = torch.tensor([2.0, 0.0])
    r = 4
    for out_u8 in (False, True):
        whole = reference.blur(x, h, w, s, r, out_u8)
        for c0, c1 in ((0, 16), (16, 32), (32, 48)):
            left = x[:, :, c0 - r:c0] if c0 else None
            right = x[:, :, c1:c1 + r] if c1 < 48 else None
            got = kernels.blur_halo(x[:, :, c0:c1], left, right, h, w, s, r, c0, 48,
                                    out_u8)
            assert torch.equal(got, whole[:, :, c0:c1])
    with pytest.raises(ValueError, match="halo"):
        kernels.blur_halo(x[:, :, 16:32], None, x[:, :, 32:36], h, w, s, r, 16, 48)
    with pytest.raises(ValueError, match="outside the bucket"):
        kernels.blur_halo(x[:, :, :16], None, None, h, w, s, r, 40, 48)


# -- the mesh -------------------------------------------------------------------

MESH_SHAPES = [(8, 1), (8, 2), (8, 4), (6, 4), (4, 8), (3, 1)]


@pytest.mark.parametrize("n,spatial", MESH_SHAPES,
                         ids=[f"{n}-s{s}" for n, s in MESH_SHAPES])
def test_get_mesh_shape_matches_the_reference(n, spatial):
    want = jmesh.get_mesh(n, spatial)
    got = get_mesh(n, spatial, devices="cpu")
    assert got.shape == tuple(want.devices.shape)
    assert mesh_devices(got) == jmesh.mesh_devices(want)
    for k in range(1, 20):
        assert pad_batch_for_mesh(k, got) == jmesh.pad_batch_for_mesh(k, want)


@pytest.mark.parametrize("healthy", [(0, 1, 2, 3), (1, 2), (3,), ()],
                         ids=["all", "two", "one", "none"])
def test_healthy_mesh_matches_the_reference(healthy):
    want = jmesh.healthy_mesh(jmesh.get_mesh(4, 2), healthy)
    mesh = get_mesh(devices=[torch.device("cpu")] * 4, spatial=2)
    got = healthy_mesh(mesh, healthy)
    if want is None:
        assert got is None
        return
    assert got.shape == tuple(want.devices.shape)
    if len(healthy) == 4:
        assert got is mesh


def test_explicit_devices_may_repeat_and_cards_are_counted():
    mesh = get_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh.shape == (3, 1) and mesh.flat == [CPU] * 3
    assert get_mesh(2, devices=["cpu"] * 4).shape == (2, 1)
    assert get_mesh(devices="cpu").shape == (1, 1)
    visible = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="asked for"):
        get_mesh(visible + 1)


def test_split_batch_and_width_own_contiguous_ranges():
    mesh = get_mesh(devices=[CPU] * 8, spatial=2)  # (4, 2)
    assert split_batch(10, mesh) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert split_batch(2, mesh) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert split_width(64, mesh) == [(0, 32), (32, 64)]
    with pytest.raises(ValueError, match="does not split evenly"):
        split_width(63, mesh)
