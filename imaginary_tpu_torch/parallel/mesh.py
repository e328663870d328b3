"""Device mesh of the port (the counterpart of
`imaginary_tpu/parallel/mesh.py:60-130`).

A `Mesh` is a [batch, spatial] grid of `torch.device`s:

  batch    data parallelism over micro-batch elements: the executor's
           lanes (one per flat entry) and its sharded dispatch;
  spatial  within-image parallelism: `parallel/spatial.sharded_blur`
           splits the W axis over it.

An entry may name the same device more than once: four entries on one
card give four lanes (each with its own stream) or four W-shards on one
card. That is how the CPU tests get the eight devices JAX gets from
XLA_FLAGS, and how one card exercises the halo exchange.

JAX's `NamedSharding` has no torch counterpart: `split_batch` and
`split_width` return the contiguous ranges each device owns, and the
callers copy those slices themselves. `init_distributed` (multi-host) is
not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A [batch, spatial] grid of devices (rows of equal length)."""

    devices: tuple  # ((torch.device, ...), ...)

    @property
    def shape(self) -> tuple:
        return (len(self.devices), len(self.devices[0]))

    @property
    def flat(self) -> list:
        """The entries in row-major order: the fault-domain index the
        executor's lanes and `engine/devhealth.py` use."""
        return [d for row in self.devices for d in row]


def _grid(devs: list, spatial: int) -> Mesh:
    n = len(devs)
    spatial = max(1, min(spatial, n))
    batch = n // spatial
    return Mesh(tuple(tuple(devs[b * spatial:(b + 1) * spatial])
                      for b in range(batch)))


def get_mesh(n_devices: Optional[int] = None, spatial: int = 1,
             devices=None) -> Mesh:
    """Build a (batch, spatial) mesh.

    `devices` None (or "cuda"): the first `n_devices` visible cards (all
    of them when n_devices is None or 0); asking for more than exist
    raises. A list: taken as given and may repeat a device (its first
    n_devices entries when n_devices is set). Any other single device
    ("cpu", "cuda:1"): that device n_devices times (once by default).
    As in the reference, spatial is clipped to the device count and a
    remainder that fills no batch row is dropped."""
    if devices is None or (isinstance(devices, (str, torch.device))
                           and str(devices) == "cuda"):
        count = torch.cuda.device_count()
        n = n_devices or count
        if n > count:
            raise RuntimeError(f"asked for {n} cards, {count} visible")
        devs = [torch.device("cuda", i) for i in range(n)]
    elif isinstance(devices, (str, torch.device)):
        devs = [torch.device(devices)] * (n_devices or 1)
    else:
        devs = [torch.device(d) for d in devices]
        if n_devices:
            devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return _grid(devs, spatial)


def healthy_mesh(mesh: Mesh, healthy) -> Optional[Mesh]:
    """The degraded view of `mesh` holding only the entries whose FLAT
    index is in `healthy`, re-formed as a batch-only (n, 1) mesh in flat
    order: W-sharding needs the full grid. None when nothing is healthy;
    `mesh` itself when everything is."""
    healthy = set(healthy)
    flat = mesh.flat
    if all(i in healthy for i in range(len(flat))):
        return mesh
    devs = [d for i, d in enumerate(flat) if i in healthy]
    if not devs:
        return None
    return _grid(devs, 1)


def mesh_devices(mesh: Mesh) -> int:
    b, s = mesh.shape
    return b * s


def pad_batch_for_mesh(n: int, mesh: Mesh) -> int:
    """Round a batch size up to a multiple of the batch axis."""
    b = mesh.shape[0]
    return ((n + b - 1) // b) * b


def split_batch(n: int, mesh: Mesh) -> list:
    """The contiguous [start, stop) range of n batch items each batch-axis
    row owns: sizes differ by at most one, the larger first (numpy's
    array_split); a row may own nothing when n is below the axis."""
    b = mesh.shape[0]
    base, extra = divmod(n, b)
    out, start = [], 0
    for i in range(b):
        stop = start + base + (1 if i < extra else 0)
        out.append((start, stop))
        start = stop
    return out


def split_width(wb: int, mesh: Mesh) -> list:
    """The [start, stop) columns each spatial-axis column of the mesh owns
    for a bucket wb wide. Raises ValueError unless wb splits evenly, as
    JAX's device_put refuses uneven shards."""
    s = mesh.shape[1]
    if wb % s:
        raise ValueError(f"bucket width {wb} does not split evenly over "
                         f"{s} spatial shards")
    lw = wb // s
    return [(i * lw, (i + 1) * lw) for i in range(s)]
