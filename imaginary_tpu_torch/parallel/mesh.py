"""Device mesh and process group of the port (the counterpart of
`imaginary_tpu/parallel/mesh.py`).

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
callers copy those slices themselves.

Multi-process: `init_distributed` joins a `torch.distributed` process
group (nccl for a card, gloo only when the caller asked for the CPU).
A torch process addresses only its own devices, so the serving executor
builds its mesh with `local=True`, as the reference's does, and the
global side is two process-group helpers: `psum` (the reference's psum
over the batch axis) and `sharded_chain_step` (one dp-sharded chain step:
each process runs its own images, and every process receives the whole
batch's outputs).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

_dist_lock = threading.Lock()
_dist_backend: Optional[str] = None  # set once this process joined a group


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> str:
    """Join a multi-process fleet (the reference's `init_distributed`,
    which wraps `jax.distributed.initialize`) through
    `torch.distributed.init_process_group`. Returns the backend.

    With a coordinator ("host:port" of process 0), the group meets at
    `tcp://<coordinator_address>` with `num_processes` ranks, this one
    `process_id`. With no arguments it reads torchrun's environment
    (`env://`: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), which takes
    the place of a TPU pod's auto-discovery. The backend follows the
    device the caller serves on: nccl for "cuda", gloo only for "cpu". A
    failed nccl init raises; nothing drops to gloo. Idempotent per
    process: a second call returns the backend of the first."""
    global _dist_backend
    import torch.distributed as dist

    with _dist_lock:
        if _dist_backend is not None:
            return _dist_backend
        kind = torch.device(device).type
        if kind == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("init_distributed: CUDA is not available; "
                                   "pass device='cpu' for a gloo group")
            if not dist.is_nccl_available():
                raise RuntimeError("init_distributed: this torch has no nccl")
            backend = "nccl"
        elif kind == "cpu":
            backend = "gloo"
        else:
            raise ValueError(f"init_distributed: no backend for device {device!r}")
        if coordinator_address:
            if num_processes is None or process_id is None:
                raise ValueError("init_distributed: a coordinator address needs "
                                 "num_processes and process_id")
            kwargs = dict(init_method=f"tcp://{coordinator_address}",
                          world_size=int(num_processes), rank=int(process_id))
        else:
            kwargs = dict(init_method="env://")
            if num_processes is not None:
                kwargs["world_size"] = int(num_processes)
            if process_id is not None:
                kwargs["rank"] = int(process_id)
        if not dist.is_initialized():
            dist.init_process_group(backend=backend, **kwargs)
        _dist_backend = dist.get_backend()
        return _dist_backend


def shutdown_distributed() -> None:
    """Leave the process group `init_distributed` joined (the reference's
    jax.distributed.shutdown); a no-op outside one."""
    global _dist_backend
    import torch.distributed as dist

    with _dist_lock:
        if dist.is_initialized():
            dist.destroy_process_group()
        _dist_backend = None


def process_count() -> int:
    """Ranks of the process group (1 outside one): jax.process_count()."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _collective_device() -> torch.device:
    """Where a collective's tensors must live: the current card for nccl,
    the host for gloo."""
    if _dist_backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over every process of the group (the reference's
    `jax.lax.psum` over the batch axis): an all_reduce of a copy on the
    backend's device, returned on x's device."""
    import torch.distributed as dist

    y = x.detach().to(_collective_device(), copy=True)
    if dist.is_initialized():
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
    return y.to(x.device)


def sharded_chain_step(arrs: list, plans: list, mesh: "Mesh") -> list:
    """One dp-sharded chain step over the fleet: this process's images
    (`arrs` with their `plans`, one chain signature; the same count on
    every process) split over its local `mesh` (`ops/chain.launch_sharded`),
    then every process's outputs gathered in rank order
    (`all_gather`). Returns the whole batch's outputs, each an HWC uint8
    array of the plan's output dims; item r x n + j is process r's item j."""
    import torch.distributed as dist

    from imaginary_tpu_torch.ops import chain as chain_mod

    local = chain_mod.fetch_batch(chain_mod.launch_sharded(arrs, plans, mesh),
                                  arrs, plans)
    world = process_count()
    if world == 1:
        return local
    dev = _collective_device()
    mine = torch.from_numpy(np.stack(local)).to(dev)
    counts = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(world)]
    dist.all_gather(counts, torch.tensor([len(local)], dtype=torch.int64, device=dev))
    if any(int(c.item()) != len(local) for c in counts):
        raise ValueError("sharded_chain_step: every process must bring the same "
                         f"number of images (got {[int(c.item()) for c in counts]})")
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    return [a for p in parts for a in p.cpu().numpy()]


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
             devices=None, local: bool = False) -> Mesh:
    """Build a (batch, spatial) mesh.

    local: the reference's flag for THIS process's devices, the serving
    executor's mesh in a fleet. A torch process addresses only its own
    devices, so both meshes are this process's; the flag is kept so the
    callers read as the reference's (the fleet-wide side is `psum` and
    `sharded_chain_step`).

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
