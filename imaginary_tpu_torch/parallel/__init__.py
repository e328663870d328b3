"""The port's multi-GPU layer: the device mesh and the W-sharded blur."""

from imaginary_tpu_torch.parallel.mesh import (
    Mesh,
    get_mesh,
    healthy_mesh,
    mesh_devices,
    pad_batch_for_mesh,
    split_batch,
    split_width,
)

__all__ = ["Mesh", "get_mesh", "healthy_mesh", "mesh_devices",
           "pad_batch_for_mesh", "split_batch", "split_width"]
