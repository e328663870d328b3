"""The port's multi-GPU layer: the device mesh, the process group and the
W-sharded blur."""

from imaginary_tpu_torch.parallel.mesh import (
    Mesh,
    get_mesh,
    healthy_mesh,
    init_distributed,
    mesh_devices,
    pad_batch_for_mesh,
    process_count,
    psum,
    sharded_chain_step,
    shutdown_distributed,
    split_batch,
    split_width,
)

__all__ = ["Mesh", "get_mesh", "healthy_mesh", "init_distributed", "mesh_devices",
           "pad_batch_for_mesh", "process_count", "psum",
           "sharded_chain_step", "shutdown_distributed", "split_batch", "split_width"]
