"""imaginary-tpu ported to PyTorch and CUDA for an NVIDIA H100.

A second package beside `imaginary_tpu` (the JAX reference, which it never
imports): the same HTTP contract, served by the reference's aiohttp
application (`web/`), and the same planner, with the device work in
hand-written CUDA C++ kernels for Hopper (`kernels/`), micro-batched by
the executor (`engine/`). It serves /, /form, /health, /metrics, /info,
/resize, /fit, /enlarge, /extract, /crop, /smartcrop, /thumbnail, /zoom,
/rotate, /autorotate, /flip, /flop, /convert, /blur, /watermark and
/pipeline on JPEG, PNG, WEBP, GIF and TIFF; see ROADMAP.md for what is
still to port.
"""

Version = "0.1.0"
