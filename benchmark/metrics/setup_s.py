"""Seconds from the harness's start to the window's first request: the
server's boot, the inputs, the warm-up (and, on the first run in a
checkout, the kernels' and codecs' build)."""


def read(w):
    return w.setup_s
