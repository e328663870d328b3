"""The server's CPU time (user and system, its descendants included, the
harness's own left out) over the window's requests, per image answered."""


def read(w):
    n = len(w.ok())
    return w.cpu_s / n * 1e3 if n else None
