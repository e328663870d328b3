"""Mean ms of the service's `encode` stage over the window's requests."""


def read(w):
    v = w.stage_ms("encode")
    return None if v != v else v
