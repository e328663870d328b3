"""Mean ms of the service's `decode` stage over the window's requests."""


def read(w):
    v = w.stage_ms("decode")
    return None if v != v else v
