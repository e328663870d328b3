"""Images answered (200, an image) inside the window over its seconds, in
a closed loop (the end-to-end `images_per_s`, kept per layer in a cell
where its spread from run to run is too wide for a bound)."""


def read(w):
    if w.loop != "closed":
        return None
    end = w.t0 + w.seconds
    return sum(1 for r in w.ok() if r.done <= end) / w.seconds
