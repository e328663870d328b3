"""Images per launched batch over the window: the executor's items over
its batches."""


def read(w):
    batches = w.delta("imaginary_tpu_executor_batches")
    return w.delta("imaginary_tpu_executor_items") / batches if batches > 0 else None
