"""``torch.cuda.max_memory_allocated()`` over the window, after the peak
was reset at its start."""


def read(r):
    return r["window_peak_bytes"] / 2**30
