"""GiB of device memory the allocator held at most during the window
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(ctx):
    if not ctx.window_peak_bytes:
        return None
    return ctx.window_peak_bytes / 2 ** 30
