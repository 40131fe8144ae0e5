"""peak_mem_GB: torch.cuda.max_memory_allocated() over the window, in GB
(1e9 bytes)."""


def read(name, ctx):
    return ctx.peak_window_bytes / 1e9 if ctx.peak_window_bytes else None
