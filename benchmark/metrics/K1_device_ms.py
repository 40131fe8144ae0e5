"""K1_device_ms.<cell>: device milliseconds a step of the kernels named
``tile_trace*`` (K1, ``csrc/tile_trace.cu``) in the profiled stretch."""


def read(name, ctx):
    p = ctx.profile
    if p is None:
        return None
    sec = p.kernel_seconds(lambda n: "tile_trace" in n)
    return 1e3 * sec / ctx.profiled_steps if sec > 0 else None
