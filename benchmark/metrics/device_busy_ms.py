"""device_busy_ms.<cell>: milliseconds a step in which some kernel, copy or
set ran on the device, over a traced run's profiled stretch (busy_s over
its steps).  A steadier reading than the window's rate where the host
paces the steps."""


def read(name, ctx):
    p = ctx.profile
    if p is None or p.busy_s <= 0 or not ctx.profiled_steps:
        return None
    return 1e3 * p.busy_s / ctx.profiled_steps
