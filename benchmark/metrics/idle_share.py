"""idle_share.<cell>: percent of the profiled stretch in which no kernel,
copy or set ran on the device (1 - busy_s / window_s)."""


def read(name, ctx):
    p = ctx.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
