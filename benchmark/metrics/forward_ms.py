"""forward_ms.<cell>: wall milliseconds a step inside the program's
``forward`` ranges in the profiled stretch (utils/profiling.span, on the
trace's clock)."""


def read(name, ctx):
    p = ctx.profile
    if p is None:
        return None
    sec = p.range_seconds(lambda n: n == "forward")
    return 1e3 * sec / ctx.profiled_steps if sec > 0 else None
