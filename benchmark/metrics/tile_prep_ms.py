"""tile_prep_ms.<cell>: wall milliseconds a step inside the program's
``tile_prep`` ranges (ops/tile_tracer.py) in the profiled stretch."""


def read(name, ctx):
    p = ctx.profile
    if p is None:
        return None
    sec = p.range_seconds(lambda n: n == "tile_prep")
    return 1e3 * sec / ctx.profiled_steps if sec > 0 else None
