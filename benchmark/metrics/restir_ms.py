"""restir_ms.<cell>: wall milliseconds a frame inside the program's
``restir_*`` ranges (render/stage1.py) in the profiled stretch."""


def read(name, ctx):
    p = ctx.profile
    if p is None:
        return None
    sec = p.range_seconds(lambda n: n.startswith("restir_"))
    return 1e3 * sec / ctx.profiled_steps if sec > 0 else None
