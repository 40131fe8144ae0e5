"""occ_update_ms.<cell>: mean milliseconds of the occupancy updates of a
traced run's window, each inside the benchmark's own span, synchronized at
both edges."""


def read(name, ctx):
    s = ctx.spans.get("occ_update")
    return 1e3 * sum(s) / len(s) if s else None
