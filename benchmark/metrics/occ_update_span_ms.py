"""occ_update_span_ms.<cell>: mean wall milliseconds of one of the
program's ``occ_update`` ranges (train/stage0.py) in the profiled stretch:
not synchronized, on the trace's clock."""


def read(name, ctx):
    p = ctx.profile
    if p is None:
        return None
    durs = [d for n, _, d in p.ranges if n == "occ_update"]
    return 1e-3 * sum(durs) / len(durs) if durs else None
