"""unspanned_idle_share.<cell>: percent of the profiled stretch's idle
time, the gaps between two busy intervals of the device, that lies in gaps
starting while no program range is open on the host: idle time that no
phase of the program can be charged with."""

import bisect


def read(name, ctx):
    p = ctx.profile
    if p is None or not p.ranges or len(p.busy) < 2:
        return None
    open_ = []
    for s, e in sorted((ts, ts + d) for _, ts, d in p.ranges):
        if open_ and s <= open_[-1][1]:
            open_[-1][1] = max(open_[-1][1], e)
        else:
            open_.append([s, e])
    starts = [s for s, _ in open_]
    idle = unspanned = 0.0
    for (_, e0), (s1, _) in zip(p.busy, p.busy[1:]):
        k = bisect.bisect_right(starts, e0) - 1
        idle += s1 - e0
        if k < 0 or open_[k][1] <= e0:
            unspanned += s1 - e0
    return 100.0 * unspanned / idle if idle > 0 else None
