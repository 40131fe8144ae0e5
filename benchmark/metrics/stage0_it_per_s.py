"""stage0_it_per_s: steps the window completed (with their occupancy
updates and batch adaptations) over the window's seconds."""


def read(name, ctx):
    return ctx.window["steps"] / ctx.window["seconds"]
