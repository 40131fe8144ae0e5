"""mfu: the whole step's share of the card's bf16 dense peak
(``peaks.json``): the model FLOPs of the window's steps (the MLP products
and hash-grid interpolations of the rows each step evaluates, three times
the forward where it is differentiated), counted from each step's shapes
before it runs (``counts/flops.py``, ``Driver.work_per_step``; host
integers, no wrapper or sync in the window), over the window's seconds."""


def read(name, ctx):
    flops = ctx.window.get("flops")
    if ctx.peaks is None or not flops:
        return None
    return 100.0 * flops / ctx.window["seconds"] / ctx.peaks["bf16_flops"]
