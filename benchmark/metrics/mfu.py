"""mfu.<cell>: model FLOPs a step (the MLP products and hash-grid
interpolations of the rows the step evaluates, three times the forward
where it is differentiated; ``counts/flops.py``, counted over the
profiled stretch) over the untraced window's seconds a step, as a percent
of the card's bf16 dense peak (``peaks.json``)."""


def read(name, ctx):
    if ctx.peaks is None or ctx.work.flops <= 0 or not ctx.window["steps"]:
        return None
    flops_per_step = ctx.work.flops / ctx.profiled_steps
    step_s = ctx.window["seconds"] / ctx.window["steps"]
    return 100.0 * flops_per_step / step_s / ctx.peaks["bf16_flops"]
