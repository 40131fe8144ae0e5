"""stage1_train_Mrays_per_s: bench.py's nominal rays of a stage-1 frame
(``counts.flops.nominal_rays``) times the steps the window completed, over
the window's seconds, in millions."""


def read(name, ctx):
    rays = ctx.work_per_step.get("nominal_rays")
    if not rays:
        return None
    return rays * ctx.window["steps"] / ctx.window["seconds"] / 1e6
