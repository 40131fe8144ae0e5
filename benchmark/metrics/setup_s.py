"""setup_s: seconds from the start of the process to the start of the
window (kernel build or load, the scene, the Trainer, its first steps)."""


def read(name, ctx):
    return ctx.setup_s
