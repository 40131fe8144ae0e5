"""K4_roofline.<cell>: percent of K4's roofline over the profiled stretch:
the bytes its launches have to move (``counts.flops.k4_bytes``: values and
indices read once, each touched table row written once) over the card's
HBM bandwidth, divided by the device time of the kernels named
``scatter_add*`` (K4, ``csrc/scatter_add.cu``)."""

from benchmark.counts.flops import roofline_share


def read(name, ctx):
    p = ctx.profile
    if p is None or ctx.peaks is None or not ctx.work.k4:
        return None
    sec = p.kernel_seconds(lambda n: "scatter_add" in n)
    if sec <= 0:
        return None
    return roofline_share(ctx.work.k4_bytes, 0.0, sec, ctx.peaks["hbm_bytes_per_s"],
                          ctx.peaks["bf16_flops"])
