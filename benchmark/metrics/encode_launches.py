"""encode_launches.<cell>: launches of the one-corner hash-grid encode
kernel (K5, ``csrc/hashgrid_encode.cu``) a step: the program's
``launches.hashgrid_encode`` over its ``steps.stage0``, read from the
counter registry (``mirres_restir_nerf_mesh_torch.utils.profiling.counters()``)
of the run's process, which counts from its start.  One a step and one an
occupancy update (every 16 steps) read 17/16.  None where the program has
no such counter."""


def read(name, ctx):
    try:
        from mirres_restir_nerf_mesh_torch.utils.profiling import counters
    except ImportError:             # a program without the registry
        return None
    c = counters()
    steps, n = c.get("steps.stage0", 0), c.get("launches.hashgrid_encode")
    return n / steps if steps and n is not None else None
