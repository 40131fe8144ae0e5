"""host_syncs.<cell>: device-to-host synchronizations a step: the sum of
the program's ``sync.*`` counters over its ``steps.stage0`` (a stage-1
cell: ``steps.stage1``), read from the counter registry
(``mirres_restir_nerf_mesh_torch.utils.profiling.counters()``) of the
run's process, which counts from its start."""


def read(name, ctx):
    try:
        from mirres_restir_nerf_mesh_torch.utils.profiling import counters
    except ImportError:             # a program without the registry
        return None
    c = counters()
    steps = c.get("steps.stage1" if ctx.traffic.get("kind") == "stage1_train" else "steps.stage0",
                  0)
    return sum(v for k, v in c.items() if k.startswith("sync.")) / steps if steps else None
