"""graphed_steps.<cell>: the share of stage-0 steps whose compute ran as
CUDA-graph replays (``train/stage0_graph.py``): the program's
``graph.stage0_step`` over its ``steps.stage0``, in %, read from the
counter registry (``mirres_restir_nerf_mesh_torch.utils.profiling.counters()``)
of the run's process, which counts from its start.  None where the program
has no such counter."""


def read(name, ctx):
    try:
        from mirres_restir_nerf_mesh_torch.utils.profiling import counters
    except ImportError:             # a program without the registry
        return None
    c = counters()
    steps, n = c.get("steps.stage0", 0), c.get("graph.stage0_step")
    return 100.0 * n / steps if steps and n is not None else None
