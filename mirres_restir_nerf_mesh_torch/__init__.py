"""PyTorch + CUDA port of the stage-1 forward frame of mirres_restir_nerf_mesh_tpu.

Module paths mirror the JAX package (``ops/tile_tracer.py`` here is the
counterpart of ``ops/tile_tracer.py`` there).  The ray-tracing kernels are
hand-written CUDA C++ for Hopper under ``csrc/``; each wrapper runs its plain
PyTorch version only for tensors that lie on the CPU.
"""
