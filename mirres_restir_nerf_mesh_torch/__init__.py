"""PyTorch + CUDA port of mirres_restir_nerf_mesh_tpu: the stage-1 forward
frame and the stage-1 train step.

Module paths mirror the JAX package (``ops/tile_tracer.py`` here is the
counterpart of ``ops/tile_tracer.py`` there).  The ray-tracing kernels and
the hash-grid backward's scatter-add are hand-written CUDA C++ for Hopper
under ``csrc/``; each wrapper runs its plain PyTorch version only for
tensors that lie on the CPU.
"""
