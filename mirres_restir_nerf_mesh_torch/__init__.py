"""PyTorch + CUDA port of mirres_restir_nerf_mesh_tpu: stage 0 (the
radiance-field train step, occupancy grid, eval render and mesh export),
stage 1 (the forward frame with ReSTIR DI and the denoisers, the train
step, the textured-mesh export), and the harness around them: the Trainer
(``train/trainer.py``), the command line (``python3 -m
mirres_restir_nerf_mesh_torch.main``), ``albedo_eval``, checkpoints,
metrics and image I/O.

Module paths mirror the JAX package (``ops/tile_tracer.py`` here is the
counterpart of ``ops/tile_tracer.py`` there).  The ray-tracing kernels and
the hash-grid backward's scatter-add are hand-written CUDA C++ for Hopper
under ``csrc/``; each wrapper runs its plain PyTorch version only for
tensors that lie on the CPU.  Entry points run on the card unless given
``device="cpu"``.
"""
