"""The benchmark of the PyTorch and CUDA port (``mirres_restir_nerf_mesh_torch``).

One run: ``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository root.  See ``benchmark/README.md``.
"""
