"""A frozen copy of the port's plain PyTorch code: the modules that a
stage-0 and a stage-1 training step run, as they stood when the benchmark
was defined, with three changes that make it the benchmark's reference:

- ``ops/scatter.py``: the hash-grid backward is ``index_add_`` alone (the
  plain version of kernel K4); no kernel is built or loaded.
- ``ops/tracer.py``: the ray tracer replays the hits and occlusions that
  the program's tracer returned for the same step, and checks a sample of
  them drawn from the seed against a brute-force test of every triangle
  (``benchmark/reference/brute.py``); the cluster and tile tracers (K1-K3)
  are not copied.
- ``precision.py``: the control's switch, which rounds the MLPs' inputs
  and weights through float8 (e4m3) before each product.

The copy imports nothing outside itself but torch and numpy.  It follows
the program: a later change to the program is held to what this copy
computes.
"""
