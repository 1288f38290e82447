"""The plain reference the benchmark judges the port against.

``gnxref/`` is a frozen copy of the port's plain-PyTorch code paths
(``gnxraytracer_tpu_torch`` at commit e40fb70: the scene tables, camera,
samplers, the watertight brute-force casts, the numpy SAH build and the
per-lane threaded walk, the texture, light, material and BSDF modules and
the path integrator), with every hand-written kernel, the native library
and the packed BVH tables cut out, so it imports nothing of the port.  A
later change to the port does not move it.  It works out again whatever
the port derives from the benchmark's inputs: the Sobol' matrices and
Halton permutations, the BVH, the environment light's distribution, the
texture pyramid and each compaction's keep probability.

``render.py`` and ``train.py`` drive it; ``compare.py`` holds the
comparisons that decide ``correct``.
"""
