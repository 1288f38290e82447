"""PyTorch/CUDA port of the gnxraytracer_tpu wavefront path tracer.

Same module layout as the JAX package, so the counterpart of a module is
found by its path.  Tables are NamedTuples of tensors, every constructor and
entry point takes an explicit ``device`` (default ``"cuda"``; nothing falls
back to the CPU by itself), and the brute-force closest-hit cast runs a
hand-written CUDA kernel (``kernels/closest_hit.py``, ``csrc/``).
"""
