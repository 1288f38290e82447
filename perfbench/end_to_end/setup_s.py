"""setup_s: seconds from the start of the process to the start of the
window: CUDA context, kernels built or loaded from the checkout's cache,
scene and BVH built, the cell's shapes warmed up (host clock)."""

UNIT = "s"
SOURCE = "host_clock"


def read(rec):
    return rec["setup_s"]
