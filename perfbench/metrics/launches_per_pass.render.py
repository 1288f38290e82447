"""launches_per_pass.render: device kernels the profiler saw in the
profiled passes, over those passes (rank 0's on several ranks)."""

LAYER = "loops"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "render_mpaths_s"


def read(tr):
    if tr is None or tr.get("kind") != "render":
        return None
    return tr["kernels"] / tr["units"]
