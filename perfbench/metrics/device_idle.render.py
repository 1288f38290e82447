"""device_idle.render: 1 - (the device's work a pass: the union of kernel,
copy and fill intervals in the profiled passes, the collectives' kernels
left out, which spin while they wait for the slowest rank) / (the mean
unprofiled pass wall time of the same run's window), in %.  The profiler
slows the host, so the wall time comes from the window.  On several ranks:
rank 0's."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "render_mpaths_s"


def read(tr):
    if tr is None or tr.get("kind") != "render":
        return None
    work = tr["work_s"] / tr["units"]
    return 100.0 * (1.0 - work / tr["unit_wall_s"])
