"""cast_roofline.render: the least time the scene casts could take over
the device time of the kernels launched inside them, in %.

The spans are the harness's record_function ranges around the port's
ops/trace.scene_intersect and scene_occluded (perfbench/tracing.cast_spans).
The least time is bandwidth alone: per ray 28 B in (o, d, t_max) and 16 B
(closest: t, tri, u, v) or 1 B (any hit) out, plus the scene's triangles
read once (36 B each) a call, at 3.35 TB/s (H100 SXM data sheet).  It does
not depend on the tree or the walk, so whatever a later change puts behind
the casts is held to the same work."""

LAYER = "casts"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "render_mpaths_s"
PEAK_BYTES_S = 3.35e12


def read(tr):
    if tr is None or tr.get("kind") != "render":
        return None
    dev_s = sum(tr["span_device_s"].values())
    nbytes = sum(tr["cast_bytes"].values())
    if dev_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / PEAK_BYTES_S) / dev_s
