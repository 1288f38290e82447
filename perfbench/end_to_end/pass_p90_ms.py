"""pass_p90_ms: the 90th percentile (nearest rank) of the wall time of
every pass in the window, each from its first launch to its
synchronize(), the combine of the ranks included (host clock)."""

import math

UNIT = "ms"
SOURCE = "host_clock"


def percentile(values, q):
    """Nearest-rank q-th percentile of all values."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def read(rec):
    return percentile(rec["walls"], 90) * 1e3
