"""combine_wait_ms.render: host clock on rank 0 around
parallel/multihost.combine_partials (its all_reduce_sum), from after the
rank's own pass has finished to the synchronize() after it, a mean over the
window's passes: the wait for the slowest rank plus the collective."""

LAYER = "process group"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "render_mpaths_s"


def read(tr):
    if tr is None or not tr.get("combine_wait_s"):
        return None
    w = tr["combine_wait_s"]
    return 1e3 * sum(w) / len(w)
