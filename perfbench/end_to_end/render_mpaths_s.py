"""render_mpaths_s: every path sample completed in the window (one path is
one (pixel, sample) lane, on every rank) over the window's seconds, in
millions (host clock; the window ends with a pass's synchronize)."""

UNIT = "Mpaths/s"
SOURCE = "host_clock"


def read(rec):
    return rec["paths"] / rec["window_s"] / 1e6
