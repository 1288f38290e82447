"""train_step_s: the window's seconds over the whole train steps in it
(host clock; each step ends in synchronize())."""

UNIT = "s"
SOURCE = "host_clock"


def read(rec):
    return rec["window_s"] / len(rec["walls"])
