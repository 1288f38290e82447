"""device_idle.train: as device_idle.render, over whole train steps."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_step_s"


def read(tr):
    if tr is None or tr.get("kind") != "train":
        return None
    return 100.0 * (1.0 - tr["work_s"] / tr["units"] / tr["unit_wall_s"])
