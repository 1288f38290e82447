"""launches_per_step.train: device kernels the profiler saw in the profiled
train steps, over those steps.  Host-side launch cuts show here where the
device paces the step and train_step_s barely moves."""

LAYER = "loops"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "train_step_s"


def read(tr):
    if tr is None or tr.get("kind") != "train" or not tr["kernels"]:
        return None
    return tr["kernels"] / tr["units"]
