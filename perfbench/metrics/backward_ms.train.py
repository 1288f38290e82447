"""backward_ms.train: the train step's own stats["backward_ms"] (CUDA
events around autograd's backward()), a mean over the window's steps."""

LAYER = "train step"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_step_s"


def read(tr):
    if tr is None or not tr.get("backward_ms"):
        return None
    b = tr["backward_ms"]
    return sum(b) / len(b)
