"""Device resolution shared by every constructor and entry point."""

import torch


def resolve_device(device="cuda"):
    """Return ``torch.device(device)``; raise when a CUDA device is asked
    for (the default) and none is present.  The CPU is used only when the
    caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (CLI: --cpu) to "
            "run on the CPU")
    return dev
