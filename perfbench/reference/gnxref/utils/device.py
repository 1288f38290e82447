"""Device resolution shared by every constructor and entry point."""

import subprocess

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


def describe_device(device):
    """What a measurement ran on: for a CUDA device the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (raises when nvidia-smi does not
    answer), else "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip()
