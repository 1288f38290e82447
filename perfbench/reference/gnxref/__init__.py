"""Frozen copy of the port's plain PyTorch paths (see perfbench/reference/__init__.py)."""
