"""Frozen copy (see perfbench/reference/__init__.py)."""
