"""The backward of a per-lane gather of a small float table: the wrapper of
csrc/table_grad.cu and the plain PyTorch version beside it.

``table_grad(idx, g, rows)`` is ``zeros(rows, C).index_put_((idx,), g,
accumulate=True)``, bit for bit as PyTorch's CUDA index-put backward sums
it (see the note in the .cu file for the order and what bounds it).  On a
CUDA tensor it groups the lanes by row (``partition``: a stable sort, as
PyTorch's own backward makes) and launches the kernel, which adds each
row's lanes in PyTorch's order; on a CPU tensor it runs
``table_grad_reference``, which is also what the kernel is held against on
the card.  It replaces no TPU kernel: ops/table.py routes the train step's
gathers of parameter tables through it.
"""

import ctypes

import torch

from . import build

# rows of the tables the kernel is held against PyTorch on (the train
# step's material, light and medium tables); a larger table, such as an
# environment image or a texture atlas, keeps PyTorch's backward
# (ops/table.py)
MAX_ROWS = 1024

# launches of the kernel since the last reset
launch_count = 0


def reset_launch_count():
    global launch_count
    launch_count = 0


def table_grad_reference(idx, g, rows):
    """Plain PyTorch version: (rows, C) float32, zeros with g's rows added
    at idx.  Any device."""
    out = torch.zeros((rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_put_((idx.long(),), g, accumulate=True)


def partition(idx, g, rows):
    """The lanes grouped by table row, in lane order within each row:
    (sorted (C, N) float32, the gradient's columns in that order; keys (N,)
    int32, each lane's row in that order, ascending).  For C >= 2 a lane
    whose gradient row is all +-0 takes the key `rows`, past the last row:
    the chain starts at +0 and never becomes -0 under round-to-nearest, so
    adding +-0 changes nothing (NaN and Inf are not zero and stay).  For
    C == 1 every lane stays, since the stride-1 order depends on each
    element's position in its row.  Any device."""
    key = torch.remainder(idx, rows).to(torch.int32)
    if g.shape[1] > 1:
        key = key.masked_fill((g == 0).all(dim=1), rows)
    key, order = torch.sort(key, stable=True)
    return torch.index_select(g.t(), 1, order), key


_fn = None


def _kernel_fn():
    """ctypes handle of the kernel's entry point."""
    global _fn
    if _fn is None:
        fn = build.load("table_grad").gnx_table_grad_chain
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, ctypes.c_longlong, i, i, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def table_grad(idx, g, rows):
    """Sum the rows of g into a (rows, C) table at idx.

    idx: (N,) int32 or int64, in [-rows, rows) (negative wraps, as in
    indexing); g: (N, C) float32; both contiguous and on one device; 1 <=
    rows <= MAX_ROWS.  Returns (rows, C) float32."""
    if not (torch.is_tensor(idx) and torch.is_tensor(g)):
        raise TypeError("idx and g must be tensors")
    if idx.dtype not in (torch.int32, torch.int64) or idx.ndim != 1:
        raise TypeError(f"idx must be (N,) int32 or int64, not {idx.dtype} "
                        f"{tuple(idx.shape)}")
    n = idx.shape[0]
    if g.dtype != torch.float32 or g.ndim != 2 or g.shape[0] != n:
        raise ValueError(f"g must be ({n}, C) float32, not {g.dtype} "
                         f"{tuple(g.shape)}")
    if g.device != idx.device:
        raise ValueError(f"g is on {g.device}, idx on {idx.device}")
    if not (idx.is_contiguous() and g.is_contiguous()):
        raise ValueError("idx and g must be contiguous")
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"rows must be in [1, {MAX_ROWS}], not {rows}")
    dev = g.device
    if dev.type == "cpu":
        return table_grad_reference(idx, g, rows)
    if dev.type != "cuda":
        raise ValueError(f"table_grad runs on cuda or cpu tensors, not {dev}")
    cols = g.shape[1]
    if n == 0 or cols == 0:
        return torch.zeros((rows, cols), dtype=torch.float32, device=dev)
    if n >= 2 ** 31:
        raise ValueError(f"table_grad takes fewer than 2**31 lanes, not {n}")
    fn = _kernel_fn()
    ordered, keys = partition(idx, g, rows)
    out = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ordered.data_ptr(), keys.data_ptr(), n, rows, cols,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"table_grad kernel launch failed: cudaError {err}")
    global launch_count
    launch_count += 1
    return out
