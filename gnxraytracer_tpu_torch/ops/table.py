"""Per-lane gathers of small parameter tables, with a hand-written backward.

``gather_rows(table, idx)`` is ``table[idx.long()]``.  Where the gather
will be differentiated on the card (grad mode on, a float32 table that
requires grad, on a CUDA device) and the table has at most
``table_grad.MAX_ROWS`` rows, it is one autograd node whose backward is the
kernel of csrc/table_grad.cu: the same sums as PyTorch's index-put
backward, bit for bit, without its one thread a row walking a million
lanes.  A larger table keeps PyTorch's backward.  Everything else (a
render, an int table, a CPU tensor) is the plain gather.

Counters (utils/stats.py, nothing without a recording): ``table_grad.kernel``
counts backward calls that returned from the kernel's wrapper (whose own
``launch_count`` counts the launches), ``table_grad.library`` gathers
left to PyTorch's backward because their table has more than MAX_ROWS rows.
"""

import torch
from torch.autograd.function import once_differentiable

from ..kernels import table_grad as tg
from ..utils import stats


class _GatherRows(torch.autograd.Function):
    """table[idx] (idx int64), whose backward sums the output's gradient
    into the table's rows through table_grad."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.table_shape = table.shape
        ctx.save_for_backward(idx)
        return table[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        g = grad.reshape(flat.shape[0], -1).contiguous()
        out = tg.table_grad(flat, g, ctx.table_shape[0])
        stats.count("table_grad.kernel", 1)
        return out.reshape(ctx.table_shape), None


def _on_card(table):
    return table.is_cuda


def gather_rows(table, idx):
    """table[idx.long()]: the rows of `table` at each lane's index."""
    idx = idx.long()
    if not (torch.is_grad_enabled() and table.requires_grad
            and table.dtype == torch.float32 and _on_card(table)):
        return table[idx]
    if table.shape[0] > tg.MAX_ROWS:
        stats.count("table_grad.library", 1)
        return table[idx]
    return _GatherRows.apply(table, idx)
