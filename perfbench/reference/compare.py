"""The comparisons that decide ``correct``.

A render: the film of a pass (the radiance sum of its samples, (H*W, 3))
against the reference's film of the same samples.  ``pixels_off`` is the
share of the film's pixels where a channel differs by more than
ATOL + RTOL * |reference|.  float32 work in another order moves a pixel by
a few 1e-7 of its value; a path that takes another turn (a tie between two
triangles, a Russian-roulette draw on its edge) moves one pixel by much
more, which is why the number is a share and not a largest gap; a pass
computed in a lower precision moves nearly every pixel.

A train step: each step's loss, the norm of each parameter's first
gradient as the update applied it (from the parameters after one step,
(p0 - p1) / lr, on both sides, so that the float32 rounding of the update
is the same in both) and the norm of each parameter's change over the
checked steps, each as the gap between the port's norm and the reference's
over the larger of the reference's norm of that parameter and the median
parameter's; the worst parameter counts.  A parameter whose reference
gradient is under a thousandth of the median parameter's is left out of
the gradient and change gaps (it moves by round-off alone).
"""

import torch

RTOL = 1e-4
ATOL = 1e-6


def pixels_off(film, want, rtol=RTOL, atol=ATOL):
    """Share of pixels of `film` off `want` (both (P, 3))."""
    film = film.detach().to(torch.float64).reshape(-1, 3)
    want = want.detach().to(torch.float64).reshape(-1, 3).to(film.device)
    off = (film - want).abs() > atol + rtol * want.abs()
    off = off.any(dim=-1) | ~torch.isfinite(film).all(dim=-1)
    return float(off.to(torch.float64).mean())


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.detach().to(torch.float64)))
            for k, v in tensors.items()}


def _median(values):
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def norm_gap(got, want):
    """Worst parameter's |norm(got) - norm(want)| over max(norm(want),
    median parameter norm of want); 0 with nothing to compare."""
    if not want:
        return 0.0
    gn, wn = _norms(got), _norms(want)
    med = _median(wn.values())
    return max(abs(gn[k] - wn[k]) / max(wn[k], med, 1e-30) for k in wn)


def train_gaps(losses, params, ref_losses, ref_params, ref_grads, lr):
    """The three numbers of a train cell.  losses / ref_losses: each
    checked step's loss; params / ref_params: the parameters before the
    first checked step and after each; ref_grads: the reference's first
    gradients (they decide which parameters moved)."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(losses, ref_losses))
    gn = _norms(ref_grads)
    med = _median(gn.values())
    moved = [k for k in gn if gn[k] >= 1e-3 * med]
    first = {k: (params[0][k] - params[1][k]) / lr for k in moved}
    ref_first = {k: (ref_params[0][k] - ref_params[1][k]) / lr for k in moved}
    grad_gap = norm_gap(first, ref_first)
    change = {k: params[-1][k] - params[0][k] for k in moved}
    ref_change = {k: ref_params[-1][k] - ref_params[0][k] for k in moved}
    change_gap = norm_gap(change, ref_change)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}
