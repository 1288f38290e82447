"""Catmull-Rom spline evaluation, integration, sampling and inversion, and
Fourier-series evaluation and sampling, batched over lanes (counterpart of
the JAX package's ops/interpolation.py; pbrt's core/Interpolation.cpp).

They serve the BSSRDF tables (models/bssrdf.py).  Every function is plain
PyTorch on the device of its arguments and differentiable where the JAX
functions are.  The reference's open-ended Newton-bisection solvers become
a fixed count of iterations (_NEWTON_ITERS) with where-masked interval
updates: every lane runs the same steps, and a converged lane stops
changing.
"""

import math

import torch

from ..constants import PI

_NEWTON_ITERS = 16


def _find_interval(nodes, x):
    """Index i of the segment [nodes[i], nodes[i+1]] holding x, clamped to
    the first and last segment."""
    idx = torch.searchsorted(nodes, x, right=True) - 1
    return torch.clamp(idx, 0, nodes.shape[0] - 2)


def catmull_rom_weights(nodes, x):
    """CatmullRomWeights: (offset, w0, w1, w2, w3, ok) for x over the sorted
    nodes (K,).  The weights apply to values[offset + i], i in 0..3, with
    the reference's folding at the ends; ok is False outside
    [nodes[0], nodes[-1]]."""
    k = nodes.shape[0]
    ok = (x >= nodes[0]) & (x <= nodes[-1])
    i = _find_interval(nodes, x)
    x0 = nodes[i]
    x1 = nodes[i + 1]
    t = (x - x0) / torch.where(x1 == x0, 1.0, x1 - x0)
    t2 = t * t
    t3 = t2 * t
    w1 = 2.0 * t3 - 3.0 * t2 + 1.0
    w2 = -2.0 * t3 + 3.0 * t2
    has_prev = i > 0
    has_next = i + 2 < k
    x_prev = nodes[torch.clamp(i - 1, min=0)]
    x_next = nodes[torch.clamp(i + 2, max=k - 1)]
    d0 = t3 - 2.0 * t2 + t
    d1 = t3 - t2
    w0_prev = d0 * (x1 - x0) / torch.where(x1 == x_prev, 1.0, x1 - x_prev)
    w0 = torch.where(has_prev, -w0_prev, 0.0)
    w2 = w2 + torch.where(has_prev, w0_prev, d0)
    w1 = w1 - torch.where(has_prev, 0.0, d0)
    w3_next = d1 * (x1 - x0) / torch.where(x_next == x0, 1.0, x_next - x0)
    w3 = torch.where(has_next, w3_next, 0.0)
    w1 = w1 - torch.where(has_next, w3_next, d1)
    w2 = w2 + torch.where(has_next, 0.0, d1)
    return i - 1, w0, w1, w2, w3, ok


def catmull_rom_eval(nodes, values, x):
    """Catmull-Rom interpolation of values (K,) over nodes (K,) at x; 0
    outside the nodes' range."""
    off, w0, w1, w2, w3, ok = catmull_rom_weights(nodes, x)
    k = nodes.shape[0]

    def val(j):
        return values[torch.clamp(off + j, 0, k - 1)]

    out = w0 * val(0) + w1 * val(1) + w2 * val(2) + w3 * val(3)
    return torch.where(ok, out, 0.0)


def _segment_derivs(nodes, f, i):
    """Endpoint values and finite-difference derivatives of segment i,
    scaled to the segment's width."""
    k = nodes.shape[0]
    x0 = nodes[i]
    x1 = nodes[i + 1]
    f0 = f[i]
    f1 = f[i + 1]
    width = x1 - x0
    prev = torch.clamp(i - 1, min=0)
    nxt = torch.clamp(i + 2, max=k - 1)
    d0 = torch.where(
        i > 0,
        width * (f1 - f[prev]) / torch.where(i > 0, x1 - nodes[prev], 1.0),
        f1 - f0)
    d1 = torch.where(
        i + 2 < k,
        width * (f[nxt] - f0) / torch.where(i + 2 < k, nodes[nxt] - x0, 1.0),
        f1 - f0)
    return x0, x1, f0, f1, d0, d1, width


def integrate_catmull_rom(nodes, values):
    """IntegrateCatmullRom: the spline's integral from nodes[0] to each node.
    Returns (cdf (K,), total)."""
    i = torch.arange(nodes.shape[0] - 1, device=nodes.device)
    _, _, f0, f1, d0, d1, width = _segment_derivs(nodes, values, i)
    seg = ((d0 - d1) * (1.0 / 12.0) + 0.5 * (f0 + f1)) * width
    cdf = torch.cat([torch.zeros(1, dtype=seg.dtype, device=seg.device),
                     torch.cumsum(seg, 0)])
    return cdf, cdf[-1]


def _spline_cdf_horner(t, f0, f1, d0, d1):
    """(Fhat, fhat): a segment's local integral and value at t, in Horner
    form."""
    fhat_int = t * (
        f0 + t * (
            0.5 * d0 + t * (
                (1.0 / 3.0) * (-2.0 * d0 - d1) + f1 - f0
                + t * (0.25 * (d0 + d1) + 0.5 * (f0 - f1)))))
    fhat = f0 + t * (
        d0 + t * (-2.0 * d0 - d1 + 3.0 * (f1 - f0)
                  + t * (d0 + d1 + 2.0 * (f0 - f1))))
    return fhat_int, fhat


def _safe_deriv(x):
    return torch.where(torch.abs(x) < 1e-12,
                       torch.where(x < 0, -1e-12, 1e-12), x)


def _newton_bisect(fn, a, b, t):
    """_NEWTON_ITERS steps of Newton-bisection for fn(t) = (value - target,
    derivative) on [a, b]; returns (a, b, t) after the last step."""
    for _ in range(_NEWTON_ITERS):
        t = torch.where((t > a) & (t < b), t, 0.5 * (a + b))
        val, deriv = fn(t)
        low = val < 0
        a = torch.where(low, t, a)
        b = torch.where(low, b, t)
        t = t - val / _safe_deriv(deriv)
    return a, b, t


def _invert_segment_integral(u, f0, f1, d0, d1):
    """Solve Fhat(t) = u on [0, 1] for a segment; returns (t, fhat(t))."""
    t0 = torch.where(
        f0 != f1,
        (f0 - torch.sqrt(torch.clamp(f0 * f0 + 2.0 * u * (f1 - f0), min=0.0)))
        / torch.where(f0 == f1, 1.0, f0 - f1),
        u / torch.where(f0 == 0, 1.0, f0))

    def fn(t):
        fhat_int, fhat = _spline_cdf_horner(t, f0, f1, d0, d1)
        return fhat_int - u, fhat

    a, b, t = _newton_bisect(fn, torch.zeros_like(u), torch.ones_like(u), t0)
    t = torch.where((t > a) & (t < b), t, 0.5 * (a + b))
    _, fhat = _spline_cdf_horner(t, f0, f1, d0, d1)
    return t, fhat


def sample_catmull_rom(nodes, f, cdf, u):
    """SampleCatmullRom: draw x ~ f through the spline's CDF (from
    integrate_catmull_rom).  Returns (x, f(x), pdf)."""
    total = cdf[-1]
    uu = u * total
    i = torch.clamp(torch.searchsorted(cdf, uu, right=True) - 1, 0,
                    nodes.shape[0] - 2)
    x0, _, f0, f1, d0, d1, width = _segment_derivs(nodes, f, i)
    u_seg = (uu - cdf[i]) / torch.where(width == 0, 1.0, width)
    t, fhat = _invert_segment_integral(u_seg, f0, f1, d0, d1)
    return x0 + width * t, fhat, fhat / total


def sample_catmull_rom_2d(nodes1, nodes2, values, cdf, alpha, u):
    """SampleCatmullRom2D: sample the second axis of a 2D table at the
    parameter alpha on the first.  nodes1 (R,), nodes2 (M,), values and
    cdf (R, M), alpha and u (...,).  Returns (x, f(x), pdf); f and the pdf
    are 0 where alpha is outside the table."""
    r = nodes1.shape[0]
    off, w0, w1, w2, w3, ok = catmull_rom_weights(nodes1, alpha)
    ws = (w0, w1, w2, w3)

    def interp(arr, idx):
        # weighted gather over the 4 rows at column idx
        out = 0.0
        for j, w in enumerate(ws):
            out = out + w * arr[torch.clamp(off + j, 0, r - 1), idx]
        return out

    m = nodes2.shape[0]
    maximum = interp(cdf, m - 1)
    uu = u * maximum

    # the interval of the interpolated cdf (a row a lane): a binary search
    # unrolled over log2(m) steps
    lo = torch.zeros(uu.shape, dtype=torch.long, device=uu.device)
    hi = torch.full_like(lo, m - 1)
    for _ in range(int(math.ceil(math.log2(max(m, 2)))) + 1):
        mid = (lo + hi) // 2
        below = interp(cdf, mid) <= uu
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    idx = torch.clamp(lo, 0, m - 2)

    f0 = interp(values, idx)
    f1 = interp(values, idx + 1)
    x0 = nodes2[idx]
    x1 = nodes2[idx + 1]
    width = x1 - x0
    u_seg = (uu - interp(cdf, idx)) / torch.where(width == 0, 1.0, width)
    prev = torch.clamp(idx - 1, min=0)
    nxt = torch.clamp(idx + 2, max=m - 1)
    fm1 = interp(values, prev)
    fp2 = interp(values, nxt)
    d0 = torch.where(
        idx > 0,
        width * (f1 - fm1) / torch.where(idx > 0, x1 - nodes2[prev], 1.0),
        f1 - f0)
    d1 = torch.where(
        idx + 2 < m,
        width * (fp2 - f0) / torch.where(idx + 2 < m, nodes2[nxt] - x0, 1.0),
        f1 - f0)
    t, fhat = _invert_segment_integral(u_seg, f0, f1, d0, d1)
    x = x0 + width * t
    fval = torch.where(ok, fhat, 0.0)
    pdf = torch.where(ok, fhat / torch.clamp(maximum, min=1e-20), 0.0)
    return torch.where(ok, x, 0.0), fval, pdf


def invert_catmull_rom(nodes, values, u):
    """InvertCatmullRom: the x with spline(x) = u for increasing values,
    clamped to the nodes' ends."""
    below = u <= values[0]
    above = u >= values[-1]
    i = torch.clamp(torch.searchsorted(values, u, right=True) - 1, 0,
                    nodes.shape[0] - 2)
    x0, _, f0, f1, d0, d1, width = _segment_derivs(nodes, values, i)

    def fn(t):
        fhat = f0 + t * (d0 + t * (-2.0 * d0 - d1 + 3.0 * (f1 - f0)
                                   + t * (d0 + d1 + 2.0 * (f0 - f1))))
        deriv = d0 + t * (-4.0 * d0 - 2.0 * d1 + 6.0 * (f1 - f0)
                          + t * (3.0 * d0 + 3.0 * d1 + 6.0 * (f0 - f1)))
        return fhat - u, deriv

    a, b, t = _newton_bisect(fn, torch.zeros_like(u), torch.ones_like(u),
                             torch.full_like(u, 0.5))
    t = torch.where((t > a) & (t < b), t, 0.5 * (a + b))
    x = x0 + width * t
    return torch.where(below, nodes[0], torch.where(above, nodes[-1], x))


# ---------------------------------------------------------------------------
# Fourier series
# ---------------------------------------------------------------------------

def fourier_eval(coeffs, cos_phi):
    """sum_k a_k cos(k phi) by the double-angle recurrence.  coeffs (..., M),
    cos_phi (...,)."""
    m = coeffs.shape[-1]
    value = torch.zeros(torch.broadcast_shapes(coeffs.shape[:-1],
                                               cos_phi.shape),
                        dtype=torch.float32, device=coeffs.device)
    cos_k_minus1 = cos_phi
    cos_k = torch.ones_like(cos_phi)
    for k in range(m):
        value = value + coeffs[..., k] * cos_k
        cos_k_next = 2.0 * cos_phi * cos_k - cos_k_minus1
        cos_k_minus1 = cos_k
        cos_k = cos_k_next
    return value


def sample_fourier(coeffs, u):
    """SampleFourier: draw phi in [0, 2 pi] from the Fourier density
    coeffs (..., M) (a_0 > 0 dominating) by Newton-bisection on its analytic
    CDF.  Returns (phi, density at phi, pdf)."""
    m = coeffs.shape[-1]
    flip = u >= 0.5
    u = torch.where(flip, 1.0 - 2.0 * (u - 0.5), 2.0 * u)

    def cdf_and_pdf(phi):
        # integral of sum a_k cos(k x) over [0, phi]
        total = coeffs[..., 0] * phi
        pdf = torch.broadcast_to(coeffs[..., 0], phi.shape)
        for k in range(1, m):
            total = total + coeffs[..., k] * torch.sin(k * phi) / k
            pdf = pdf + coeffs[..., k] * torch.cos(k * phi)
        return total, pdf

    full, _ = cdf_and_pdf(torch.full_like(u, PI))
    target = u * full

    def fn(t):
        val, deriv = cdf_and_pdf(t)
        return val - target, deriv

    a, b, phi = _newton_bisect(fn, torch.zeros_like(u), torch.full_like(u, PI),
                               u * PI)
    phi = torch.where((phi > a) & (phi < b), phi, 0.5 * (a + b))
    _, pdf_val = cdf_and_pdf(phi)
    pdf = pdf_val / torch.clamp(2.0 * full, min=1e-20)
    phi = torch.where(flip, 2.0 * PI - phi, phi)
    return phi, pdf_val, pdf
