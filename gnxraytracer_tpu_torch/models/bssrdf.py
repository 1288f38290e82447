"""Subsurface scattering: separable BSSRDFs, the tabulated beam-diffusion
profile and the Disney/Burley two-exponential profile (counterpart of the
JAX package's models/bssrdf.py; pbrt's core/SubReflection.cpp and the
DisneyBSSRDF).

A library with no integrator wiring, as in the JAX package: the reference
renderer's only consumer of it is compiled out.  The pieces are pure batched
functions over (N,) lanes: the directional term `sw`, the radial profiles
(`disney_*`, `tabulated_*`), the axis and channel machinery of Sample_Sp /
Pdf_Sp, and the probe-ray chain of Sample_Sp (`sample_sp_probe`), which casts
through ops/trace and so takes whichever casts the configuration names,
the hand-written kernels included.  The beam-diffusion table is computed on
the host in numpy once per medium.  Gradients flow through the profile
parameters (R, d, sigma_a, sigma_s) by plain autograd.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..constants import PI
from ..ops.interpolation import (
    catmull_rom_weights, integrate_catmull_rom, invert_catmull_rom,
    sample_catmull_rom_2d,
)
from ..utils.device import resolve_device
from ..utils.math import cos_theta, normalize
from . import bxdf


# ---------------------------------------------------------------------------
# Fresnel moments, branchless over eta < 1 and eta > 1
# ---------------------------------------------------------------------------

def fresnel_moment1(eta):
    eta = torch.as_tensor(eta, dtype=torch.float32)
    e2 = eta * eta
    e3 = e2 * eta
    e4 = e3 * eta
    e5 = e4 * eta
    lo = (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return torch.where(eta < 1.0, lo, hi)


def fresnel_moment2(eta):
    eta = torch.as_tensor(eta, dtype=torch.float32)
    e2 = eta * eta
    e3 = e2 * eta
    e4 = e3 * eta
    e5 = e4 * eta
    lo = (0.27614 - 0.87350 * eta + 1.12077 * e2 - 0.65095 * e3
          + 0.07883 * e4 + 0.04860 * e5)
    r = 1.0 / torch.clamp(eta, min=1e-6)
    r2 = r * r
    r3 = r2 * r
    hi = (-547.033 + 45.3087 * r3 - 218.725 * r2 + 458.843 * r
          + 404.557 * eta - 189.519 * e2 + 54.9327 * e3 - 9.00603 * e4
          + 0.63942 * e5)
    return torch.where(eta < 1.0, lo, hi)


# ---------------------------------------------------------------------------
# Separable directional term
# ---------------------------------------------------------------------------

def sw(w, eta):
    """Sw(w) = (1 - Fr(cos w)) / (c pi), c = 1 - 2 FresnelMoment1(1/eta)."""
    c = 1.0 - 2.0 * fresnel_moment1(1.0 / eta)
    return (1.0 - bxdf.fr_dielectric(cos_theta(w), 1.0, eta)) / (c * PI)


def adapter_f(wo, wi, eta):
    """SeparableBSSRDFAdapter::f: Sw(wi) with the radiance-mode eta^2
    factor, as an (..., 1) spectrum; sampled like any diffuse lobe."""
    del wo
    return (sw(wi, eta) * eta * eta)[..., None]


# ---------------------------------------------------------------------------
# Disney/Burley two-exponential profile
# ---------------------------------------------------------------------------

def disney_sr(r, big_r, d):
    """Sr(r) = R (e^{-r/d} + e^{-r/3d}) / (8 pi d r), d already scaled by
    the caller's 0.2 Burley factor.  r (...,); big_r, d (..., 3)."""
    r = torch.clamp(r, min=1e-6)[..., None]
    return big_r * (torch.exp(-r / d) + torch.exp(-r / (3.0 * d))) / (
        8.0 * PI * d * r)


def disney_sample_sr(u, d_ch):
    """Sample_Sr: a 1:3 mix of the two exponentials, each inverted in
    closed form."""
    first = u < 0.25
    u1 = torch.clamp(u * 4.0, max=1.0 - 1e-7)
    u2 = torch.clamp((u - 0.25) / 0.75, max=1.0 - 1e-7)
    r1 = d_ch * torch.log(1.0 / (1.0 - u1))
    r2 = 3.0 * d_ch * torch.log(1.0 / (1.0 - u2))
    return torch.where(first, r1, r2)


def disney_pdf_sr(r, d_ch):
    """Pdf_Sr of the mix."""
    r = torch.clamp(r, min=1e-6)
    return (0.25 * torch.exp(-r / d_ch) / (2.0 * PI * d_ch * r)
            + 0.75 * torch.exp(-r / (3.0 * d_ch)) / (6.0 * PI * d_ch * r))


def disney_s(po_p, po_ns, po_wo_local_z, pi_p, pi_ns, wi_local_z, r_prof, sp):
    """DisneyBSSRDF::S: the cavity fade times Schlick's retro-weights times
    Sp / pi, from the |cos| terms in local frames and the profile value sp."""
    del r_prof
    a = normalize(pi_p - po_p, eps=1e-20)
    ct = torch.sum(a * po_ns, -1)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    a2 = po_ns * st[..., None] - (a - po_ns * ct[..., None]) * (
        ct / torch.clamp(st, min=1e-6))[..., None]
    fade = torch.where(ct > 0,
                       torch.clamp(torch.sum(pi_ns * a2, -1), min=0.0), 1.0)

    def schlick_weight(c):
        m = torch.clamp(1.0 - c, 0.0, 1.0)
        return (m * m) * (m * m) * m

    fo = schlick_weight(torch.abs(po_wo_local_z))
    fi = schlick_weight(torch.abs(wi_local_z))
    return (fade * (1.0 - 0.5 * fo) * (1.0 - 0.5 * fi))[..., None] * sp / PI


# ---------------------------------------------------------------------------
# Beam-diffusion table (ComputeBeamDiffusionBSSRDF)
# ---------------------------------------------------------------------------

class BSSRDFTable(NamedTuple):
    rho_samples: torch.Tensor     # (R,)
    radius_samples: torch.Tensor  # (M,)
    profile: torch.Tensor         # (R, M)
    rho_eff: torch.Tensor         # (R,)
    profile_cdf: torch.Tensor     # (R, M)


def _beam_diffusion_ms(sigma_s, sigma_a, g, eta, r, n=100):
    """BeamDiffusionMS, numpy over the depth quadrature and broadcast over
    the (sigma, r) grids."""
    sigma_s, sigma_a, r = np.broadcast_arrays(
        np.asarray(sigma_s, np.float64), np.asarray(sigma_a, np.float64),
        np.asarray(r, np.float64))
    sigmap_s = sigma_s * (1.0 - g)
    sigmap_t = sigma_a + sigmap_s
    rhop = sigmap_s / np.maximum(sigmap_t, 1e-12)
    d_g = (2.0 * sigma_a + sigmap_s) / (3.0 * sigmap_t * sigmap_t)
    sigma_tr = np.sqrt(sigma_a / np.maximum(d_g, 1e-12))
    fm1 = float(fresnel_moment1(eta))
    fm2 = float(fresnel_moment2(eta))
    ze = -2.0 * d_g * (1.0 + 3.0 * fm2) / (1.0 - 2.0 * fm1)
    c_phi = 0.25 * (1.0 - 2.0 * fm1)
    c_e = 0.5 * (1.0 - 3.0 * fm2)
    i = (np.arange(n) + 0.5) / n
    i_col = np.log(1.0 - i).reshape((n,) + (1,) * sigmap_t.ndim)
    zr = -i_col / sigmap_t[None]
    zv = -zr + 2.0 * ze[None]
    rr = r[None]
    dr = np.sqrt(rr * rr + zr * zr)
    dv = np.sqrt(rr * rr + zv * zv)
    inv4pi = 1.0 / (4.0 * np.pi)
    phi_d = inv4pi / d_g[None] * (
        np.exp(-sigma_tr[None] * dr) / dr - np.exp(-sigma_tr[None] * dv) / dv)
    edn = inv4pi * (
        zr * (1.0 + sigma_tr[None] * dr) * np.exp(-sigma_tr[None] * dr) / dr ** 3
        - zv * (1.0 + sigma_tr[None] * dv) * np.exp(-sigma_tr[None] * dv) / dv ** 3)
    e = phi_d * c_phi + edn * c_e
    kappa = 1.0 - np.exp(-2.0 * sigmap_t[None] * (dr + zr))
    return (kappa * (rhop * rhop)[None] * e).mean(0)


def _fr_dielectric_np(ci, eta_i, eta_t):
    """FrDielectric on the host, float64."""
    ci = np.clip(ci, -1.0, 1.0)
    entering = ci > 0
    ei = np.where(entering, eta_i, eta_t)
    et = np.where(entering, eta_t, eta_i)
    ci = np.abs(ci)
    si = np.sqrt(np.maximum(0.0, 1.0 - ci * ci))
    st = ei / et * si
    ct = np.sqrt(np.maximum(0.0, 1.0 - st * st))
    rp = (et * ci - ei * ct) / np.maximum(et * ci + ei * ct, 1e-12)
    rs = (ei * ci - et * ct) / np.maximum(ei * ci + et * ct, 1e-12)
    return np.where(st >= 1.0, 1.0, 0.5 * (rp * rp + rs * rs))


def _beam_diffusion_ss(sigma_s, sigma_a, g, eta, r, n=100):
    """BeamDiffusionSS, numpy."""
    sigma_s, sigma_a, r = np.broadcast_arrays(
        np.asarray(sigma_s, np.float64), np.asarray(sigma_a, np.float64),
        np.asarray(r, np.float64))
    sigma_t = sigma_a + sigma_s
    rho = sigma_s / np.maximum(sigma_t, 1e-12)
    t_crit = r * np.sqrt(max(eta * eta - 1.0, 0.0))
    i = (np.arange(n) + 0.5) / n
    i_col = np.log(1.0 - i).reshape((n,) + (1,) * sigma_t.ndim)
    ti = t_crit[None] - i_col / sigma_t[None]
    d = np.sqrt(r[None] ** 2 + ti * ti)
    cos_o = ti / d
    denom = 1.0 + g * g + 2.0 * g * cos_o
    phase = (1.0 / (4.0 * np.pi)) * (1.0 - g * g) / (
        denom * np.sqrt(np.maximum(denom, 1e-12)))
    ess = (rho[None] * np.exp(-sigma_t[None] * (d + t_crit[None])) / (d * d)
           * phase * (1.0 - _fr_dielectric_np(-cos_o, 1.0, eta))
           * np.abs(cos_o))
    return ess.mean(0)


def compute_beam_diffusion_table(g, eta, n_rho=100, n_radius=64,
                                 device="cuda"):
    """ComputeBeamDiffusionBSSRDF: the profile over (rho, optical radius)
    with each row's rho_eff and CDF (the spline integral of
    integrate_catmull_rom), computed on the host and put on `device`."""
    dev = resolve_device(device)
    radius = np.zeros(n_radius)
    radius[1] = 2.5e-3
    for i in range(2, n_radius):
        radius[i] = radius[i - 1] * 1.2
    rho = (1.0 - np.exp(-8.0 * np.arange(n_rho) / (n_rho - 1))) / (
        1.0 - np.exp(-8.0))
    rho_g, r_g = np.meshgrid(rho, radius, indexing="ij")  # (R, M)
    profile = 2.0 * np.pi * r_g * (
        _beam_diffusion_ss(rho_g, 1.0 - rho_g, g, eta, r_g)
        + _beam_diffusion_ms(rho_g, 1.0 - rho_g, g, eta, r_g))
    radius_t = torch.as_tensor(radius, dtype=torch.float32)
    profile_t = torch.as_tensor(profile, dtype=torch.float32)
    cdfs, effs = [], []
    for i in range(n_rho):
        cdf, total = integrate_catmull_rom(radius_t, profile_t[i])
        cdfs.append(cdf)
        effs.append(total)
    return BSSRDFTable(
        rho_samples=torch.as_tensor(rho, dtype=torch.float32).to(dev),
        radius_samples=radius_t.to(dev),
        profile=profile_t.to(dev),
        rho_eff=torch.stack(effs).to(dev),
        profile_cdf=torch.stack(cdfs).to(dev))


def subsurface_from_diffuse(table: BSSRDFTable, rho_eff, mfp):
    """SubsurfaceFromDiffuse: invert rho_eff to the single-scattering albedo
    and turn the mean free path into (sigma_a, sigma_s)."""
    rho = invert_catmull_rom(table.rho_samples, table.rho_eff, rho_eff)
    sigma_s = rho / mfp
    sigma_a = (1.0 - rho) / mfp
    return sigma_a, sigma_s


# ---------------------------------------------------------------------------
# TabulatedBSSRDF
# ---------------------------------------------------------------------------

def _tensor_spline(table: BSSRDFTable, rho, r_optical):
    """4x4 tensor Catmull-Rom interpolation of the profile and the
    interpolated rho_eff: (sr, rho_eff, ok)."""
    r_rows = table.rho_samples.shape[0]
    m_cols = table.radius_samples.shape[0]
    ro_off, *ro_w, ro_ok = catmull_rom_weights(table.rho_samples, rho)
    ra_off, *ra_w, ra_ok = catmull_rom_weights(table.radius_samples, r_optical)
    sr = 0.0
    rho_eff = 0.0
    for i in range(4):
        row = torch.clamp(ro_off + i, 0, r_rows - 1)
        rho_eff = rho_eff + ro_w[i] * table.rho_eff[row]
        for j in range(4):
            col = torch.clamp(ra_off + j, 0, m_cols - 1)
            sr = sr + ro_w[i] * ra_w[j] * table.profile[row, col]
    ok = ro_ok & ra_ok
    return torch.where(ok, sr, 0.0), torch.where(ok, rho_eff, 1.0), ok


def tabulated_sr(table: BSSRDFTable, sigma_t, rho, r):
    """TabulatedBSSRDF::Sr.  sigma_t, rho (..., C) a channel; r (...,).
    Returns (..., C)."""
    r_optical = r[..., None] * sigma_t
    sr, _, _ = _tensor_spline(table, rho, r_optical)
    sr = torch.where(r_optical != 0,
                     sr / (2.0 * PI * torch.clamp(r_optical, min=1e-20)), sr)
    return torch.clamp(sr * sigma_t * sigma_t, min=0.0)


def tabulated_sample_sr(table: BSSRDFTable, sigma_t_ch, rho_ch, u):
    """TabulatedBSSRDF::Sample_Sr: (r, valid) in place of the reference's
    r < 0 convention."""
    r_opt, _, _ = sample_catmull_rom_2d(
        table.rho_samples, table.radius_samples, table.profile,
        table.profile_cdf, rho_ch, u)
    valid = sigma_t_ch > 0
    return (torch.where(valid, r_opt / torch.clamp(sigma_t_ch, min=1e-20),
                        0.0), valid)


def tabulated_pdf_sr(table: BSSRDFTable, sigma_t_ch, rho_ch, r):
    """TabulatedBSSRDF::Pdf_Sr."""
    r_optical = r * sigma_t_ch
    sr, rho_eff, ok = _tensor_spline(table, rho_ch, r_optical)
    sr = torch.where(r_optical != 0,
                     sr / (2.0 * PI * torch.clamp(r_optical, min=1e-20)), sr)
    pdf = sr * sigma_t_ch * sigma_t_ch / torch.clamp(rho_eff, min=1e-20)
    return torch.where(ok, torch.clamp(pdf, min=0.0), 0.0)


# ---------------------------------------------------------------------------
# The axis and channel machinery of Sample_Sp / Pdf_Sp
# ---------------------------------------------------------------------------

def choose_projection_axis(u1, ss, ts, ns):
    """Sample_Sp's 1/2 : 1/4 : 1/4 pick of the projection axis; returns
    (vx, vy, vz, u1 remapped to [0, 1))."""
    first = u1 < 0.5
    second = (u1 >= 0.5) & (u1 < 0.75)
    u1r = torch.where(first, u1 * 2.0,
                      torch.where(second, (u1 - 0.5) * 4.0, (u1 - 0.75) * 4.0))
    fsel = first[..., None]
    ssel = second[..., None]
    vx = torch.where(fsel, ss, torch.where(ssel, ts, ns))
    vy = torch.where(fsel, ts, torch.where(ssel, ns, ss))
    vz = torch.where(fsel, ns, torch.where(ssel, ss, ts))
    return vx, vy, vz, u1r


def sample_sp_probe(scene, cfg, po_p, po_perr, po_ng, vx, vy, vz, r, phi,
                    r_max, mat_id, u_select, max_chain=4):
    """Sample_Sp's probe-ray chain over a wavefront: the probe segment of
    length 2 sqrt(r_max^2 - r^2) through the sampled offset point is cast up
    to max_chain times (each cast from the last hit on), the crossings whose
    material is mat_id are kept, and one of them is chosen with probability
    1/n_found (u_select).  The casts are trace.scene_intersect's, so they
    take whichever casts cfg names.  Returns (found (N,), the chosen hit's
    trace.Interaction, n_found (N,))."""
    from ..ops import trace

    del po_perr, po_ng
    n = po_p.shape[0]
    bad = r >= r_max
    l_len = 2.0 * torch.sqrt(torch.clamp(r_max * r_max - r * r, min=0.0))
    base = (po_p
            + r[..., None] * (vx * torch.cos(phi)[..., None]
                              + vy * torch.sin(phi)[..., None])
            - 0.5 * l_len[..., None] * vz)
    target = base + l_len[..., None] * vz

    hits_valid, hit_records = [], []
    o = base
    d = normalize(target - base, eps=1e-20)
    remaining = l_len
    alive = ~bad & (l_len > 1e-7)
    for _ in range(max_chain):
        h = trace.scene_intersect(scene, cfg, o, d,
                                  torch.clamp(remaining, min=0.0))
        it = trace.make_interaction(scene, cfg, o, d, h)
        ok = h.hit & alive
        hits_valid.append(ok & (it.mat == mat_id))
        hit_records.append(it)
        # continue the walk from the hit point
        o_next = trace.offset_ray_origin(it.p, it.p_err, it.ng, d)
        remaining = remaining - h.t
        alive = ok & (remaining > 1e-6)
        o = torch.where(ok[..., None], o_next, o)

    n_found = torch.sum(torch.stack(hits_valid, -1).to(torch.int32), -1)
    found = n_found > 0
    # the floor(u * n_found)-th admissible hit
    sel = torch.clamp((u_select * n_found.to(torch.float32)).to(torch.int32),
                      min=torch.zeros_like(n_found),
                      max=torch.clamp(n_found - 1, min=0))
    chosen = torch.zeros((n,), dtype=torch.int32, device=po_p.device)
    running = torch.zeros((n,), dtype=torch.int32, device=po_p.device)
    for k in range(max_chain):
        chosen = torch.where(hits_valid[k] & (running == sel), k, chosen)
        running = running + hits_valid[k].to(torch.int32)

    def gather_field(name):
        out = getattr(hit_records[0], name)
        for k in range(1, max_chain):
            pick = chosen == k
            fk = getattr(hit_records[k], name)
            out = torch.where(pick[..., None] if fk.ndim > 1 else pick, fk, out)
        return out

    pi = trace.Interaction(*(gather_field(f)
                             for f in trace.Interaction._fields))
    return found, pi, n_found


def pdf_sp(pdf_sr_fn, po_p, pi_p, pi_ng, ss, ts, ns, n_channels=3):
    """SeparableBSSRDF::Pdf_Sp: the 3 axis projections times the
    n_channels channel strategies.  pdf_sr_fn(ch, r) -> (...,) radial pdf
    of channel ch."""
    d = po_p - pi_p
    d_local = torch.stack([torch.sum(ss * d, -1), torch.sum(ts * d, -1),
                           torch.sum(ns * d, -1)], -1)
    n_local = torch.stack([torch.sum(ss * pi_ng, -1),
                           torch.sum(ts * pi_ng, -1),
                           torch.sum(ns * pi_ng, -1)], -1)
    r_proj = torch.stack([
        torch.sqrt(d_local[..., 1] ** 2 + d_local[..., 2] ** 2),
        torch.sqrt(d_local[..., 2] ** 2 + d_local[..., 0] ** 2),
        torch.sqrt(d_local[..., 0] ** 2 + d_local[..., 1] ** 2)], -1)
    axis_prob = (0.25, 0.25, 0.5)
    ch_prob = 1.0 / n_channels
    pdf = 0.0
    for axis in range(3):
        for ch in range(n_channels):
            pdf = pdf + (pdf_sr_fn(ch, r_proj[..., axis])
                         * torch.abs(n_local[..., axis]) * ch_prob
                         * axis_prob[axis])
    return pdf
