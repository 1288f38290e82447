"""Microfacet distributions + glossy material assemblies.

Trowbridge-Reitz (GGX) and Beckmann D / Smith Lambda / G, visible-normal
sampling, the RoughnessToAlpha remap, and the glossy material assemblies
Metal / Plastic / rough Glass (and the dispatch to Disney) as batched masked
dispatch.  All parameters differentiable; directions sampled detached.
"""

import torch

from ..constants import PI
from ..scene.scene import MAT_DISNEY, MAT_GLASS, MAT_METAL, MAT_PLASTIC
from ..utils.math import (
    abs_cos_theta, cos2_phi, cos2_theta, cos_phi, cos_theta, cross, normalize,
    reflect, refract, same_hemisphere, sin2_phi, sin2_theta, sin_phi,
    sin_theta, tan2_theta, tan_theta,
)
from . import bxdf
from .materials import _g

TROWBRIDGE = 0
BECKMANN = 1


def roughness_to_alpha(roughness):
    """Log-polynomial roughness -> alpha remap."""
    r = torch.clamp(roughness, min=1e-3)
    x = torch.log(r)
    return 1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3 + 0.000640711 * x ** 4


# ---------------------------------------------------------------------------
# Trowbridge-Reitz (GGX)
# ---------------------------------------------------------------------------

# NOTE on the double-where pattern below: a degenerate lane (grazing wh,
# zero wi, below-horizon wo) must not merely mask its *value* to 0 — if the
# unselected branch's primal is inf/NaN, the gradient of torch.where
# propagates NaN into parameter gradients (0 * inf).  So the degenerate
# operand is sanitized BEFORE the arithmetic, and the result masked after.

def _tan2_ok(w):
    """(tan^2 theta where the JAX package's masks let it through, else 0;
    that mask).  The mask is taken on the plain tan2_theta, and the division
    is made only where it holds: at cos(theta) = 0 the plain quotient is
    inf, and its backward turns the masked zero gradient into NaN (a 1M-lane
    mesh step on an H100 met such a half vector)."""
    with torch.no_grad():
        ok = torch.isfinite(tan2_theta(w)) & ((cos_theta(w) ** 2) ** 2 > 1e-16)
    return torch.where(
        ok, sin2_theta(w) / torch.where(ok, cos2_theta(w), 1.0), 0.0), ok


def _abs_tan_ok(w):
    """(|tan theta| where it is finite, else 0; that mask), with the same
    care as _tan2_ok."""
    with torch.no_grad():
        ok = torch.isfinite(torch.abs(tan_theta(w)))
    return torch.where(ok, torch.abs(
        sin_theta(w) / torch.where(ok, w[..., 2], 1.0)), 0.0), ok


def tr_d(wh, ax, ay):
    """GGX anisotropic D."""
    t2s, ok = _tan2_ok(wh)
    c2 = cos_theta(wh) ** 2
    c4s = torch.where(ok, c2 * c2, 1.0)
    e = (cos2_phi(wh) / (ax * ax) + sin2_phi(wh) / (ay * ay)) * t2s
    d = 1.0 / (PI * ax * ay * c4s * (1.0 + e) ** 2)
    return torch.where(ok, d, 0.0)


def tr_lambda(w, ax, ay):
    at, ok = _abs_tan_ok(w)
    # clamp: a zero-vector lane has cos2_phi == sin2_phi == 0 and sqrt(0)
    # has an infinite derivative w.r.t. ax/ay
    alpha = torch.sqrt(torch.clamp(
        cos2_phi(w) * ax * ax + sin2_phi(w) * ay * ay, min=1e-12))
    a2t2 = (alpha * at) ** 2
    lam = (-1.0 + torch.sqrt(1.0 + a2t2)) / 2.0
    return torch.where(ok, lam, 0.0)


def beckmann_d(wh, ax, ay):
    t2s, ok = _tan2_ok(wh)
    c2 = cos_theta(wh) ** 2
    c4s = torch.where(ok, c2 * c2, 1.0)
    d = torch.exp(-t2s * (cos2_phi(wh) / (ax * ax) + sin2_phi(wh) / (ay * ay))) / (
        PI * ax * ay * c4s
    )
    return torch.where(ok, d, 0.0)


def beckmann_lambda(w, ax, ay):
    at, ok = _abs_tan_ok(w)
    at = torch.where(ok, at, 1.0)
    alpha = torch.sqrt(torch.clamp(
        cos2_phi(w) * ax * ax + sin2_phi(w) * ay * ay, min=1e-12))
    a = 1.0 / torch.clamp(alpha * at, min=1e-8)
    a_s = torch.clamp(a, max=1.6)  # branch-sanitized: >=1.6 lanes return 0
    lam = torch.where(
        a >= 1.6, 0.0,
        (1.0 - 1.259 * a_s + 0.396 * a_s * a_s)
        / (3.535 * a_s + 2.181 * a_s * a_s),
    )
    return torch.where(ok, lam, 0.0)


def mf_g1(lam):
    return 1.0 / (1.0 + lam)


def mf_g(lam_o, lam_i):
    return 1.0 / (1.0 + lam_o + lam_i)


def mf_pdf_visible(w, wh, d_val, lam_w):
    """pdf for visible-normal sampling: D * G1(w) * |w.wh| / |cos w|."""
    g1 = mf_g1(lam_w)
    cos_w = abs_cos_theta(w)
    return d_val * g1 * torch.abs(torch.sum(w * wh, -1)) / torch.clamp(cos_w, min=1e-8)


def tr_sample_wh(wo, u, ax, ay):
    """GGX visible-normal sampling (Heitz 2018 ellipsoid method)."""
    flip = wo[..., 2] < 0
    w = torch.where(flip[..., None], -wo, wo)
    # stretch
    vh = normalize(torch.stack([ax * w[..., 0], ay * w[..., 1], w[..., 2]], -1))
    # orthonormal basis around vh
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype, device=vh.device)
    t1 = torch.where(
        (lensq > 1e-12)[..., None],
        torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(lensq)], -1)
        / torch.sqrt(torch.clamp(lensq, min=1e-12))[..., None],
        x_axis.expand_as(vh),
    )
    t2 = cross(vh, t1)
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * PI * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    # unstretch
    wh = normalize(
        torch.stack([ax * nh[..., 0], ay * nh[..., 1],
                     torch.clamp(nh[..., 2], min=1e-6)], -1)
    )
    return torch.where(flip[..., None], -wh, wh)


def beckmann_sample_wh(wo, u, ax, ay):
    """Beckmann visible-normal sampling: stretch -> sample P22 slopes ->
    rotate -> unstretch.

    The slope CDF inversion is a 10-step Newton/bisection hybrid in the erf
    domain; all lanes run the fixed 10 iterations with where-masked interval
    updates.
    """
    erf, erfinv = torch.special.erf, torch.special.erfinv

    flip = wo[..., 2] < 0
    w = torch.where(flip[..., None], -wo, wo)
    # 1. stretch
    ws = normalize(torch.stack([ax * w[..., 0], ay * w[..., 1], w[..., 2]], -1))
    ci = torch.clamp(ws[..., 2], -1.0, 1.0)
    u1 = torch.clamp(u[..., 0], min=1e-6)
    u2 = u[..., 1]

    # normal-incidence special case (cosTheta > .9999)
    r_ni = torch.sqrt(-torch.log(torch.clamp(1.0 - u1, min=1e-12)))
    sx_ni = r_ni * torch.cos(2.0 * PI * u2)
    sy_ni = r_ni * torch.sin(2.0 * PI * u2)

    # general case: numerical inversion in the erf domain
    ci_safe = torch.clamp(torch.abs(ci), min=1e-4)
    si = torch.sqrt(torch.clamp(1.0 - ci_safe * ci_safe, min=0.0))
    tan_ti = si / ci_safe
    cot_ti = 1.0 / torch.clamp(tan_ti, min=1e-12)
    sqrt_pi_inv = 1.0 / PI ** 0.5
    a = torch.full_like(u1, -1.0)
    c = erf(cot_ti)
    theta_i = torch.acos(torch.clamp(ci_safe, -1.0, 1.0))
    fit = 1.0 + theta_i * (-0.876 + theta_i * (0.4265 - 0.0594 * theta_i))
    b = c - (1.0 + c) * torch.pow(torch.clamp(1.0 - u1, min=1e-12), fit)
    norm = 1.0 / (1.0 + c + sqrt_pi_inv * tan_ti * torch.exp(-cot_ti * cot_ti))

    for _ in range(10):
        b = torch.where((b >= a) & (b <= c), b, 0.5 * (a + c))
        inv_erf = erfinv(torch.clamp(b, -1.0 + 1e-6, 1.0 - 1e-6))
        value = norm * (
            1.0 + b + sqrt_pi_inv * tan_ti * torch.exp(-inv_erf * inv_erf)
        ) - u1
        deriv = norm * (1.0 - inv_erf * tan_ti)
        c = torch.where(value > 0, b, c)
        a = torch.where(value > 0, a, b)
        b = b - value / torch.where(torch.abs(deriv) < 1e-12,
                                    torch.where(deriv < 0, -1e-12, 1e-12), deriv)
    sx_g = erfinv(torch.clamp(b, -1.0 + 1e-6, 1.0 - 1e-6))
    sy_g = erfinv(torch.clamp(2.0 * torch.clamp(u2, min=1e-6) - 1.0,
                              -1.0 + 1e-6, 1.0 - 1e-6))

    ni = ci > 0.9999
    slope_x = torch.where(ni, sx_ni, sx_g)
    slope_y = torch.where(ni, sy_ni, sy_g)

    # 3. rotate by phi of the stretched direction
    cphi = cos_phi(ws)
    sphi = sin_phi(ws)
    tmp = cphi * slope_x - sphi * slope_y
    slope_y = sphi * slope_x + cphi * slope_y
    slope_x = tmp
    # 4. unstretch; 5. normal
    wh = normalize(
        torch.stack([-ax * slope_x, -ay * slope_y, torch.ones_like(slope_x)], -1)
    )
    return torch.where(flip[..., None], -wh, wh)


# ---------------------------------------------------------------------------
# FresnelBlend (Ashikhmin-Shirley)
# ---------------------------------------------------------------------------

def _pow5(v):
    return (v * v) * (v * v) * v


def fresnel_blend_f(wo, wi, rd, rs, ax, ay):
    """FresnelBlend::f: coupled diffuse + Schlick-Fresnel microfacet gloss."""
    aci = abs_cos_theta(wi)
    aco = abs_cos_theta(wo)
    diffuse = (
        (28.0 / (23.0 * PI)) * rd * (1.0 - rs)
        * (1.0 - _pow5(1.0 - 0.5 * aci))[..., None]
        * (1.0 - _pow5(1.0 - 0.5 * aco))[..., None]
    )
    wh = wi + wo
    degenerate = torch.sum(wh * wh, -1) < 1e-16
    wh_n = normalize(wh, eps=1e-20)
    d = tr_d(wh_n, ax, ay)
    dot_ih = torch.sum(wi * wh_n, -1)
    schlick = rs + _pow5(1.0 - torch.clamp(dot_ih, 0.0, 1.0))[..., None] * (1.0 - rs)
    denom = 4.0 * torch.abs(dot_ih) * torch.maximum(aci, aco)
    specular = (d / torch.clamp(denom, min=1e-8))[..., None] * schlick
    out = diffuse + torch.where(degenerate[..., None], 0.0, specular)
    same = same_hemisphere(wo, wi)
    return torch.where(same[..., None], out, 0.0)


def fresnel_blend_pdf(wo, wi, ax, ay):
    """FresnelBlend::Pdf: average of cosine and wh pdfs."""
    wh = normalize(wo + wi, eps=1e-20)
    d = tr_d(wh, ax, ay)
    pdf_wh = mf_pdf_visible(wo, wh, d, tr_lambda(wo, ax, ay))
    pdf = 0.5 * (
        abs_cos_theta(wi) / PI
        + pdf_wh / torch.clamp(4.0 * torch.abs(torch.sum(wo * wh, -1)), min=1e-8)
    )
    return torch.where(same_hemisphere(wo, wi), pdf, 0.0)


def fresnel_blend_sample(wo, u2, uc, rd, rs, ax, ay):
    """FresnelBlend::Sample_f: uc<.5 cosine-samples the hemisphere, else
    samples wh and reflects; pdf/f from the full mixture.
    Returns (wi, f, pdf, valid)."""
    pick_diffuse = uc < 0.5
    wi_d = bxdf.diffuse_sample_wi(wo, u2)
    wh = tr_sample_wh(wo, u2, ax, ay)
    wi_s = reflect(wo, wh)
    wi = torch.where(pick_diffuse[..., None], wi_d, wi_s).detach()
    same = same_hemisphere(wo, wi)
    f = fresnel_blend_f(wo, wi, rd, rs, ax, ay)
    pdf = fresnel_blend_pdf(wo, wi, ax, ay)
    valid = same & (pdf > 0)
    return wi, f, pdf, valid


# ---------------------------------------------------------------------------
# Lobe assemblies
# ---------------------------------------------------------------------------

def _alphas(mats, mid):
    ru = _g(mats.rough_u, mid)
    rv = _g(mats.rough_v, mid)
    remap = _g(mats.remap_rough, mid) > 0.5
    ax = torch.where(remap, roughness_to_alpha(ru), torch.clamp(ru, min=1e-3))
    ay = torch.where(remap, roughness_to_alpha(rv), torch.clamp(rv, min=1e-3))
    return ax, ay


def microfacet_reflection_f(wo, wi, ax, ay, fresnel_fn, scale):
    """MicrofacetReflection::f: D G F / (4 cos cos)."""
    co = abs_cos_theta(wo)
    ci = abs_cos_theta(wi)
    wh = wo + wi
    degenerate = (co < 1e-8) | (ci < 1e-8) | (torch.sum(wh * wh, -1) < 1e-16)
    wh_n = normalize(wh, eps=1e-20)
    d = tr_d(wh_n, ax, ay)
    g = mf_g(tr_lambda(wo, ax, ay), tr_lambda(wi, ax, ay))
    # Fresnel at wh.wi with wh in the upper hemisphere (faceforward)
    wh_f = torch.where((wh_n[..., 2] < 0)[..., None], -wh_n, wh_n)
    fr = fresnel_fn(torch.sum(wi * wh_f, -1))
    f = scale * fr * (d * g / torch.clamp(4.0 * co * ci, min=1e-8))[..., None]
    same = same_hemisphere(wo, wi)
    return torch.where((degenerate | ~same)[..., None], 0.0, f)


def microfacet_reflection_pdf(wo, wi, ax, ay):
    wh = normalize(wo + wi, eps=1e-20)
    d = tr_d(wh, ax, ay)
    pdf_wh = mf_pdf_visible(wo, wh, d, tr_lambda(wo, ax, ay))
    pdf = pdf_wh / torch.clamp(4.0 * torch.abs(torch.sum(wo * wh, -1)), min=1e-8)
    return torch.where(same_hemisphere(wo, wi), pdf, 0.0)


def microfacet_transmission_f(wo, wi, ax, ay, eta_a, eta_b, kt):
    """MicrofacetTransmission::f: GGX refraction lobe."""
    same = same_hemisphere(wo, wi)
    co = cos_theta(wo)
    ci = cos_theta(wi)
    eta = torch.where(co > 0, eta_b / eta_a, eta_a / eta_b)
    wh = normalize(wo + wi * eta[..., None], eps=1e-20)
    wh = torch.where((wh[..., 2] < 0)[..., None], -wh, wh)
    wo_dot = torch.sum(wo * wh, -1)
    wi_dot = torch.sum(wi * wh, -1)
    same_side = wo_dot * wi_dot > 0  # reject same-side
    fr = bxdf.fr_dielectric(wo_dot, eta_a, eta_b)
    d = tr_d(wh, ax, ay)
    g = mf_g(tr_lambda(wo, ax, ay), tr_lambda(wi, ax, ay))
    denom = (wo_dot + eta * wi_dot) ** 2
    factor = 1.0 / eta  # radiance transport
    val = (
        (1.0 - fr)
        * torch.abs(
            d * g * eta * eta * torch.abs(wi_dot) * torch.abs(wo_dot) * factor * factor
            / torch.clamp(ci * co * denom, min=1e-10)
        )
    )
    bad = same | (co == 0) | (ci == 0) | same_side
    return torch.where(bad[..., None], 0.0, kt * val[..., None])


def microfacet_transmission_pdf(wo, wi, ax, ay, eta_a, eta_b):
    same = same_hemisphere(wo, wi)
    eta = torch.where(cos_theta(wo) > 0, eta_b / eta_a, eta_a / eta_b)
    wh = normalize(wo + wi * eta[..., None], eps=1e-20)
    wo_dot = torch.sum(wo * wh, -1)
    wi_dot = torch.sum(wi * wh, -1)
    same_side = wo_dot * wi_dot > 0
    sqrt_denom = wo_dot + eta * wi_dot
    dwh_dwi = torch.abs(eta * eta * wi_dot) / torch.clamp(sqrt_denom * sqrt_denom, min=1e-10)
    d = tr_d(torch.where((wh[..., 2] < 0)[..., None], -wh, wh), ax, ay)
    pdf_wh = mf_pdf_visible(wo, wh, d, tr_lambda(wo, ax, ay))
    return torch.where(same | same_side, 0.0, pdf_wh * dwh_dwi)


# ---------------------------------------------------------------------------
# Dispatch: evaluate / sample over glossy material kinds
# ---------------------------------------------------------------------------

def evaluate_glossy(mats, mid, cfg, wo, wi, kd_override=None):
    """(f, pdf, handled_mask) for METAL / PLASTIC / rough GLASS / DISNEY."""
    kind = _g(mats.kind, mid)
    n = kind.shape[0]
    dev = kind.device
    f = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    pdf = torch.zeros((n,), dtype=torch.float32, device=dev)
    handled = torch.zeros((n,), dtype=torch.bool, device=dev)
    ax, ay = _alphas(mats, mid)

    if MAT_METAL in cfg.mat_kinds:
        m = kind == MAT_METAL
        eta3 = _g(mats.eta3, mid)
        k3 = _g(mats.k3, mid)
        fres = lambda c: bxdf.fr_conductor(c, torch.ones_like(eta3), eta3, k3)
        f_m = microfacet_reflection_f(wo, wi, ax, ay, fres, 1.0)
        p_m = microfacet_reflection_pdf(wo, wi, ax, ay)
        f = torch.where(m[..., None], f_m, f)
        pdf = torch.where(m, p_m, pdf)
        handled = handled | m

    if MAT_PLASTIC in cfg.mat_kinds:
        # Plastic: Lambertian kd + GGX ks with dielectric Fresnel 1.5; f sums
        # lobes, pdf averages.
        m = kind == MAT_PLASTIC
        kd = kd_override if kd_override is not None else _g(mats.kd, mid)
        ks = _g(mats.ks, mid)
        fres = lambda c: bxdf.fr_dielectric(c, 1.5, 1.0)[..., None]
        f_spec = microfacet_reflection_f(wo, wi, ax, ay, fres, ks)
        f_diff = bxdf.lambert_f(wo, wi, kd)
        p_spec = microfacet_reflection_pdf(wo, wi, ax, ay)
        p_diff = bxdf.lambert_pdf(wo, wi)
        f = torch.where(m[..., None], f_spec + f_diff, f)
        pdf = torch.where(m, 0.5 * (p_spec + p_diff), pdf)
        handled = handled | m

    if MAT_GLASS in cfg.mat_kinds:
        # rough glass only (smooth handled as specular in materials.py)
        rough = (_g(mats.rough_u, mid) > 0) | (_g(mats.rough_v, mid) > 0)
        m = (kind == MAT_GLASS) & rough
        kr = _g(mats.kr, mid)
        kt = _g(mats.kt, mid)
        eta_b = _g(mats.eta, mid)
        one = torch.ones_like(eta_b)
        fres = lambda c: bxdf.fr_dielectric(c, 1.0, eta_b)[..., None]
        f_r = microfacet_reflection_f(wo, wi, ax, ay, fres, kr)
        f_t = microfacet_transmission_f(wo, wi, ax, ay, one, eta_b, kt)
        p_r = microfacet_reflection_pdf(wo, wi, ax, ay)
        p_t = microfacet_transmission_pdf(wo, wi, ax, ay, one, eta_b)
        same = same_hemisphere(wo, wi)
        f_m = torch.where(same[..., None], f_r, f_t)
        p_m = 0.5 * (p_r + p_t)
        f = torch.where(m[..., None], f_m, f)
        pdf = torch.where(m, p_m, pdf)
        handled = handled | m

    if MAT_DISNEY in cfg.mat_kinds:
        from . import disney

        f_d, p_d, m = disney.evaluate(mats, mid, cfg, wo, wi, kd_override)
        f = torch.where(m[..., None], f_d, f)
        pdf = torch.where(m, p_d, pdf)
        handled = handled | m

    return f, pdf, handled


def sample_glossy(mats, mid, cfg, wo, u2, uc, kd_override=None):
    """BsdfSample for glossy kinds; returns (sample, handled_mask)."""
    from .materials import BsdfSample

    kind = _g(mats.kind, mid)
    n = kind.shape[0]
    dev = kind.device
    ax, ay = _alphas(mats, mid)
    out = dict(
        wi=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        weight=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        pdf=torch.zeros((n,), dtype=torch.float32, device=dev),
        f=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        specular=torch.zeros((n,), dtype=torch.bool, device=dev),
        transmission=torch.zeros((n,), dtype=torch.bool, device=dev),
        eta=torch.ones((n,), dtype=torch.float32, device=dev),
        valid=torch.zeros((n,), dtype=torch.bool, device=dev),
    )
    handled = torch.zeros((n,), dtype=torch.bool, device=dev)

    def finish(m, wi_m, f_m, p_m, is_trans=None):
        nonlocal handled
        ok = (p_m > 0) & (abs_cos_theta(wi_m) > 1e-8)
        w_m = f_m * (
            abs_cos_theta(wi_m) / torch.clamp(p_m.detach(), min=1e-12)
        )[..., None]
        out["wi"] = torch.where(m[..., None], wi_m, out["wi"])
        out["weight"] = torch.where(m[..., None], w_m, out["weight"])
        out["pdf"] = torch.where(m, p_m, out["pdf"])
        out["f"] = torch.where(m[..., None], f_m, out["f"])
        out["valid"] = out["valid"] | (m & ok)
        handled = handled | m
        if is_trans is not None:
            out["transmission"] = out["transmission"] | (m & is_trans)

    if MAT_METAL in cfg.mat_kinds:
        m = kind == MAT_METAL
        wh = tr_sample_wh(wo, u2, ax, ay)
        wi_m = reflect(wo, wh).detach()
        eta3 = _g(mats.eta3, mid)
        k3 = _g(mats.k3, mid)
        fres = lambda c: bxdf.fr_conductor(c, torch.ones_like(eta3), eta3, k3)
        f_m = microfacet_reflection_f(wo, wi_m, ax, ay, fres, 1.0)
        p_m = microfacet_reflection_pdf(wo, wi_m, ax, ay)
        finish(m, wi_m, f_m, p_m)

    if MAT_PLASTIC in cfg.mat_kinds:
        m = kind == MAT_PLASTIC
        kd = kd_override if kd_override is not None else _g(mats.kd, mid)
        ks = _g(mats.ks, mid)
        pick_spec = uc < 0.5
        wh = tr_sample_wh(wo, u2, ax, ay)
        wi_spec = reflect(wo, wh)
        wi_diff = bxdf.diffuse_sample_wi(wo, u2)
        wi_m = torch.where(pick_spec[..., None], wi_spec, wi_diff).detach()
        fres = lambda c: bxdf.fr_dielectric(c, 1.5, 1.0)[..., None]
        f_m = microfacet_reflection_f(wo, wi_m, ax, ay, fres, ks) + bxdf.lambert_f(
            wo, wi_m, kd
        )
        p_m = 0.5 * (
            microfacet_reflection_pdf(wo, wi_m, ax, ay) + bxdf.lambert_pdf(wo, wi_m)
        )
        finish(m, wi_m, f_m, p_m)

    if MAT_GLASS in cfg.mat_kinds:
        rough = (_g(mats.rough_u, mid) > 0) | (_g(mats.rough_v, mid) > 0)
        m = (kind == MAT_GLASS) & rough
        kr = _g(mats.kr, mid)
        kt = _g(mats.kt, mid)
        eta_b = _g(mats.eta, mid)
        one = torch.ones_like(eta_b)
        wh = tr_sample_wh(wo, u2, ax, ay)
        wi_r = reflect(wo, wh)
        eta_ratio = torch.where(cos_theta(wo) > 0, 1.0 / eta_b, eta_b)
        refr_ok, wi_t = refract(
            wo, torch.where((torch.sum(wo * wh, -1) < 0)[..., None], -wh, wh),
            eta_ratio)
        pick_r = uc < 0.5
        wi_m = torch.where(pick_r[..., None], wi_r, wi_t).detach()
        fres = lambda c: bxdf.fr_dielectric(c, 1.0, eta_b)[..., None]
        same = same_hemisphere(wo, wi_m)
        f_m = torch.where(
            same[..., None],
            microfacet_reflection_f(wo, wi_m, ax, ay, fres, kr),
            microfacet_transmission_f(wo, wi_m, ax, ay, one, eta_b, kt),
        )
        p_m = 0.5 * (
            microfacet_reflection_pdf(wo, wi_m, ax, ay)
            + microfacet_transmission_pdf(wo, wi_m, ax, ay, one, eta_b)
        )
        ok_branch = pick_r | refr_ok
        finish(m & ok_branch, wi_m, f_m, p_m, is_trans=~same)
        out["eta"] = torch.where(m, eta_b, out["eta"])

    if MAT_DISNEY in cfg.mat_kinds:
        from . import disney

        smp_d, m = disney.sample(mats, mid, cfg, wo, u2, uc, kd_override)
        out["wi"] = torch.where(m[..., None], smp_d.wi, out["wi"])
        out["weight"] = torch.where(m[..., None], smp_d.weight, out["weight"])
        for k in ("pdf", "specular", "transmission", "eta", "valid"):
            out[k] = torch.where(m, getattr(smp_d, k), out[k])
        out["f"] = torch.where(m[..., None], smp_d.f, out["f"])
        handled = handled | m

    return BsdfSample(**out), handled
