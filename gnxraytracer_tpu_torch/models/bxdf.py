"""BxDF lobes as pure batched functions in the local shading frame
(z = shading normal).

Gradients: directions/pdfs are sampled *detached*, f is evaluated
*attached* — the detached-sampling reparameterized estimator.  Mixtures and
material assemblies live in materials.py.
"""

import torch

from ..constants import INV_PI
from ..ops.sampling import cosine_sample_hemisphere
from ..utils.math import (
    abs_cos_theta, cos_phi, cos_theta, refract, same_hemisphere, sin_phi,
    sin_theta, sqrt0,
)

# ---------------------------------------------------------------------------
# Fresnel
# ---------------------------------------------------------------------------

def fr_dielectric(cos_theta_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel; handles both sides by swapping."""
    ci = torch.clamp(cos_theta_i, -1.0, 1.0)
    entering = ci > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(ci)
    si = sqrt0(1.0 - ci * ci)
    st = ei / et * si
    tir = st >= 1.0
    # sanitize BEFORE the sqrt: at (or beyond) total internal reflection
    # 1-st^2 <= 0 and sqrt's derivative w.r.t. eta is infinite
    sts = torch.where(tir, 0.0, st)
    ct = sqrt0(1.0 - sts * sts)
    d_parl = et * ci + ei * ct
    d_perp = ei * ci + et * ct
    r_parl = (et * ci - ei * ct) / torch.where(d_parl == 0, 1.0, d_parl)
    r_perp = (ei * ci - et * ct) / torch.where(d_perp == 0, 1.0, d_perp)
    fr = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


def fr_conductor(cos_theta_i, eta_i, eta_t, k):
    """Conductor Fresnel with complex IOR, per channel.

    cos_theta_i: (...,); eta_i/eta_t/k: (..., 3). Returns (..., 3).
    """
    ci = torch.clamp(torch.abs(cos_theta_i), 0.0, 1.0)[..., None]
    eta = eta_t / eta_i
    etak = k / eta_i
    cos2 = ci * ci
    sin2 = 1.0 - cos2
    eta2 = eta * eta
    etak2 = etak * etak
    t0 = eta2 - etak2 - sin2
    a2b2 = sqrt0(t0 * t0 + 4.0 * eta2 * etak2)
    t1 = a2b2 + cos2
    a = sqrt0(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / (t1 + t2)
    t3 = cos2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / (t3 + t4)
    return 0.5 * (rp + rs)


def schlick_fresnel(cos_t, r0):
    m = torch.clamp(1.0 - cos_t, 0.0, 1.0)
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)


# ---------------------------------------------------------------------------
# Lambertian
# ---------------------------------------------------------------------------

def lambert_f(wo, wi, kd):
    same = same_hemisphere(wo, wi)
    return torch.where(same[..., None], kd * INV_PI, 0.0)


def lambert_pdf(wo, wi):
    return torch.where(same_hemisphere(wo, wi), abs_cos_theta(wi) * INV_PI, 0.0)


# ---------------------------------------------------------------------------
# Oren-Nayar
# ---------------------------------------------------------------------------

def oren_nayar_ab(sigma_deg):
    """A/B coefficients from sigma in degrees."""
    sigma = torch.deg2rad(sigma_deg)
    sigma2 = sigma * sigma
    a = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
    b = 0.45 * sigma2 / (sigma2 + 0.09)
    return a, b


def oren_nayar_f(wo, wi, kd, sigma_deg):
    a, b = oren_nayar_ab(sigma_deg)
    sin_ti = sin_theta(wi)
    sin_to = sin_theta(wo)
    # max cos(phi_i - phi_o)
    both = (sin_ti > 1e-4) & (sin_to > 1e-4)
    d_cos = cos_phi(wi) * cos_phi(wo) + sin_phi(wi) * sin_phi(wo)
    max_cos = torch.where(both, torch.clamp(d_cos, min=0.0), 0.0)
    abs_ci = abs_cos_theta(wi)
    abs_co = abs_cos_theta(wo)
    i_larger = abs_ci > abs_co
    sin_alpha = torch.where(i_larger, sin_to, sin_ti)
    tan_beta = torch.where(
        i_larger,
        sin_ti / torch.clamp(abs_ci, min=1e-8),
        sin_to / torch.clamp(abs_co, min=1e-8),
    )
    val = INV_PI * (a + b * max_cos * sin_alpha * tan_beta)
    same = same_hemisphere(wo, wi)
    return torch.where(same[..., None], kd * val[..., None], 0.0)


def diffuse_sample_wi(wo, u):
    """Detached cosine sample flipped into wo's hemisphere."""
    wi = cosine_sample_hemisphere(u)
    flip = wo[..., 2] < 0.0
    wi = torch.cat([wi[..., :2],
                    torch.where(flip, -wi[..., 2], wi[..., 2])[..., None]],
                   dim=-1)
    return wi.detach()


# ---------------------------------------------------------------------------
# Specular lobes
# ---------------------------------------------------------------------------

def _mirror_dir(wo):
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)


def specular_mirror_sample(wo, kr):
    """Perfect mirror without Fresnel: wi=(-x,-y,z), weight = kr
    (pdf 1, f = kr/|cos|, so f*|cos|/pdf = kr)."""
    return _mirror_dir(wo).detach(), kr


def fresnel_specular_sample(wo, uc, eta_a, eta_b):
    """Stochastic reflect/transmit split of a smooth dielectric.  Returns
    (wi, weight_r, weight_t, choose_r, pdf, refraction_ok).

    The weights already include the f*|cos|/pdf simplification: reflect F
    (pdf = F), transmit (1-F) * eta^2 (pdf = 1-F; radiance-mode scale
    eta^2 = (ei/et)^2)."""
    ct = cos_theta(wo)
    f = fr_dielectric(ct, eta_a, eta_b)
    choose_r = uc < f
    wi_r = _mirror_dir(wo)
    entering = ct > 0.0
    ei = torch.where(entering, eta_a, eta_b)
    et = torch.where(entering, eta_b, eta_a)
    eta = ei / et
    n = torch.cat(
        [torch.zeros_like(wo[..., :2]),
         torch.where(entering, 1.0, -1.0)[..., None]], dim=-1)
    ok, wi_t = refract(wo, n, eta)
    wi = torch.where(choose_r[..., None], wi_r, wi_t)
    pdf = torch.where(choose_r, f, 1.0 - f)
    return wi.detach(), f, (1.0 - f) * (eta * eta), choose_r, pdf, ok
