"""Disney BSDF (2015) as a batched lobe mixture.

DisneyDiffuse, the Hanrahan-Krueger fake subsurface lobe, DisneyRetro,
DisneySheen, the GTR1 clearcoat, the metallic/dielectric Fresnel lerp, the
Disney-tweaked GGX, and their assembly with thin-surface mode and spectral
transmission.  The BSSRDF is left out, as it is in the reference renderer's
integrator.

Lobe presence is parameter-dependent per material row; presence masks are
floats in {0,1} so lobe selection and pdf averaging stay branchless and
differentiable in every continuous parameter.
"""

import torch

from ..constants import INV_PI, PI
from ..utils.math import (
    abs_cos_theta, cos_theta, normalize, reflect, refract, same_hemisphere,
    tan2_theta,
)
from . import bxdf
from .materials import _g
from .microfacet import (
    mf_g, mf_g1, mf_pdf_visible, microfacet_transmission_f,
    microfacet_transmission_pdf, tr_d, tr_lambda, tr_sample_wh,
)


def _schlick_weight(c):
    m = torch.clamp(1.0 - c, 0.0, 1.0)
    return (m * m) * (m * m) * m


def _lum(c):
    return c @ torch.tensor([0.212671, 0.715160, 0.072169], dtype=torch.float32,
                            device=c.device)


def _params(mats, mid):
    g = lambda col: _g(col, mid)
    return dict(
        c=g(mats.kd), metallic=g(mats.metallic), eta=g(mats.eta),
        strans=g(mats.spec_trans), rough=g(mats.rough_u),
        spec_tint=g(mats.specular_tint), aniso=g(mats.anisotropic),
        sheen=g(mats.sheen), sheen_tint=g(mats.sheen_tint),
        cc=g(mats.clearcoat), cc_gloss=g(mats.clearcoat_gloss),
        flat=g(mats.flatness), dt=g(mats.diff_trans), thin=g(mats.thin) > 0.5,
    )


def _derived(p):
    c = p["c"]
    lum = _lum(c)
    ctint = torch.where((lum > 0)[..., None],
                        c / torch.clamp(lum, min=1e-8)[..., None], 1.0)
    dw = (1.0 - p["metallic"]) * (1.0 - p["strans"])
    aspect = torch.sqrt(1.0 - p["aniso"] * 0.9)
    r2 = p["rough"] * p["rough"]
    ax = torch.clamp(r2 / aspect, min=1e-3)
    ay = torch.clamp(r2 * aspect, min=1e-3)
    r0 = _schlick_r0(p["eta"])[..., None]
    cspec0 = _lerp3(p["metallic"],
                    r0 * _lerp3(p["spec_tint"], torch.ones_like(c), ctint), c)
    csheen = _lerp3(p["sheen_tint"], torch.ones_like(c), ctint)
    gloss = _lerp(p["cc_gloss"], 0.1, 0.001)
    return dict(ctint=ctint, dw=dw, ax=ax, ay=ay, cspec0=cspec0,
                csheen=csheen, gloss=gloss)


def _lerp(t, a, b):
    return (1.0 - t) * a + t * b


def _lerp3(t, a, b):
    return (1.0 - t)[..., None] * a + t[..., None] * b


def _schlick_r0(eta):
    return ((eta - 1.0) / (eta + 1.0)) ** 2


# ---------------------------------------------------------------------------
# Lobe evaluations
# ---------------------------------------------------------------------------

def disney_diffuse_f(wo, wi, scale_c):
    fo = _schlick_weight(abs_cos_theta(wo))
    fi = _schlick_weight(abs_cos_theta(wi))
    val = INV_PI * (1.0 - fo / 2.0) * (1.0 - fi / 2.0)
    return scale_c * val[..., None]


def disney_fake_ss_f(wo, wi, scale_c, rough):
    wh = wo + wi
    ok = torch.sum(wh * wh, -1) > 1e-16
    wh = normalize(wh, eps=1e-20)
    cos_d = torch.sum(wi * wh, -1)
    fss90 = cos_d * cos_d * rough
    fo = _schlick_weight(abs_cos_theta(wo))
    fi = _schlick_weight(abs_cos_theta(wi))
    fss = _lerp(fo, 1.0, fss90) * _lerp(fi, 1.0, fss90)
    ss = 1.25 * (fss * (1.0 / (abs_cos_theta(wo) + abs_cos_theta(wi) + 1e-8) - 0.5) + 0.5)
    return torch.where(ok[..., None], scale_c * (INV_PI * ss)[..., None], 0.0)


def disney_retro_f(wo, wi, scale_c, rough):
    wh = wo + wi
    ok = torch.sum(wh * wh, -1) > 1e-16
    wh = normalize(wh, eps=1e-20)
    cos_d = torch.sum(wi * wh, -1)
    fo = _schlick_weight(abs_cos_theta(wo))
    fi = _schlick_weight(abs_cos_theta(wi))
    rr = 2.0 * rough * cos_d * cos_d
    val = INV_PI * rr * (fo + fi + fo * fi * (rr - 1.0))
    return torch.where(ok[..., None], scale_c * val[..., None], 0.0)


def disney_sheen_f(wo, wi, scale_c):
    wh = wo + wi
    ok = torch.sum(wh * wh, -1) > 1e-16
    wh = normalize(wh, eps=1e-20)
    cos_d = torch.sum(wi * wh, -1)
    return torch.where(ok[..., None], scale_c * _schlick_weight(cos_d)[..., None], 0.0)


def _gtr1(cos_th, alpha):
    a2 = alpha * alpha
    return (a2 - 1.0) / (PI * torch.log(a2) * (1.0 + (a2 - 1.0) * cos_th * cos_th))


def _smith_g_ggx(cos_th, alpha):
    a2 = alpha * alpha
    c2 = cos_th * cos_th
    return 1.0 / (cos_th + torch.sqrt(a2 + c2 - a2 * c2))


def disney_clearcoat_f(wo, wi, weight, gloss):
    wh = wo + wi
    ok = torch.sum(wh * wh, -1) > 1e-16
    wh = normalize(wh, eps=1e-20)
    d = _gtr1(abs_cos_theta(wh), gloss)
    f = bxdf.schlick_fresnel(torch.abs(torch.sum(wo * wh, -1)), 0.04)
    g = _smith_g_ggx(abs_cos_theta(wo), 0.25) * _smith_g_ggx(abs_cos_theta(wi), 0.25)
    return torch.where(ok, weight * d * f * g / 4.0, 0.0)


def disney_clearcoat_pdf(wo, wi, gloss):
    wh = wo + wi
    ok = (torch.sum(wh * wh, -1) > 1e-16) & same_hemisphere(wo, wi)
    wh = normalize(wh, eps=1e-20)
    d = _gtr1(abs_cos_theta(wh), gloss)
    pdf = d * abs_cos_theta(wh) / torch.clamp(4.0 * torch.abs(torch.sum(wo * wh, -1)), min=1e-8)
    return torch.where(ok, pdf, 0.0)


def _disney_fresnel(p, drv, cos_i):
    """DisneyFresnel: lerp(metallic, dielectric Fresnel, Schlick with
    Cspec0)."""
    fd = bxdf.fr_dielectric(cos_i, 1.0, p["eta"])[..., None] * torch.ones_like(drv["cspec0"])
    fs = drv["cspec0"] + (1.0 - drv["cspec0"]) * _schlick_weight(cos_i)[..., None]
    return _lerp3(p["metallic"], fd, fs)


# ---------------------------------------------------------------------------
# Assembly: f / pdf / sample
# ---------------------------------------------------------------------------

def _lobe_presence(p):
    """Presence (0/1 floats) of [diffuse-ish, microfacet refl, clearcoat,
    microfacet trans, lambert-trans(thin)], the lobes the material allocates."""
    dw = (1.0 - p["metallic"]) * (1.0 - p["strans"])
    pres_diff = (dw > 0).to(torch.float32)
    pres_spec = torch.ones_like(dw)  # microfacet reflection always added
    pres_cc = (p["cc"] > 0).to(torch.float32)
    pres_trans = (p["strans"] > 0).to(torch.float32)
    pres_ltrans = ((p["dt"] > 0) & p["thin"]).to(torch.float32)
    return pres_diff, pres_spec, pres_cc, pres_trans, pres_ltrans


def _f_impl(p, drv, wo, wi):
    same = same_hemisphere(wo, wi)
    dw = drv["dw"]
    c = p["c"]
    f = torch.zeros_like(c)

    # diffuse group (reflection hemisphere)
    flat = torch.where(p["thin"], p["flat"], 0.0)
    diff_scale = (dw * (1.0 - flat))[..., None] * c
    ss_scale = (dw * flat)[..., None] * c
    f_diff = disney_diffuse_f(wo, wi, diff_scale)
    f_ss = disney_fake_ss_f(wo, wi, ss_scale, p["rough"])
    f_retro = disney_retro_f(wo, wi, dw[..., None] * c, p["rough"])
    f_sheen = disney_sheen_f(wo, wi, (dw * p["sheen"])[..., None] * drv["csheen"])
    pres_diff, pres_spec, pres_cc, pres_trans, pres_ltrans = _lobe_presence(p)
    f = f + torch.where(same[..., None],
                      pres_diff[..., None] * (f_diff + f_ss + f_retro + f_sheen), 0.0)

    # microfacet reflection with DisneyFresnel and Disney G
    co = abs_cos_theta(wo)
    ci = abs_cos_theta(wi)
    wh = wo + wi
    ok = (co > 1e-8) & (ci > 1e-8) & (torch.sum(wh * wh, -1) > 1e-16)
    whn = normalize(wh, eps=1e-20)
    whf = torch.where((whn[..., 2] < 0)[..., None], -whn, whn)
    d_val = tr_d(whn, drv["ax"], drv["ay"])
    # Disney G: separable smith with remapped roughness
    g_val = mf_g1(tr_lambda(wo, drv["ax"], drv["ay"])) * mf_g1(tr_lambda(wi, drv["ax"], drv["ay"]))
    fr = _disney_fresnel(p, drv, torch.sum(wi * whf, -1))
    f_spec = fr * (d_val * g_val / torch.clamp(4.0 * co * ci, min=1e-8))[..., None]
    f = f + torch.where((same & ok)[..., None], f_spec, 0.0)

    # clearcoat
    f_cc = disney_clearcoat_f(wo, wi, p["cc"], drv["gloss"])
    f = f + torch.where(same[..., None], (pres_cc * f_cc)[..., None], 0.0)

    # microfacet transmission (strans)
    # sqrt'(0) is infinite: black base-color texels would leak NaN into
    # texture-texel gradients through the 0-cotangent product — sanitize
    # the operand and mask the value (identical primal)
    c_pos = c > 0
    t_col = p["strans"][..., None] * torch.where(
        c_pos, torch.sqrt(torch.where(c_pos, c, 1.0)), 0.0)
    rscaled = (0.65 * p["eta"] - 0.35) * p["rough"]  # thin remap
    ax_t = torch.where(p["thin"], torch.clamp(rscaled * rscaled / torch.sqrt(1.0 - p["aniso"] * 0.9), min=1e-3), drv["ax"])
    ay_t = torch.where(p["thin"], torch.clamp(rscaled * rscaled * torch.sqrt(1.0 - p["aniso"] * 0.9), min=1e-3), drv["ay"])
    f_trans = microfacet_transmission_f(wo, wi, ax_t, ay_t,
                                        torch.ones_like(p["eta"]), p["eta"], t_col)
    f = f + pres_trans[..., None] * f_trans

    # thin lambertian transmission
    f_lt = (p["dt"] / 2.0)[..., None] * c * INV_PI
    f = f + torch.where(same[..., None], 0.0, pres_ltrans[..., None] * f_lt)

    return f


def _pdf_impl(p, drv, wo, wi):
    pres = _lobe_presence(p)
    n_lobes = sum(pres)
    same = same_hemisphere(wo, wi)
    pdf = torch.zeros(wo.shape[0], dtype=torch.float32, device=wo.device)
    # diffuse cosine pdf (+ thin lambert-trans handled on other side)
    pdf = pdf + pres[0] * torch.where(same, abs_cos_theta(wi) * INV_PI, 0.0)
    # microfacet reflection
    wh = normalize(wo + wi, eps=1e-20)
    d_val = tr_d(wh, drv["ax"], drv["ay"])
    p_spec = mf_pdf_visible(wo, wh, d_val, tr_lambda(wo, drv["ax"], drv["ay"]))
    p_spec = p_spec / torch.clamp(4.0 * torch.abs(torch.sum(wo * wh, -1)), min=1e-8)
    pdf = pdf + pres[1] * torch.where(same, p_spec, 0.0)
    # clearcoat
    pdf = pdf + pres[2] * disney_clearcoat_pdf(wo, wi, drv["gloss"])
    # transmission
    p_tr = microfacet_transmission_pdf(wo, wi, drv["ax"], drv["ay"],
                                       torch.ones_like(p["eta"]), p["eta"])
    pdf = pdf + pres[3] * p_tr
    # thin lambert transmission
    pdf = pdf + pres[4] * torch.where(same, 0.0, abs_cos_theta(wi) * INV_PI)
    return pdf / torch.clamp(n_lobes, min=1.0)


def evaluate(mats, mid, cfg, wo, wi, kd_override=None):
    kind = _g(mats.kind, mid)
    from ..scene.scene import MAT_DISNEY

    m = kind == MAT_DISNEY
    p = _params(mats, mid)
    if kd_override is not None:
        p['c'] = kd_override
    drv = _derived(p)
    f = _f_impl(p, drv, wo, wi)
    pdf = _pdf_impl(p, drv, wo, wi)
    return f, pdf, m


def sample(mats, mid, cfg, wo, u2, uc, kd_override=None):
    from ..scene.scene import MAT_DISNEY
    from .materials import BsdfSample

    kind = _g(mats.kind, mid)
    m = kind == MAT_DISNEY
    p = _params(mats, mid)
    if kd_override is not None:
        p['c'] = kd_override
    drv = _derived(p)
    pres = _lobe_presence(p)
    n_lobes = sum(pres)

    # pick a lobe index in [0, n_lobes) among present lobes
    pick = torch.floor(uc * n_lobes)
    cum0 = pres[0]
    cum1 = cum0 + pres[1]
    cum2 = cum1 + pres[2]
    cum3 = cum2 + pres[3]
    choose_diff = pick < cum0
    choose_spec = (~choose_diff) & (pick < cum1)
    choose_cc = (~choose_diff) & (~choose_spec) & (pick < cum2)
    choose_trans = (~choose_diff) & (~choose_spec) & (~choose_cc) & (pick < cum3)
    choose_lt = (~choose_diff) & (~choose_spec) & (~choose_cc) & (~choose_trans)

    # candidate directions
    wi_diff = bxdf.diffuse_sample_wi(wo, u2)
    wh = tr_sample_wh(wo, u2, drv["ax"], drv["ay"])
    wi_spec = reflect(wo, wh)
    # clearcoat GTR1 sample
    a2 = drv["gloss"] * drv["gloss"]
    ct2 = (1.0 - torch.pow(a2, 1.0 - u2[..., 0])) / (1.0 - a2 + 1e-12)
    cth = torch.sqrt(torch.clamp(ct2, 0.0, 1.0))
    sth = torch.sqrt(torch.clamp(1.0 - ct2, min=0.0))
    phi = 2 * PI * u2[..., 1]
    wh_cc = torch.stack([sth * torch.cos(phi), sth * torch.sin(phi), cth], -1)
    wh_cc = torch.where((wo[..., 2] < 0)[..., None], -wh_cc, wh_cc)
    wi_cc = reflect(wo, wh_cc)
    # transmission through sampled wh
    eta_ratio = torch.where(cos_theta(wo) > 0, 1.0 / p["eta"], p["eta"])
    _ok_t, wi_tr = refract(
        wo, torch.where((torch.sum(wo * wh, -1) < 0)[..., None], -wh, wh), eta_ratio
    )
    # thin lambert transmission: cosine sample flipped to other side
    wi_lt = bxdf.diffuse_sample_wi(-wo, u2)

    wi = torch.where(choose_diff[..., None], wi_diff,
         torch.where(choose_spec[..., None], wi_spec,
         torch.where(choose_cc[..., None], wi_cc,
         torch.where(choose_trans[..., None], wi_tr, wi_lt))))
    wi = wi.detach()

    f = _f_impl(p, drv, wo, wi)
    pdf = _pdf_impl(p, drv, wo, wi)
    ok = pdf > 1e-10
    weight = f * (abs_cos_theta(wi) / torch.clamp(pdf.detach(), min=1e-10))[..., None]
    weight = torch.where(ok[..., None], weight, 0.0)
    trans = choose_trans | choose_lt

    return BsdfSample(
        wi=wi, weight=weight, pdf=pdf, f=f,
        specular=torch.zeros_like(m),
        transmission=trans,
        eta=p["eta"],
        valid=ok,
    ), m
