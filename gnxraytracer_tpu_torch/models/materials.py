"""Material assemblies: per-hit lobe mixtures dispatched by material kind.

Each hit gathers its material row, every material *kind present in the
scene* is evaluated for all lanes, and results combine with where-masks.
The set of present kinds is static (render config), so absent kinds cost
nothing.  Matte (Lambert / Oren-Nayar), mirror and smooth glass are
assembled here; the microfacet kinds (metal, plastic, rough glass, Disney)
in microfacet.py and disney.py.

Interface (local shading frame, z = ns):
  evaluate(mats, mid, cfg, wo, wi)  -> (f, pdf)   over non-specular lobes
  sample(mats, mid, cfg, wo, u2, uc) -> BsdfSample (detached wi, attached weight)
  has_nonspecular(mats, mid, cfg)   -> bool mask
"""

from typing import NamedTuple

import torch

from ..ops.table import gather_rows
from ..scene.scene import (
    MAT_DISNEY, MAT_GLASS, MAT_MATTE, MAT_METAL, MAT_MIRROR, MAT_PLASTIC,
    MaterialTable,
)
from ..utils.math import abs_cos_theta
from . import bxdf


class BsdfSample(NamedTuple):
    wi: torch.Tensor        # (N,3) local, detached
    weight: torch.Tensor    # (N,3) f * |cos| / pdf (attached params)
    pdf: torch.Tensor       # (N,) sampling pdf (detached value ok)
    f: torch.Tensor         # (N,3) raw f (0 for specular lanes)
    specular: torch.Tensor  # (N,) bool — sampled a delta lobe
    transmission: torch.Tensor  # (N,) bool — sampled a transmissive lobe
    eta: torch.Tensor       # (N,) material eta (for etaScale tracking)
    valid: torch.Tensor     # (N,) bool — black f / zero pdf -> terminate


def _g(col, mid):
    """Gather a material column per lane. mid=None means the table was
    pre-gathered to per-lane rows by gather_material_table."""
    if mid is None:
        return col
    return gather_rows(col, mid)


def gather_material_table(mats: MaterialTable, mid) -> MaterialTable:
    """Per-lane material rows: a MaterialTable whose columns are (N,)/(N,3);
    downstream code then indexes with mid=None."""
    idx = mid.long()
    return MaterialTable(*(gather_rows(c, idx) for c in mats))


def has_nonspecular(mats: MaterialTable, mid, cfg):
    """Whether the BSDF has any non-delta lobe, per kind."""
    kind = _g(mats.kind, mid)
    ns = torch.ones(kind.shape, dtype=torch.bool, device=kind.device)
    if MAT_MIRROR in cfg.mat_kinds:  # mirror: specular only
        ns = ns & (kind != MAT_MIRROR)
    if MAT_GLASS in cfg.mat_kinds:  # smooth glass: specular only
        rough = (_g(mats.rough_u, mid) > 0) | (_g(mats.rough_v, mid) > 0)
        ns = ns & ((kind != MAT_GLASS) | rough)
    return ns


def resolve_kd(scene, cfg, mid, uv, mats=None, duv=None):
    """Per-hit diffuse/base color: texture lookup where kd_tex >= 0, else
    the table color.

    mats: optionally a pre-gathered per-lane table (then mid=None).
    duv: optional (duvdx, duvdy) texture-space footprint from
    trace.compute_differentials — selects the filtered lookup per
    cfg.texture_filter (trilinear / EWA) instead of level-0 bilinear."""
    if mats is None:
        mats = scene.materials
    kd = _g(mats.kd, mid)
    if not getattr(cfg, "has_textures", False) or scene.textures is None:
        return kd
    from ..ops.texture import bilinear_lookup, ewa_lookup, trilinear_lookup

    atlas, offs, sizes = scene.textures
    tex_id = _g(mats.kd_tex, mid)
    tid = torch.clamp(tex_id, min=0)
    filt = getattr(cfg, "texture_filter", "bilinear")
    if duv is not None and filt == "ewa":
        val = ewa_lookup(atlas, offs, sizes, tid, uv, duv[0], duv[1])
    elif duv is not None and filt == "trilinear":
        # isotropic width = max footprint extent
        width = torch.maximum(
            torch.amax(torch.abs(duv[0]), dim=-1),
            torch.amax(torch.abs(duv[1]), dim=-1))
        val = trilinear_lookup(atlas, offs, sizes, tid, uv, width)
    else:
        val = bilinear_lookup(atlas, offs, sizes, tid, uv)
    return torch.where((tex_id >= 0)[..., None], val, kd)


_GLOSSY_EVAL = (MAT_METAL, MAT_PLASTIC, MAT_GLASS, MAT_DISNEY)
_GLOSSY_SAMPLE = (MAT_METAL, MAT_PLASTIC, MAT_DISNEY)


def _matte(mats, mid, wo, wi, kd_override):
    kd = kd_override if kd_override is not None else _g(mats.kd, mid)
    sigma = _g(mats.sigma, mid)
    f_on = bxdf.oren_nayar_f(wo, wi, kd, sigma)
    f_lam = bxdf.lambert_f(wo, wi, kd)
    return (torch.where((sigma > 0)[..., None], f_on, f_lam),
            bxdf.lambert_pdf(wo, wi))


def evaluate(mats: MaterialTable, mid, cfg, wo, wi, kd_override=None):
    """f and pdf over non-specular lobes."""
    kind = _g(mats.kind, mid)
    n = kind.shape[0]
    f = torch.zeros((n, 3), dtype=torch.float32, device=kind.device)
    pdf = torch.zeros((n,), dtype=torch.float32, device=kind.device)

    if MAT_MATTE in cfg.mat_kinds:
        m = kind == MAT_MATTE
        f_m, p_m = _matte(mats, mid, wo, wi, kd_override)
        f = torch.where(m[..., None], f_m, f)
        pdf = torch.where(m, p_m, pdf)

    if any(k in cfg.mat_kinds for k in _GLOSSY_EVAL):
        from . import microfacet as mf

        f2, p2, mask2 = mf.evaluate_glossy(mats, mid, cfg, wo, wi, kd_override)
        f = torch.where(mask2[..., None], f2, f)
        pdf = torch.where(mask2, p2, pdf)

    return f, pdf


def sample(mats: MaterialTable, mid, cfg, wo, u2, uc, kd_override=None):
    """BSDF sampling dispatch.

    u2: (N,2) direction sample; uc: (N,) lobe-choice sample.
    """
    kind = _g(mats.kind, mid)
    n = kind.shape[0]
    dev = kind.device
    wi = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    weight = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    pdf = torch.zeros((n,), dtype=torch.float32, device=dev)
    f = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    spec = torch.zeros((n,), dtype=torch.bool, device=dev)
    trans = torch.zeros((n,), dtype=torch.bool, device=dev)
    eta = torch.ones((n,), dtype=torch.float32, device=dev)
    valid = torch.zeros((n,), dtype=torch.bool, device=dev)

    if MAT_MATTE in cfg.mat_kinds:
        m = kind == MAT_MATTE
        wi_m = bxdf.diffuse_sample_wi(wo, u2)
        f_m, p_m = _matte(mats, mid, wo, wi_m, kd_override)
        ok = p_m > 0
        w_m = f_m * (abs_cos_theta(wi_m)
                     / torch.clamp(p_m.detach(), min=1e-12))[..., None]
        wi = torch.where(m[..., None], wi_m, wi)
        weight = torch.where(m[..., None], w_m, weight)
        pdf = torch.where(m, p_m, pdf)
        f = torch.where(m[..., None], f_m, f)
        valid = valid | (m & ok)

    if MAT_MIRROR in cfg.mat_kinds:
        m = kind == MAT_MIRROR
        kr = _g(mats.kr, mid)
        wi_m, w_m = bxdf.specular_mirror_sample(wo, kr)
        wi = torch.where(m[..., None], wi_m, wi)
        weight = torch.where(m[..., None], w_m, weight)
        pdf = torch.where(m, 1.0, pdf)
        spec = spec | m
        valid = valid | m

    if MAT_GLASS in cfg.mat_kinds:
        # Smooth glass: one stochastic reflect/transmit delta lobe
        m = kind == MAT_GLASS
        kr = _g(mats.kr, mid)
        kt = _g(mats.kt, mid)
        eta_b = _g(mats.eta, mid)
        wi_m, w_r, w_t, choose_r, p_m, refr_ok = bxdf.fresnel_specular_sample(
            wo, uc, torch.ones_like(eta_b), eta_b)
        p_safe = torch.clamp(p_m, min=1e-12)
        w_m = torch.where(choose_r[..., None], kr * (w_r / p_safe)[..., None],
                          kt * (w_t / p_safe)[..., None])
        ok = choose_r | refr_ok
        wi = torch.where(m[..., None], wi_m, wi)
        weight = torch.where(m[..., None], w_m, weight)
        pdf = torch.where(m, p_m, pdf)
        spec = spec | m
        trans = trans | (m & ~choose_r)
        eta = torch.where(m, eta_b, eta)
        valid = valid | (m & ok)

    if any(k in cfg.mat_kinds for k in _GLOSSY_SAMPLE):
        # rough glass comes through here too when a scene also holds one of
        # these kinds, exactly as in the JAX package
        from . import microfacet as mf

        smp2, mask2 = mf.sample_glossy(mats, mid, cfg, wo, u2, uc, kd_override)
        wi = torch.where(mask2[..., None], smp2.wi, wi)
        weight = torch.where(mask2[..., None], smp2.weight, weight)
        pdf = torch.where(mask2, smp2.pdf, pdf)
        f = torch.where(mask2[..., None], smp2.f, f)
        spec = torch.where(mask2, smp2.specular, spec)
        trans = torch.where(mask2, smp2.transmission, trans)
        eta = torch.where(mask2, smp2.eta, eta)
        valid = torch.where(mask2, smp2.valid, valid)

    return BsdfSample(wi, weight, pdf, f, spec, trans, eta, valid)
