"""Light sampling as masked table dispatch over the LightTable.

A per-lane light index gathers a row of the table; every light *kind*
present in the scene is evaluated branchlessly and combined with
where-masks.  Kinds: point (0), spot (1), distant (2), diffuse area (3),
the HDR environment map (4) and skybox (5).

Parity note: the reference renderer's diffuse area light emits whenever
dot(n, w) is nonzero (a bool-conversion bug that makes it effectively
two-sided).  It is replicated when cfg.reference_area_bug is on (default),
since the default scenes depend on it for the visible light patch.
"""

from typing import NamedTuple

import torch

from ..constants import INV_2PI, INV_PI, PI
from ..ops.sampling import (
    Distribution2D, pdf_2d, sample_continuous_2d_idx, uniform_sample_triangle,
)
from ..ops.table import gather_rows
from ..scene.scene import (
    LIGHT_AREA, LIGHT_DISTANT, LIGHT_INFINITE, LIGHT_POINT, LIGHT_SKYBOX,
    LIGHT_SPOT, Scene,
)
from ..utils.math import (
    cross, dot, length, normalize, spherical_phi, spherical_theta,
)


class LightSample(NamedTuple):
    wi: torch.Tensor        # (N,3) world, unit
    pdf: torch.Tensor       # (N,) solid-angle pdf (1 for delta lights)
    li: torch.Tensor        # (N,3) incident radiance (pre-visibility)
    target: torch.Tensor    # (N,3) point the shadow ray shoots to
    is_delta: torch.Tensor  # (N,) bool
    is_infinite: torch.Tensor  # (N,) bool (shadow ray is unbounded)


class LightRow(NamedTuple):
    """All per-light attributes for each lane."""
    kind: torch.Tensor
    pos: torch.Tensor
    emit: torch.Tensor
    axis: torch.Tensor
    two_sided: torch.Tensor
    cos_falloff: torch.Tensor
    cos_total: torch.Tensor
    p0: torch.Tensor  # area-light triangle vertices (zeros for non-area)
    p1: torch.Tensor
    p2: torch.Tensor


def light_rows(scene: Scene, light_idx) -> LightRow:
    """Per-lane rows of the light table, by plain index gathers."""
    L = scene.lights
    g = scene.geom
    li = light_idx.long()
    tri_id = L.tri[li]
    has_tri = (tri_id >= 0)[:, None].to(torch.float32)
    tv = g.triangles[torch.clamp(tri_id, min=0).long()].long()
    return LightRow(
        kind=L.kind[li], pos=L.pos[li], emit=gather_rows(L.emit, li),
        axis=L.axis[li],
        two_sided=L.two_sided[li], cos_falloff=L.cos_falloff[li],
        cos_total=L.cos_total[li],
        p0=g.vertices[tv[:, 0]] * has_tri,
        p1=g.vertices[tv[:, 1]] * has_tri,
        p2=g.vertices[tv[:, 2]] * has_tri,
    )


def area_light_emitted(scene: Scene, light_idx, n_light, w,
                       reference_bug=True, row: LightRow = None):
    """Radiance leaving a diffuse area light's surface toward w.

    light_idx: (N,) int32 (valid rows); n_light: (N,3) light-surface normal.
    """
    if row is not None:
        lemit = row.emit
        two_sided = row.two_sided > 0.5
    else:
        lemit = gather_rows(scene.lights.emit, light_idx)
        two_sided = scene.lights.two_sided[light_idx.long()] > 0.5
    d = dot(n_light, w)
    if reference_bug:
        emits = two_sided | (d != 0.0)
    else:
        emits = two_sided | (d > 0.0)
    return torch.where(emits[..., None], lemit, 0.0)


def _tri_normal_area(p0, p1, p2):
    c = cross(p1 - p0, p2 - p0)
    return normalize(c), 0.5 * length(c)


def skybox_le(scene: Scene, o, d):
    """Skybox radiance with no image data: a position gradient on the
    world sphere."""
    wc = scene.world_center
    wr = scene.world_radius
    oc = o - wc
    a = dot(d, d)
    b = 2.0 * dot(oc, d)
    c = dot(oc, oc) - wr * wr
    disc = b * b - 4 * a * c
    hit = disc >= 0.0
    t = (-b + torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
    hp = oc + t[..., None] * d  # relative to center
    col = (hp + wr) / (2.0 * wr)
    return torch.where(hit[..., None], col, 0.0)


def _env_texel(env, d):
    """(iv, iu, theta) of world direction d in the equirect map."""
    w = normalize(d @ env.world_to_light[:3, :3].T)
    theta = spherical_theta(w)
    u = spherical_phi(w) * INV_2PI
    v = theta * INV_PI
    h, wd = env.image.shape[:2]
    iu = torch.clamp((u * wd).to(torch.int64), 0, wd - 1)
    iv = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return iv, iu, theta


def _env_pdf(map_pdf, sin_theta):
    return torch.where(
        sin_theta > 0,
        map_pdf / (2.0 * PI * PI * torch.clamp(sin_theta, min=1e-8)), 0.0)


def envmap_le(scene: Scene, d):
    """Environment radiance along d: equirect texel lookup."""
    iv, iu, _ = _env_texel(scene.env, d)
    return scene.env.image[iv, iu]


def envmap_le_pdf(scene: Scene, d):
    """Environment radiance AND the light-sampling pdf of direction d from
    ONE (N, 4) gather of the packed [rgb, func/marg_int] table and one
    spherical-trig pass."""
    iv, iu, theta = _env_texel(scene.env, d)
    row = scene.env.le_func[iv, iu]
    return row[..., 0:3], _env_pdf(row[..., 3], torch.sin(theta))


def escaped_radiance(scene: Scene, cfg, o, d):
    """Sum of infinite-light Le for escaped rays."""
    le = torch.zeros_like(d)
    if cfg.has_skybox:
        le = le + skybox_le(scene, o, d)
    if cfg.has_env:
        le = le + envmap_le(scene, d)
    return le


def _env_distribution(env):
    return Distribution2D(env.cond_func, env.cond_cdf, env.cond_int,
                          env.marg_cdf, env.marg_int)


def sample_li(scene: Scene, cfg, light_idx, p, u2):
    """Dispatch light sampling over the table for each lane.

    light_idx: (N,) int32; p: (N,3) shading point; u2: (N,2).
    """
    row = light_rows(scene, light_idx)
    kind = row.kind
    pos = row.pos
    emit = row.emit
    axis = row.axis

    n = p.shape[0]
    wi = torch.zeros_like(p)
    pdf = torch.zeros((n,), dtype=torch.float32, device=p.device)
    li = torch.zeros_like(p)
    target = torch.zeros_like(p)
    is_delta = torch.zeros((n,), dtype=torch.bool, device=p.device)
    is_inf = torch.zeros((n,), dtype=torch.bool, device=p.device)

    if cfg.has_point_like:
        # point light: I / r^2
        to_l = pos - p
        d2 = torch.clamp(dot(to_l, to_l), min=1e-12)
        w = to_l / torch.sqrt(d2)[..., None]
        li_pt = emit / d2[..., None]
        m = kind == LIGHT_POINT
        wi = torch.where(m[..., None], w, wi)
        pdf = torch.where(m, 1.0, pdf)
        li = torch.where(m[..., None], li_pt, li)
        target = torch.where(m[..., None], pos, target)
        is_delta = is_delta | m

        # spot light: cone falloff on I/r^2
        m = kind == LIGHT_SPOT
        if cfg.has_spot:
            cos_f = row.cos_falloff
            cos_t = row.cos_total
            ct = dot(axis, -w)
            delta = torch.clamp(
                (ct - cos_t) / torch.clamp(cos_f - cos_t, min=1e-8), 0.0, 1.0)
            falloff = torch.where(
                ct < cos_t, 0.0,
                torch.where(ct > cos_f, 1.0, (delta * delta) * (delta * delta)))
            wi = torch.where(m[..., None], w, wi)
            pdf = torch.where(m, 1.0, pdf)
            li = torch.where(m[..., None], li_pt * falloff[..., None], li)
            target = torch.where(m[..., None], pos, target)
            is_delta = is_delta | m

    if cfg.has_distant:
        # distant light: w = -wLight, target outside the world bounds
        m = kind == LIGHT_DISTANT
        w = normalize(-axis)
        tgt = p + w * (2.0 * scene.world_radius)
        wi = torch.where(m[..., None], w, wi)
        pdf = torch.where(m, 1.0, pdf)
        li = torch.where(m[..., None], emit, li)
        target = torch.where(m[..., None], tgt, target)
        is_delta = is_delta | m

    if cfg.has_area:
        # diffuse area light via uniform triangle sampling; area pdf ->
        # solid-angle pdf
        m = kind == LIGHT_AREA
        p0, p1, p2 = row.p0, row.p1, row.p2
        b = uniform_sample_triangle(u2)
        ps = b[..., 0:1] * p0 + b[..., 1:2] * p1 + (1.0 - b[..., 0:1] - b[..., 1:2]) * p2
        nl, area = _tri_normal_area(p0, p1, p2)
        to_l = ps - p
        d2 = dot(to_l, to_l)
        dist = torch.sqrt(torch.clamp(d2, min=1e-12))
        w = to_l / dist[..., None]
        cos_l = torch.abs(dot(nl, -w))
        pdf_sa = torch.where(
            (cos_l > 1e-8) & (d2 > 0),
            d2 / torch.clamp(cos_l * area, min=1e-12), 0.0)
        l_val = area_light_emitted(scene, light_idx, nl, -w,
                                   cfg.reference_area_bug, row)
        wi = torch.where(m[..., None], w, wi)
        pdf = torch.where(m, pdf_sa, pdf)
        li = torch.where(m[..., None], l_val, li)
        target = torch.where(m[..., None], ps, target)

    if cfg.has_skybox:
        # skybox: uniform direction, pdf 1/4pi, black radiance (no image)
        m = kind == LIGHT_SKYBOX
        theta = u2[..., 1] * PI
        phi = u2[..., 0] * 2.0 * PI
        st, ct = torch.sin(theta), torch.cos(theta)
        w = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
        wi = torch.where(m[..., None], w, wi)
        pdf = torch.where(m, 1.0 / (4.0 * PI), pdf)
        li = torch.where(m[..., None], 0.0, li)
        target = torch.where(m[..., None],
                             p + w * (2.0 * scene.world_radius), target)
        is_inf = is_inf | m

    if cfg.has_env:
        # environment map: 2D CDF importance sample -> (theta, phi),
        # pdf / (2 pi^2 sin).  The sampled integer texel serves radiance AND
        # the map pdf from one packed-row gather (le_func[..., 3] ==
        # func/marg_int == the 2D distribution's pdf at that texel).
        m = kind == LIGHT_INFINITE
        env = scene.env
        uv, iv, iu = sample_continuous_2d_idx(_env_distribution(env), u2)
        erow = env.le_func[iv.long(), iu.long()]
        theta = uv[..., 1] * PI
        phi = uv[..., 0] * 2.0 * PI
        st, ct = torch.sin(theta), torch.cos(theta)
        w_light = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct],
                              dim=-1)
        w = w_light @ env.light_to_world[:3, :3].T
        wi = torch.where(m[..., None], w, wi)
        pdf = torch.where(m, _env_pdf(erow[..., 3], st), pdf)
        li = torch.where(m[..., None], erow[..., 0:3], li)
        target = torch.where(m[..., None],
                             p + w * (2.0 * scene.world_radius), target)
        is_inf = is_inf | m

    return LightSample(wi, pdf, li, target, is_delta, is_inf)


def pdf_li(scene: Scene, cfg, light_idx, p, wi):
    """Solid-angle pdf of the chosen light sampling direction wi (the
    BSDF-side MIS weight).  Delta lights return 0, and so does the skybox,
    which makes the BSDF side skip it for non-specular lobes."""
    row = light_rows(scene, light_idx)
    pdf = torch.zeros(p.shape[0], dtype=torch.float32, device=p.device)

    if cfg.has_area:
        # re-intersect the specific light triangle
        m = row.kind == LIGHT_AREA
        p0, p1, p2 = row.p0, row.p1, row.p2
        valid, t = _single_tri_hit(p, wi, p0, p1, p2)
        nl, area = _tri_normal_area(p0, p1, p2)
        dist2 = t * t  # wi unit
        cos_l = torch.abs(dot(nl, -wi))
        pdf_sa = torch.where(
            valid & (cos_l > 1e-8),
            dist2 / torch.clamp(cos_l * area, min=1e-12), 0.0)
        pdf = torch.where(m, pdf_sa, pdf)

    if cfg.has_env:
        m = row.kind == LIGHT_INFINITE
        env = scene.env
        w_l = normalize(wi @ env.world_to_light[:3, :3].T)
        theta = spherical_theta(w_l)
        uv = torch.stack([spherical_phi(w_l) * INV_2PI, theta * INV_PI], dim=-1)
        p2 = pdf_2d(_env_distribution(env), uv)
        pdf = torch.where(m, _env_pdf(p2, torch.sin(theta)), pdf)

    return pdf


def _single_tri_hit(o, d, p0, p1, p2):
    """Per-lane Moller-Trumbore against one triangle each (for the pdf
    re-intersection; watertightness not needed for a pdf estimate)."""
    e1 = p1 - p0
    e2 = p2 - p0
    pv = cross(d, e2)
    det = dot(e1, pv)
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tv = o - p0
    u = dot(tv, pv) * inv_det
    qv = cross(tv, e1)
    v = dot(d, qv) * inv_det
    t = dot(e2, qv) * inv_det
    valid = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4)
    return valid, t
