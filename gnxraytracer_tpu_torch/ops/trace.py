"""Scene-level ray casting: closest-hit and any-hit over all primitive
types, plus surface-interaction construction.

A hit record is SoA tensors carrying prim ids; the surface interaction
gathers positions/normals/uv, applies the bump map and builds the shading
frame.  With cfg.use_bvh the triangle casts walk the scene's width-8 BVH
table (kernels/wide_bvh.py) or its binary threaded one
(kernels/packet_bvh.py), or take the per-lane walks of ops/bvh.py
(bvh_mode "stack" / "stackless").  The brute-force casts (every triangle of
a scene without a BVH, the big triangles kept out of one) go through the two
kernels of kernels/closest_hit.py, closest and any hit, where the
configuration asks for kernels.  Instanced copies of a base mesh
(cfg.n_inst > 0) are cast in each instance's object space
(ops/instancing.py): through the binary threaded-BVH kernels when the base
mesh has a tree, else through the brute-force ones, where the configuration
asks for kernels.
The JAX package fetches per-triangle attributes with a one-hot matmul (a
TPU device); plain index gathers give the same values here.
"""

from typing import NamedTuple

import torch

from ..constants import INFINITY, PI, gamma
from ..utils.math import coordinate_system, cross, dot, face_forward, normalize
from ..utils.stats import spanned
from ..utils.transform import mat_vec
from . import bvh, intersect

PRIM_NONE = -1
PRIM_TRI = 0
PRIM_SPH = 1
PRIM_INST = 2  # instanced base-mesh triangle; prim = inst * n_inst_tris + tri


class Hit(NamedTuple):
    hit: torch.Tensor       # (N,) bool
    t: torch.Tensor         # (N,)
    kind: torch.Tensor      # (N,) int32: PRIM_TRI / PRIM_SPH / PRIM_INST
    prim: torch.Tensor      # (N,) int32 triangle, sphere or instance code
    b: torch.Tensor         # (N,3) triangle barycentrics


class Interaction(NamedTuple):
    p: torch.Tensor         # (N,3) hit point
    p_err: torch.Tensor     # (N,3) conservative position error bound
    ng: torch.Tensor        # (N,3) geometric normal
    ns: torch.Tensor        # (N,3) shading normal
    ss: torch.Tensor        # (N,3) shading tangent (dpdu orthogonalized)
    ts: torch.Tensor        # (N,3) shading bitangent
    uv: torch.Tensor        # (N,2)
    wo: torch.Tensor        # (N,3) world, toward viewer
    mat: torch.Tensor       # (N,) int32 material id
    light: torch.Tensor     # (N,) int32 area light id or -1


def _bvh_mode(cfg):
    return cfg.bvh_mode if cfg.bvh_stackless else "stack"


def _brute_force(scene, cfg, o, d, t_max, any_hit=False, tri_idx=None):
    """Brute-force cast of the scene's triangles (or those of tri_idx): the
    closest hit (TriHit) or, with any_hit, occlusion ((N,) bool).  Through
    the hand-written kernels' wrappers (kernels/closest_hit.py: the kernel
    on CUDA tensors, the plain version on CPU tensors) where the
    configuration asks for kernels: cfg.use_pallas in a scene without a
    BVH, bvh_mode "pallas" for the big triangles kept out of a BVH; else
    the plain loops."""
    from ..kernels import closest_hit as ch

    g = scene.geom
    tris = g.triangles if tri_idx is None else g.triangles[tri_idx.long()]
    kernels = (_bvh_mode(cfg) == "pallas" if cfg.use_bvh
               else getattr(cfg, "use_pallas", False))
    if not kernels:
        cast = (intersect.any_triangle_hit if any_hit
                else intersect.closest_triangle_hit)
        return cast(o, d, t_max, g.vertices, tris)
    cast = ch.any_hit if any_hit else ch.closest_hit
    t_max = intersect._lane_t_max(t_max, o.shape[0], o.device)
    return cast(o.contiguous(), d.contiguous(), t_max.contiguous(),
                ch.tri_soa_from_mesh(g.vertices, tris))


def _instances(scene, cfg):
    """The scene's instanced geometry, its transform table, and whether its
    casts go through the kernels' wrappers: where the configuration asks for
    kernels (cfg.use_pallas, or bvh_mode "pallas")."""
    from . import instancing

    ig = scene.instanced
    if ig is None:
        raise ValueError("cfg.n_inst > 0 needs a scene with instances "
                         "(SceneBuilder.add_instances)")
    kernels = getattr(cfg, "use_pallas", False) or cfg.bvh_mode == "pallas"
    return ig, instancing.InstanceTable(ig.obj_to_world, ig.world_to_obj), \
        kernels


def _bvh_casts(scene, cfg):
    """(closest, any) cast functions (o, d, t_max) -> result over the scene's
    BVH for cfg.bvh_mode: "pallas" is the hand-written kernels' wrappers
    (kernel on CUDA tensors, plain version on CPU tensors), "packet" the
    plain walks of those kernels on any device.  Which tree they walk
    follows the JAX package's rule (kernels/packet_bvh._use_wide): the
    width-8 table, or with GNX_WIDE_BVH=0 in the environment the binary
    threaded one.  "stackless" and "stack" (or cfg.bvh_stackless=False) are
    the per-lane walks of ops/bvh.py over the binary tree, plain PyTorch on
    any device: the threaded walk from the packed leaf rows, and the stack
    walk through the scene's vertex and triangle lists."""
    from ..kernels import packet_bvh, wide_bvh

    if scene.bvh is None:
        raise ValueError("cfg.use_bvh needs a scene built with bvh=True")

    mode = _bvh_mode(cfg)
    tree = scene.bvh
    if mode == "stackless":
        return (lambda o, d, t: bvh.bvh_closest_hit_stackless(tree, o, d, t),
                lambda o, d, t: bvh.bvh_any_hit_stackless(tree, o, d, t))
    if mode == "stack":
        v, tris = scene.geom.vertices, scene.geom.triangles
        return (lambda o, d, t: bvh.bvh_closest_hit(tree, v, tris, o, d, t),
                lambda o, d, t: bvh.bvh_any_hit(tree, v, tris, o, d, t))
    if mode not in ("pallas", "packet"):
        raise ValueError(f"unknown bvh_mode {mode!r}")
    if packet_bvh._use_wide(scene.bvh):
        pack, mod = scene.bvh.wide, wide_bvh
        kernels = (mod.wide_closest_hit, mod.wide_any_hit)
        plain = (mod.wide_closest_hit_reference, mod.wide_any_hit_reference)
    else:
        pack, mod = scene.bvh.packet, packet_bvh
        kernels = (mod.packet_closest_hit, mod.packet_any_hit)
        plain = (mod.packet_closest_hit_reference,
                 mod.packet_any_hit_reference)
    if mode == "packet":
        closest, any_hit = plain
        return (lambda o, d, t: closest(pack, o, d, t),
                lambda o, d, t: any_hit(pack, o, d, t))
    key = cfg.sort_key
    closest, any_hit = kernels
    return (lambda o, d, t: closest(pack, o, d, t, sort_key=key),
            lambda o, d, t: any_hit(pack, o, d, t, sort_key=key))


def _merge_tri_hit(th, prim_of, t_best, hit, kind, prim, bary):
    better = th.hit & (th.t < t_best)
    return (torch.where(better, th.t, t_best), hit | better,
            torch.where(better, PRIM_TRI, kind),
            torch.where(better, prim_of(th.tri), prim),
            torch.where(better[..., None], th.b, bary))


@spanned("cast")
def scene_intersect(scene, cfg, o, d, t_max):
    """Closest hit across triangles, spheres and instances.  With
    cfg.use_bvh the triangle cast walks the BVH (a few huge triangles kept
    out of the tree are brute-forced first, and their hit t caps the walk);
    else the triangles are brute-forced (_brute_force says through what).
    Each cast starts from the best t found before it."""
    n = o.shape[0]
    dev = o.device
    t_best = intersect._lane_t_max(t_max, n, dev)
    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    kind = torch.full((n,), PRIM_NONE, dtype=torch.int32, device=dev)
    prim = torch.zeros((n,), dtype=torch.int32, device=dev)
    bary = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    state = (t_best, hit, kind, prim, bary)

    if cfg.n_tris > 0:
        if cfg.use_bvh:
            if getattr(cfg, "n_big", 0) > 0:
                big = scene.big_tri_idx
                bh = _brute_force(scene, cfg, o, d, state[0], tri_idx=big)
                state = _merge_tri_hit(bh, lambda i: big[i.long()], *state)
            closest, _ = _bvh_casts(scene, cfg)
            th = closest(o.contiguous(), d.contiguous(),
                         state[0].contiguous())
        else:
            th = _brute_force(scene, cfg, o, d, state[0])
        state = _merge_tri_hit(th, lambda i: i, *state)
    t_best, hit, kind, prim, bary = state

    if cfg.n_sphs > 0:
        sh = intersect.closest_sphere_hit(
            o, d, t_best, scene.geom.sph_center, scene.geom.sph_radius)
        better = sh.hit & (sh.t < t_best)
        t_best = torch.where(better, sh.t, t_best)
        hit = hit | better
        kind = torch.where(better, PRIM_SPH, kind)
        prim = torch.where(better, sh.sph, prim)

    if getattr(cfg, "n_inst", 0) > 0:
        from .instancing import instanced_closest_hit

        ig, table, kernels = _instances(scene, cfg)
        ih = instanced_closest_hit(ig.verts, ig.tris, table, o, d, t_best,
                                   bvh=ig.bvh, kernels=kernels)
        better = ih.hit & (ih.t < t_best)
        t_best = torch.where(better, ih.t, t_best)
        hit = hit | better
        kind = torch.where(better, PRIM_INST, kind)
        prim = torch.where(better, ih.inst * cfg.n_inst_tris + ih.tri, prim)
        bary = torch.where(better[..., None], ih.b, bary)

    return Hit(hit, torch.where(hit, t_best, INFINITY), kind, prim, bary)


@spanned("cast")
def scene_occluded(scene, cfg, o, d, t_max):
    """Any-hit (shadow ray).  With cfg.use_bvh the triangle cast walks the
    BVH; lanes that a big triangle already occludes skip the walk
    (t_max = 0).  The brute-force and instance casts go as in
    scene_intersect."""
    n = o.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    if cfg.n_tris > 0:
        if cfg.use_bvh:
            t_walk = intersect._lane_t_max(t_max, n, o.device)
            if getattr(cfg, "n_big", 0) > 0:
                occ = occ | _brute_force(scene, cfg, o, d, t_max, any_hit=True,
                                         tri_idx=scene.big_tri_idx)
                t_walk = torch.where(occ, 0.0, t_walk)
            _, any_hit = _bvh_casts(scene, cfg)
            occ = occ | any_hit(o.contiguous(), d.contiguous(),
                                t_walk.contiguous())
        else:
            occ = occ | _brute_force(scene, cfg, o, d, t_max, any_hit=True)
    if cfg.n_sphs > 0:
        ok, _ = intersect.ray_spheres(o, d, t_max, scene.geom.sph_center,
                                      scene.geom.sph_radius)
        occ = occ | torch.any(ok, dim=-1)
    if getattr(cfg, "n_inst", 0) > 0:
        from .instancing import instanced_any_hit

        ig, table, kernels = _instances(scene, cfg)
        occ = occ | instanced_any_hit(ig.verts, ig.tris, table, o, d, t_max,
                                      bvh=ig.bvh, kernels=kernels)
    return occ


def _tri_vertices(g, tri_idx):
    tri = g.triangles[tri_idx.long()].long()
    return tri, g.vertices[tri[:, 0]], g.vertices[tri[:, 1]], g.vertices[tri[:, 2]]


def tri_emission_attrs(scene, cfg, prim_idx):
    """(p0, p1, p2, light_id) of a triangle hit — the data the integrators
    need to evaluate emitted radiance at a BSDF-sampled hit."""
    g = scene.geom
    _, p0, p1, p2 = _tri_vertices(g, prim_idx)
    return p0, p1, p2, g.tri_light[prim_idx.long()]


def _shading_normal(g, tri, b, ng):
    """Interpolated shading normal (falling back to ng where degenerate)
    and ng flipped into its hemisphere."""
    n0, n1, n2 = g.normals[tri[:, 0]], g.normals[tri[:, 1]], g.normals[tri[:, 2]]
    ns = normalize(b[:, 0:1] * n0 + b[:, 1:2] * n1 + b[:, 2:3] * n2, eps=1e-20)
    degen = torch.sum(ns * ns, dim=-1) < 0.5
    ns = torch.where(degen[:, None], ng, ns)
    return ns, face_forward(ng, ns)


def tri_light_and_ng(scene, cfg, hit: Hit):
    """(light_id, ng) of a triangle hit — the only Interaction fields the
    emission term reads.  Matches make_interaction's ng exactly, including
    the shading-normal face_forward fixup."""
    g = scene.geom
    is_tri = hit.kind == PRIM_TRI
    tri_idx = torch.where(is_tri, hit.prim, 0)
    tri, p0, p1, p2 = _tri_vertices(g, tri_idx)
    light = g.tri_light[tri_idx.long()]
    ng = normalize(cross(p0 - p2, p1 - p2))
    if g.normals is not None:
        _, ng = _shading_normal(g, tri, hit.b, ng)
    return torch.where(is_tri, light, -1), ng


def make_interaction(scene, cfg, o, d, hit: Hit) -> Interaction:
    """Build the surface interaction for each (possibly invalid) lane."""
    g = scene.geom
    is_tri = hit.kind == PRIM_TRI
    tri_idx = torch.where(is_tri, hit.prim, 0)
    tri, p0, p1, p2 = _tri_vertices(g, tri_idx)
    b = hit.b
    # hit point from barycentrics, and its error bound gamma(7) * sum |bi pi|
    p_tri = b[:, 0:1] * p0 + b[:, 1:2] * p1 + b[:, 2:3] * p2
    p_err_tri = gamma(7) * (
        torch.abs(b[:, 0:1] * p0) + torch.abs(b[:, 1:2] * p1)
        + torch.abs(b[:, 2:3] * p2))
    ng_tri = normalize(cross(p0 - p2, p1 - p2))
    dpdu_tri = p1 - p0  # default UVs (0,0),(1,0),(1,1) -> dpdu = p1 - p0
    if g.uvs is not None:
        uv0, uv1, uv2 = g.uvs[tri[:, 0]], g.uvs[tri[:, 1]], g.uvs[tri[:, 2]]
        duv02 = uv0 - uv2
        duv12 = uv1 - uv2
        det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
        ok = torch.abs(det) > 1e-12
        inv = torch.where(ok, 1.0 / det, 0.0)
        dpdu_uv = (duv12[:, 1:2] * (p0 - p2) - duv02[:, 1:2] * (p1 - p2)) * inv[:, None]
        dpdu_tri = torch.where(ok[:, None], dpdu_uv, dpdu_tri)
        uv_tri = b[:, 0:1] * uv0 + b[:, 1:2] * uv1 + b[:, 2:3] * uv2
    else:
        # default UVs: uv = b0*(0,0) + b1*(1,0) + b2*(1,1)
        uv_tri = torch.stack([b[:, 1] + b[:, 2], b[:, 2]], dim=-1)
    if g.normals is not None:
        ns_tri, ng_tri = _shading_normal(g, tri, b, ng_tri)
    else:
        ns_tri = ng_tri
    mat_tri = g.tri_mat[tri_idx.long()]
    light_tri = g.tri_light[tri_idx.long()]
    return _finish_interaction(scene, cfg, o, d, hit, p_tri, p_err_tri,
                               ng_tri, ns_tri, dpdu_tri, uv_tri, mat_tri,
                               light_tri)


def _instanced_intermediates(scene, cfg, hit: Hit):
    """Triangle interaction intermediates of the instance-hit lanes: the
    base triangle's vertices go to world space through each lane's
    object-to-world matrix, its normals through the inverse-transpose, and
    then the world-space triangle formulas apply, as for a flattened copy.
    Instances carry no area light."""
    ig = scene.instanced
    code = torch.where(hit.kind == PRIM_INST, hit.prim, 0).long()
    inst = code // cfg.n_inst_tris
    tidx = code % cfg.n_inst_tris
    m = ig.obj_to_world[inst]        # (N,4,4)
    tv = ig.tris[tidx].long()

    def to_world_p(p):
        return mat_vec(m[:, :3, :3], p) + m[:, :3, 3]

    p0, p1, p2 = (to_world_p(ig.verts[tv[:, k]]) for k in range(3))
    b = hit.b
    p = b[:, 0:1] * p0 + b[:, 1:2] * p1 + b[:, 2:3] * p2
    p_err = gamma(7) * (
        torch.abs(b[:, 0:1] * p0) + torch.abs(b[:, 1:2] * p1)
        + torch.abs(b[:, 2:3] * p2))
    ng = normalize(cross(p0 - p2, p1 - p2))
    dpdu = p1 - p0
    if ig.uvs is not None:
        uv0, uv1, uv2 = (ig.uvs[tv[:, k]] for k in range(3))
        duv02 = uv0 - uv2
        duv12 = uv1 - uv2
        det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
        ok = torch.abs(det) > 1e-12
        inv = torch.where(ok, 1.0 / det, 0.0)
        dpdu_uv = (duv12[:, 1:2] * (p0 - p2) - duv02[:, 1:2] * (p1 - p2)) * inv[:, None]
        dpdu = torch.where(ok[:, None], dpdu_uv, dpdu)
        uv = b[:, 0:1] * uv0 + b[:, 1:2] * uv1 + b[:, 2:3] * uv2
    else:
        uv = torch.stack([b[:, 1] + b[:, 2], b[:, 2]], dim=-1)
    if ig.normals is not None:
        w2o_t = ig.world_to_obj[inst][:, :3, :3].transpose(-1, -2)
        n0, n1, n2 = (mat_vec(w2o_t, ig.normals[tv[:, k]]) for k in range(3))
        ns = normalize(b[:, 0:1] * n0 + b[:, 1:2] * n1 + b[:, 2:3] * n2,
                       eps=1e-20)
        degen = torch.sum(ns * ns, dim=-1) < 0.5
        ns = torch.where(degen[:, None], ng, ns)
        ng = face_forward(ng, ns)
    else:
        ns = ng
    over = ig.inst_mat[inst]
    mat = torch.where(over >= 0, over, ig.tri_mat[tidx])
    return p, p_err, ng, ns, dpdu, uv, mat, torch.full_like(mat, -1)


def _bump(scene, mat, uv, ns, dpdu):
    """Bump mapping: the shading normal displaced by forward differences
    (half a texel of the top mip level) of the material's height texture
    in uv.  Returns (ns, dpdu)."""
    from .texture import bilinear_lookup

    atlas, offs, sizes = scene.textures
    mi = torch.clamp(mat, min=0).long()
    b_tex = scene.materials.bump_tex[mi]
    b_scale = scene.materials.bump_scale[mi]
    has_b = (b_tex >= 0)[:, None]
    tid = torch.clamp(b_tex, min=0)
    du = 0.5 / sizes[0].to(torch.float32)
    step_u = torch.stack([du, torch.zeros_like(du)])
    step_v = torch.stack([torch.zeros_like(du), du])
    h0 = bilinear_lookup(atlas, offs, sizes, tid, uv)[..., 0]
    hu = bilinear_lookup(atlas, offs, sizes, tid, uv + step_u)[..., 0]
    hv = bilinear_lookup(atlas, offs, sizes, tid, uv + step_v)[..., 0]
    dhdu = (hu - h0) / du * b_scale
    dhdv = (hv - h0) / du * b_scale
    # perturbed frame: dpdu' = dpdu + dh/du * ns; dpdv' = ts0 + dh/dv * ns
    ts0 = cross(ns, normalize(dpdu, eps=1e-20))
    dpdu_b = dpdu + dhdu[:, None] * ns
    dpdv_b = ts0 + dhdv[:, None] * ns
    ns_b = face_forward(normalize(cross(dpdu_b, dpdv_b), eps=1e-20), ns)
    return torch.where(has_b, ns_b, ns), torch.where(has_b, dpdu_b, dpdu)


def _finish_interaction(scene, cfg, o, d, hit, p_tri, p_err_tri, ng_tri,
                        ns_tri, dpdu_tri, uv_tri, mat_tri, light_tri):
    g = scene.geom
    if getattr(cfg, "n_inst", 0) > 0:
        inst = _instanced_intermediates(scene, cfg, hit)
        im = hit.kind == PRIM_INST
        imc = im[:, None]
        p_tri, p_err_tri, ng_tri, ns_tri, dpdu_tri, uv_tri = (
            torch.where(imc, a, b) for a, b in zip(
                inst[:6], (p_tri, p_err_tri, ng_tri, ns_tri, dpdu_tri, uv_tri)))
        mat_tri = torch.where(im, inst[6], mat_tri)
        light_tri = torch.where(im, inst[7], light_tri)
    if cfg.n_sphs > 0:
        is_sph = hit.kind == PRIM_SPH
        sph_idx = torch.where(is_sph, hit.prim, 0).long()
        c = g.sph_center[sph_idx]
        r = g.sph_radius[sph_idx]
        p_s = o + hit.t[:, None] * d
        # reproject onto the sphere (pbrt sphere hit refinement)
        rel = p_s - c
        rel = rel * (r / torch.clamp(torch.sqrt(torch.sum(rel * rel, -1)),
                                     min=1e-12))[:, None]
        p_sph = c + rel
        ng_sph = normalize(rel)
        # spherical uv + dpdu = (-y, x, 0) * 2pi
        phi = torch.atan2(rel[:, 1], rel[:, 0])
        phi = torch.where(phi < 0, phi + 2 * PI, phi)
        theta = torch.acos(torch.clamp(rel[:, 2] / torch.clamp(r, min=1e-12),
                                       -1.0, 1.0))
        uv_sph = torch.stack([phi / (2 * PI), theta / PI], dim=-1)
        dpdu_sph = torch.stack([-rel[:, 1], rel[:, 0], torch.zeros_like(r)],
                               dim=-1)
        p_err_sph = gamma(5) * torch.abs(p_sph)

        pick = is_sph[:, None]
        p = torch.where(pick, p_sph, p_tri)
        p_err = torch.where(pick, p_err_sph, p_err_tri)
        ng = torch.where(pick, ng_sph, ng_tri)
        ns = torch.where(pick, ng_sph, ns_tri)
        dpdu = torch.where(pick, dpdu_sph, dpdu_tri)
        uv = torch.where(pick, uv_sph, uv_tri)
        mat = torch.where(is_sph, g.sph_mat[sph_idx], mat_tri)
        light = torch.where(is_sph, g.sph_light[sph_idx], light_tri)
    else:
        p, p_err, ng, ns, dpdu, uv, mat, light = (
            p_tri, p_err_tri, ng_tri, ns_tri, dpdu_tri, uv_tri, mat_tri,
            light_tri)

    if getattr(cfg, "has_bump", False) and scene.textures is not None:
        ns, dpdu = _bump(scene, mat, uv, ns, dpdu)

    # shading frame: ss = normalized dpdu orthogonalized against ns
    ss = dpdu - ns * torch.sum(ns * dpdu, dim=-1, keepdim=True)
    len2 = torch.sum(ss * ss, dim=-1)
    ss_cs, _ = coordinate_system(ns)
    ss = torch.where((len2 > 1e-12)[:, None], ss * _rsqrt(len2)[:, None], ss_cs)
    ts = cross(ns, ss)

    return Interaction(
        p=p, p_err=p_err, ng=ng, ns=ns, ss=ss, ts=ts, uv=uv,
        wo=normalize(-d), mat=mat, light=light,
    )


def _rsqrt(x):
    return 1.0 / torch.sqrt(torch.clamp(x, min=1e-24))


def triangle_dpduv(scene, hit: Hit):
    """Parametric partials dpdu/dpdv of the hit triangle from its UV chart."""
    g = scene.geom
    tri_idx = torch.where(hit.kind == PRIM_TRI, hit.prim, 0)
    tri, p0, p1, p2 = _tri_vertices(g, tri_idx)
    if g.uvs is not None:
        uv0, uv1, uv2 = g.uvs[tri[:, 0]], g.uvs[tri[:, 1]], g.uvs[tri[:, 2]]
    else:
        uv0 = torch.zeros((tri.shape[0], 2), dtype=torch.float32,
                          device=p0.device)
        uv1 = torch.tensor([1.0, 0.0], device=p0.device).expand_as(uv0)
        uv2 = torch.tensor([1.0, 1.0], device=p0.device).expand_as(uv0)
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    dp02 = p0 - p2
    dp12 = p1 - p2
    det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
    ok = torch.abs(det) > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)[:, None]
    dpdu = (duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12) * inv
    dpdv = (-duv12[:, 0:1] * dp02 + duv02[:, 0:1] * dp12) * inv
    # degenerate chart: orthonormal fallback
    ng = normalize(cross(dp02, dp12), eps=1e-20)
    fb_u, fb_v = coordinate_system(ng)
    bad = ~ok[:, None]
    return torch.where(bad, fb_u, dpdu), torch.where(bad, fb_v, dpdv)


def compute_differentials(p, n, dpdu, dpdv, rd, return_dp=False):
    """Texture-space footprint of a camera ray: intersect the two auxiliary
    rays with the tangent plane, then solve the 2x2 system for (du,dv) per
    axis.

    rd: camera.RayDifferentials.  Returns (duvdx (N,2), duvdy (N,2)); with
    return_dp also (dpdx (N,3), dpdy (N,3)), the surface footprint."""
    d_plane = dot(n, p)

    def aux(o_a, d_a):
        denom = dot(n, d_a)
        small = torch.abs(denom) < 1e-9
        t = -(dot(n, o_a) - d_plane) / torch.where(
            small, torch.where(denom < 0, -1e-9, 1e-9), denom)
        return o_a + t[:, None] * d_a, ~small

    px, okx = aux(rd.rx_o, rd.rx_d)
    py, oky = aux(rd.ry_o, rd.ry_d)
    dpdx = px - p
    dpdy = py - p

    # choose the two coordinate dims where |n| is smallest
    an = torch.abs(n)
    use_yz = (an[:, 0] > an[:, 1]) & (an[:, 0] > an[:, 2])
    use_xz = ~use_yz & (an[:, 1] > an[:, 2])

    def pick2(v):
        a = torch.where(use_yz, v[:, 1], v[:, 0])
        b = torch.where(use_yz | use_xz, v[:, 2], v[:, 1])
        return a, b

    a00, a10 = pick2(dpdu)
    a01, a11 = pick2(dpdv)
    det = a00 * a11 - a01 * a10
    ok = torch.abs(det) > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)

    def solve(b):
        b0, b1 = pick2(b)
        du = (a11 * b0 - a01 * b1) * inv
        dv = (a00 * b1 - a10 * b0) * inv
        return torch.stack([du, dv], -1)

    duvdx = torch.where(okx[:, None], solve(dpdx), 0.0)
    duvdy = torch.where(oky[:, None], solve(dpdy), 0.0)
    if return_dp:
        return (duvdx, duvdy, torch.where(okx[:, None], dpdx, 0.0),
                torch.where(oky[:, None], dpdy, 0.0))
    return duvdx, duvdy


def to_local(it: Interaction, v):
    """World -> shading frame."""
    return torch.stack([dot(v, it.ss), dot(v, it.ts), dot(v, it.ns)], dim=-1)


def to_world(it: Interaction, v):
    return v[..., 0:1] * it.ss + v[..., 1:2] * it.ts + v[..., 2:3] * it.ns


def offset_ray_origin(p, p_err, ng, w):
    """Robust ray-origin offset: move along ng by the projected error
    bound, toward the side of w."""
    dist = torch.sum(torch.abs(ng) * p_err, dim=-1, keepdim=True) + 1e-5
    offset = dist * ng
    offset = torch.where(torch.sum(w * ng, dim=-1, keepdim=True) < 0,
                         -offset, offset)
    return p + offset


def spawn_ray(it: Interaction, w):
    return offset_ray_origin(it.p, it.p_err, it.ng, w), w


def shadow_ray(it: Interaction, target, is_infinite):
    """Ray toward a light sample point; returns (o, d_unit, t_max)."""
    o = offset_ray_origin(it.p, it.p_err, it.ng, target - it.p)
    to_t = target - o
    dist = torch.sqrt(torch.clamp(torch.sum(to_t * to_t, -1), min=1e-20))
    d = to_t / dist[:, None]
    t_max = torch.where(is_infinite, INFINITY, dist * (1.0 - 1e-3))
    return o, d, t_max
