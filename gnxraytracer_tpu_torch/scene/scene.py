"""Scene as NamedTuples of SoA device tensors.

Flat tables replace a pointer-based object graph: triangles carry int32 ids
into the material / light tables and hit records gather per-hit parameters
by id.  Field names are those of the JAX package's scene tables, so state
carries across by name (see convert.py).

Triangle meshes, spheres, instanced copies of one base mesh, every material
kind, point / spot / distant / area / environment-map / skybox lights, image
textures (and bump maps), homogeneous and grid media behind null-material
boundaries, the SAH BVH build (with big-prim separation) and the LBVH build
(ops/lbvh.py).
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.stats import span, spanned

# Material kinds (models/materials.py implements their lobe assemblies)
MAT_MATTE = 0
MAT_MIRROR = 1
MAT_GLASS = 2
MAT_METAL = 3
MAT_PLASTIC = 4
MAT_DISNEY = 5

# Light kinds
LIGHT_POINT = 0
LIGHT_SPOT = 1
LIGHT_DISTANT = 2
LIGHT_AREA = 3
LIGHT_INFINITE = 4
LIGHT_SKYBOX = 5


class Geometry(NamedTuple):
    vertices: torch.Tensor        # (V,3) f32, world space (pre-transformed)
    triangles: torch.Tensor       # (T,3) i32
    normals: Optional[torch.Tensor]   # (V,3) shading normals or None
    uvs: Optional[torch.Tensor]       # (V,2) or None
    tri_mat: torch.Tensor         # (T,) i32 material id (-1 = null boundary)
    tri_light: torch.Tensor       # (T,) i32 area-light id or -1
    tri_medium: torch.Tensor      # (T,2) i32 [inside, outside] medium or -1
    sph_center: torch.Tensor      # (S,3)
    sph_radius: torch.Tensor      # (S,)
    sph_mat: torch.Tensor         # (S,) i32
    sph_light: torch.Tensor       # (S,) i32
    sph_medium: torch.Tensor      # (S,2) i32 [inside, outside]


class InstancedGeom(NamedTuple):
    """One object-space base mesh and I rows of object<->world matrices.
    Casts run in object space (ops/instancing.py); the interaction
    transforms the hit triangle's vertices and normals back to world space
    (ops/trace.py)."""
    verts: torch.Tensor          # (V,3) f32 object space
    tris: torch.Tensor           # (T,3) i32
    normals: Optional[torch.Tensor]  # (V,3) object-space shading normals
    uvs: Optional[torch.Tensor]      # (V,2)
    tri_mat: torch.Tensor        # (T,) i32 base material per triangle
    obj_to_world: torch.Tensor   # (I,4,4)
    world_to_obj: torch.Tensor   # (I,4,4)
    inst_mat: torch.Tensor       # (I,) i32 per-instance material override, -1
    bvh: Optional[tuple]         # BVH over the base mesh (ops/bvh.py) or None


class MediumTable(NamedTuple):
    """Participating media.  kind 0 = homogeneous; kind 1 = grid density
    (the rows of kind 1 share the scene's one grid)."""
    kind: torch.Tensor      # (K,) i32
    sigma_a: torch.Tensor   # (K,3)
    sigma_s: torch.Tensor   # (K,3)
    g: torch.Tensor         # (K,) Henyey-Greenstein asymmetry
    density: Optional[torch.Tensor]   # (nz,ny,nx) or None
    world_to_medium: torch.Tensor     # (K,4,4)
    inv_max_density: torch.Tensor     # (K,)


class MaterialTable(NamedTuple):
    """One row per material; columns cover the union of the material
    parameter sets.  Unused columns are zero."""
    kind: torch.Tensor      # (M,) i32
    kd: torch.Tensor        # (M,3) diffuse / base color
    sigma: torch.Tensor     # (M,) Oren-Nayar sigma (degrees)
    kr: torch.Tensor        # (M,3) specular reflect scale
    kt: torch.Tensor        # (M,3) specular transmit scale
    ks: torch.Tensor        # (M,3) glossy scale
    eta: torch.Tensor       # (M,) dielectric IOR
    eta3: torch.Tensor      # (M,3) conductor eta
    k3: torch.Tensor        # (M,3) conductor absorption
    rough_u: torch.Tensor   # (M,)
    rough_v: torch.Tensor   # (M,)
    remap_rough: torch.Tensor  # (M,) 1.0 if roughness->alpha remap applies
    kd_tex: torch.Tensor    # (M,) i32 texture id for kd, or -1
    bump_tex: torch.Tensor  # (M,) i32 texture id for bump height, or -1
    bump_scale: torch.Tensor  # (M,) bump height scale
    # Disney 2015 extras
    metallic: torch.Tensor       # (M,)
    spec_trans: torch.Tensor     # (M,)
    specular_tint: torch.Tensor  # (M,)
    anisotropic: torch.Tensor    # (M,)
    sheen: torch.Tensor          # (M,)
    sheen_tint: torch.Tensor     # (M,)
    clearcoat: torch.Tensor      # (M,)
    clearcoat_gloss: torch.Tensor  # (M,)
    flatness: torch.Tensor       # (M,)
    diff_trans: torch.Tensor     # (M,)
    thin: torch.Tensor           # (M,) 1.0 if thin surface


class LightTable(NamedTuple):
    kind: torch.Tensor       # (L,) i32
    pos: torch.Tensor        # (L,3) point/spot world position
    emit: torch.Tensor       # (L,3) I (point/spot), L (distant/area Lemit)
    axis: torch.Tensor       # (L,3) spot axis / distant wLight direction
    tri: torch.Tensor        # (L,) i32 area-light triangle id or -1
    two_sided: torch.Tensor  # (L,)
    cos_falloff: torch.Tensor  # (L,) spot cosFalloffStart
    cos_total: torch.Tensor    # (L,) spot cosTotalWidth
    scale: torch.Tensor      # (L,) extra radiance scale


class EnvMap(NamedTuple):
    """Environment-map light + its importance-sampling CDFs."""
    image: torch.Tensor          # (H,W,3) radiance texels
    cond_func: torch.Tensor      # Distribution2D pieces over luminance*sin
    cond_cdf: torch.Tensor
    cond_int: torch.Tensor
    marg_cdf: torch.Tensor
    marg_int: torch.Tensor
    world_to_light: torch.Tensor  # (4,4)
    light_to_world: torch.Tensor  # (4,4)
    # the JAX package's inverse-CDF jump table; always None here (see
    # ops/sampling.Distribution2D)
    cond_inv: object = None
    # (H, W, 4) [r, g, b, cond_func/marg_int] packed so the escaped-ray MIS
    # path fetches Le AND the map pdf numerator with ONE per-lane gather
    le_func: Optional[torch.Tensor] = None


_INT_MATERIAL_COLS = ("kind", "kd_tex", "bump_tex")
_INT_LIGHT_COLS = ("kind", "tri")


class Scene(NamedTuple):
    geom: Geometry
    materials: MaterialTable
    lights: LightTable
    env: Optional[EnvMap]
    textures: Optional[tuple]  # (atlas, level offsets, level sizes) or None
    media: Optional[MediumTable]
    camera_medium: int
    world_center: torch.Tensor  # (3,)
    world_radius: torch.Tensor  # ()
    bvh: Optional[tuple]  # BVH tables (ops/bvh.py) or None -> brute force
    # spatial light distribution (models/light_dist.SpatialLightDist)
    light_dist: Optional[tuple] = None
    instanced: Optional[InstancedGeom] = None
    # power-strategy selection pmf, precomputed at build.  Frozen w.r.t.
    # emission updates, which keeps the estimator unbiased (any fixed pmf
    # does) and the selection pdf detached for gradients.
    light_pmf: Optional[torch.Tensor] = None
    # big-prim separation (ops/bvh.build_bvh subset): global ids of huge
    # triangles kept OUT of the BVH and brute-forced by scene_intersect
    big_tri_idx: Optional[torch.Tensor] = None

    @property
    def n_lights(self):
        return self.lights.kind.shape[0]

    @property
    def device(self):
        return self.geom.vertices.device


def with_light_pmf(scene: Scene) -> Scene:
    """Attach the power-strategy selection pmf (uniform when no light has
    power)."""
    from ..models.light_dist import light_powers

    pw = light_powers(scene)
    total = torch.sum(pw)
    nl = pw.shape[0]
    pmf = torch.where(total > 0, pw / torch.clamp(total, min=1e-12),
                      torch.full((nl,), 1.0 / nl, device=pw.device))
    return scene._replace(light_pmf=pmf)


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------

def _v3(x):
    a = np.asarray(x, np.float32)
    if a.ndim == 0:
        a = np.full(3, float(a), np.float32)
    return a


class SceneBuilder:
    """Accumulates host-side numpy geometry/material/light data, then
    freezes into the Scene tables on a device."""

    def __init__(self):
        self.vertices = []
        self.triangles = []
        self.normals = []
        self.uvs = []
        self.tri_mat = []
        self.tri_light = []
        self.tri_medium = []
        self.sph = []  # (center, radius, mat, light, medium)
        self.media = []  # dicts
        self.materials = []  # dicts
        self.lights = []  # dicts
        self.textures = []  # host images for the mip atlas
        self.env = None
        self.instanced = None
        self.camera_medium = -1
        self._vtx_count = 0
        self._has_normals = False
        self._has_uvs = False

    # -- media ---------------------------------------------------------------

    def add_homogeneous_medium(self, sigma_a, sigma_s, g=0.0):
        """A homogeneous medium; returns its id for the medium=(inside,
        outside) interfaces of add_mesh / add_sphere."""
        self.media.append(dict(kind=0, sigma_a=_v3(sigma_a),
                               sigma_s=_v3(sigma_s), g=float(g), density=None,
                               world_to_medium=np.eye(4, dtype=np.float32)))
        return len(self.media) - 1

    def add_grid_medium(self, density, sigma_a, sigma_s, g=0.0,
                        medium_to_world=None):
        """A grid medium: density (nz,ny,nx) over [0,1]^3 in medium space
        (placed by medium_to_world), sigma_t scaled by the trilinear
        density.  A scene holds one grid."""
        if medium_to_world is None:
            medium_to_world = np.eye(4)
        w2m = np.linalg.inv(np.asarray(medium_to_world, np.float64)).astype(
            np.float32)
        self.media.append(dict(kind=1, sigma_a=_v3(sigma_a),
                               sigma_s=_v3(sigma_s), g=float(g),
                               density=np.asarray(density, np.float32),
                               world_to_medium=w2m))
        return len(self.media) - 1

    # -- materials -----------------------------------------------------------

    def add_material(self, kind, **kw):
        m = dict(
            kind=kind, kd=(0.5, 0.5, 0.5), sigma=0.0, kr=(1.0, 1.0, 1.0),
            kt=(1.0, 1.0, 1.0), ks=(1.0, 1.0, 1.0), eta=1.5,
            eta3=(1.0, 1.0, 1.0), k3=(1.0, 1.0, 1.0), rough_u=0.0,
            rough_v=0.0, remap_rough=1.0, kd_tex=-1, bump_tex=-1,
            bump_scale=1.0,
            metallic=0.0, spec_trans=0.0, specular_tint=0.0, anisotropic=0.0,
            sheen=0.0, sheen_tint=0.5, clearcoat=0.0, clearcoat_gloss=1.0,
            flatness=0.0, diff_trans=1.0, thin=0.0,
        )
        m.update(kw)
        self.materials.append(m)
        return len(self.materials) - 1

    def add_texture(self, image):
        """Register an image texture; returns a texture id usable as kd_tex
        on any material."""
        self.textures.append(np.asarray(image, np.float32))
        return len(self.textures) - 1

    def add_matte(self, kd, sigma=0.0, kd_tex=-1):
        return self.add_material(MAT_MATTE, kd=kd, sigma=sigma, kd_tex=kd_tex)

    def add_mirror(self, kr=(0.9, 0.9, 0.9)):
        return self.add_material(MAT_MIRROR, kr=kr)

    def add_glass(self, kr=(1.0, 1.0, 1.0), kt=(1.0, 1.0, 1.0), eta=1.5,
                  rough_u=0.0, rough_v=0.0):
        return self.add_material(MAT_GLASS, kr=kr, kt=kt, eta=eta,
                                 rough_u=rough_u, rough_v=rough_v)

    # Copper conductor spectrum (the standard RGB conversions of measured
    # copper n / k), the default of add_metal
    COPPER_ETA = (0.2004, 0.9240, 1.1022)
    COPPER_K = (3.9129, 2.4528, 2.1421)

    def add_metal(self, eta3=None, k3=None, roughness=0.01, remap_rough=1.0):
        """A microfacet conductor; eta3 / k3 default to copper.  remap_rough
        = 0 takes the roughness as the microfacet alpha itself."""
        if eta3 is None:
            eta3 = self.COPPER_ETA
        if k3 is None:
            k3 = self.COPPER_K
        return self.add_material(MAT_METAL, eta3=eta3, k3=k3,
                                 rough_u=roughness, rough_v=roughness,
                                 remap_rough=remap_rough)

    def add_plastic(self, kd, ks=(1.0, 1.0, 1.0), roughness=0.1):
        return self.add_material(MAT_PLASTIC, kd=kd, ks=ks, rough_u=roughness,
                                 rough_v=roughness)

    def add_disney(self, color, **kw):
        return self.add_material(MAT_DISNEY, kd=color, **kw)

    # -- geometry ------------------------------------------------------------

    def add_mesh(self, vertices, triangles, material, light=-1, transform=None,
                 normals=None, uvs=None, medium=(-1, -1)):
        """vertices (V,3), triangles (T,3) int; optional 4x4 transform
        applied host-side.  Returns the (first, count) triangle id range."""
        v = np.asarray(vertices, np.float64)
        if transform is not None:
            t = np.asarray(transform, np.float64)
            v = v @ t[:3, :3].T + t[:3, 3]
        tri = np.asarray(triangles, np.int64).reshape(-1, 3)
        base = self._vtx_count
        self.vertices.append(v.astype(np.float32))
        self.triangles.append((tri + base).astype(np.int32))
        n = len(tri)
        self.tri_mat.append(np.full(n, material, np.int32))
        self.tri_light.append(np.full(n, light, np.int32))
        self.tri_medium.append(np.tile(np.asarray(medium, np.int32), (n, 1)))
        if normals is not None:
            nr = np.asarray(normals, np.float64)
            if transform is not None:
                t = np.asarray(transform, np.float64)
                inv_t = np.linalg.inv(t[:3, :3]).T
                nr = nr @ inv_t.T
                nr /= np.linalg.norm(nr, axis=1, keepdims=True)
            self.normals.append(nr.astype(np.float32))
            self._has_normals = True
        else:
            self.normals.append(None)
        if uvs is not None:
            self.uvs.append(np.asarray(uvs, np.float32))
            self._has_uvs = True
        else:
            self.uvs.append(None)
        self._vtx_count += len(v)
        first_tri = sum(len(t) for t in self.triangles[:-1])
        return first_tri, n

    def add_instances(self, vertices, triangles, transforms, material=-1,
                      normals=None, uvs=None, per_instance_material=None,
                      bvh=False):
        """Instanced copies of one base mesh.  transforms: (I,4,4)
        object-to-world matrices; material: the base material id of every
        triangle, or an array of per-triangle ids; per_instance_material:
        optional (I,) overrides (-1 rows keep the base); bvh: build a tree
        over the base mesh, which every instance's cast walks.  One
        instanced mesh per scene.  Returns the instance count."""
        if self.instanced is not None:
            raise ValueError("one instanced mesh per scene")
        v = np.asarray(vertices, np.float32)
        t = np.asarray(triangles, np.int32).reshape(-1, 3)
        m = np.asarray(transforms, np.float64).reshape(-1, 4, 4)
        tri_mat = (np.full(len(t), material, np.int32)
                   if np.ndim(material) == 0
                   else np.asarray(material, np.int32))
        inst_mat = (np.full(len(m), -1, np.int32)
                    if per_instance_material is None
                    else np.asarray(per_instance_material, np.int32))
        self.instanced = dict(
            verts=v, tris=t,
            normals=None if normals is None else np.asarray(normals, np.float32),
            uvs=None if uvs is None else np.asarray(uvs, np.float32),
            tri_mat=tri_mat, o2w=m.astype(np.float32),
            w2o=np.linalg.inv(m).astype(np.float32), inst_mat=inst_mat,
            bvh=bvh)
        return len(m)

    def add_sphere(self, center, radius, material, light=-1, medium=(-1, -1)):
        self.sph.append((np.asarray(center, np.float32), float(radius),
                         int(material), int(light), np.asarray(medium, np.int32)))
        return len(self.sph) - 1

    # -- lights --------------------------------------------------------------

    def _light(self, kind, **kw):
        l = dict(kind=kind, pos=(0.0, 0.0, 0.0), emit=(0.0, 0.0, 0.0),
                 axis=(0.0, 0.0, 1.0), tri=-1, two_sided=0.0,
                 cos_falloff=1.0, cos_total=0.0, scale=1.0)
        l.update(kw)
        self.lights.append(l)
        return len(self.lights) - 1

    def add_point_light(self, pos, intensity):
        return self._light(LIGHT_POINT, pos=pos, emit=intensity)

    def add_spot_light(self, pos, axis, intensity, total_width_deg, falloff_start_deg):
        return self._light(
            LIGHT_SPOT, pos=pos, axis=axis, emit=intensity,
            cos_total=float(np.cos(np.deg2rad(total_width_deg))),
            cos_falloff=float(np.cos(np.deg2rad(falloff_start_deg))),
        )

    def add_distant_light(self, w_light, radiance):
        return self._light(LIGHT_DISTANT, axis=w_light, emit=radiance)

    def add_area_light_tri(self, tri_id, l_emit, two_sided=False):
        return self._light(LIGHT_AREA, emit=l_emit, tri=tri_id,
                           two_sided=1.0 if two_sided else 0.0)

    def add_skybox_light(self, scale=1.0):
        """Skybox with no image data: Le is a position gradient on the
        world sphere and its sampled radiance is black (the reference
        renderer's behaviour when its image fails to load)."""
        return self._light(LIGHT_SKYBOX, scale=scale)

    def set_environment(self, image, light_to_world=None, scale=1.0):
        """Environment-map light from an equirect (H,W,3) radiance image."""
        self.env = (np.asarray(image, np.float32) * scale, light_to_world)
        return self._light(LIGHT_INFINITE)

    # -- freeze --------------------------------------------------------------

    @spanned("build")
    def build(self, bvh=False, device="cuda"):
        """Freeze into a Scene on `device`.  bvh: False (brute-force casts),
        True or "sah" (host SAH build, ops/bvh.build_bvh, with big-prim
        separation), or "lbvh" (Morton / Karras build on the device,
        ops/lbvh.build_lbvh; every triangle in the tree)."""
        dev = resolve_device(device)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        if self.vertices:
            verts = np.concatenate(self.vertices, 0)
            tris = np.concatenate(self.triangles, 0)
            tri_mat = np.concatenate(self.tri_mat, 0)
            tri_light = np.concatenate(self.tri_light, 0)
            tri_medium = np.concatenate(self.tri_medium, 0)
        else:
            verts = np.zeros((3, 3), np.float32)
            tris = np.zeros((1, 3), np.int32)
            tri_mat = np.zeros(1, np.int32)
            tri_light = np.full(1, -1, np.int32)
            tri_medium = np.full((1, 2), -1, np.int32)

        normals = None
        if self._has_normals:
            normals = np.concatenate(
                [n if n is not None else np.zeros_like(v)
                 for n, v in zip(self.normals, self.vertices)], 0)
        uvs = None
        if self._has_uvs:
            uvs = np.concatenate(
                [u if u is not None else np.zeros((len(v), 2), np.float32)
                 for u, v in zip(self.uvs, self.vertices)], 0)

        if self.sph:
            sc = np.stack([s[0] for s in self.sph])
            sr = np.asarray([s[1] for s in self.sph], np.float32)
            sm = np.asarray([s[2] for s in self.sph], np.int32)
            sl = np.asarray([s[3] for s in self.sph], np.int32)
            smed = np.stack([s[4] for s in self.sph]).astype(np.int32)
        else:
            sc = np.zeros((0, 3), np.float32)
            sr = np.zeros((0,), np.float32)
            sm = np.zeros((0,), np.int32)
            sl = np.zeros((0,), np.int32)
            smed = np.zeros((0, 2), np.int32)

        geom = Geometry(
            vertices=put(verts), triangles=put(tris),
            normals=None if normals is None else put(normals),
            uvs=None if uvs is None else put(uvs),
            tri_mat=put(tri_mat), tri_light=put(tri_light),
            tri_medium=put(tri_medium),
            sph_center=put(sc), sph_radius=put(sr),
            sph_mat=put(sm), sph_light=put(sl), sph_medium=put(smed),
        )

        if not self.materials:
            self.add_matte((0.5, 0.5, 0.5))
        mat = MaterialTable(**{
            k: put(np.asarray(
                [m[k] for m in self.materials],
                np.int32 if k in _INT_MATERIAL_COLS else np.float32))
            for k in MaterialTable._fields
        })

        if not self.lights:
            self._light(LIGHT_POINT, emit=(0.0, 0.0, 0.0))
        lights = LightTable(**{
            k: put(np.asarray(
                [l[k] for l in self.lights],
                np.int32 if k in _INT_LIGHT_COLS else np.float32))
            for k in LightTable._fields
        })

        instanced = None
        if self.instanced is not None:
            ig = self.instanced
            ig_bvh = None
            if ig["bvh"]:
                from ..ops.bvh import build_bvh

                ig_bvh = build_bvh(ig["verts"], ig["tris"], device=dev)
            instanced = InstancedGeom(
                verts=put(ig["verts"]), tris=put(ig["tris"]),
                normals=None if ig["normals"] is None else put(ig["normals"]),
                uvs=None if ig["uvs"] is None else put(ig["uvs"]),
                tri_mat=put(ig["tri_mat"]), obj_to_world=put(ig["o2w"]),
                world_to_obj=put(ig["w2o"]), inst_mat=put(ig["inst_mat"]),
                bvh=ig_bvh)

        # world bounds -> bounding sphere, over the transformed instances too
        pts = [verts] if len(verts) else []
        if len(sc):
            pts += [sc - sr[:, None], sc + sr[:, None]]
        if self.instanced is not None:
            ig = self.instanced
            vh = np.concatenate([ig["verts"], np.ones((len(ig["verts"]), 1),
                                                      np.float32)], 1)
            pts += [(vh @ m.T)[:, :3] for m in ig["o2w"]]
        allp = np.concatenate(pts, 0) if pts else np.zeros((1, 3), np.float32)
        lo, hi = allp.min(0), allp.max(0)
        center = (lo + hi) / 2
        radius = float(np.linalg.norm(hi - center))

        with span("build.lights"):  # the environment light's distribution
            env = None
            if self.env is not None:
                from ..ops.sampling import make_distribution2d

                img, l2w = self.env
                if l2w is None:
                    l2w = np.eye(4, dtype=np.float32)
                h, w = img.shape[:2]
                # luminance * sin(theta) importance image
                lum = img @ np.asarray([0.212671, 0.715160, 0.072169], np.float32)
                sin_theta = np.sin(np.pi * (np.arange(h) + 0.5) / h).astype(np.float32)
                d2 = make_distribution2d(put(lum * sin_theta[:, None]))
                lf = torch.cat(
                    [put(img), (d2.cond_func / torch.clamp(d2.marg_int, min=1e-20)
                                )[..., None]], dim=-1)
                env = EnvMap(
                    image=put(img),
                    cond_func=d2.cond_func, cond_cdf=d2.cond_cdf,
                    cond_int=d2.cond_int, marg_cdf=d2.marg_cdf,
                    marg_int=d2.marg_int,
                    world_to_light=put(np.linalg.inv(l2w).astype(np.float32)),
                    light_to_world=put(np.asarray(l2w, np.float32)),
                    le_func=lf,
                )

        textures = None
        if self.textures:
            from ..ops.texture import build_texture_atlas

            textures = build_texture_atlas(self.textures, device=dev)

        media = None
        if self.media:
            grid = None
            inv_max = []
            for m in self.media:
                if m["density"] is not None:
                    grid = m["density"]
                    inv_max.append(1.0 / max(float(grid.max()), 1e-8))
                else:
                    inv_max.append(1.0)
            media = MediumTable(
                kind=put(np.asarray([m["kind"] for m in self.media], np.int32)),
                sigma_a=put(np.stack([m["sigma_a"] for m in self.media])),
                sigma_s=put(np.stack([m["sigma_s"] for m in self.media])),
                g=put(np.asarray([m["g"] for m in self.media], np.float32)),
                density=None if grid is None else put(grid),
                world_to_medium=put(np.stack(
                    [m["world_to_medium"] for m in self.media])),
                inv_max_density=put(np.asarray(inv_max, np.float32)),
            )

        bvh_tables = None
        big_idx = None
        if bvh == "lbvh":
            from ..ops.lbvh import build_lbvh

            bvh_tables = build_lbvh(verts, tris, device=dev)
        elif bvh:
            from ..ops.bvh import build_bvh

            # big-prim separation: a few huge triangles (a ground plane)
            # would sit in every ray's node set; they stay out of the tree
            # and are brute-forced by the casts instead
            subset = None
            if len(tris) > 4096:
                e1 = verts[tris[:, 1]] - verts[tris[:, 0]]
                e2 = verts[tris[:, 2]] - verts[tris[:, 0]]
                areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
                med = np.median(areas[areas > 0]) if (areas > 0).any() else 0
                big = areas > 1000.0 * max(med, 1e-20)
                if 0 < int(big.sum()) <= 64:
                    big_idx = np.nonzero(big)[0]
                    subset = np.nonzero(~big)[0]
            bvh_tables = build_bvh(verts, tris, subset=subset, device=dev)

        scene = Scene(
            geom=geom, materials=mat, lights=lights, env=env,
            textures=textures, media=media, camera_medium=self.camera_medium,
            world_center=torch.tensor(center, dtype=torch.float32, device=dev),
            world_radius=torch.tensor(max(radius, 1e-3), dtype=torch.float32,
                                      device=dev),
            bvh=bvh_tables, instanced=instanced,
            big_tri_idx=(None if big_idx is None
                         else put(big_idx.astype(np.int32))),
        )
        with span("build.lights"):
            return with_light_pmf(scene)
