"""Scene presets replicating the reference renderer's hardcoded scenes:
the Cornell box with its two-triangle area light and skybox (optionally with
a mesh behind a BVH), its glass / mirror / Disney box twin of the reference
renderer's `gmd` scene, its three scenes with participating media, the
single-sphere point-light scene, and the environment-lit textured mesh
scene.  The presets that need instancing are not ported yet.
"""

import os

import numpy as np

from .camera import make_perspective_camera
from .scene import SceneBuilder

# Cornell wall vertices, 10 triangles, before the translate by -2.5
_L = 5.0
CORNELL_VERTS = np.array([
    # floor
    [0, 0, _L], [_L, 0, _L], [0, 0, 0],
    [_L, 0, _L], [_L, 0, 0], [0, 0, 0],
    # ceiling
    [0, _L, _L], [0, _L, 0], [_L, _L, _L],
    [_L, _L, _L], [0, _L, 0], [_L, _L, 0],
    # back wall
    [0, 0, 0], [_L, 0, 0], [_L, _L, 0],
    [0, 0, 0], [_L, _L, 0], [0, _L, 0],
    # right wall (x=0 side; red)
    [0, 0, 0], [0, _L, _L], [0, 0, _L],
    [0, 0, 0], [0, _L, 0], [0, _L, _L],
    # left wall (x=L side; blue)
    [_L, 0, 0], [_L, _L, _L], [_L, 0, _L],
    [_L, 0, 0], [_L, _L, 0], [_L, _L, _L],
], np.float32)

# Area light quad, translated by (0, 2.45, 0)
AREA_LIGHT_VERTS = np.array([
    [-1.4, 0.0, 1.4], [-1.4, 0.0, -1.4], [1.4, 0.0, 1.4],
    [1.4, 0.0, 1.4], [-1.4, 0.0, -1.4], [1.4, 0.0, -1.4],
], np.float32)


def _translate(v):
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = v
    return m


def add_cornell(b: SceneBuilder, mat_red, mat_blue, mat_white):
    """The ten wall triangles: tris 6,7 red, tris 8,9 blue, rest white."""
    tris = np.arange(30).reshape(10, 3)
    xf = _translate([-0.5 * _L, -0.5 * _L, -0.5 * _L])
    mats = [mat_white] * 6 + [mat_red] * 2 + [mat_blue] * 2
    start, _ = b.add_mesh(CORNELL_VERTS, tris, mat_white, transform=xf)
    b.tri_mat[-1] = np.asarray(mats, np.int32)
    return start


def add_area_lights(b: SceneBuilder, mat_light, l_emit=(5.0, 5.0, 5.0)):
    """2 emissive triangles at y=2.45, each its own area light, Lemit=5."""
    xf = _translate([0.0, 2.45, 0.0])
    start, n = b.add_mesh(AREA_LIGHT_VERTS, np.arange(6).reshape(2, 3),
                          mat_light, transform=xf)
    ids = [b.add_area_light_tri(start + i, l_emit, two_sided=False)
           for i in range(n)]
    b.tri_light[-1] = np.asarray(ids, np.int32)
    return ids


def reference_materials(b: SceneBuilder, sigma=60.0):
    """The reference renderer's material set (sigma=60 -> Oren-Nayar)."""
    white = b.add_matte((0.91, 0.91, 0.91), sigma=sigma)
    dragon = b.add_matte((0.2, 0.8, 0.2), sigma=sigma)
    red = b.add_matte((0.9, 0.1, 0.17), sigma=sigma)
    blue = b.add_matte((0.14, 0.21, 0.87), sigma=sigma)
    mirror = b.add_mirror((0.2, 0.8, 0.2))
    return dict(white=white, dragon=dragon, red=red, blue=blue, mirror=mirror)


def cornell_box(width=500, height=500, sigma=60.0, skybox=True,
                dragon_material=None, bvh=False, mesh=None, mesh_transform=None,
                device="cuda"):
    """Cornell box + 2-triangle area light + skybox, camera at (0,0,5)
    looking at the origin, fov 90.

    mesh: optional (vertices, triangles) placed with a translate of
    (0,-2.9,0) unless mesh_transform is given.
    """
    b = SceneBuilder()
    mats = reference_materials(b, sigma=sigma)
    add_cornell(b, mats["red"], mats["blue"], mats["white"])
    add_area_lights(b, mats["dragon"])
    if mesh is not None:
        v, t = mesh
        xf = mesh_transform if mesh_transform is not None else _translate([0.0, -2.9, 0.0])
        mat = dragon_material if dragon_material is not None else mats["dragon"]
        b.add_mesh(v, t, mat, transform=xf)
    if skybox:
        b.add_skybox_light()
    scene = b.build(bvh=bvh, device=device)
    cam = make_perspective_camera(width, height, eye=(0.0, 0.0, 5.0),
                                  look=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
                                  device=device)
    return scene, cam


def cornell_gmd(width=500, height=500, sigma=0.0, device="cuda"):
    """Cornell + area light + three axis-aligned boxes carrying Glass,
    Mirror and Disney materials: the twin of the reference renderer's `gmd`
    parity scene (its box literals)."""
    b = SceneBuilder()
    mats = reference_materials(b, sigma=sigma)
    add_cornell(b, mats["red"], mats["blue"], mats["white"])
    add_area_lights(b, mats["dragon"])
    glass = b.add_glass(kr=(1.0, 1.0, 1.0), kt=(1.0, 1.0, 1.0), eta=1.5)
    mirror = b.add_mirror((0.9, 0.9, 0.9))
    disney = b.add_disney((0.7, 0.3, 0.2), metallic=0.4, eta=1.5,
                          rough_u=0.3, rough_v=0.3, specular_tint=0.0,
                          anisotropic=0.0, sheen=0.5, sheen_tint=0.5,
                          clearcoat=1.0, clearcoat_gloss=1.0)
    for lo, hi, mat in (
            ((-1.9, -2.5, -0.3), (-0.7, -1.3, 0.9), glass),
            ((0.6, -2.5, -1.2), (2.0, -0.7, 0.2), mirror),
            ((-0.35, -2.5, 1.0), (0.75, -1.4, 2.1), disney)):
        v, f = _box_mesh(np.asarray(lo), np.asarray(hi))
        b.add_mesh(v, f, mat)
    scene = b.build(device=device)
    cam = make_perspective_camera(width, height, eye=(0.0, 0.0, 5.0),
                                  look=(0.0, 0.0, 0.0), device=device)
    return scene, cam


def _box_mesh(lo, hi):
    """12-triangle axis-aligned box with outward winding."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = np.array([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
    ], np.float32)
    f = np.array([
        [0, 2, 1], [0, 3, 2],  # z0 face (normal -z)
        [4, 5, 6], [4, 6, 7],  # z1 face (+z)
        [0, 1, 5], [0, 5, 4],  # y0 (-y)
        [3, 6, 2], [3, 7, 6],  # y1 (+y)
        [0, 7, 3], [0, 4, 7],  # x0 (-x)
        [1, 2, 6], [1, 6, 5],  # x1 (+x)
    ], np.int32)
    return v, f


def cornell_homogeneous(width=500, height=500, device="cuda"):
    """Cornell + area light + a null-material box holding a homogeneous
    medium (sigma_a 0.25, sigma_s 0.45, g 0.3): the twin of the reference
    renderer's `volpath` parity scene."""
    b = SceneBuilder()
    mats = reference_materials(b, sigma=0.0)
    add_cornell(b, mats["red"], mats["blue"], mats["white"])
    add_area_lights(b, mats["dragon"])
    hom = b.add_homogeneous_medium((0.25, 0.25, 0.25), (0.45, 0.45, 0.45),
                                   g=0.3)
    v, f = _box_mesh(np.array([-1.0, -2.4, -1.0]), np.array([1.0, -0.4, 1.0]))
    b.add_mesh(v, f, material=-1, medium=(hom, -1))
    scene = b.build(device=device)
    cam = make_perspective_camera(width, height, eye=(0.0, 0.0, 5.0),
                                  look=(0.0, 0.0, 0.0), device=device)
    return scene, cam


def _grid_box_to_world():
    """medium_to_world of the grid media: the unit cube onto the
    [-1,-2.4,-1] x [1,-0.4,1] box on the floor."""
    m2w = np.eye(4)
    m2w[0, 0] = m2w[1, 1] = m2w[2, 2] = 2.0
    m2w[:3, 3] = [-1.0, -2.4, -1.0]
    return m2w


def cornell_gridvol(width=500, height=500, volume_path=None, device="cuda"):
    """Cornell + area light + a null-material box holding a grid medium from
    the reference renderer's density_render.70.volume (default: under
    $GNX_RESOURCES; there is no in-code fallback): sigma = the file's values
    x 0.1, g = 0."""
    from .loaders import load_volume

    if volume_path is None:
        volume_path = _resource("density_render.70.volume")
    if volume_path is None or not os.path.exists(volume_path):
        raise FileNotFoundError(
            "cornell_gridvol needs density_render.70.volume (set "
            "GNX_RESOURCES or pass volume_path)")
    b = SceneBuilder()
    mats = reference_materials(b, sigma=0.0)
    add_cornell(b, mats["red"], mats["blue"], mats["white"])
    add_area_lights(b, mats["dragon"])
    vol = load_volume(volume_path)
    grid_med = b.add_grid_medium(vol["density"],
                                 np.asarray(vol["sigma_a"]) * 0.1,
                                 np.asarray(vol["sigma_s"]) * 0.1, g=0.0,
                                 medium_to_world=_grid_box_to_world())
    v, f = _box_mesh(np.array([-1.0, -2.4, -1.0]), np.array([1.0, -0.4, 1.0]))
    b.add_mesh(v, f, material=-1, medium=(grid_med, -1))
    scene = b.build(device=device)
    cam = make_perspective_camera(width, height, eye=(0.0, 0.0, 5.0),
                                  look=(0.0, 0.0, 0.0), device=device)
    return scene, cam


def volumetric_cornell(width=128, height=128, use_reference_volume=True,
                       device="cuda"):
    """Cornell + a grid medium in a null-boundary box on the floor + a glass
    sphere holding a homogeneous medium (2.4 / 1.4 scaled by 0.1, g 0.5).
    The grid is density_render.70.volume under $GNX_RESOURCES when
    use_reference_volume and the file is there, else a procedural gaussian
    blob (32^3, sigma_a 10, sigma_s 90, both x 0.1)."""
    b = SceneBuilder()
    mats = reference_materials(b, sigma=0.0)
    add_cornell(b, mats["red"], mats["blue"], mats["white"])
    add_area_lights(b, mats["dragon"])
    vol_path = _resource("density_render.70.volume")
    if use_reference_volume and vol_path is not None \
            and os.path.exists(vol_path):
        from .loaders import load_volume

        vol = load_volume(vol_path)
        density = vol["density"]
        sigma_a, sigma_s = vol["sigma_a"], vol["sigma_s"]
    else:
        z, y, x = np.mgrid[0:32, 0:32, 0:32] / 31.0
        density = np.exp(-8 * ((x - .5) ** 2 + (y - .5) ** 2
                               + (z - .5) ** 2)).astype(np.float32)
        sigma_a, sigma_s = (10.0, 10.0, 10.0), (90.0, 90.0, 90.0)
    grid_med = b.add_grid_medium(density, np.asarray(sigma_a) * 0.1,
                                 np.asarray(sigma_s) * 0.1, g=0.0,
                                 medium_to_world=_grid_box_to_world())
    bv, bt = _box_mesh(np.array([-1.0, -2.4, -1.0]), np.array([1.0, -0.4, 1.0]))
    b.add_mesh(bv, bt, material=-1, medium=(grid_med, -1))
    hom = b.add_homogeneous_medium((0.24, 0.24, 0.24), (0.14, 0.14, 0.14),
                                   g=0.5)
    glass = b.add_glass(eta=1.5)
    b.add_sphere((1.2, -1.5, 0.8), 0.9, glass, medium=(hom, -1))
    scene = b.build(device=device)
    cam = make_perspective_camera(width, height, eye=(0.0, 0.0, 5.0),
                                  look=(0.0, 0.0, 0.0), device=device)
    return scene, cam


def sphere_point_light(width=64, height=64, device="cuda"):
    """Single matte sphere + point light."""
    b = SceneBuilder()
    m = b.add_matte((0.7, 0.5, 0.4), sigma=0.0)
    b.add_sphere((0.0, 0.0, 0.0), 1.0, m)
    b.add_point_light((2.0, 3.0, 4.0), (100.0, 100.0, 100.0))
    scene = b.build(device=device)
    cam = make_perspective_camera(width, height, eye=(0.0, 0.0, 5.0),
                                  look=(0.0, 0.0, 0.0), device=device)
    return scene, cam


def _rot_x(deg):
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def _rot_y(deg):
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def _resource(name):
    """Path of a reference-renderer asset under $GNX_RESOURCES, or None when
    the variable is unset (the presets then take their in-code fallbacks)."""
    root = os.environ.get("GNX_RESOURCES")
    return os.path.join(root, name) if root else None


def envmap_mesh(width=500, height=500, hdr_path=None, mesh=None,
                mesh_tris=104_882, texture_path=None, device="cuda"):
    """The mesh scene: a ~dragon-scale blob mesh with a Disney material via
    the BVH, an image-textured ground plane (filtered texture lookups), and
    an HDR environment light with LightToWorld = RotateX(20) * RotateY(-90) *
    RotateX(-90).

    hdr_path / texture_path default to MonValley1000.hdr and
    awesomeface.jpg under $GNX_RESOURCES.  Where a file is absent the scene
    falls back to a skybox light / a checker texture."""
    if hdr_path is None:
        hdr_path = _resource("MonValley1000.hdr")
    if texture_path is None:
        texture_path = _resource("awesomeface.jpg")
    b = SceneBuilder()
    mat = b.add_disney((0.6, 0.5, 0.45), rough_u=0.35, metallic=0.1)
    if mesh is None:
        from .loaders import make_blob_mesh

        n_seg = max(8, int(round((mesh_tris / 2) ** 0.5)))
        v, t, n, uv = make_blob_mesh(n_seg)
        b.add_mesh(v, t, mat, transform=_translate([0.0, -0.5, 0.0]),
                   normals=n, uvs=uv)
    else:
        v, t = mesh
        b.add_mesh(v, t, mat, transform=_translate([0.0, -0.5, 0.0]))
    # textured ground plane
    if texture_path is not None and os.path.exists(texture_path):
        from ..utils.image import load_image

        tex = b.add_texture(load_image(texture_path, gamma=True))
    else:
        y, x = np.mgrid[0:128, 0:128]
        tex = b.add_texture(
            0.2 + 0.6 * np.stack([(((x // 16) + (y // 16)) % 2).astype(np.float32)] * 3, -1))
    floor_mat = b.add_matte((1.0, 1.0, 1.0), sigma=0.0, kd_tex=tex)
    g = 6.0
    gv = np.array([[-g, -1.7, g], [g, -1.7, g], [-g, -1.7, -g],
                   [g, -1.7, g], [g, -1.7, -g], [-g, -1.7, -g]], np.float32)
    guv = np.array([[0, 0], [4, 0], [0, 4], [4, 0], [4, 4], [0, 4]],
                   np.float32)
    b.add_mesh(gv, np.arange(6).reshape(2, 3), floor_mat, uvs=guv)
    if hdr_path is not None and os.path.exists(hdr_path):
        from ..utils.image import load_image

        img = load_image(hdr_path)
        l2w = _rot_x(20) @ _rot_y(-90) @ _rot_x(-90)
        b.set_environment(img, light_to_world=l2w)
    else:
        b.add_skybox_light()
    scene = b.build(bvh=True, device=device)
    cam = make_perspective_camera(width, height, eye=(0.0, 0.8, 5.0),
                                  look=(0.0, -0.3, 0.0), device=device)
    return scene, cam
