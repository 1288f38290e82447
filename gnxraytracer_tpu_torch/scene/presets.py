"""Scene presets replicating the reference renderer's hardcoded scenes:
the Cornell box with its two-triangle area light and skybox (optionally with
a mesh behind a BVH), the single-sphere point-light scene, and the
environment-lit textured mesh scene.  The presets that need media or
instancing are not ported yet.
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
