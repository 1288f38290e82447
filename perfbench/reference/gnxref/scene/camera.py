"""Perspective / orthographic cameras as batched ray-generation functions.

The raster->screen->camera->world chain is precomputed host-side (numpy
float64) into one 4x4 raster-to-camera matrix plus the camera-to-world
matrix; ray generation is a batched tensor op.  Ray differentials (the
+1-pixel auxiliary rays) feed the filtered texture lookups.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..ops.sampling import concentric_sample_disk
from ..utils.device import resolve_device
from ..utils.math import normalize

PERSPECTIVE = 0
ORTHOGRAPHIC = 1


class Camera(NamedTuple):
    kind: int  # PERSPECTIVE | ORTHOGRAPHIC
    raster_to_camera: torch.Tensor  # (4,4)
    camera_to_world: torch.Tensor  # (4,4)
    lens_radius: float
    focal_distance: float
    shutter_open: float
    shutter_close: float
    width: int
    height: int


# ---------------------------------------------------------------------------
# Host-side transforms (numpy float64 for precision, cast to f32)
# ---------------------------------------------------------------------------

def look_at(eye, look, up):
    """Camera-to-world 4x4 of a camera at `eye` looking at `look`."""
    eye, look, up = (np.asarray(v, np.float64) for v in (eye, look, up))
    d = look - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    right = right / np.linalg.norm(right)
    new_up = np.cross(d, right)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = eye
    return m


def perspective_projection(fov_deg, near=1e-2, far=1000.0):
    """Perspective camera-to-screen matrix."""
    persp = np.array(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [0, 0, far / (far - near), -far * near / (far - near)],
            [0, 0, 1, 0],
        ],
        np.float64,
    )
    inv_tan = 1.0 / np.tan(np.deg2rad(fov_deg) / 2)
    scale = np.diag([inv_tan, inv_tan, 1.0, 1.0])
    return scale @ persp


def _screen_window(width, height):
    """Default screen window from the aspect ratio."""
    frame = width / height
    if frame > 1:
        return (-frame, frame, -1.0, 1.0)
    return (-1.0, 1.0, -1.0 / frame, 1.0 / frame)


def _translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = [x, y, z]
    return m


def _raster_to_screen(width, height, win):
    x0, x1, y0, y1 = win
    screen_to_raster = (
        np.diag([width, height, 1.0, 1.0])
        @ np.diag([1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0, 1.0])
        @ _translate(-x0, -y1, 0.0)
    )
    return np.linalg.inv(screen_to_raster)


def _make_camera(kind, raster_to_camera, cam_to_world, width, height,
                 lens_radius, focal_distance, shutter, device):
    dev = resolve_device(device)
    return Camera(
        kind=kind,
        raster_to_camera=torch.tensor(raster_to_camera, dtype=torch.float32,
                                      device=dev),
        camera_to_world=torch.tensor(cam_to_world, dtype=torch.float32,
                                     device=dev),
        lens_radius=float(lens_radius),
        focal_distance=float(focal_distance),
        shutter_open=float(shutter[0]),
        shutter_close=float(shutter[1]),
        width=width,
        height=height,
    )


def make_perspective_camera(width, height, eye, look, up=(0.0, 1.0, 0.0),
                            fov=90.0, lens_radius=0.0, focal_distance=3.0,
                            shutter=(0.0, 1.0), device="cuda"):
    """Defaults of the reference renderer: fov=90, no depth of field."""
    cam_to_world = look_at(eye, look, up)
    cam_to_screen = perspective_projection(fov)
    raster_to_camera = np.linalg.inv(cam_to_screen) @ _raster_to_screen(
        width, height, _screen_window(width, height))
    return _make_camera(PERSPECTIVE, raster_to_camera, cam_to_world, width,
                        height, lens_radius, focal_distance, shutter, device)


def make_orthographic_camera(width, height, eye, look, up=(0.0, 1.0, 0.0),
                             lens_radius=0.0, focal_distance=3.0,
                             shutter=(0.0, 1.0), device="cuda"):
    """Orthographic projection: camera-to-screen =
    Scale(1,1,1/(far-near)) * Translate(0,0,-near)."""
    cam_to_world = look_at(eye, look, up)
    near, far = 0.0, 1.0
    cam_to_screen = np.diag([1.0, 1.0, 1.0 / (far - near), 1.0]) @ _translate(0, 0, -near)
    raster_to_camera = np.linalg.inv(cam_to_screen) @ _raster_to_screen(
        width, height, _screen_window(width, height))
    return _make_camera(ORTHOGRAPHIC, raster_to_camera, cam_to_world, width,
                        height, lens_radius, focal_distance, shutter, device)


# ---------------------------------------------------------------------------
# Batched ray generation
# ---------------------------------------------------------------------------

def _xform_point(m, p):
    """Apply 4x4 m to (..., 3) points with perspective divide."""
    ph = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3] + m[3, 3]
    return ph / w[..., None]


def _xform_vector(m, v):
    return v @ m[:3, :3].T


def generate_rays(camera: Camera, p_film, time_u, p_lens_u):
    """Batched GenerateRay.

    p_film: (N, 2) raster coords; time_u, p_lens_u: sampler dims.
    Returns (origins (N,3), directions (N,3), time (N,)) in world space.
    """
    n = p_film.shape[0]
    zeros1 = torch.zeros((n, 1), dtype=p_film.dtype, device=p_film.device)
    p_raster = torch.cat([p_film, zeros1], dim=-1)
    p_camera = _xform_point(camera.raster_to_camera, p_raster)
    if camera.kind == PERSPECTIVE:
        o = torch.zeros((n, 3), dtype=torch.float32, device=p_film.device)
        d = normalize(p_camera)
    else:
        o = p_camera
        d = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                         device=p_film.device).expand(n, 3)
    if camera.lens_radius > 0:
        p_lens = camera.lens_radius * concentric_sample_disk(p_lens_u)
        ft = camera.focal_distance / d[..., 2]
        p_focus = o + ft[..., None] * d
        o = torch.cat([p_lens, zeros1], dim=-1)
        d = normalize(p_focus - o)
    time = camera.shutter_open + time_u * (camera.shutter_close - camera.shutter_open)
    o_world = _xform_point(camera.camera_to_world, o)
    d_world = normalize(_xform_vector(camera.camera_to_world, d))
    return o_world, d_world, time


class RayDifferentials(NamedTuple):
    """Auxiliary +1-pixel rays."""
    rx_o: torch.Tensor  # (N,3)
    rx_d: torch.Tensor
    ry_o: torch.Tensor
    ry_d: torch.Tensor


def generate_ray_differentials(camera: Camera, p_film, time_u, p_lens_u):
    """Batched GenerateRayDifferential: offset p_film by one pixel in x and
    y; the same lens sample is reused for the auxiliary rays.

    Returns (o, d, time, RayDifferentials)."""
    o, d, time = generate_rays(camera, p_film, time_u, p_lens_u)
    dx = torch.tensor([1.0, 0.0], dtype=p_film.dtype, device=p_film.device)
    dy = torch.tensor([0.0, 1.0], dtype=p_film.dtype, device=p_film.device)
    rx_o, rx_d, _ = generate_rays(camera, p_film + dx, time_u, p_lens_u)
    ry_o, ry_d, _ = generate_rays(camera, p_film + dy, time_u, p_lens_u)
    return o, d, time, RayDifferentials(rx_o, rx_d, ry_o, ry_d)


def scale_differentials(o, d, rd: RayDifferentials, s):
    """Shrink the one-pixel offsets by s = 1/sqrt(spp)."""
    return RayDifferentials(
        rx_o=o + (rd.rx_o - o) * s,
        rx_d=d + (rd.rx_d - d) * s,
        ry_o=o + (rd.ry_o - o) * s,
        ry_d=d + (rd.ry_d - d) * s,
    )
