"""Scene inputs from a configuration file (perfbench/configs/<name>.json).

A configuration describes a scene as data: its materials, meshes (vertex
lists, or a generator with its parameters), textures, lights, environment
and camera.  ``build_scene`` makes every input from those constants on the
host and hands them, through the SceneBuilder and camera constructor it is
given, to the port (``gnxraytracer_tpu_torch.scene``) or to the reference
(``perfbench/reference/gnxref/scene``), so both sides get the same inputs.

The generators are copies of the port's (``scene/loaders.make_blob_mesh``,
``utils/image.write_procedural_hdr``'s image, ``scene/presets.envmap_mesh``'s
checker), so a later change there does not move the yardstick.
"""

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def _translate(v):
    m = np.eye(4)
    m[:3, 3] = v
    return m


def _rotate(axis, deg):
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4)
    i, j = {"x": (1, 2), "y": (2, 0), "z": (0, 1)}[axis]
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def transform(ops):
    """The 4x4 product of [["translate", [x, y, z]] | ["rotate_x", deg] |
    ...], left to right (the first op is the leftmost factor)."""
    m = np.eye(4)
    for op, arg in ops:
        if op == "translate":
            m = m @ _translate(arg)
        elif op.startswith("rotate_"):
            m = m @ _rotate(op[-1], arg)
        else:
            raise ValueError(f"unknown transform op {op!r}")
    return m


def blob_mesh(n_seg):
    """Displaced UV sphere with area-weighted vertex normals and spherical
    uvs, 2 * n_seg^2 triangles (copy of the port's make_blob_mesh)."""
    th = np.linspace(1e-3, np.pi - 1e-3, n_seg + 1)
    ph = np.linspace(0, 2 * np.pi, n_seg + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    R = 1.0 + 0.13 * np.sin(6 * T) * np.cos(7 * P) + 0.05 * np.sin(13 * P)
    x = R * np.sin(T) * np.cos(P)
    y = R * np.cos(T)
    z = R * np.sin(T) * np.sin(P)
    v = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([P / (2 * np.pi), T / np.pi], -1).reshape(-1, 2).astype(np.float32)
    idx = np.arange((n_seg + 1) * (n_seg + 1)).reshape(n_seg + 1, n_seg + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[1:, 1:].ravel()
    d = idx[:-1, 1:].ravel()
    f = np.concatenate([np.stack([a, b, c], -1),
                        np.stack([a, c, d], -1)]).astype(np.int32)
    n = np.zeros_like(v)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    return v, f, n.astype(np.float32), uv


def procedural_sky(height, width):
    """(height, width, 3) float32 radiance: a sky gradient, a darker ground
    half and a small sun (the image of the port's write_procedural_hdr,
    kept in memory, without its RGBE rounding)."""
    v = (np.arange(height, dtype=np.float32)[:, None] + 0.5) / height
    u = (np.arange(width, dtype=np.float32)[None, :] + 0.5) / width
    sky = np.clip(1.0 - 1.6 * v, 0.0, 1.0)
    img = np.stack([0.25 + 0.6 * sky + 0.1 * np.sin(6.283 * u),
                    0.30 + 0.8 * sky + 0.0 * u,
                    0.35 + 1.4 * sky + 0.1 * np.cos(6.283 * u)], -1)
    sun = ((u - 0.3) ** 2 * 4 + (v - 0.2) ** 2) < 0.0004
    img[sun] = (900.0, 800.0, 600.0)
    return img.astype(np.float32)


def checker(size, cell, low, span):
    y, x = np.mgrid[0:size, 0:size]
    c = (((x // cell) + (y // cell)) % 2).astype(np.float32)
    return low + span * np.stack([c] * 3, -1)


def _mesh_arrays(spec, overrides):
    if spec.get("generator") == "blob":
        n_seg = overrides.get("n_seg", spec["n_seg"])
        v, t, n, uv = blob_mesh(n_seg)
        return v, t, n, uv
    if "generator" in spec:
        raise ValueError(f"unknown mesh generator {spec['generator']!r}")
    uv = spec.get("uvs")
    return (np.asarray(spec["vertices"], np.float32),
            np.asarray(spec["triangles"], np.int32), None,
            None if uv is None else np.asarray(uv, np.float32))


def _add_material(b, m, tex_ids):
    kind = m["type"]
    if kind == "matte":
        return b.add_matte(tuple(m["kd"]), sigma=m.get("sigma", 0.0),
                           kd_tex=tex_ids[m["kd_tex"]] if "kd_tex" in m else -1)
    if kind == "mirror":
        return b.add_mirror(tuple(m["kr"]))
    if kind == "disney":
        kw = {k: v for k, v in m.items() if k not in ("name", "type", "color")}
        return b.add_disney(tuple(m["color"]), **kw)
    raise ValueError(f"unknown material type {kind!r}")


def build_scene(config, scene_builder, make_camera, device, **overrides):
    """(scene, camera) of `config` on `device`, built through
    scene_builder() (a SceneBuilder class) and make_camera (a
    make_perspective_camera).  overrides: width, height or a blob's n_seg,
    for the CPU tests only."""
    width = overrides.get("width", config["width"])
    height = overrides.get("height", config["height"])
    b = scene_builder()
    tex_ids = {}
    for t in config.get("textures", []):
        if t["generator"] != "checker":
            raise ValueError(f"unknown texture generator {t['generator']!r}")
        tex_ids[t["name"]] = b.add_texture(
            checker(t["size"], t["cell"], t["low"], t["span"]))
    mat_ids = {m["name"]: _add_material(b, m, tex_ids)
               for m in config["materials"]}
    for spec in config["meshes"]:
        v, t, n, uv = _mesh_arrays(spec, overrides)
        mats = [mat_ids[k] for k in spec["materials"]]
        xf = transform(spec["transform"]) if "transform" in spec else None
        start, count = b.add_mesh(v, t, mats[0], transform=xf, normals=n,
                                  uvs=uv)
        if len(mats) > 1:
            b.tri_mat[-1] = np.asarray(mats, np.int32)
        light = spec.get("area_light")
        if light is not None:
            ids = [b.add_area_light_tri(start + i, tuple(light["emit"]),
                                        two_sided=light["two_sided"])
                   for i in range(count)]
            b.tri_light[-1] = np.asarray(ids, np.int32)
    if "skybox" in config:
        b.add_skybox_light(scale=config["skybox"]["scale"])
    env = config.get("environment")
    if env is not None:
        if env["generator"] != "procedural_sky":
            raise ValueError(f"unknown environment generator {env['generator']!r}")
        b.set_environment(procedural_sky(env["height"], env["width"]),
                          light_to_world=transform(env["light_to_world"]))
    scene = b.build(bvh=config["bvh"], device=device)
    cam = config["camera"]
    camera = make_camera(width, height, eye=tuple(cam["eye"]),
                         look=tuple(cam["look"]), up=tuple(cam["up"]),
                         fov=cam["fov"], device=device)
    return scene, camera
