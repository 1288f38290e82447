"""State carried across from the JAX package.

Each function takes a JAX-package table whose leaves were already turned
into numpy arrays (``jax.tree.map(np.asarray, scene)`` on the caller's
side; this module imports no jax) and returns the port's table on a device,
so that both packages run on identical state.  Tables are matched by field
name.
"""

import numpy as np
import torch

from .models.integrators.path import RenderCfg
from .ops.samplers import Sampler, halton_sampler_from_tables
from .scene.camera import Camera
from .ops.bvh import bvh_from_numpy
from .models.light_dist import SpatialLightDist
from .scene.scene import (EnvMap, Geometry, InstancedGeom, LightTable,
                          MaterialTable, MediumTable, Scene)
from .utils.device import resolve_device


def _tensor(a, dev):
    if a is None:
        return None
    a = np.array(a, order="C")  # a writable copy; keeps 0-d arrays 0-d
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(dev)


def _table(cls, src, dev):
    return cls(**{f: _tensor(getattr(src, f), dev) for f in cls._fields})


def scene_from_numpy(tree, device="cuda"):
    """JAX-package Scene (numpy leaves) -> the port's Scene."""
    dev = resolve_device(device)
    env = None
    if tree.env is not None:
        # the inverse-CDF jump table is a TPU device and is not carried
        env = EnvMap(**{f: (None if f == "cond_inv"
                            else _tensor(getattr(tree.env, f), dev))
                        for f in EnvMap._fields})
    textures = None
    if tree.textures is not None:
        textures = tuple(_tensor(a, dev) for a in tree.textures)
    instanced = None
    if tree.instanced is not None:
        ig = tree.instanced
        instanced = InstancedGeom(**{
            f: (None if ig.bvh is None else bvh_from_numpy_tree(ig.bvh, dev))
            if f == "bvh" else _tensor(getattr(ig, f), dev)
            for f in InstancedGeom._fields})
    light_dist = None
    if tree.light_dist is not None:
        ld = tree.light_dist
        light_dist = SpatialLightDist(
            cdf=_tensor(ld.cdf, dev), pmf=_tensor(ld.pmf, dev),
            res=tuple(int(r) for r in ld.res), lo=_tensor(ld.lo, dev),
            inv_extent=_tensor(ld.inv_extent, dev))
    return Scene(
        geom=_table(Geometry, tree.geom, dev),
        materials=_table(MaterialTable, tree.materials, dev),
        lights=_table(LightTable, tree.lights, dev),
        env=env, textures=textures,
        media=None if tree.media is None else _table(MediumTable, tree.media,
                                                     dev),
        camera_medium=int(tree.camera_medium),
        world_center=_tensor(tree.world_center, dev),
        world_radius=_tensor(tree.world_radius, dev),
        bvh=None if tree.bvh is None else bvh_from_numpy_tree(tree.bvh, dev),
        light_dist=light_dist, instanced=instanced,
        light_pmf=_tensor(tree.light_pmf, dev),
        big_tri_idx=_tensor(tree.big_tri_idx, dev),
    )


def bvh_from_numpy_tree(bvh, device="cuda"):
    """JAX-package BVH (numpy leaves; an SAH or an LBVH tree) -> the port's
    BVH.  The binary tables carry across as they are; the width-8 table the
    port walks is made from them (ops/wbvh.build_wide_pack), and so is the
    binary threaded table (ops/bvh.build_packet_pack), so both packages walk
    the same tree.  The JAX package's treelet tables exist to fit the TPU's
    fast memory and are not carried."""
    return bvh_from_numpy(
        *(np.asarray(getattr(bvh, f)) for f in (
            "bounds_lo", "bounds_hi", "offset", "n_prims", "axis", "prim_idx",
            "miss", "leaf_soa", "first8", "miss8")),
        device=device)


def camera_from_numpy(cam, device="cuda"):
    """JAX-package Camera (numpy leaves) -> the port's Camera."""
    dev = resolve_device(device)
    return Camera(
        kind=int(cam.kind),
        raster_to_camera=_tensor(cam.raster_to_camera, dev),
        camera_to_world=_tensor(cam.camera_to_world, dev),
        lens_radius=float(cam.lens_radius),
        focal_distance=float(cam.focal_distance),
        shutter_open=float(cam.shutter_open),
        shutter_close=float(cam.shutter_close),
        width=int(cam.width), height=int(cam.height),
    )


def sampler_from_numpy(smp, device="cuda"):
    """JAX-package Sampler -> the port's Sampler.  Of a Halton sampler the
    per-film pixel_offset table and stride / exp2 / scale3 carry across; its
    primes, prime_sums and perms are the fixed tables of ops/lds.py, which
    the port makes itself (the tests hold them equal)."""
    dev = resolve_device(device)
    if smp.kind == "halton":
        return halton_sampler_from_tables(
            smp.spp, smp.seed, np.asarray(smp.pixel_offset), smp.stride,
            smp.exp2, smp.scale3, device=dev)
    if smp.kind not in ("random", "sobol"):
        raise ValueError(f"unknown sampler kind {smp.kind!r}")
    return Sampler(kind=smp.kind, spp=int(smp.spp), seed=int(smp.seed),
                   device=str(dev))


def params_from_numpy(p, device="cuda"):
    """The JAX package's extract_params dict (numpy leaves) -> the port's
    (parallel/sharding.extract_params), tensors on `device`."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in p.items()}


def cfg_from_dict(d):
    """``jax_cfg._asdict()`` -> the port's RenderCfg (same field names)."""
    d = dict(d)
    unknown = set(d) - set(RenderCfg._fields)
    if unknown:
        raise ValueError(f"unknown RenderCfg fields: {sorted(unknown)}")
    for k in ("mat_kinds", "light_kinds", "light_kind_seq", "compact_stages"):
        if k in d:
            d[k] = tuple(tuple(x) if isinstance(x, (list, tuple)) else x
                         for x in d[k])
    return RenderCfg(**d)
