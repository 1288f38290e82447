"""Object instancing: transformed copies of one base mesh sharing its
geometry.

An instance is a row of a small transform table.  A cast transforms the
whole ray wavefront into each instance's object space (the direction is not
renormalized, so t stays in world units) and casts it against the shared
base mesh; the results combine with where-masks over the instance loop, each
instance's closest cast starting from the best t found so far.  Instances may
carry two-keyframe motion (utils/transform.AnimatedTransform): the
world-to-object matrix is then interpolated per lane at the ray's time.

Which cast serves an instance: with ``kernels=True`` the hand-written
kernels' wrappers, which launch their CUDA kernel on CUDA tensors and run
their plain version on CPU tensors; with ``bvh`` (the base mesh's tree,
ops/bvh.BVH) the binary threaded-BVH pair (kernels/packet_bvh.py), as the
JAX package walks an instance's tree with its binary walk, else the
brute-force pair (kernels/closest_hit.py) on the base mesh's triangle table,
made once per cast.  With ``kernels=False`` the same plain versions run on
any device.

Normals return to world space through the inverse-transpose, hit points
through the forward transform.  Every product is written as multiply-adds
(utils/transform.mat_vec), never as a matmul, so no TF32 enters on a card.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import INFINITY
from ..utils import transform as tf
from ..utils.device import resolve_device
from .intersect import _lane_t_max


class InstanceTable(NamedTuple):
    obj_to_world: torch.Tensor  # (I, 4, 4)
    world_to_obj: torch.Tensor  # (I, 4, 4)
    # optional keyframe motion: one AnimatedTransform per instance
    animated: Optional[tuple] = None


def make_instances(matrices, device="cuda"):
    """An InstanceTable from (I, 4, 4) object-to-world matrices (inverted
    in float64 on the host)."""
    dev = resolve_device(device)
    m = np.asarray(matrices, np.float64)
    return InstanceTable(
        obj_to_world=torch.tensor(m.astype(np.float32), device=dev),
        world_to_obj=torch.tensor(np.linalg.inv(m).astype(np.float32),
                                  device=dev))


def make_animated_instances(m_start, m_end, t0=0.0, t1=1.0, device="cuda"):
    """Instances with two-keyframe motion from m_start to m_end over the
    shutter [t0, t1]."""
    base = make_instances(m_start, device=device)
    ats = tuple(tf.make_animated_transform(np.asarray(m_start[i]),
                                           np.asarray(m_end[i]), t0, t1,
                                           device=device)
                for i in range(len(m_start)))
    return base._replace(animated=ats)


def _xform_ray(m, o, d):
    """Rays through one 4x4 (or per-lane (N,4,4)) matrix; the direction is
    NOT renormalized, so the t of a hit is the world ray's."""
    return tf.mat_vec(m[..., :3, :3], o) + m[..., :3, 3], \
        tf.mat_vec(m[..., :3, :3], d)


def _world_to_obj(table, i, time):
    if table.animated is not None and time is not None:
        return torch.linalg.inv(tf.interpolate(table.animated[i], time))
    return table.world_to_obj[i]


class InstanceHit(NamedTuple):
    hit: torch.Tensor       # (N,) bool
    t: torch.Tensor         # (N,) world-space t
    tri: torch.Tensor       # (N,) int32 triangle id within the base mesh
    inst: torch.Tensor      # (N,) int32 instance id
    b: torch.Tensor         # (N,3) barycentrics


def _casts(verts, tris, bvh, kernels):
    """(closest, any) cast functions (o, d, t_max) -> result of one
    instance's object-space rays against the base mesh."""
    from ..kernels import closest_hit as ch
    from ..kernels import packet_bvh as pk

    if bvh is not None:
        pack = bvh.packet
        if kernels:
            return (lambda o, d, t: pk.packet_closest_hit(pack, o, d, t),
                    lambda o, d, t: pk.packet_any_hit(pack, o, d, t))
        return (lambda o, d, t: pk.packet_closest_hit_reference(pack, o, d, t),
                lambda o, d, t: pk.packet_any_hit_reference(pack, o, d, t))
    soa = ch.tri_soa_from_mesh(verts, tris)
    if kernels:
        return (lambda o, d, t: ch.closest_hit(o, d, t, soa),
                lambda o, d, t: ch.any_hit(o, d, t, soa))
    return (lambda o, d, t: ch.closest_hit_reference(o, d, t, soa),
            lambda o, d, t: ch.any_hit_reference(o, d, t, soa))


def instanced_closest_hit(verts, tris, table: InstanceTable, o, d, t_max,
                          time=None, bvh=None, kernels=False):
    """Closest hit over every instance of the base mesh (verts (V,3), tris
    (T,3)).  t_max: (N,) or a scalar; time: optional (N,) per-lane times of
    an animated table; bvh: the base mesh's tree, walked instead of brute
    force; kernels: cast through the hand-written kernels' wrappers (module
    docstring)."""
    n = o.shape[0]
    dev = o.device
    closest, _ = _casts(verts, tris, bvh, kernels)
    t_best = _lane_t_max(t_max, n, dev).contiguous()
    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    tri = torch.zeros((n,), dtype=torch.int32, device=dev)
    inst = torch.zeros((n,), dtype=torch.int32, device=dev)
    bary = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for i in range(table.obj_to_world.shape[0]):
        oo, do = _xform_ray(_world_to_obj(table, i, time), o, d)
        th = closest(oo.contiguous(), do.contiguous(), t_best)
        better = th.hit & (th.t < t_best)
        t_best = torch.where(better, th.t, t_best)
        hit = hit | better
        tri = torch.where(better, th.tri, tri)
        inst = torch.where(better, i, inst)
        bary = torch.where(better[:, None], th.b, bary)
    return InstanceHit(hit=hit, t=torch.where(hit, t_best, INFINITY), tri=tri,
                       inst=inst, b=bary)


def instanced_any_hit(verts, tris, table: InstanceTable, o, d, t_max,
                      time=None, bvh=None, kernels=False):
    """Occlusion over every instance: (N,) bool.  Each instance's cast takes
    the caller's t_max.  Arguments as instanced_closest_hit's."""
    n = o.shape[0]
    _, any_hit = _casts(verts, tris, bvh, kernels)
    t_max = _lane_t_max(t_max, n, o.device).contiguous()
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for i in range(table.obj_to_world.shape[0]):
        oo, do = _xform_ray(_world_to_obj(table, i, time), o, d)
        occ = occ | any_hit(oo.contiguous(), do.contiguous(), t_max)
    return occ


def instance_hit_geometry(verts, tris, table: InstanceTable, h: InstanceHit,
                          time=None):
    """World-space hit point and unit geometric normal of an InstanceHit:
    the hit triangle's object-space point through the forward transform,
    its normal through the inverse-transpose."""
    tv = tris[h.tri.long()].long()
    p0, p1, p2 = verts[tv[:, 0]], verts[tv[:, 1]], verts[tv[:, 2]]
    p_obj = h.b[:, 0:1] * p0 + h.b[:, 1:2] * p1 + h.b[:, 2:3] * p2
    ng_obj = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    idx = h.inst.long()
    if table.animated is not None and time is not None:
        o2w = torch.stack([tf.interpolate(at, time) for at in table.animated])
        m = o2w[idx, torch.arange(idx.shape[0], device=idx.device)]
        w2o = torch.linalg.inv(m)
    else:
        m = table.obj_to_world[idx]
        w2o = table.world_to_obj[idx]
    p_w = tf.mat_vec(m[:, :3, :3], p_obj) + m[:, :3, 3]
    ng_w = tf.mat_vec(w2o[:, :3, :3].transpose(-1, -2), ng_obj)
    ng_w = ng_w / torch.clamp(torch.linalg.vector_norm(ng_w, dim=-1,
                                                       keepdim=True), min=1e-20)
    return p_w, ng_w
