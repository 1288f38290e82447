"""Brute-force watertight casts: the wrappers of the two CUDA kernels of
csrc/closest_hit.cu, closest hit and any hit, and the plain PyTorch version
beside each.

The closest-hit kernel replaces the JAX package's TPU kernel
ops/pallas_intersect.py::_kernel; the any-hit kernel is the same template
for shadow rays, where the JAX package runs XLA code
(intersect.any_triangle_hit).  See the note in the .cu file for what bounds
them on an H100 and what the design does about it.  On a CUDA tensor
``closest_hit`` / ``any_hit`` launch their kernel or raise; on a CPU tensor
they run ``closest_hit_reference`` / ``any_hit_reference``, which are also
what the kernels are held against on the card.
"""

import ctypes

import torch

from ..constants import INFINITY
from ..ops.intersect import TriHit, _permute_shear, _watertight_one
from . import build

# launches of each CUDA kernel (and nothing else) since the last reset
launch_count = 0  # closest hit
any_launch_count = 0


def reset_launch_count():
    global launch_count, any_launch_count
    launch_count = 0
    any_launch_count = 0


def tri_soa_from_mesh(vertices, triangles):
    """(T,9) [p0|p1|p2] float32 layout the kernel reads."""
    tri = triangles.long()
    return torch.cat([vertices[tri[:, k]] for k in range(3)], dim=1).contiguous()


def closest_hit_reference(o, d, t_max, tri_soa):
    """Plain PyTorch version: a loop over triangles of flat (N,) tensor
    math, carrying the running best hit.  Any device."""
    n = o.shape[0]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    (m0, m1), (sx, sy, sz) = _permute_shear(d)
    best_t = t_max.to(torch.float32).clone()
    best_tri = torch.zeros((n,), dtype=torch.int32, device=o.device)
    best_b = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    hit = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for ti in range(tri_soa.shape[0]):
        tv = tri_soa[ti]
        valid, t, b0, b1, b2 = _watertight_one(
            ox, oy, oz, m0, m1, sx, sy, sz, best_t, tv[0:3], tv[3:6], tv[6:9])
        better = valid & (t < best_t)
        best_t = torch.where(better, t, best_t)
        best_tri = torch.where(better, ti, best_tri)
        best_b = torch.where(better[:, None],
                             torch.stack([b0, b1, b2], dim=-1), best_b)
        hit = hit | better
    return TriHit(hit=hit, t=torch.where(hit, best_t, INFINITY), tri=best_tri,
                  b=best_b)


def any_hit_reference(o, d, t_max, tri_soa):
    """Plain PyTorch version of the any hit (shadow ray, IntersectP
    semantics): a loop over triangles of flat (N,) tensor math; a lane is
    occluded when any triangle's full test is valid with t <= t_max.  Any
    device."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    (m0, m1), (sx, sy, sz) = _permute_shear(d)
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for ti in range(tri_soa.shape[0]):
        tv = tri_soa[ti]
        valid, _, _, _, _ = _watertight_one(
            ox, oy, oz, m0, m1, sx, sy, sz, t_max, tv[0:3], tv[3:6], tv[6:9])
        occ = occ | valid
    return occ


_fns = {}


def _kernel_fn(entry):
    """ctypes handle of an entry point of csrc/closest_hit.cu."""
    fn = _fns.get(entry)
    if fn is None:
        fn = getattr(build.load("closest_hit"), entry)
        p = ctypes.c_void_p
        outs = [p] * (4 if entry == "gnx_closest_hit" else 1)
        fn.argtypes = [p, ctypes.c_int, p, p, p, *outs, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn


def _check(name, x, shape, dtype, device):
    if not torch.is_tensor(x):
        raise TypeError(f"{name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_cast(name, o, d, t_max, tri_soa):
    """The inputs both wrappers take; returns the device type."""
    n = o.shape[0]
    dev = o.device
    f32 = torch.float32
    _check("o", o, (n, 3), f32, dev)
    _check("d", d, (n, 3), f32, dev)
    _check("t_max", t_max, (n,), f32, dev)
    if tri_soa.ndim != 2 or tri_soa.shape[0] < 1:
        raise ValueError("tri_soa must be (T,9) with T >= 1")
    _check("tri_soa", tri_soa, (tri_soa.shape[0], 9), f32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {dev}")
    return dev.type


def closest_hit(o, d, t_max, tri_soa):
    """Closest hit of N rays against the (T,9) triangle table.

    o, d: (N,3) float32; t_max: (N,) float32; tri_soa: (T,9) float32, T >= 1;
    all contiguous and on one device.  Returns TriHit(hit (N,) bool,
    t (N,) f32 — INFINITY on a miss, tri (N,) i32, b (N,3) f32)."""
    if _check_cast("closest_hit", o, d, t_max, tri_soa) == "cpu":
        return closest_hit_reference(o, d, t_max, tri_soa)

    n, dev, f32 = o.shape[0], o.device, torch.float32
    fn = _kernel_fn("gnx_closest_hit")
    t_out = torch.empty((n,), dtype=f32, device=dev)
    tri_out = torch.empty((n,), dtype=torch.int32, device=dev)
    b_out = torch.empty((n, 3), dtype=f32, device=dev)
    hit_out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return TriHit(hit=hit_out, t=t_out, tri=tri_out, b=b_out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(tri_soa.data_ptr(), tri_soa.shape[0], o.data_ptr(),
                 d.data_ptr(), t_max.data_ptr(), t_out.data_ptr(),
                 tri_out.data_ptr(), b_out.data_ptr(), hit_out.data_ptr(),
                 n, stream)
    if err != 0:
        raise RuntimeError(f"closest_hit kernel launch failed: cudaError {err}")
    global launch_count
    launch_count += 1
    return TriHit(hit=hit_out, t=t_out, tri=tri_out, b=b_out)


def any_hit(o, d, t_max, tri_soa):
    """Any hit (shadow rays) of N rays against the (T,9) triangle table:
    (N,) bool, True where some triangle is hit with 0 < t <= t_max.  Inputs
    as closest_hit's."""
    if _check_cast("any_hit", o, d, t_max, tri_soa) == "cpu":
        return any_hit_reference(o, d, t_max, tri_soa)

    n, dev = o.shape[0], o.device
    fn = _kernel_fn("gnx_brute_any_hit")
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(tri_soa.data_ptr(), tri_soa.shape[0], o.data_ptr(),
                 d.data_ptr(), t_max.data_ptr(), occ.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"any_hit kernel launch failed: cudaError {err}")
    global any_launch_count
    any_launch_count += 1
    return occ
