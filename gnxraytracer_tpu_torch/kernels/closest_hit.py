"""Brute-force watertight closest hit: the wrapper of the CUDA kernel
csrc/closest_hit.cu, and the plain PyTorch version beside it.

The kernel replaces the JAX package's TPU kernel
ops/pallas_intersect.py::_kernel (see the note in the .cu file for what
bounds it on an H100 and what the design does about it).  On a CUDA tensor
``closest_hit`` launches the kernel or raises; on a CPU tensor it runs
``closest_hit_reference``, which is also what the kernel is held against
on the card.
"""

import ctypes

import torch

from ..constants import INFINITY
from ..ops.intersect import TriHit, _permute_shear, _watertight_one
from . import build

# launches of the CUDA kernel (and nothing else) since the last reset
launch_count = 0


def reset_launch_count():
    global launch_count
    launch_count = 0


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


_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("closest_hit").gnx_closest_hit
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, p, p, p, p, p,
                       ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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


def closest_hit(o, d, t_max, tri_soa):
    """Closest hit of N rays against the (T,9) triangle table.

    o, d: (N,3) float32; t_max: (N,) float32; tri_soa: (T,9) float32, T >= 1;
    all contiguous and on one device.  Returns TriHit(hit (N,) bool,
    t (N,) f32 — INFINITY on a miss, tri (N,) i32, b (N,3) f32)."""
    n = o.shape[0]
    dev = o.device
    f32 = torch.float32
    _check("o", o, (n, 3), f32, dev)
    _check("d", d, (n, 3), f32, dev)
    _check("t_max", t_max, (n,), f32, dev)
    if tri_soa.ndim != 2 or tri_soa.shape[0] < 1:
        raise ValueError("tri_soa must be (T,9) with T >= 1")
    _check("tri_soa", tri_soa, (tri_soa.shape[0], 9), f32, dev)
    if dev.type == "cpu":
        return closest_hit_reference(o, d, t_max, tri_soa)
    if dev.type != "cuda":
        raise ValueError(f"closest_hit runs on cuda or cpu tensors, not {dev}")

    fn = _kernel_fn()
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
