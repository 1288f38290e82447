"""Quaternions and animated transforms (keyframe motion).

  * quaternions are (..., 4) float32 tensors in (x, y, z, w) layout,
    batched and differentiable;
  * ``decompose`` splits a 4x4 into translate * rotate * scale by polar
    iteration, on the host;
  * ``interpolate`` lerps T and S and slerps R of an ``AnimatedTransform``,
    batched over per-lane times;
  * ``motion_bounds`` returns a conservative box for animated geometry by
    unioning the transformed corners over a dense time sweep and padding.

Every matrix product here is written as multiply-adds of whole tensors, never
as a matmul: on a CUDA device a matmul may run in TF32, and these products
place rays and hit points.
"""

from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device


def mat_vec(m, v):
    """(..., 3, 3) x (..., 3) -> (..., 3), broadcasting the batch
    dimensions, as ((m0 v0 + m1 v1) + m2 v2) row by row in float32."""
    return (m[..., :, 0] * v[..., None, 0] + m[..., :, 1] * v[..., None, 1]
            + m[..., :, 2] * v[..., None, 2])


def mat_mul(a, b):
    """(..., R, K) x (..., K, C) -> (..., R, C) as multiply-adds."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


# ---------------------------------------------------------------------------
# Quaternion: (..., 4) tensors, layout (x, y, z, w)
# ---------------------------------------------------------------------------

def quat_identity(device="cuda"):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32,
                        device=resolve_device(device))


def quat_dot(a, b):
    return torch.sum(a * b, dim=-1)


def quat_normalize(q):
    return q / torch.sqrt(torch.clamp(quat_dot(q, q), min=1e-30))[..., None]


def quat_mul(a, b):
    """Hamilton product."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def slerp(t, q1, q2):
    """Spherical linear interpolation; normalized lerp where the two
    quaternions are nearly parallel (cos theta > .9995)."""
    cos_theta = quat_dot(q1, q2)
    near = cos_theta > 0.9995
    q_lerp = quat_normalize(q1 + t[..., None] * (q2 - q1))
    theta = torch.acos(torch.clamp(cos_theta, -1.0, 1.0))
    theta_p = theta * t
    qperp = quat_normalize(q2 - q1 * cos_theta[..., None])
    q_slerp = (q1 * torch.cos(theta_p)[..., None]
               + qperp * torch.sin(theta_p)[..., None])
    return torch.where(near[..., None], q_lerp, q_slerp)


def quat_from_matrix(m):
    """Quaternion of a 3x3 / 4x4 rotation: Shepperd's method, its trace
    branches selected with where-masks."""
    r = m[..., :3, :3]
    t00, t11, t22 = r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]
    trace = t00 + t11 + t22

    s0 = torch.sqrt(torch.clamp(trace + 1.0, min=1e-12))
    s0i = 0.5 / s0
    q0 = torch.stack([(r[..., 2, 1] - r[..., 1, 2]) * s0i,
                      (r[..., 0, 2] - r[..., 2, 0]) * s0i,
                      (r[..., 1, 0] - r[..., 0, 1]) * s0i,
                      s0 / 2.0], dim=-1)

    def axis_case(i, j, k):
        s = torch.sqrt(torch.clamp(
            r[..., i, i] - (r[..., j, j] + r[..., k, k]) + 1.0, min=1e-12))
        si = 0.5 / s
        out = [None, None, None]
        out[i] = s * 0.5
        out[j] = (r[..., j, i] + r[..., i, j]) * si
        out[k] = (r[..., k, i] + r[..., i, k]) * si
        return torch.stack(out + [(r[..., k, j] - r[..., j, k]) * si], dim=-1)

    use_x = (t00 > t11) & (t00 > t22)
    use_y = ~use_x & (t11 > t22)
    q_neg = torch.where(use_x[..., None], axis_case(0, 1, 2),
                        torch.where(use_y[..., None], axis_case(1, 2, 0),
                                    axis_case(2, 0, 1)))
    return quat_normalize(torch.where((trace > 0.0)[..., None], q0, q_neg))


def quat_to_matrix(q):
    """(..., 4) quaternion -> (..., 4, 4) rotation."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    rows = [
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy), zero], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx), zero], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy), zero], -1),
        torch.stack([zero, zero, zero, one], -1),
    ]
    return torch.stack(rows, dim=-2)


# ---------------------------------------------------------------------------
# Decompose + AnimatedTransform
# ---------------------------------------------------------------------------

def decompose(m):
    """M = T * R * S on the host (numpy, float64): returns (t (3,), r
    quaternion (4,), s (4,4)), float32.  The rotation comes from the polar
    iteration M_{i+1} = (M_i + M_i^-T) / 2 (at most 100 steps, 1e-4 norm
    cutoff)."""
    m = np.asarray(m, np.float64)
    t = m[:3, 3].copy()
    rot = m.copy()
    rot[:3, 3] = 0.0
    rot[3, :] = [0, 0, 0, 1]
    r = rot.copy()
    for _ in range(100):
        r_next = 0.5 * (r + np.linalg.inv(r.T))
        norm = np.abs(r_next[:3, :3] - r[:3, :3]).sum(axis=1).max()
        r = r_next
        if norm < 1e-4:
            break
    s = np.linalg.inv(r) @ rot
    q = quat_from_matrix(torch.from_numpy(r.astype(np.float32))).numpy()
    return t.astype(np.float32), q.astype(np.float32), s.astype(np.float32)


class AnimatedTransform(NamedTuple):
    """Two-keyframe rigid + scale motion; every field a tensor on the
    device, so a batch of per-lane times interpolates in one pass."""
    start_time: torch.Tensor     # ()
    end_time: torch.Tensor       # ()
    t0: torch.Tensor             # (3,) translations
    t1: torch.Tensor
    r0: torch.Tensor             # (4,) rotations
    r1: torch.Tensor
    s0: torch.Tensor             # (4,4) scale / shear parts
    s1: torch.Tensor
    actually_animated: torch.Tensor  # () bool


def make_animated_transform(m_start, m_end, t_start=0.0, t_end=1.0,
                            device="cuda"):
    dev = resolve_device(device)
    t0, r0, s0 = decompose(m_start)
    t1, r1, s1 = decompose(m_end)
    if float(np.sum(r0 * r1)) < 0.0:  # the shorter rotation arc
        r1 = -r1
    animated = not np.allclose(np.asarray(m_start), np.asarray(m_end))

    def put(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return AnimatedTransform(
        start_time=put(t_start), end_time=put(t_end), t0=put(t0), t1=put(t1),
        r0=put(r0), r1=put(r1), s0=put(s0), s1=put(s1),
        actually_animated=torch.tensor(animated, device=dev))


def interpolate(at: AnimatedTransform, time):
    """The transform at each of (...,) times -> (..., 4, 4)."""
    time = torch.as_tensor(time, dtype=torch.float32, device=at.t0.device)
    dt = torch.where(
        at.end_time > at.start_time,
        (time - at.start_time)
        / torch.clamp(at.end_time - at.start_time, min=1e-12),
        torch.zeros_like(time))
    dt = torch.clamp(dt, 0.0, 1.0)
    trans = (1.0 - dt)[..., None] * at.t0 + dt[..., None] * at.t1
    rot = slerp(dt, at.r0.expand(dt.shape + (4,)), at.r1.expand(dt.shape + (4,)))
    scale = (1.0 - dt)[..., None, None] * at.s0 + dt[..., None, None] * at.s1
    m = mat_mul(quat_to_matrix(rot), scale)
    return _with_translation(m, m[..., :3, 3] + trans)


def _with_translation(m, t):
    top = torch.cat([m[..., :3, :3], t[..., None]], dim=-1)
    return torch.cat([top, m[..., 3:4, :]], dim=-2)


def xform_point(m, p):
    """(..., 4, 4) x (..., 3) -> (..., 3) with the perspective divide."""
    ph = mat_vec(m[..., :3, :3], p) + m[..., :3, 3]
    w = (m[..., 3, 0] * p[..., 0] + m[..., 3, 1] * p[..., 1]
         + m[..., 3, 2] * p[..., 2]) + m[..., 3, 3]
    return ph / w[..., None]


def xform_vector(m, v):
    return mat_vec(m[..., :3, :3], v)


def motion_bounds(at: AnimatedTransform, lo, hi, n_samples=64, pad=1e-3):
    """Conservative bounds of the box [lo, hi] swept over [start, end]:
    the union of its transformed corners over n_samples times, padded by
    pad x its largest extent."""
    dev = at.t0.device
    lo = torch.as_tensor(lo, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=dev)
    corners = torch.stack([
        torch.stack([hi[0] if i & 1 else lo[0], hi[1] if i & 2 else lo[1],
                     hi[2] if i & 4 else lo[2]])
        for i in range(8)])  # (8, 3)
    times = torch.linspace(float(at.start_time), float(at.end_time),
                           n_samples, device=dev)
    mats = interpolate(at, times)  # (S, 4, 4)
    pts = xform_point(mats[:, None], corners[None, :])  # (S, 8, 3)
    diag = torch.max(hi - lo)
    return (torch.amin(pts, dim=(0, 1)) - pad * diag,
            torch.amax(pts, dim=(0, 1)) + pad * diag)
