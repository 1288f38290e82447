"""Vector math over SoA (..., 3) float32 tensors; every helper broadcasts
over leading batch dimensions (counterpart of the JAX utils/math.py)."""

import torch

from ..constants import PI


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def absdot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(v):
    return torch.sum(v * v, dim=-1)


def sqrt0(x):
    """sqrt(max(x, 0)) with a zero gradient where x <= 0.  The plain sqrt's
    derivative is infinite at 0, and the zero gradient that a masking
    where() (or a factor that vanishes there) sends back becomes NaN
    (0 * inf) in every parameter upstream.  The values are
    torch.sqrt(torch.clamp(x, min=0))'s, bit for bit."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def length(v):
    return torch.sqrt(length_squared(v))


def normalize(v, eps=0.0):
    """Normalize along the last axis. eps guards 0-vectors for AD safety."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    inv = 1.0 / torch.sqrt(torch.clamp(n2, min=eps if eps else 1e-30))
    return v * torch.where(n2 > 0, inv, 0.0)


def face_forward(n, v):
    """Flip n so it lies in the hemisphere of v."""
    s = torch.where(dot(n, v) < 0.0, -1.0, 1.0)
    return n * s[..., None]


def coordinate_system(v1):
    """Orthonormal basis around unit v1: pick the larger of |x|,|y| to avoid
    degeneracy, expressed branchlessly with where masks."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    cond = torch.abs(x) > torch.abs(y)
    inv_a = 1.0 / torch.sqrt(torch.where(cond, x * x + z * z, y * y + z * z))
    zero = torch.zeros_like(x)
    v2a = torch.stack([-z, zero, x], dim=-1)
    v2b = torch.stack([zero, z, -y], dim=-1)
    v2 = torch.where(cond[..., None], v2a, v2b) * inv_a[..., None]
    v3 = cross(v1, v2)
    return v2, v3


def spherical_direction(sin_theta, cos_theta, phi):
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta],
        dim=-1)


def spherical_direction_basis(sin_theta, cos_theta, phi, x, y, z):
    """The direction (sin_theta, phi, cos_theta) in the frame x, y, z."""
    return ((sin_theta * torch.cos(phi))[..., None] * x
            + (sin_theta * torch.sin(phi))[..., None] * y
            + cos_theta[..., None] * z)


def spherical_theta(v):
    return torch.acos(torch.clamp(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + 2.0 * PI, p)


def reflect(wo, n):
    """Mirror wo about n (both pointing away from the surface)."""
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi, n, eta):
    """Refract wi about n with relative IOR eta (incident/transmitted).
    Returns (ok, wt): ok is False on total internal reflection."""
    cos_theta_i = dot(n, wi)
    sin2_theta_i = torch.clamp(1.0 - cos_theta_i * cos_theta_i, min=0.0)
    sin2_theta_t = eta * eta * sin2_theta_i
    ok = sin2_theta_t < 1.0
    # sanitize before the sqrt: past TIR 1-sin2 <= 0 and sqrt's derivative
    # w.r.t. eta is infinite
    s2s = torch.where(ok, sin2_theta_t, 0.0)
    cos_theta_t = sqrt0(1.0 - s2s)
    wt = eta[..., None] * -wi + (eta * cos_theta_i - cos_theta_t)[..., None] * n
    return ok, wt


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


def distance(a, b):
    return length(a - b)


# ---- local shading-frame helpers (BSDF space: z = normal) -------------------

def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def sin2_theta(w):
    return torch.clamp(1.0 - cos2_theta(w), min=0.0)


def sin_theta(w):
    return sqrt0(sin2_theta(w))


def tan_theta(w):
    return sin_theta(w) / w[..., 2]


def tan2_theta(w):
    return sin2_theta(w) / cos2_theta(w)


def cos_phi(w):
    s = sin_theta(w)
    safe = torch.where(s == 0.0, 1.0, s)
    return torch.where(s == 0.0, 1.0, torch.clamp(w[..., 0] / safe, -1.0, 1.0))


def sin_phi(w):
    s = sin_theta(w)
    safe = torch.where(s == 0.0, 1.0, s)
    return torch.where(s == 0.0, 0.0, torch.clamp(w[..., 1] / safe, -1.0, 1.0))


def cos2_phi(w):
    c = cos_phi(w)
    return c * c


def sin2_phi(w):
    s = sin_phi(w)
    return s * s


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0
