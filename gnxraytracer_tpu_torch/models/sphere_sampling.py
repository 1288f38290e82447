"""Sphere area sampling: uniform sampling of the surface and cone sampling
toward a reference point, with the matching solid-angle pdfs (counterpart
of the JAX package's models/sphere_sampling.py; pbrt-v3's Sphere::Sample
and Sphere::Pdf, which the reference renderer's Shape interface promises).

  * `sample_uniform`: area sampling over the whole sphere, pdf 1 / area;
  * `sample_from_ref`: from a reference point outside the sphere, the cone
    of directions it subtends is sampled; from inside, uniform area
    sampling converted to solid angle;
  * `pdf_from_ref`: the solid-angle pdf of a direction toward the sphere.

Batched over (N,) lanes, plain PyTorch on the device of the arguments and
differentiable with respect to the center and the radius.
"""

from typing import NamedTuple

import torch

from ..constants import PI
from ..ops.sampling import uniform_cone_pdf, uniform_sample_sphere
from ..utils.math import (
    coordinate_system, dot, length_squared, normalize,
    spherical_direction_basis,
)


class ShapeSample(NamedTuple):
    p: torch.Tensor    # (N,3) sampled point on the sphere
    n: torch.Tensor    # (N,3) outward normal
    pdf: torch.Tensor  # (N,) pdf (area measure for sample_uniform,
                       #          solid angle for sample_from_ref)


def sphere_area(radius):
    return 4.0 * PI * radius * radius


def sample_uniform(center, radius, u2):
    """Shape::Sample(u): uniform over the surface, pdf = 1 / area."""
    dir_ = uniform_sample_sphere(u2)
    p = center + radius[..., None] * dir_
    return ShapeSample(p=p, n=dir_, pdf=1.0 / sphere_area(radius))


def sample_from_ref(center, radius, ref_p, u2):
    """Sphere::Sample(ref, u): the visible cap's cone when ref_p is outside,
    uniform area sampling converted to solid angle when it is inside.
    Returns a ShapeSample with a solid-angle pdf."""
    dc2 = length_squared(ref_p - center)
    dc = torch.sqrt(torch.clamp(dc2, min=1e-20))
    r2 = radius * radius
    inside = dc2 <= r2

    # outside: the cone the sphere subtends
    wc = normalize(center - ref_p, eps=1e-20)
    wc_x, wc_y = coordinate_system(wc)
    sin2_theta_max = r2 / dc2
    cos_theta_max = torch.sqrt(torch.clamp(1.0 - sin2_theta_max, min=0.0))
    cos_theta = (1.0 - u2[..., 0]) + u2[..., 0] * cos_theta_max
    sin2_theta = torch.clamp(1.0 - cos_theta * cos_theta, min=0.0)
    phi = u2[..., 1] * 2.0 * PI
    # distance to the sampled point along the cone's ray, and the angle
    # alpha at the center (law of cosines)
    ds = dc * cos_theta - torch.sqrt(torch.clamp(r2 - dc2 * sin2_theta,
                                                 min=0.0))
    cos_alpha = (dc2 + r2 - ds * ds) / torch.clamp(2.0 * dc * radius,
                                                   min=1e-20)
    sin_alpha = torch.sqrt(torch.clamp(1.0 - cos_alpha * cos_alpha, min=0.0))
    n_out = spherical_direction_basis(sin_alpha, cos_alpha, phi,
                                      -wc_x, -wc_y, -wc)
    p_out = center + radius[..., None] * n_out
    pdf_out = uniform_cone_pdf(cos_theta_max)

    # inside: uniform area, converted to solid angle
    s_in = sample_uniform(center, radius, u2)
    wi = s_in.p - ref_p
    d2 = length_squared(wi)
    wi_n = normalize(wi, eps=1e-20)
    cos_surf = torch.abs(dot(s_in.n, -wi_n))
    pdf_in = torch.where(cos_surf > 1e-9,
                         s_in.pdf * d2 / torch.clamp(cos_surf, min=1e-9), 0.0)

    pick = inside[..., None]
    return ShapeSample(p=torch.where(pick, s_in.p, p_out),
                       n=torch.where(pick, s_in.n, n_out),
                       pdf=torch.where(inside, pdf_in, pdf_out))


def pdf_from_ref(center, radius, ref_p, wi):
    """Sphere::Pdf(ref, wi): the uniform cone pdf inside the subtended cone
    (0 outside it) when ref_p is outside; the area pdf converted at the
    point where the ray (ref_p, wi) leaves the sphere when it is inside."""
    dc2 = length_squared(ref_p - center)
    r2 = radius * radius
    inside = dc2 <= r2

    sin2_theta_max = r2 / torch.clamp(dc2, min=1e-20)
    cos_theta_max = torch.sqrt(torch.clamp(1.0 - sin2_theta_max, min=0.0))
    pdf_out = uniform_cone_pdf(cos_theta_max)

    oc = ref_p - center
    b = dot(oc, wi)
    c = length_squared(oc) - r2
    disc = b * b - c
    hit = disc > 0
    t = -b + torch.sqrt(torch.clamp(disc, min=0.0))  # the far root
    p_hit = ref_p + t[..., None] * wi
    n_hit = normalize(p_hit - center, eps=1e-20)
    cos_surf = torch.abs(dot(n_hit, -wi))
    pdf_in = torch.where(
        hit & (cos_surf > 1e-9),
        (t * t) / (torch.clamp(cos_surf, min=1e-9) * sphere_area(radius)),
        0.0)
    wc = normalize(center - ref_p, eps=1e-20)
    in_cone = dot(wc, wi) >= cos_theta_max
    pdf_out = torch.where(in_cone, pdf_out, 0.0)
    return torch.where(inside, pdf_in, pdf_out)
