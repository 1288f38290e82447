"""Image textures: host-side mip pyramid build + lookups on the device.

Textures are resampled host-side to a common power-of-two resolution and
stacked into one (K, H_total, W, 3) tensor; lookups are bilinear (or
trilinear across the stacked pyramid, or anisotropic EWA) gathers + lerps.

The mip pyramid is stored widest-level-first inside the H axis of the atlas
with per-level row offsets, so one tensor carries all levels of all
textures.  The JAX package fetches EWA window rows as 8-texel segments with a
per-lane barrel rotate (a TPU device); plain per-texel gathers read the same
taps with the same weights here.
"""

import numpy as np
import torch

from ..utils.stats import spanned


def _resize_pow2(img, size):
    """Point resample to (size, size) (sufficient for minification)."""
    h, w = img.shape[:2]
    ys = (np.linspace(0, h - 1, size)).astype(int)
    xs = (np.linspace(0, w - 1, size)).astype(int)
    return img[ys][:, xs]


@spanned("build.textures")
def build_texture_atlas(images, base_size=256, device="cpu"):
    """Stack images into a mip atlas.

    Returns (atlas (K, H_total, base, 3), level_offsets (L,) i32,
    level_sizes (L,) i32) on `device`.  H_total = base + base/2 + ... + 1.
    """
    levels = int(np.log2(base_size)) + 1
    sizes = [base_size >> l for l in range(levels)]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    h_total = int(np.sum(sizes))
    atlas = np.zeros((len(images), h_total, base_size, 3), np.float32)
    for k, img in enumerate(images):
        img = np.asarray(img, np.float32)
        level = _resize_pow2(img, base_size)
        for l, s in enumerate(sizes):
            if l > 0:
                # 2x2 box downsample of previous level
                prev = level
                level = 0.25 * (
                    prev[0::2, 0::2] + prev[1::2, 0::2]
                    + prev[0::2, 1::2] + prev[1::2, 1::2]
                )
            atlas[k, offsets[l]: offsets[l] + s, :s] = level
    dev = torch.device(device)
    return (torch.from_numpy(atlas).to(dev), torch.from_numpy(offsets).to(dev),
            torch.tensor(sizes, dtype=torch.int32, device=dev))


def _level_size_offset(sizes, level):
    """(size, row offset) of per-lane mip levels by pow-2 pyramid arithmetic:
    sizes[l] = base >> l, offsets[l] = 2*base - (base >> (l-1))."""
    base = sizes[0].to(torch.int64)
    s = base >> level
    off = torch.where(level == 0, 0,
                      2 * base - (base >> torch.clamp(level - 1, min=0)))
    return s, off


def bilinear_lookup(atlas, offsets, sizes, tex_id, uv, level=0):
    """Bilinear texel lookup at a mip level (Repeat wrap mode).

    atlas: (K, H_total, W, 3); tex_id: (N,); uv: (N,2); level: an int or a
    (N,) tensor of per-lane levels.
    """
    if isinstance(level, int):
        s = sizes[level].to(torch.int64)
        off = offsets[level].to(torch.int64)
    else:
        s, off = _level_size_offset(sizes, level.to(torch.int64))
    sf = s.to(torch.float32)
    u = uv[..., 0] * sf - 0.5
    v = uv[..., 1] * sf - 0.5
    u0f = torch.floor(u)
    v0f = torch.floor(v)
    u0 = u0f.to(torch.int64)
    v0 = v0f.to(torch.int64)
    du = (u - u0f)[..., None]
    dv = (v - v0f)[..., None]
    tid = tex_id.to(torch.int64)

    def texel(ui, vi):
        ui = torch.remainder(ui, s)
        vi = torch.remainder(vi, s)
        return atlas[tid, off + vi, ui]

    return (
        (1 - du) * (1 - dv) * texel(u0, v0)
        + du * (1 - dv) * texel(u0 + 1, v0)
        + (1 - du) * dv * texel(u0, v0 + 1)
        + du * dv * texel(u0 + 1, v0 + 1)
    )


def ewa_lookup(atlas, offsets, sizes, tex_id, uv, dst0, dst1,
               max_anisotropy=8.0, window=8):
    """Anisotropic EWA filtering.

    Every lane scans a fixed (window x window) texel footprint at the chosen
    mip level (the lod rule makes the minor axis ~1 texel, and the
    eccentricity clamp bounds the major axis to max_anisotropy texels, so a
    fixed window loses only extreme-anisotropy tails) with the
    exp(-2 r^2) - exp(-2) falloff.  Two adjacent levels are blended.

    uv: (N,2); dst0/dst1: (N,2) texture-space footprint axes.
    """
    # swap so dst0 is the major axis
    l0 = torch.sum(dst0 * dst0, -1)
    l1 = torch.sum(dst1 * dst1, -1)
    swap = (l0 < l1)[..., None]
    d0 = torch.where(swap, dst1, dst0)
    d1 = torch.where(swap, dst0, dst1)
    major = torch.sqrt(torch.clamp(torch.sum(d0 * d0, -1), min=1e-20))
    minor = torch.sqrt(torch.clamp(torch.sum(d1 * d1, -1), min=1e-20))
    # clamp eccentricity
    scale = torch.where(minor * max_anisotropy < major,
                        major / (minor * max_anisotropy), 1.0)
    d1 = d1 * scale[..., None]
    minor = minor * scale

    n_levels = sizes.shape[0]
    lod = torch.clamp(n_levels - 1.0 + torch.log2(torch.clamp(minor, min=1e-8)),
                      0.0, n_levels - 1.0)
    l0f = torch.floor(lod)
    l0i = l0f.to(torch.int64)
    dl = (lod - l0f)[..., None]
    tid = tex_id.to(torch.int64)
    exp_m2 = float(np.exp(np.float32(-2.0)))

    def ewa_level(level_idx):
        """level_idx: (N,) per-lane mip level; one footprint scan for all
        lanes at per-lane levels."""
        si, off = _level_size_offset(sizes, level_idx)
        s = si.to(torch.float32)
        st = uv * s[..., None] - 0.5
        e0 = d0 * s[..., None]
        e1 = d1 * s[..., None]
        a = e0[..., 1] ** 2 + e1[..., 1] ** 2 + 1.0
        b = -2.0 * (e0[..., 0] * e0[..., 1] + e1[..., 0] * e1[..., 1])
        c = e0[..., 0] ** 2 + e1[..., 0] ** 2 + 1.0
        inv_f = 1.0 / (a * c - 0.25 * b * b)
        a = a * inv_f
        b = b * inv_f
        c = c * inv_f
        s0 = torch.round(st[..., 0]).to(torch.int64) - window // 2
        t0 = torch.round(st[..., 1]).to(torch.int64) - window // 2
        acc = torch.zeros(uv.shape[:-1] + (3,), dtype=torch.float32,
                          device=uv.device)
        wsum = torch.zeros(uv.shape[:-1], dtype=torch.float32,
                           device=uv.device)
        for it in range(window):
            tt = (t0 + it).to(torch.float32) - st[..., 1]
            vi = off + torch.remainder(t0 + it, si)
            for is_ in range(window):
                ss_ = (s0 + is_).to(torch.float32) - st[..., 0]
                r2 = a * ss_ * ss_ + b * ss_ * tt + c * tt * tt
                w = torch.where(r2 < 1.0, torch.exp(-2.0 * r2) - exp_m2, 0.0)
                ui = torch.remainder(s0 + is_, si)
                acc = acc + w[..., None] * atlas[tid, vi, ui]
                wsum = wsum + w
        return acc, wsum

    acc0, w0 = ewa_level(l0i)
    acc1, w1 = ewa_level(torch.clamp(l0i + 1, max=n_levels - 1))
    fallback = bilinear_lookup(atlas, offsets, sizes, tex_id, uv, 0)

    def finish(acc, wsum):
        ok = (wsum > 1e-8)[..., None]
        return torch.where(ok, acc / torch.clamp(wsum[..., None], min=1e-8),
                           fallback)

    return (1.0 - dl) * finish(acc0, w0) + dl * finish(acc1, w1)


def trilinear_lookup(atlas, offsets, sizes, tex_id, uv, width):
    """Trilinear lookup with filter width -> mip level selection."""
    n_levels = sizes.shape[0]
    base = sizes[0].to(torch.float32)
    level_f = n_levels - 1 + torch.log2(torch.clamp(width, min=1e-8))
    level_f = torch.clamp(level_f + torch.log2(base) - (n_levels - 1), 0.0,
                          n_levels - 1.0)
    l0f = torch.floor(level_f)
    l0 = l0f.to(torch.int64)
    dl = (level_f - l0f)[..., None]
    out0 = bilinear_lookup(atlas, offsets, sizes, tex_id, uv, l0)
    out1 = bilinear_lookup(atlas, offsets, sizes, tex_id, uv,
                           torch.clamp(l0 + 1, max=n_levels - 1))
    return (1 - dl) * out0 + dl * out1
