"""Image export and tonemapping.

The film stays linear HDR (correct for parity and gradients); tonemapping
happens only at export, with the reference renderer's exposure curve for
visual comparison.  The HDR / image loaders of the JAX package wait for the
textured and environment-lit scenes.
"""

import numpy as np


def tonemap_reference(img):
    """The reference exposure curve: 1 - exp(-v / (1 - 0.75))."""
    return 1.0 - np.exp(-np.asarray(img) / 0.25)


def to_srgb(img):
    x = np.clip(np.asarray(img), 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x, 1.055 * x ** (1 / 2.4) - 0.055)


def to_uint8(img):
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_png(path, img, tonemap="reference"):
    """Save linear HDR (H,W,3) to PNG.  tonemap: reference | srgb | none."""
    if tonemap == "reference":
        img = tonemap_reference(img)
    elif tonemap == "srgb":
        img = to_srgb(img)
    arr = to_uint8(img)
    try:
        from PIL import Image

        Image.fromarray(arr).save(path)
    except ImportError:
        import imageio

        imageio.imwrite(path, arr)
    return path
