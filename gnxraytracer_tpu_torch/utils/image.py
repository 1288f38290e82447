"""Image IO and tonemapping.

The film stays linear HDR (correct for parity and gradients); tonemapping
happens only at export, with the reference renderer's exposure curve for
visual comparison.  Loaders: Radiance RGBE (.hdr) environment maps and LDR
texture images; a writer of a procedural .hdr environment for where the
reference renderer's MonValley1000.hdr is not at hand.
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


def load_hdr(path):
    """Radiance RGBE (.hdr) decoder -> float32 (H,W,3) linear radiance.

    Written from the public RGBE spec.  Handles new-style RLE scanlines and
    flat data.
    """
    with open(path, "rb") as f:
        data = f.read()
    # header ends at the first blank line
    pos = 0
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    # resolution line, e.g. "-Y 500 +X 1000"
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    height = int(res[1])
    width = int(res[3])
    body = np.frombuffer(data, np.uint8, offset=pos)

    rgbe = np.zeros((height, width, 4), np.uint8)
    if width < 8 or width > 0x7FFF or body[0] != 2 or body[1] != 2:
        # flat (non-RLE) data
        rgbe = body[: height * width * 4].reshape(height, width, 4)
    else:
        off = 0
        for y in range(height):
            if body[off] != 2 or body[off + 1] != 2:
                raise ValueError(f"{path}: bad RLE scanline header at row {y}")
            off += 4  # 0x02 0x02 + 2-byte width
            for c in range(4):
                x = 0
                while x < width:
                    count = int(body[off])
                    off += 1
                    if count > 128:  # run
                        rgbe[y, x: x + count - 128, c] = body[off]
                        off += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x: x + count, c] = body[off: off + count]
                        off += count
                        x += count
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def load_image(path, gamma=True, flip_v=False):
    """Load LDR/HDR image as float32 (H,W,3) linear.

    LDR images are gamma-decoded (sRGB to linear); HDR (.hdr) files go
    through load_hdr (imageio tone-maps .hdr to uint8, losing radiance).
    """
    if path.lower().endswith(".hdr"):
        arr = load_hdr(path)
        if flip_v:
            arr = arr[::-1]
        return arr
    import imageio.v2 as imageio

    arr = np.asarray(imageio.imread(path)).astype(np.float32)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    arr = arr[..., :3]
    arr = arr / 255.0
    if gamma:
        arr = np.where(arr <= 0.04045, arr / 12.92, ((arr + 0.055) / 1.055) ** 2.4)
    if flip_v:
        arr = arr[::-1]
    return arr


def write_procedural_hdr(path, h=500, w=1000):
    """A flat (non-RLE) Radiance RGBE file: a sky gradient, a darker ground
    half and a small sun, so the environment light has something to
    importance-sample."""
    v = (np.arange(h, dtype=np.float32)[:, None] + 0.5) / h
    u = (np.arange(w, dtype=np.float32)[None, :] + 0.5) / w
    sky = np.clip(1.0 - 1.6 * v, 0.0, 1.0)
    img = np.stack([0.25 + 0.6 * sky + 0.1 * np.sin(6.283 * u),
                    0.30 + 0.8 * sky + 0.0 * u,
                    0.35 + 1.4 * sky + 0.1 * np.cos(6.283 * u)], -1)
    sun = ((u - 0.3) ** 2 * 4 + (v - 0.2) ** 2) < 0.0004
    img[sun] = (900.0, 800.0, 600.0)
    img = img.astype(np.float32)
    m = img.max(-1)
    e = np.ceil(np.log2(np.maximum(m, 1e-30))).astype(np.int32)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img / np.exp2(e)[..., None] * 256.0, 0, 255)
    rgbe[..., 3] = np.where(m > 1e-30, e + 128, 0)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    return path
