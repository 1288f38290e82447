"""Live progressive viewers, the command line's stand-in for the reference
renderer's Qt display: after each progressive chunk the current estimate is
drawn into the terminal (24-bit ANSI half-blocks, two pixels a character
cell) or rewritten to a PNG that a file watcher or image viewer can follow.
The tonemap is the reference renderer's export curve.  Works on numpy
images (the caller copies the film to the host once a chunk).

Counterpart of the JAX package's utils/viewer.py: the same strings and
pixels for the same image.
"""

import sys

import numpy as np


def _tonemap(img, mode="reference"):
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    if mode == "reference":
        # 1 - exp(-v / (1 - 0.75))
        return 1.0 - np.exp(-img / 0.25)
    if mode == "srgb":
        return np.clip(img, 0, 1) ** (1 / 2.2)
    return np.clip(img, 0, 1)


def term_preview(img, max_cols=100, tonemap="reference", out=None):
    """Draw an (H, W, 3) linear image into the terminal with upper
    half-blocks (one character = two pixels, one above the other), 24-bit
    color.  Returns the lines drawn, for term_redraw_prefix."""
    out = out or sys.stdout
    h, w = img.shape[:2]
    cols = min(max_cols, w)
    rows_px = max(2, int(round(cols * h / w)))
    rows_px += rows_px % 2
    ys = (np.linspace(0, h - 1, rows_px)).astype(int)
    xs = (np.linspace(0, w - 1, cols)).astype(int)
    small = _tonemap(img[ys][:, xs], tonemap)
    rgb = (np.clip(small, 0, 1) * 255).astype(int)
    lines = []
    for r in range(0, rows_px, 2):
        top = rgb[r]
        bot = rgb[r + 1]
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(top, bot)
        ]
        lines.append("".join(cells) + "\x1b[0m")
    out.write("\n".join(lines) + "\n")
    out.flush()
    return rows_px // 2


def term_redraw_prefix(n_lines):
    """ANSI cursor-up so that the next term_preview overwrites the last."""
    return f"\x1b[{n_lines}A" if n_lines else ""


class LivePngWriter:
    """Rewrites a PNG with the current progressive estimate after each
    chunk."""

    def __init__(self, path, tonemap="reference"):
        self.path = path
        self.tonemap = tonemap

    def update(self, img):
        from .image import save_png

        save_png(self.path, img, tonemap=self.tonemap)
