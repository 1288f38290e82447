"""utils/viewer.py of the port against the JAX package's, and the CLI's live
viewers: the ANSI preview and its redraw prefix are the same strings, the
live PNG the same pixels, for the same image; ``cli render --live PNG
--view`` rewrites the PNG after every chunk and draws the preview."""

import io
import os

import numpy as np
import pytest

from gnxraytracer_tpu.utils import viewer as J_view
from gnxraytracer_tpu_torch import cli
from gnxraytracer_tpu_torch.utils import viewer as T_view


def _image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.gamma(1.0, 0.4, size=(h, w, 3)).astype(np.float32)
    img[0, 0] = (-0.5, 3.0, 0.0)  # a negative and a blown-out value
    return img


@pytest.mark.parametrize("tonemap", ["reference", "srgb", "none"])
@pytest.mark.parametrize("shape,cols", [((8, 8), 80), ((33, 50), 20),
                                        ((500, 500), 80), ((3, 40), 100)])
def test_term_preview_is_the_jax_string(tonemap, shape, cols):
    img = _image(*shape)
    ours, theirs = io.StringIO(), io.StringIO()
    n_ours = T_view.term_preview(img, max_cols=cols, tonemap=tonemap, out=ours)
    n_theirs = J_view.term_preview(img, max_cols=cols, tonemap=tonemap,
                                   out=theirs)
    assert n_ours == n_theirs
    assert ours.getvalue() == theirs.getvalue()
    assert ours.getvalue().count("\n") == n_ours
    assert "▀" in ours.getvalue()


@pytest.mark.parametrize("n", [0, 1, 7])
def test_term_redraw_prefix_is_the_jax_string(n):
    assert T_view.term_redraw_prefix(n) == J_view.term_redraw_prefix(n)


@pytest.mark.parametrize("tonemap", ["reference", "srgb", "none"])
def test_live_png_is_the_jax_pixels(tonemap, tmp_path):
    import imageio.v2 as imageio

    img = _image(12, 20, seed=1)
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    T_view.LivePngWriter(ours, tonemap=tonemap).update(img)
    J_view.LivePngWriter(theirs, tonemap=tonemap).update(img)
    a, b = imageio.imread(ours), imageio.imread(theirs)
    assert a.shape == (12, 20, 3)
    np.testing.assert_array_equal(a, b)
    T_view.LivePngWriter(ours, tonemap=tonemap).update(img * 0.5)
    assert not np.array_equal(imageio.imread(ours), b)  # rewritten


def test_cli_live_and_view_rewrite_the_png_after_each_chunk(
        tmp_path, monkeypatch, capsys):
    import imageio.v2 as imageio

    live = str(tmp_path / "live.png")
    npy = str(tmp_path / "final.npy")
    written = []
    real = T_view.LivePngWriter.update

    def update(self, img):
        written.append(np.array(img))
        real(self, img)
    monkeypatch.setattr(T_view.LivePngWriter, "update", update)
    cli.main(["render", "--preset", "cornell", "--width", "8", "--height",
              "8", "--spp", "4", "--spp-chunk", "2", "--cpu", "--live", live,
              "--view", "--view-cols", "8", "--out-npy", npy])
    out = capsys.readouterr().out
    assert len(written) == 2  # one rewrite a chunk
    final = np.load(npy)
    np.testing.assert_allclose(written[-1], final, rtol=1e-6)
    png = imageio.imread(live)
    assert png.shape == (8, 8, 3) and png.max() > 0
    # two previews of 4 lines (8 columns, 8 pixel rows): each moves the
    # cursor up over the chunk's stats line (and the last preview), is drawn,
    # and is followed by the stats line again
    assert out.count("▀") == 2 * 4 * 8
    assert out.index("\x1b[1A") < out.index("\x1b[5A")
    assert out.count('"spp": 2,') == 2
    assert os.path.getsize(live) > 0
