"""The '.3d' mesh reader and writer and presets.envmap_mesh_parity of the
port against the JAX package's: the writer's file is byte-equal, the reader
returns the same arrays, and envmap_mesh_parity fails on both sides without
the reference renderer's assets and builds equal tables from the same
images."""

import os

import numpy as np
import pytest

from gnxraytracer_tpu.scene import loaders as J_load
from gnxraytracer_tpu.scene import presets as J_presets
from gnxraytracer_tpu.utils import image as J_image
from gnxraytracer_tpu_torch.scene import loaders as T_load
from gnxraytracer_tpu_torch.scene import presets as T_presets
from gnxraytracer_tpu_torch.utils import image as T_image

from test_torch_convert import assert_tables_equal, procedural_hdr


def _meshes():
    v, t, _n, _uv = J_load.make_blob_mesh(7)
    return {"blob": (v, t), "test_mesh": J_load.make_test_mesh(1),
            "one_triangle": (np.asarray([[0.0, 1e-7, -3.5], [2.0, 0.0, 0.0],
                                         [0.0, 1.0, 0.0]], np.float32),
                             np.asarray([[0, 1, 2]], np.int32))}


@pytest.mark.parametrize("name", sorted(_meshes()))
def test_save_3d_is_byte_equal(name, tmp_path):
    v, t = _meshes()[name]
    ours, theirs = tmp_path / "ours.3d", tmp_path / "theirs.3d"
    T_load.save_3d(str(ours), v, t)
    J_load.save_3d(str(theirs), v, t)
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.read_text().startswith(f"vertex {len(v)} face {len(t)}\n")


@pytest.mark.parametrize("name", sorted(_meshes()))
def test_load_3d_mesh_of_a_jax_file_is_the_jax_load(name, tmp_path):
    v, t = _meshes()[name]
    path = str(tmp_path / "m.3d")
    J_load.save_3d(path, v, t)
    ov, ot = T_load.load_3d_mesh(path)
    jv, jt = J_load.load_3d_mesh(path)
    assert ov.dtype == np.float32 and ot.dtype == np.int32
    np.testing.assert_array_equal(ov, jv)
    np.testing.assert_array_equal(ot, jt)
    np.testing.assert_array_equal(ot, t)
    np.testing.assert_allclose(ov, v, rtol=1e-6, atol=1e-6)


def test_load_3d_mesh_reads_the_header_and_faces_as_jax(tmp_path):
    """A header spread over two lines, blank lines, faces without the
    leading count, a scale, and lines past the counts."""
    path = tmp_path / "h.3d"
    path.write_text("mesh vertex 4\n\ncomment face 2\n"
                    "0 0 0\n1 0 0\n\n0 1 0\n1 1 0.5\n"
                    "0 1 2\n3 1 3 2\n9 9 9\n")
    ours = T_load.load_3d_mesh(str(path), scale=2.0)
    theirs = J_load.load_3d_mesh(str(path), scale=2.0)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[1], [[0, 1, 2], [1, 3, 2]])
    assert ours[0].shape == (4, 3) and ours[0][3, 2] == 1.0


def test_envmap_mesh_parity_fails_without_the_assets(tmp_path, monkeypatch):
    """The JAX preset asserts that its asset paths exist; the port's names
    the missing file.  Neither builds a scene without them."""
    with monkeypatch.context() as m:
        m.setattr(os.path, "exists", lambda p: False)
        with pytest.raises(AssertionError):
            J_presets.envmap_mesh_parity(8, 8, n_seg=8)
    monkeypatch.delenv("GNX_RESOURCES", raising=False)
    with pytest.raises(FileNotFoundError, match="awesomeface.jpg"):
        T_presets.envmap_mesh_parity(8, 8, n_seg=8, device="cpu")
    monkeypatch.setenv("GNX_RESOURCES", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="awesomeface.jpg"):
        T_presets.envmap_mesh_parity(8, 8, n_seg=8, device="cpu")
    import imageio.v2 as imageio

    imageio.imwrite(str(tmp_path / "awesomeface.jpg"),
                    np.full((4, 4, 3), 200, np.uint8))
    with pytest.raises(FileNotFoundError, match="MonValley1000.hdr"):
        T_presets.envmap_mesh_parity(8, 8, n_seg=8, device="cpu")


def test_envmap_mesh_parity_tables_equal_jax(monkeypatch):
    """With the image loader and the asset check replaced in both packages
    (a procedural texture and HDR in place of the assets), the scene tables,
    the camera and the mesh are the JAX package's."""
    rng = np.random.default_rng(3)
    face = rng.random((16, 16, 3)).astype(np.float32)
    env = procedural_hdr()

    def load_image(path, gamma=True, flip_v=False):
        if path.endswith(".jpg"):
            assert gamma
            return face
        assert path.endswith(".hdr")
        return env.copy()

    with monkeypatch.context() as m:
        m.setattr(J_image, "load_image", load_image)
        m.setattr(os.path, "exists", lambda p: True)
        js, jc, (jv, jt) = J_presets.envmap_mesh_parity(16, 12, n_seg=8)
    monkeypatch.setattr(T_image, "load_image", load_image)
    monkeypatch.setattr(T_presets, "_require", lambda name: name)
    ts, tc, (tv, tt) = T_presets.envmap_mesh_parity(16, 12, n_seg=8,
                                                    device="cpu")
    assert_tables_equal(ts, js, "scene")
    assert_tables_equal(tc, jc, "camera")
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)
    assert ts.env is not None and ts.textures is not None
