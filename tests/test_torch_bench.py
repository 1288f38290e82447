"""The port's bench (gnxraytracer_tpu_torch/bench.py) against the JAX
package's root bench.py: the same JSON keys, less the two TPU utilisation
shares and plus ``mesh_env``; its Cornell loop renders path.render's image;
a failing workload ends the run instead of becoming an ``*_error`` key.

bench.py points JAX's compile cache into the repository when it is
imported, so its keys are read with ast and it is never imported."""

import ast
import functools
import json
import os

import numpy as np
import pytest
import torch

from gnxraytracer_tpu_torch import bench
from gnxraytracer_tpu_torch.models.integrators import path as T_path

import test_torch_convert  # noqa: F401  (one intra-op thread, see there)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DROPPED = {"mfu_vpu_frac_est", "mesh_vpu_frac_est"}  # v5e VPU shares
TINY = dict(width=8, height=8, reps=1, device="cpu")


def bench_py_keys():
    """(keys bench.py prints on success, keys it prints only from an except
    handler), from its source."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    handled = {id(n) for h in ast.walk(tree) if isinstance(h, ast.ExceptHandler)
               for n in ast.walk(h)}
    ok, on_error = set(), set()
    for node in ast.walk(tree):
        keys = []
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys
                    if isinstance(k, ast.Constant) and isinstance(k.value, str)]
        elif isinstance(node, ast.Assign):
            keys = [t.slice.value for t in node.targets
                    if isinstance(t, ast.Subscript)
                    and isinstance(t.slice, ast.Constant)
                    and isinstance(t.slice.value, str)]
        (on_error if id(node) in handled else ok).update(keys)
    return ok, on_error


@pytest.fixture(scope="module")
def tiny_line():
    """main()'s line with each workload at 8x8 and 1 rep on the CPU (the
    mesh scene with the procedural HDR)."""
    with pytest.MonkeyPatch.context() as m:
        m.delenv("GNX_RESOURCES", raising=False)
        return {
            "cornell": bench.bench_cornell(spp=4, max_depth=3, **TINY),
            "whitted": bench.bench_whitted(spp=2, max_depth=2, **TINY),
            "mesh": bench.bench_mesh(spp=1, max_depth=2, **TINY),
        }


def test_bench_py_keys_are_read():
    ok, on_error = bench_py_keys()
    assert {"metric", "value", "vs_baseline", "whitted_vs_baseline",
            "mesh_vs_baseline", "mesh_rays_per_path"} <= ok
    assert DROPPED <= ok
    assert on_error == {"whitted_error", "mesh_error"}


def test_keys_are_the_jax_benchs(tiny_line):
    ok, on_error = bench_py_keys()
    ours = set()
    for part in tiny_line.values():
        assert not ours & set(part)
        ours |= set(part)
    assert ours == (ok - DROPPED) | {"mesh_env"}
    assert not ours & on_error


def test_figures_are_finite_and_named(tiny_line):
    line = dict(kv for part in tiny_line.values() for kv in part.items())
    for k, v in line.items():
        if isinstance(v, float):
            assert np.isfinite(v) and v > 0, k
    assert line["wall_s_min"] <= line["wall_s_256spp"] <= line["wall_s_max"]
    assert line["device"] == "cpu"
    assert line["unit"] == "Mpaths/s"
    assert line["mesh_tris"] == 104_882 + 2  # the blob and the floor
    assert line["mesh_bvh_mode"] == "packet"  # the plain walk on the CPU
    assert line["mesh_env"] == "procedural"
    # against BASELINE_MEASURED.json's reference-renderer figures
    with open(os.path.join(ROOT, "BASELINE_MEASURED.json")) as f:
        base = json.load(f)["workloads"]
    np.testing.assert_allclose(
        line["vs_baseline"],
        line["value"] / base["path_500px_256spp"]["Mpaths_per_s"], rtol=1e-12)
    assert line["rays_per_path"] > 1.0


def test_main_prints_one_line_and_raises_on_a_failure(monkeypatch, capsys):
    for name, kw in (("bench_cornell", dict(spp=2, max_depth=2)),
                     ("bench_whitted", dict(spp=1, max_depth=1)),
                     ("bench_mesh", dict(spp=1, max_depth=1))):
        monkeypatch.setattr(bench, name, functools.partial(
            getattr(bench, name), **dict(TINY, **kw)))
    line = bench.main(["--cpu", "--reps", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line

    def broken(**_kw):
        raise RuntimeError("the mesh workload failed")
    monkeypatch.setattr(bench, "bench_mesh", broken)
    with pytest.raises(RuntimeError, match="mesh workload failed"):
        bench.main(["--cpu", "--reps", "1"])
    assert capsys.readouterr().out == ""  # no line, no *_error key


def test_cornell_loop_gives_path_render(monkeypatch):
    """The bench's Cornell workload at 8x8, 8 spp: its chunk loop sums to
    path.render's image, and counts more casts than camera rays."""
    scene, cam, smp, cfg = bench.cornell_setup(8, 8, 8, 8, "cpu")
    assert (cfg.fast_mis, cfg.compact_tail, cfg.count_rays, cfg.spp_chunk,
            cfg.max_depth, cfg.rr_threshold) == (True, True, True, 4, 8, 1.0)
    acc, n_rays = bench.run_chunks(T_path.render_chunk, scene, cam, smp, cfg)
    img = T_path.render(scene, cam, smp, cfg)
    np.testing.assert_allclose(acc.numpy().reshape(8, 8, 3) / 8, img.numpy(),
                               rtol=1e-6)
    assert n_rays > 8 * 8 * 8
    assert img.mean() > 0.05


def test_mesh_environment_takes_the_asset_when_there(tmp_path, monkeypatch):
    monkeypatch.delenv("GNX_RESOURCES", raising=False)
    hdr, name = bench.mesh_environment(str(tmp_path))
    assert name == "procedural" and os.path.dirname(hdr) == str(tmp_path)
    assets = tmp_path / "assets"
    assets.mkdir()
    (assets / "MonValley1000.hdr").write_bytes(b"")
    monkeypatch.setenv("GNX_RESOURCES", str(assets))
    assert bench.mesh_environment(str(tmp_path)) == (
        str(assets / "MonValley1000.hdr"), "MonValley1000.hdr")


def test_bench_needs_cuda_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.bench_cornell(width=8, height=8, spp=1, reps=1)
