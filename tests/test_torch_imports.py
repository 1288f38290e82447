"""The port stands alone: importing it pulls in neither jax nor the JAX
package; its entry points refuse to run without a CUDA device unless the
caller names the CPU; and every branch that an earlier part of the port
refused (the last were the per-lane BVH walks) now runs."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import gnxraytracer_tpu_torch
from gnxraytracer_tpu_torch import cli
from gnxraytracer_tpu_torch.models import lights as T_lights
from gnxraytracer_tpu_torch.models.integrators import direct as T_direct
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.models.integrators import whitted as T_whitted
from gnxraytracer_tpu_torch.ops import bvh as T_bvh
from gnxraytracer_tpu_torch.ops import instancing as T_inst
from gnxraytracer_tpu_torch.ops import lbvh as T_lbvh
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.ops import trace as T_trace
from gnxraytracer_tpu_torch.scene import camera as T_cam
from gnxraytracer_tpu_torch.scene import loaders as T_load
from gnxraytracer_tpu_torch.scene import presets as T_presets
from gnxraytracer_tpu_torch.scene import scene as T_scene
from gnxraytracer_tpu_torch.utils import transform as T_tf
from gnxraytracer_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(gnxraytracer_tpu_torch.__file__)


def port_modules():
    names = ["gnxraytracer_tpu_torch"]
    for m in pkgutil.walk_packages([PKG_DIR], "gnxraytracer_tpu_torch."):
        names.append(m.name)
    return sorted(names)


def port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG_DIR):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_every_module_is_found():
    mods = port_modules()
    for want in ("cli", "convert", "constants", "kernels.closest_hit",
                 "kernels.build", "kernels.wide_bvh", "kernels.packet_bvh",
                 "native", "ops.trace", "ops.lds", "ops.samplers",
                 "ops.intersect", "ops.sobol", "ops.bvh", "ops.wbvh",
                 "ops.texture", "ops.sampling", "models.integrators.path",
                 "models.integrators.whitted", "models.integrators.direct",
                 "models.lights", "models.microfacet", "models.disney",
                 "models.media", "models.integrators.volpath",
                 "parallel.sharding", "scene.presets", "scene.loaders",
                 "utils.image", "utils.transform", "ops.instancing",
                 "ops.lbvh", "bench", "utils.stats", "utils.viewer",
                 "parallel.multihost", "utils.device", "ops.interpolation",
                 "models.bssrdf", "ops.procedural", "models.sphere_sampling"):
        assert f"gnxraytracer_tpu_torch.{want}" in mods


def test_fresh_interpreter_imports_no_jax():
    """Import every module of the port (and chip_smoke.py) in a new
    interpreter: jax and gnxraytracer_tpu stay out of sys.modules, and
    nothing is compiled (nvcc, g++) or loaded (ctypes) on the way."""
    code = (
        "import sys, importlib, subprocess, ctypes\n"
        "import torch\n"  # loads its own libraries with ctypes
        "def refuse(*a, **kw):\n"
        "    raise AssertionError('built or loaded at import: %r' % (a,))\n"
        "subprocess.Popen = subprocess.run = ctypes.CDLL = refuse\n"
        "def banned(m):\n"
        "    top = m.split('.')[0]\n"
        "    return top in ('jax', 'jaxlib', 'gnxraytracer_tpu')\n"
        "for m in [m for m in sys.modules if banned(m)]:\n"
        "    del sys.modules[m]\n"  # whatever a site hook preloaded
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for name in {port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if banned(m))\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
        "from gnxraytracer_tpu_torch import native\n"
        "from gnxraytracer_tpu_torch.kernels import build, closest_hit, wide_bvh\n"
        "from gnxraytracer_tpu_torch.kernels import packet_bvh\n"
        "assert build._libs == {} and build.build_log == {}\n"
        "assert native._lib is None and wide_bvh._fns is None\n"
        "assert packet_bvh._fns is None\n"
        "for m in ('whitted', 'direct'):\n"
        "    assert 'gnxraytracer_tpu_torch.models.integrators.' + m in sys.modules\n"
        "print('CLEAN', len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "CLEAN" in r.stdout


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_names_no_jax(path):
    """No import statement of the port names jax or the JAX package, not
    even inside a function."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "gnxraytracer_tpu"), \
                f"{path}:{node.lineno} imports {n}"


def test_build_paths_hash_headers_and_stay_in_the_ignored_directory(
        tmp_path, monkeypatch):
    """kernels/build.py names a library after its source AND the files under
    csrc/ that it includes, so an edited header is rebuilt; the kernels and
    the C++ BVH library all go to the one build directory, which
    .gitignore lists."""
    import shutil

    from gnxraytracer_tpu_torch import native
    from gnxraytracer_tpu_torch.kernels import build

    for name in ("wide_bvh", "closest_hit", "packet_bvh"):
        files = [os.path.basename(f) for f in build.source_files(name)]
        assert files == sorted([name + ".cu", "watertight.cuh"])
    flags = " ".join(build.NVCC_FLAGS)
    assert "sm_90a" in flags and "--fmad=false" in flags
    assert "fast-math" not in flags
    _, before = build._target("wide_bvh")
    assert os.path.dirname(before) == build.BUILD_DIR
    assert os.path.dirname(native.library_path()) == build.BUILD_DIR
    rel = os.path.relpath(build.BUILD_DIR, ROOT).replace(os.sep, "/") + "/"
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert rel in [line.strip() for line in f]
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, copy)
    monkeypatch.setattr(build, "CSRC_DIR", str(copy))
    assert os.path.basename(build._target("wide_bvh")[1]) == \
        os.path.basename(before)
    with open(copy / "watertight.cuh", "a") as f:
        f.write("// edited\n")
    assert os.path.basename(build._target("wide_bvh")[1]) != \
        os.path.basename(before)
    names = {os.path.basename(build._target(n)[1])
             for n in ("closest_hit", "wide_bvh", "packet_bvh")}
    assert len(names) == 3


def test_kernel_sources_have_the_entry_points_the_wrappers_bind():
    from gnxraytracer_tpu_torch.kernels import build

    with open(os.path.join(build.CSRC_DIR, "wide_bvh.cu")) as f:
        src = f.read()
    for entry in ("gnx_wide_closest_hit", "gnx_wide_any_hit",
                  "gnx_wide_stack_cap"):
        assert f'extern "C" int {entry}(' in src
    assert '#include "watertight.cuh"' in src and "cudaGetLastError" in src
    assert "template <bool kAnyHit>" in src
    # the node-group stack lives in shared memory, not in a local array
    assert "extern __shared__ int stack_smem[];" in src and "int stack[" not in src
    with open(os.path.join(build.CSRC_DIR, "closest_hit.cu")) as f:
        assert '#include "watertight.cuh"' in f.read()
    with open(os.path.join(build.CSRC_DIR, "packet_bvh.cu")) as f:
        src = f.read()
    for entry in ("gnx_packet_closest_hit", "gnx_packet_any_hit"):
        assert f'extern "C" int {entry}(' in src
    assert '#include "watertight.cuh"' in src and "cudaGetLastError" in src
    assert "template <bool kAnyHit>" in src and "__trap()" in src
    # the stackless walk keeps no per-thread stack
    assert "stack[" not in src


# -- the device is explicit ---------------------------------------------------

def _no_cuda():
    return not torch.cuda.is_available()


ENTRY_POINTS = {
    "resolve_device": lambda **kw: resolve_device(**kw),
    "cornell_box": lambda **kw: T_presets.cornell_box(16, 16, **kw),
    "envmap_mesh": lambda **kw: T_presets.envmap_mesh(
        8, 8, mesh=T_load.make_blob_mesh(8)[:2], **kw),
    "build_bvh": lambda **kw: T_bvh.build_bvh(
        *T_load.make_blob_mesh(8)[:2], builder="numpy", **kw),
    "sphere_point_light": lambda **kw: T_presets.sphere_point_light(8, 8, **kw),
    "SceneBuilder.build": lambda **kw: T_scene.SceneBuilder().build(**kw),
    "make_perspective_camera": lambda **kw: T_cam.make_perspective_camera(
        8, 8, (0, 0, 5), (0, 0, 0), **kw),
    "make_orthographic_camera": lambda **kw: T_cam.make_orthographic_camera(
        8, 8, (0, 0, 5), (0, 0, 0), **kw),
    "make_sobol_sampler": lambda **kw: T_smp.make_sobol_sampler(4, **kw),
    "make_random_sampler": lambda **kw: T_smp.make_random_sampler(4, **kw),
    "make_halton_sampler": lambda **kw: T_smp.make_halton_sampler(4, 8, 8, **kw),
    "halton_sampler_from_tables": lambda **kw: T_smp.halton_sampler_from_tables(
        4, 0, np.zeros(64, np.uint32), 6, 3, 9, **kw),
    "build_packet_pack": lambda **kw: T_bvh.build_packet_pack(
        np.zeros((1, 3)), np.ones((1, 3)), np.zeros(1, np.int32),
        np.ones(1, np.int32), np.asarray([0, -1, -1, -1]), np.zeros((4, 9)),
        np.asarray([-1]), **kw),
    "build_lbvh": lambda **kw: T_lbvh.build_lbvh(
        *T_load.make_blob_mesh(8)[:2], **kw),
    "make_instances": lambda **kw: T_inst.make_instances(
        np.eye(4)[None], **kw),
    "make_animated_instances": lambda **kw: T_inst.make_animated_instances(
        np.eye(4)[None], np.eye(4)[None], **kw),
    "make_animated_transform": lambda **kw: T_tf.make_animated_transform(
        np.eye(4), np.eye(4), **kw),
    "quat_identity": lambda **kw: T_tf.quat_identity(**kw),
    "cornell_glass": lambda **kw: T_presets.cornell_glass(8, 8, **kw),
    "cornell_metal": lambda **kw: T_presets.cornell_metal(8, 8, **kw),
    "cornell_instanced": lambda **kw: T_presets.cornell_instanced(
        8, 8, bvh=True, **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_needs_cuda_unless_cpu_is_named(name):
    fn = ENTRY_POINTS[name]
    fn(device="cpu")  # works when the CPU is asked for
    if not _no_cuda():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()  # default device is "cuda": never carries on on the CPU


def test_cli_needs_cuda_unless_cpu_flag(tmp_path, capsys):
    args = ["render", "--preset", "cornell", "--sampler", "sobol", "--fast-mis",
            "--width", "16", "--height", "16", "--spp", "2", "--spp-chunk", "2"]
    out = tmp_path / "x.png"
    npy = tmp_path / "x.npy"
    cli.main(args + ["--cpu", "--out", str(out), "--out-npy", str(npy)])
    img = np.load(npy)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.mean() > 0
    assert out.stat().st_size > 0
    assert '"device": "cpu"' in capsys.readouterr().out
    if _no_cuda():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(args)


@pytest.mark.parametrize("integrator", ["path", "whitted", "direct"])
def test_cli_default_flags_run(integrator, tmp_path, capsys):
    """No sampler or estimator flag: the JAX CLI's defaults (Halton, the
    faithful estimator, depth 5) through each ported integrator; without
    --cpu and without a card it stops with the device error."""
    args = ["render", "--preset", "cornell", "--spp", "4", "--width", "32",
            "--height", "32", "--integrator", integrator]
    npy = tmp_path / "x.npy"
    cli.main(args + ["--cpu", "--out-npy", str(npy)])
    img = np.load(npy)
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert 0.1 < img.mean() < 2.0
    assert '"device": "cpu"' in capsys.readouterr().out
    if _no_cuda():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(args)


def test_cli_integrators_are_the_modules():
    from gnxraytracer_tpu_torch.models.integrators import volpath as T_vol

    assert cli.get_integrator("path") is T_path
    assert cli.get_integrator("whitted") is T_whitted
    assert cli.get_integrator("direct") is T_direct
    assert cli.get_integrator("volpath") is T_vol


def test_cli_whitted_on_the_mesh_preset_takes_either_walk(tmp_path, monkeypatch):
    """--preset cornell-mesh --integrator whitted with default flags, through
    the wide walk and, with GNX_WIDE_BVH=0, the binary one: the same image
    up to ties."""
    args = ["render", "--preset", "cornell-mesh", "--integrator", "whitted",
            "--spp", "1", "--spp-chunk", "1", "--width", "12", "--height",
            "12", "--cpu"]
    monkeypatch.delenv("GNX_WIDE_BVH", raising=False)
    cli.main(args + ["--out-npy", str(tmp_path / "w.npy")])
    monkeypatch.setenv("GNX_WIDE_BVH", "0")
    cli.main(args + ["--out-npy", str(tmp_path / "b.npy")])
    w, b = np.load(tmp_path / "w.npy"), np.load(tmp_path / "b.npy")
    assert w.mean() > 0.05
    np.testing.assert_allclose(b, w, rtol=1e-4, atol=1e-5)


def test_cli_resume_from_checkpoint(tmp_path):
    ck = tmp_path / "ck.npz"
    base = ["render", "--preset", "sphere", "--sampler", "random", "--fast-mis",
            "--width", "8", "--height", "8", "--spp-chunk", "2", "--cpu",
            "--checkpoint", str(ck)]
    a, b = tmp_path / "a.npy", tmp_path / "b.npy"
    cli.main(base + ["--spp", "2"])
    cli.main(base + ["--spp", "4", "--resume", "--out-npy", str(a)])
    cli.main(base[:-2] + ["--spp", "4", "--out-npy", str(b)])
    np.testing.assert_allclose(np.load(a), np.load(b), rtol=1e-6)


@pytest.mark.parametrize("argv,names", [
    (["--live", "x.png"], "--live"),
    (["--sampler", "sobol", "--fast-mis", "--view"], "--view"),
])
def test_cli_names_what_is_not_ported(argv, names, tmp_path, monkeypatch,
                                      capsys):
    """The live viewers were refused until the slice that ported them; now
    each flag runs (no SystemExit): --live writes its PNG, --view draws the
    ANSI preview."""
    monkeypatch.chdir(tmp_path)
    cli.main(["render", "--cpu", "--width", "8", "--height", "8", "--spp",
              "2", "--spp-chunk", "2"] + argv)
    out = capsys.readouterr().out
    if names == "--live":
        assert (tmp_path / "x.png").stat().st_size > 0
        assert "▀" not in out
    else:
        assert "▀" in out and not list(tmp_path.iterdir())


@pytest.mark.parametrize("preset", ["envmap", "cornell-mesh"])
def test_cli_renders_the_mesh_presets(preset, tmp_path, capsys):
    """The two presets with a BVH, through the CLI on the CPU (the full
    meshes, a tiny image); without the HDR asset envmap takes its skybox."""
    npy = tmp_path / "x.npy"
    cli.main(["render", "--preset", preset, "--sampler", "sobol", "--fast-mis",
              "--width", "12", "--height", "12", "--spp", "1", "--spp-chunk",
              "1", "--max-depth", "3", "--cpu", "--out-npy", str(npy)])
    img = np.load(npy)
    assert img.shape == (12, 12, 3) and np.isfinite(img).all()
    assert img.mean() > 0.01
    assert '"device": "cpu"' in capsys.readouterr().out


def _render_flags(cli_module, monkeypatch):
    """{flag: (default, choices, type)} of a CLI's render subcommand, read
    from the parser that its main() builds."""
    import argparse

    class Captured(Exception):
        pass

    def capture(self, args=None, namespace=None):
        raise Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Captured) as e:
        cli_module.main([])
    monkeypatch.undo()
    parser = e.value.args[0]
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    assert set(sub.choices) == {"render", "presets"}
    return {a.option_strings[0]: (a.default, a.choices and sorted(a.choices),
                                  a.type)
            for a in sub.choices["render"]._actions
            if a.option_strings and a.option_strings[0] != "-h"}


def test_cli_flags_and_defaults_are_the_jax_clis(monkeypatch):
    """Same render flags, defaults and choices as the JAX CLI, besides the
    port's own --trace DIR (the program's spans and a profiler trace)."""
    from gnxraytracer_tpu import cli as jax_cli

    ours = _render_flags(cli, monkeypatch)
    theirs = _render_flags(jax_cli, monkeypatch)
    assert ours.pop("--trace") == (None, None, None)
    assert ours == theirs
    assert "--cpu" in ours and "--fast-mis" in ours
    assert theirs["--sampler"][0] == "halton" and theirs["--width"][0] == 500


# -- what is not ported raises --------------------------------------------------

def _cornell():
    return T_presets.cornell_box(16, 16, device="cpu")


def _ported_builder_calls():
    """What the mesh path brought: each refused before and works now."""
    b = T_scene.SceneBuilder

    def textured():
        sb = b()
        tex = sb.add_texture(np.full((4, 4, 3), 0.5, np.float32))
        sb.add_sphere((0, 0, 0), 1.0, sb.add_matte((1, 1, 1), kd_tex=tex))
        return sb.build(device="cpu").textures

    def environment():
        sb = b()
        sb.set_environment(np.ones((4, 8, 3), np.float32))
        return sb.build(device="cpu").env

    def rd():
        cam = T_cam.make_perspective_camera(8, 8, (0, 0, 5), (0, 0, 0),
                                            device="cpu")
        z = torch.zeros((3,))
        return T_cam.generate_ray_differentials(
            cam, torch.ones((3, 2)), z, torch.zeros((3, 2)))[3]

    return {
        "build(bvh=True)": lambda: T_presets.cornell_box(
            8, 8, device="cpu")[0] and b().build(bvh=True, device="cpu").bvh,
        "add_texture+add_matte(kd_tex)": textured,
        "set_environment": environment,
        "add_disney": lambda: b().add_disney((0.5, 0.5, 0.5), metallic=0.3) == 0,
        "cornell_box(bvh=True)": lambda: T_presets.cornell_box(
            8, 8, bvh=True, device="cpu")[0].bvh,
        "generate_ray_differentials": rd,
        "make_halton_sampler": lambda: T_smp.make_halton_sampler(
            4, 8, 8, device="cpu"),
        "add_homogeneous_medium": lambda: media_scene().media,
        "add_grid_medium": lambda: media_scene(grid=True).media.density,
        "add_instances": lambda: T_presets.cornell_instanced(
            8, 8, device="cpu")[0].instanced,
        "build(bvh='lbvh')": lambda: T_presets.cornell_box(
            8, 8, bvh="lbvh", device="cpu")[0].bvh,
        "add_metal": lambda: b().add_metal() == 0,
        "add_plastic": lambda: b().add_plastic((0.5, 0.5, 0.5)) == 0,
    }


def media_scene(grid=False):
    """A sphere behind a null-material box holding a medium: what the
    volumetric slice brought (refused before it)."""
    b = T_scene.SceneBuilder()
    med = (b.add_grid_medium(np.ones((2, 2, 2)), 1, 1) if grid
           else b.add_homogeneous_medium(1, 1))
    vi, fi = T_presets._box_mesh((-1, -1, -1), (1, 1, 1))
    b.add_mesh(vi, fi, material=-1, medium=(med, -1))
    b.add_point_light((0, 3, 0), (10, 10, 10))
    return b.build(device="cpu")


@pytest.mark.parametrize("name", sorted(_ported_builder_calls()))
def test_ported_builder_call_works(name):
    assert _ported_builder_calls()[name]() is not None


def _render(scene=None, cam=None, **kw):
    if scene is None:
        scene, cam = _cornell()
    cfg = T_path.make_config(scene, 16, 16, spp=1, spp_chunk=1, **kw)
    return T_path.render_chunk(scene, cam,
                               T_smp.make_sobol_sampler(1, device="cpu"),
                               cfg, 0, 1)


@pytest.mark.parametrize("kw", [
    dict(fast_mis=True, pipeline_casts=True, compact_tail=True,
         compact_stages=((0, 1),)),
    dict(fast_mis=True, use_bvh=True),
    dict(fast_mis=True, use_bvh=True, bvh_mode="pallas"),
    dict(fast_mis=False),
    dict(fast_mis=False, use_bvh=True),
    # the per-lane walks, refused until the last slice of the port
    dict(fast_mis=True, use_bvh=True, bvh_mode="stack"),
    dict(fast_mis=True, use_bvh=True, bvh_stackless=False),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_ported_render_branch_runs(kw):
    """Branches that were refused in an earlier part of the port and render
    now; all give the brute-force image's mean of the same estimator."""
    scene, cam = T_presets.cornell_box(16, 16, bvh=True, device="cpu")
    want = _render(scene, cam, fast_mis=kw["fast_mis"], use_bvh=False)
    got = _render(scene, cam, **kw)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy().mean(), want.numpy().mean(),
                               rtol=1e-4)


def test_unported_material_and_light_kinds_raise():
    """No material or light kind is refused any more: bump maps (refused
    before the scene-feature slice) set has_bump; Disney, rough glass and
    the environment light (refused before the mesh path) are dispatched."""
    b = T_scene.SceneBuilder()
    tex = b.add_texture(np.zeros((2, 2, 3), np.float32))
    b.add_sphere((0, 0, 0), 1.0,
                 b.add_material(T_scene.MAT_MATTE, bump_tex=tex))
    assert T_path.make_config(b.build(device="cpu"), 8, 8, spp=1).has_bump
    b = T_scene.SceneBuilder()
    b.add_sphere((0, 0, 0), 1.0, b.add_disney((0.5, 0.5, 0.5)))
    b.add_sphere((3, 0, 0), 1.0, b.add_glass(rough_u=0.2, rough_v=0.2))
    b.set_environment(np.ones((4, 8, 3), np.float32))
    scene = b.build(device="cpu")
    cfg = T_path.make_config(scene, 8, 8, spp=1)
    assert cfg.mat_kinds == (T_scene.MAT_GLASS, T_scene.MAT_DISNEY)
    assert cfg.has_env
    z = torch.zeros((4, 3))
    up = torch.tensor([[0.6, 0.0, 0.8]] * 4)  # off the map's poles
    idx = torch.zeros((4,), dtype=torch.int32)
    ls = T_lights.sample_li(scene, cfg, idx, z, torch.full((4, 2), 0.3))
    assert bool(ls.is_infinite.all()) and bool((ls.pdf > 0).all())
    assert bool((T_lights.pdf_li(scene, cfg, idx, z, up) > 0).all())
    assert bool((T_lights.escaped_radiance(scene, cfg, z, up) == 1).all())


def test_unported_trace_branches_raise():
    scene, _ = _cornell()
    cfg = T_path.make_config(scene, 8, 8, spp=1)
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    t = torch.ones((4,))
    # instances and use_bvh on a scene that was built without them are the
    # caller's error
    for cast in (T_trace.scene_intersect, T_trace.scene_occluded):
        with pytest.raises(ValueError, match="add_instances"):
            cast(scene, cfg._replace(n_inst=1, n_inst_tris=12), o, d, t)
        with pytest.raises(ValueError, match="bvh=True"):
            cast(scene, cfg._replace(use_bvh=True), o, d, t)
    # the per-lane walks (refused until the last slice of the port) cast,
    # with the hits of the plain walk of the kernels on the same tree
    bscene, _ = T_presets.cornell_box(8, 8, bvh=True, device="cpu")
    d = torch.tensor([[0.1, -0.2, -1.0], [0.0, 1.0, 0.0], [-1.0, 0.3, 0.1],
                      [0.2, 0.1, 1.0]])
    bcfg = cfg._replace(use_bvh=True, bvh_mode="packet")
    want = T_trace.scene_intersect(bscene, bcfg, o, d, t * 100)
    want_occ = T_trace.scene_occluded(bscene, bcfg, o, d, t * 100)
    # the box's walls, floor and ceiling; it is open toward the camera (+z)
    assert want.hit.tolist() == [True, True, True, False]
    for mode in ("stack", "stackless"):
        mcfg = bcfg._replace(bvh_mode=mode)
        got = T_trace.scene_intersect(bscene, mcfg, o, d, t * 100)
        for f in ("hit", "kind", "prim"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (mode, f)
        torch.testing.assert_close(got.t, want.t, rtol=1e-5, atol=0)
        assert torch.equal(T_trace.scene_occluded(bscene, mcfg, o, d, t * 100),
                           want_occ)
    with pytest.raises(ValueError, match="unknown bvh_mode"):
        T_trace.scene_intersect(bscene, bcfg._replace(bvh_mode="walk"), o, d, t)
    # the spatial strategy without a grid is the power strategy (as in the
    # JAX package)
    u = torch.linspace(0, 0.99, 4)
    for got, want in zip(
            T_path._choose_light(scene, cfg._replace(light_strategy="spatial"),
                                 u),
            T_path._choose_light(scene, cfg._replace(light_strategy="power"),
                                 u)):
        assert torch.equal(got, want)
