"""Rendering and training across processes: two ranks of a gloo process
group on the CPU (loopback), each a process of
``python -m gnxraytracer_tpu_torch.parallel.multihost``, against one process.

Tolerances: the images within atol 1e-5 (the JAX package's
test_multihost.py), the train step's loss within rtol 1e-5 and its
parameters within rtol 1e-4 + atol 1e-6 (test_gradients.py's
TestShardedTrainStep); every lane depends only on its (pixel, sample), so
only the order of float sums differs.  Where tail compaction runs, each rank
compacts its own lanes: the test holds the ranks to one process only where
every stage applied on both and every pre-thinning probability was 1, and
checks that the worker reports so."""

import json

import numpy as np
import pytest
import torch

from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.parallel import multihost as T_mh
from gnxraytracer_tpu_torch.parallel import sharding as T_sh
from gnxraytracer_tpu_torch.scene import presets as T_presets
from gnxraytracer_tpu_torch.tools import compare_ranks

import test_torch_convert  # noqa: F401  (one intra-op thread, see there)

TIMEOUT_S = 120


def run_ranks(tmp_path, argv, n=2):
    """Run n ranks of the worker on the CPU (compare_ranks.spawn_ranks);
    returns (rank 0's result, each rank's JSON record).  A rank that fails or
    outlives TIMEOUT_S fails the test (every rank is killed)."""
    got, records = compare_ranks.spawn_ranks(
        ["--cpu", *argv], n, str(tmp_path / "result.npz"), TIMEOUT_S,
        env={"OMP_NUM_THREADS": "1"})
    for rank, rec in enumerate(records):
        assert rec["rank"] == rank and rec["world"] == n
        assert rec["backend"] == "gloo" and rec["device"] == "cpu"
    return got, records


def one_process(w, h, spp, chunk, depth, sampler="sobol", **kw):
    scene, cam = T_presets.cornell_box(w, h, device="cpu")
    cfg = T_path.make_config(scene, w, h, spp=spp, max_depth=depth,
                             spp_chunk=chunk, rr_threshold=1.0, **kw)
    smp = (T_smp.make_halton_sampler(spp, w, h, device="cpu")
           if sampler == "halton" else T_smp.make_sobol_sampler(spp,
                                                                device="cpu"))
    return scene, cam, smp, cfg


SMALL = ["--width", "8", "--height", "8", "--spp", "4", "--spp-chunk", "2",
         "--max-depth", "2"]


@pytest.mark.parametrize("mode", ["samples", "rows", "pixels"])
@pytest.mark.parametrize("fast_mis", [False, True], ids=["faithful", "fast_mis"])
def test_two_ranks_render_the_one_process_image(mode, fast_mis, tmp_path):
    got, records = run_ranks(tmp_path, ["--mode", mode] + SMALL
                             + (["--fast-mis"] if fast_mis else []))
    scene, cam, smp, cfg = one_process(8, 8, 4, 2, 2, fast_mis=fast_mis)
    want = T_path.render(scene, cam, smp, cfg).numpy()
    assert got["image"].shape == (8, 8, 3)
    np.testing.assert_allclose(got["image"], want, atol=1e-5)
    lanes = [r["compaction"]["lanes_this_rank"] for r in records]
    assert lanes == ([64 * 2] * 2 if mode == "samples" else [32 * 2] * 2)


def test_two_ranks_compacting_match_one_process(tmp_path):
    """32x32, 4 spp a chunk: 4,096 lanes in one process, 2,048 a rank; the
    bench's tail compaction (after bounce 5, into 1/8 of the lanes) applies
    at both widths, and with every p_keep 1 the image is one process's."""
    argv = ["--mode", "pixels", "--width", "32", "--height", "32", "--spp",
            "4", "--spp-chunk", "4", "--max-depth", "6", "--fast-mis",
            "--compact-tail"]
    got, records = run_ranks(tmp_path, argv)
    for rec in records:
        rep = rec["compaction"]
        assert rep["lanes_one_process"] == 4096
        assert rep["lanes_this_rank"] == 2048
        assert rep["stages_one_process"] == rep["stages_this_rank"] == [[5, 8]]
        assert rep["p_keep"] == [1.0]
    scene, cam, smp, cfg = one_process(32, 32, 4, 4, 6, fast_mis=True,
                                       compact_tail=True)
    with T_path.recording_prethin() as log:
        want = T_path.render(scene, cam, smp, cfg).numpy()
    assert [(n, m, p) for n, m, p in log] == [(4096, 512, 1.0)]
    np.testing.assert_allclose(got["image"], want, atol=1e-5)


def test_two_rank_train_step_matches_one_rank(tmp_path):
    """The data-parallel step (each rank 4 of the 8 rows, the loss and the
    gradients summed with all_reduce) against the one-rank step:
    TestShardedTrainStep's configuration (8x8, 4 spp, depth 2, Halton, the
    faithful estimator)."""
    argv = ["--mode", "train", "--width", "8", "--height", "8", "--spp", "4",
            "--spp-chunk", "4", "--max-depth", "2", "--sampler", "halton",
            "--lr", "1.0"]
    got, records = run_ranks(tmp_path, argv)
    assert [r["compaction"]["lanes_this_rank"] for r in records] == [128, 128]
    scene, cam, smp, cfg = one_process(8, 8, 4, 4, 2, sampler="halton")
    params, target = T_mh.train_inputs(scene, cfg)
    step = T_sh.make_train_step(cfg, device="cpu")
    loss, new = step(params, scene, cam, smp, target, lr=1.0)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    assert set(k[6:] for k in got if k.startswith("param_")) == set(new)
    for k, v in new.items():
        np.testing.assert_allclose(got["param_" + k], v.numpy(), rtol=1e-4,
                                   atol=1e-6)
        assert np.abs(v.numpy() - params[k].numpy()).max() > 0  # moved


def test_a_rank_that_fails_fails_the_run(tmp_path):
    """A rank that raises (an unknown preset) ends with a non-zero code; the
    test's own timeout bounds the other rank."""
    with pytest.raises(RuntimeError, match="failed"):
        run_ranks(tmp_path, ["--mode", "pixels", "--preset", "nope"] + SMALL)


def test_make_mesh_over_more_ranks_than_exist_raises():
    with pytest.raises(ValueError, match="only 1 rank"):
        T_sh.make_mesh(3)
    assert T_sh.mesh_rows(T_path.RenderCfg(4, 7, 1),
                          T_sh.Mesh(rank=1, size=2)) == (4, 7)
    assert T_sh.mesh_rows(T_path.RenderCfg(4, 1, 1),
                          T_sh.Mesh(rank=1, size=2)) == (1, 1)  # no rows
    cfg = T_path.RenderCfg(4, 7, 1, spp_chunk=2)
    assert T_sh.pixel_passes(cfg, 16, rows=(4, 7)) == [(16, 24), (24, 28)]
    assert T_sh.pixel_passes(cfg, 16, rows=(1, 1)) == []
    assert T_sh.pixel_passes(cfg, 10 ** 6) == [(0, 28)]
    assert torch.equal(T_sh.all_reduce_sum(torch.ones(3), T_sh.make_mesh()),
                       torch.ones(3))


def test_compare_ranks_reads_records_through_interleaved_output():
    """tools/compare_ranks.py reads each rank's record wherever the ranks'
    other output (torchrun merges their streams) cut into its line."""
    log = ('multihost: rank 1 of 2 on cpu, backend gloo{"rank": 1, "seconds": '
           '2.5, "compaction": {"p_keep": [1.0]}}multihost: rank 0 of 2\n'
           '[W socket] warning\n{"rank": 0, "seconds": 2.0}\n')
    recs = compare_ranks.records(log)
    assert sorted(r["rank"] for r in recs) == [0, 1]
    assert {r["rank"]: r["seconds"] for r in recs} == {0: 2.0, 1: 2.5}


def test_compare_ranks_runs_every_mode_against_one_process(monkeypatch,
                                                           capsys):
    """tools/compare_ranks.py end to end on two CPU ranks at 8x8, depth 2:
    one line a mode, each split within atol 1e-5 of one process, the step's
    loss within rtol 1e-5 and its parameters within 1e-4 absolute."""
    monkeypatch.setattr(compare_ranks, "COMMON",
                        ["--preset", "cornell", "--width", "8", "--height",
                         "8", "--max-depth", "2"])
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    compare_ranks.main(["--nproc", "2", "--spp", "4", "--cpu", "--timeout",
                        str(TIMEOUT_S)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith('{"mode"')]
    assert [x["mode"] for x in lines] == ["samples", "rows", "pixels",
                                          "train"]
    for x in lines:
        assert x["nproc"] == 2 and x["backend"] == "gloo"
        assert x["devices"] == ["cpu", "cpu"]
        assert all(c["p_keep_all_1"] for c in x["compaction"])
    for x in lines[:3]:
        assert x["max_abs_err"] <= 1e-5
    train = lines[3]
    assert train["loss_rel_err"] <= 1e-5
    assert set(train["param_max_abs_err"]) == {"kd", "light_emit"}
    assert all(v <= 1e-4 for v in train["param_max_abs_err"].values())
