"""Each cell rehearsed on the CPU at a small size through the harness's
internal entry (the command itself refuses without a card), the control
and the faults that `correct` has to catch, and the cells on the card.

Run with ``python -m pytest perfbench/tests -q`` from the repository's root
(a few minutes on the CPU); the tests marked ``cuda`` run on a machine with
the cards the cells ask for.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench import control, harness

ROOT = harness.ROOT
SMALL = {"width": 32, "height": 32, "n_seg": 12}
RENDER_CELLS = ["cornell-path", "envmesh-path"]
TRAIN_CELL = "cornell-train-16spp"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rehearse(workload, seed=20260917, seconds=0.3):
    return harness.run_cell(harness.load_manifest(), workload, seed, seconds,
                            0, "cpu", time.perf_counter(), overrides=SMALL)


@pytest.mark.parametrize("workload", RENDER_CELLS + [TRAIN_CELL])
def test_a_cell_rehearsed_on_the_cpu(workload):
    out = rehearse(workload)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    m = harness.load_manifest()
    want = {e["name"] for e in harness.cell_metrics(m, workload, "end_to_end")}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def _four_ranks(fault=None):
    port = harness._free_port()
    worker = os.path.join(harness.HERE, "tests", "rank_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, "cornell-path-4chip", str(r), "4", str(port)]
        + ([fault] if fault else []), cwd=ROOT, stdout=subprocess.PIPE,
        text=True) for r in range(4)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0, 0]
    return json.loads(outs[0].strip().splitlines()[-1])


def test_the_four_rank_cell_rehearsed_on_the_cpu():
    out = _four_ranks()
    assert out["correct"] is True
    assert out["device"]["count"] == 4


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "cornell-path", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


# --- the control: the reference in bfloat16 in the port's place -----------

@pytest.mark.parametrize("workload", RENDER_CELLS + ["cornell-path-4chip"])
def test_the_control_fails_a_render_cell(workload):
    from perfbench.tests.rank_worker import FOUR_RANKS, manifest_with

    rows = control.readings(workload, [11, 12], "cpu", program=True,
                            overrides=SMALL, manifest=manifest_with(FOUR_RANKS))
    limit = harness.load_json("limits", workload)["pixels_off"]
    for r in rows:
        assert r["control"] > limit, r
        assert r["port"] <= limit, r


def test_the_control_fails_the_train_cell():
    rows = control.readings(TRAIN_CELL, [11], "cpu", program=True,
                            overrides={"width": 24, "height": 24})
    limits = harness.load_json("limits", TRAIN_CELL)
    for r in rows:
        assert any(r["control"][k] > limits[k] for k in limits), r
        assert all(r["port"][k] <= limits[k] for k in limits), r


# --- the timed path broken underneath: correct comes out false -------------

def _broken_render(monkeypatch, fault):
    from gnxraytracer_tpu_torch.models.integrators import path

    orig = path.render_chunk

    def render_chunk(scene, camera, sampler, cfg, sample_start, n_samples):
        if fault == "half":
            # half of the samples left out, the rest counted double
            return 2.0 * orig(scene, camera, sampler, cfg, sample_start,
                              n_samples // 2)
        # an answer altered where it is produced
        return orig(scene, camera, sampler, cfg, sample_start,
                    n_samples) * (1.0 + 1e-3)

    monkeypatch.setattr(path, "render_chunk", render_chunk)


@pytest.mark.parametrize("fault", ["half", "altered"])
@pytest.mark.parametrize("workload", RENDER_CELLS)
def test_a_broken_render_is_not_correct(monkeypatch, workload, fault):
    _broken_render(monkeypatch, fault)
    out = rehearse(workload)
    assert out["correct"] is False and out["failed"] >= 1


def test_the_four_rank_cell_without_its_exchange_is_not_correct():
    assert _four_ranks("no_exchange")["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_train_step_is_not_correct(monkeypatch, fault):
    from gnxraytracer_tpu_torch.parallel import sharding

    orig_make, orig_passes = sharding.make_train_step, sharding.pixel_passes
    if fault == "half":
        # half of the pixels left out, the loss over the rest
        def pixel_passes(cfg, lane_budget, rows=None):
            return [(p0, p0 + (p1 - p0) // 2)
                    for p0, p1 in orig_passes(cfg, lane_budget, rows)]
        monkeypatch.setattr(sharding, "pixel_passes", pixel_passes)
    else:
        def make_train_step(cfg, **kw):
            run = orig_make(cfg, **kw)

            def step(params, *a, **k):
                loss, new = run(params, *a, **k)
                if fault == "unchanged":
                    return loss, params  # the step returns its state
                return loss * (1.0 + 1e-3), new
            return step
        monkeypatch.setattr(sharding, "make_train_step", make_train_step)
    out = harness.run_cell(harness.load_manifest(), TRAIN_CELL, 7, 0.3,
                           0, "cpu", time.perf_counter(),
                           overrides={"width": 24, "height": 24})
    assert out["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_train_step_broken_after_set_up_is_not_correct(monkeypatch, fault):
    """A step that goes wrong only once the checked set-up steps are done
    (a replay that stops applying its update, a step that computes
    something else later) is caught by the window's step."""
    from gnxraytracer_tpu_torch.parallel import sharding

    cell = next(w for w in harness.load_manifest()["workloads"]
                if w["name"] == TRAIN_CELL)
    checked = harness.load_json("traffic", cell["traffic"])["checked_steps"]
    orig_make = sharding.make_train_step

    def make_train_step(cfg, **kw):
        run, calls = orig_make(cfg, **kw), [0]

        def step(params, *a, **k):
            calls[0] += 1
            loss, new = run(params, *a, **k)
            if calls[0] <= checked:
                return loss, new
            if fault == "unchanged":
                return loss, params  # the update is no longer applied
            return loss * (1.0 + 1e-3), new
        return step

    monkeypatch.setattr(sharding, "make_train_step", make_train_step)
    out = harness.run_cell(harness.load_manifest(), TRAIN_CELL, 7, 0.3,
                           0, "cpu", time.perf_counter(),
                           overrides={"width": 24, "height": 24})
    assert out["correct"] is False
    late = {"unchanged": "window_grad_gap", "altered": "window_loss_gap"}[fault]
    assert out["checks"][late]["value"] > out["checks"][late]["limit"]
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert out["checks"][name]["value"] <= out["checks"][name]["limit"]


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cards():
    """The number of CUDA devices; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "workload", [w["name"] for w in harness.load_manifest()["workloads"]])
def test_a_short_run_on_the_card(cards, workload):
    chips = next(w["chips"] for w in harness.load_manifest()["workloads"]
                 if w["name"] == workload)
    if cards < chips:
        pytest.skip(f"{workload} needs {chips} cards")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        workload, "--seed", "4294967311", "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
