"""BENCHMARK.json against the benchmark's format rules, and the files it names."""

import json
import os
import re
import shutil

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind in ("end_to_end", "per_layer"), e["name"]))
    metric_names = [n for is_m, n in names if is_m]
    assert len(metric_names) == len(set(metric_names))
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in manifest["configs"]:
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        for k in c["reduced"]:
            assert NAME.match(k)


def test_units_sources_and_bounds(manifest):
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])


def test_every_cell_reports_enough(manifest):
    for w in manifest["workloads"]:
        e2e = [m["name"] for m in
               harness.cell_metrics(manifest, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layers = harness.cell_metrics(manifest, w["name"], "per_layer")
        assert layers, w["name"]
        for m in layers:
            # a per-layer metric's `moves` is reported where it is
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_configs_cells_and_chips(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in manifest["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in manifest["workloads"])
    assert len(four) <= max(1, len(manifest["workloads"]) // 4)


def test_files_the_manifest_names(manifest):
    root = harness.ROOT
    assert manifest["paths"] == ["perfbench"]
    assert manifest["command"] == ["python3", "perfbench/run.py"]
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        with open(os.path.join(root, c["file"])) as f:
            cfg = json.load(f)
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert cfg["source"] == c["source"]
    for w in manifest["workloads"]:
        harness.load_json("traffic", w["traffic"])
        harness.load_json("limits", w["name"])
    for m in manifest["end_to_end"]:
        mod = harness.load_module("end_to_end", m["name"])
        assert (mod.UNIT, mod.SOURCE) == (m["unit"], m["source"])
    for m in manifest["per_layer"]:
        mod = harness.load_module("metrics", m["name"])
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"]), m["name"]


def test_run_seconds_fits_a_full_check(manifest):
    s = manifest["run_seconds"]
    assert 1 <= s <= 51 and int(s) == s
    cells = 24
    total = (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_a_new_metric_is_found_by_name(tmp_path, manifest):
    """A per-layer metric dropped into a copy is found by its name alone."""
    here = tmp_path / "perfbench"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests",
                                                  "reference"))
    (here / "metrics" / "rays_per_path.render.py").write_text(
        'LAYER = "loops"\nUNIT = "rays"\nSOURCE = "program_counter"\n'
        'MOVES = "render_mpaths_s"\n\n\ndef read(tr):\n'
        '    return None if tr is None else tr.get("rays_per_path")\n')
    m = json.loads(json.dumps(manifest))
    m["per_layer"].append({"name": "rays_per_path.render", "unit": "rays",
                           "better": "lower", "source": "program_counter",
                           "layer": "loops", "moves": "render_mpaths_s",
                           "workloads": ["cornell-path"]})
    names = [e["name"] for e in
             harness.cell_metrics(m, "cornell-path", "per_layer")]
    assert "rays_per_path.render" in names
    assert "rays_per_path.render" not in [
        e["name"] for e in harness.cell_metrics(m, "cornell-train-16spp",
                                                "per_layer")]
    mod = harness.load_module("metrics", "rays_per_path.render", here=str(here))
    assert mod.read({"rays_per_path": 5.5}) == 5.5
    assert mod.read({}) is None
    # a configuration, a traffic mix and a cell are data files and entries:
    # a cell made of new files alone runs (on the CPU, at a small size)
    cfg = harness.load_json("configs", "cornell")
    cfg.update(name="cornell_dim", materials=[
        dict(mat, kd=[0.5 * k for k in mat["kd"]]) if "kd" in mat else mat
        for mat in cfg["materials"]])
    (here / "configs" / "cornell_dim.json").write_text(json.dumps(cfg))
    (here / "traffic" / "progressive_8spp.json").write_text(
        json.dumps(dict(harness.load_json("traffic", "progressive_256spp"),
                        spp_frame=8, check_passes=1)))
    (here / "limits" / "cornell_dim-path8.json").write_text(
        json.dumps({"pixels_off": 0.01}))
    m["configs"].append(dict(m["configs"][0], name="cornell_dim",
                             file="perfbench/configs/cornell_dim.json"))
    m["workloads"].append({"name": "cornell_dim-path8", "config": "cornell_dim",
                           "traffic": "progressive_8spp", "chips": 1,
                           "why": "a cell of new files"})
    for e in m["end_to_end"]:
        if e["name"] == "render_mpaths_s":
            e["workloads"].append("cornell_dim-path8")
    import time

    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = harness.run_cell(m, "cornell_dim-path8", 5, 0.2, 0, "cpu",
                               time.perf_counter(), here=str(here),
                               overrides={"width": 32, "height": 32})
    finally:
        torch.set_num_threads(n)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"render_mpaths_s", "setup_s"}
