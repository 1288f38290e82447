"""One rank of a cell of several chips, on the CPU at a small size, for the
tests: python3 perfbench/tests/rank_worker.py WORKLOAD RANK WORLD PORT
[FAULT].  FAULT "no_exchange" leaves out the combine of the ranks' films
(each rank keeps its own).  Rank 0 prints the result line."""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

SMALL = {"width": 32, "height": 32}
# the four-rank cell, for the tests where BENCHMARK.json does not list it
FOUR_RANKS = {"name": "cornell-path-4chip", "config": "cornell",
              "traffic": "progressive_256spp_split4", "chips": 4,
              "why": "cornell-path split by samples over 4 ranks"}


def manifest_with(cell):
    """BENCHMARK.json, with `cell` added where it lacks a cell of that name."""
    from perfbench import harness

    m = harness.load_manifest()
    if all(w["name"] != cell["name"] for w in m["workloads"]):
        m["workloads"].append(cell)
        for e in m["end_to_end"]:
            if e["name"] in ("render_mpaths_s", "pass_p90_ms"):
                e["workloads"].append(cell["name"])
    return m


def main(workload, rank, world, port, fault=None):
    import torch

    torch.set_num_threads(1)
    from gnxraytracer_tpu_torch.parallel import multihost

    from perfbench import harness

    if fault == "no_exchange":
        multihost.combine_partials = lambda partial, w, tw: partial * w / tw
    elif fault is not None:
        raise ValueError(fault)
    out = harness.run_cell(manifest_with(FOUR_RANKS), workload, 20260917, 0.3,
                           0, "cpu", time.perf_counter(), rank=rank,
                           world=world, port=port, overrides=SMALL)
    if rank == 0:
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0], int(a[1]), int(a[2]), int(a[3]), a[4] if len(a) > 4 else None)
