"""Run one cell of the benchmark once, from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, metrics and bounds are in BENCHMARK.json; perfbench/harness.py
says how a run goes.  The last line of standard output is the result.
"""

import os
import sys
import time


def _process_age_s():
    """Seconds since this process started (Linux /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


# set-up is counted from the start of the process
T_START = time.perf_counter() - _process_age_s()

# few host threads a process; the benchmark's own cache directories
os.environ.setdefault("OMP_NUM_THREADS", "4")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(_ROOT, ".cache", "perfbench", _sub)
os.environ["NCCL_SHM_DISABLE"] = "1"
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, _ROOT)

if __name__ == "__main__":
    from perfbench import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
