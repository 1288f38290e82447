"""What the benchmark loads: never JAX or the JAX package (top-level module
names compared whole, since the port's name begins with the JAX
package's), and the reference nothing of the port."""

import json
import os
import subprocess
import sys

from perfbench import harness

ROOT = harness.ROOT


def loaded_after(code):
    """Top-level names of the modules a fresh interpreter holds after
    running `code` from the repository's root."""
    probe = (code + "\nimport json, sys\n"
             "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_names_are_compared_whole():
    mods = {"gnxraytracer_tpu_torch.ops.trace": 1, "jaxtyping": 1,
            "numpy": 1}
    assert harness.forbidden_loaded(mods) == []
    mods.update({"gnxraytracer_tpu.ops": 1, "jax.numpy": 1})
    assert harness.forbidden_loaded(mods) == ["gnxraytracer_tpu.ops",
                                              "jax.numpy"]


def test_the_harness_loads_no_jax():
    top = loaded_after(
        "import perfbench.harness, perfbench.runners.progressive, "
        "perfbench.runners.train, perfbench.tracing\n"
        "from perfbench import harness\n"
        "[harness.load_module(k, m['name']) for k in ('end_to_end',) "
        "for m in harness.load_manifest()['end_to_end']]\n"
        "[harness.load_module('metrics', m['name']) "
        "for m in harness.load_manifest()['per_layer']]\n"
        "import gnxraytracer_tpu_torch.models.integrators.path, "
        "gnxraytracer_tpu_torch.parallel.multihost, "
        "gnxraytracer_tpu_torch.parallel.sharding")
    assert not top & set(harness.FORBIDDEN_MODULES), top


def test_the_reference_loads_nothing_of_the_port():
    top = loaded_after("import perfbench.reference.render, "
                       "perfbench.reference.train, perfbench.reference.compare")
    assert "gnxraytracer_tpu_torch" not in top
    assert not top & set(harness.FORBIDDEN_MODULES), top


def test_the_reference_sources_name_nothing_of_the_port():
    ref = os.path.join(harness.HERE, "reference")
    for dirpath, _dirs, files in os.walk(ref):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    src = f.read()
                for bad in ("import gnxraytracer", "from gnxraytracer",
                            "import jax", "from jax", ".kernels", ".native"):
                    assert bad not in src, (name, bad)
