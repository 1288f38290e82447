"""The JAX package's own AD of d(mean image)/d(eta) on presets.cornell_glass,
written to tests/golden/jax_grad_glass_eta.json for
tests/test_torch_scene_features.py to hold the port's AD against.

    JAX_PLATFORMS=cpu python tests/jax_glass_eta_grad.py

The configuration is TestGradientSurface.test_grad_wrt_eta_finite_and_nonzero's
(16x16, 16 spp Halton in one chunk, depth 4, the faithful path estimator):
the gradient with respect to every row of the material table's eta column.
XLA's CPU compiler takes about ten minutes over this graph (the Glass /
Mirror / Disney scene), too long for a test run; the port's side takes
seconds.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "golden", "jax_grad_glass_eta.json")
CONFIG = dict(width=16, height=16, spp=16, max_depth=4, spp_chunk=16)


def main():
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(HERE))
    from gnxraytracer_tpu.models.integrators import path
    from gnxraytracer_tpu.ops import samplers
    from gnxraytracer_tpu.scene import presets

    w, h = CONFIG["width"], CONFIG["height"]
    scene, cam = presets.cornell_glass(w, h)
    cfg = path.make_config(scene, w, h, spp=CONFIG["spp"],
                           max_depth=CONFIG["max_depth"],
                           spp_chunk=CONFIG["spp_chunk"])
    smp = samplers.make_halton_sampler(CONFIG["spp"], w, h)

    def loss(eta):
        sc = scene._replace(materials=scene.materials._replace(eta=eta))
        img = path.render_chunk(sc, cam, smp, cfg, 0, cfg.spp_chunk)
        return jnp.mean(img / cfg.spp_chunk)

    t0 = time.time()
    g = jax.grad(loss)(scene.materials.eta)
    out = dict(CONFIG, sampler="halton", estimator="faithful",
               scene="presets.cornell_glass", jax=jax.__version__,
               grad_eta=[float(x) for x in g])
    print(out, f"{time.time() - t0:.1f} s", flush=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
