"""The JAX package's own AD of the five gradient goldens, written to
tests/golden/jax_grad_ad.json for the port's checks to compare against.

    JAX_PLATFORMS=cpu python tests/jax_gradient_goldens.py [NAME ...]

For each golden of tests/golden/ref_grad_*.npz (the reference renderer's
central FD of d(mean image)/d(theta)), the JAX package's AD at theta = 1 (or
the golden's base value), computed as tests/test_reference_parity.py
computes it (32x32, 256 spp Halton, depth 8, 32-spp chunks; path for the
surface scenes, volpath for the medium) but with each chunk's gradient
jitted once and summed.  The file also records the golden's FD and the
relative error of the JAX AD against it, which says whether the JAX package
passes its own golden.  Names default to all five; an existing file is
updated, not replaced.  Takes a few minutes on a CPU (the Glass/Mirror/
Disney scene's compile the longest).
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "golden", "jax_grad_ad.json")
W = H = 32
SPP = 256
CHUNK = 32


def _setup(name):
    from gnxraytracer_tpu.models.integrators import path as P
    from gnxraytracer_tpu.models.integrators import volpath as V
    from gnxraytracer_tpu.scene import presets
    from gnxraytracer_tpu.scene.scene import MAT_DISNEY

    if name in ("ref_grad_kd", "ref_grad_le"):
        scene, cam = presets.cornell_box(W, H, sigma=0.0, skybox=False)
    elif name == "ref_grad_sigma":
        scene, cam = presets.cornell_box(W, H, sigma=60.0, skybox=False)
    elif name == "ref_grad_disney_rough":
        scene, cam = presets.cornell_gmd(W, H, sigma=0.0)
    else:
        scene, cam = presets.cornell_homogeneous(W, H)
    mats = scene.materials

    def scaled(theta):
        if name == "ref_grad_kd":
            return scene._replace(materials=mats._replace(
                kd=mats.kd.at[0].mul(theta)))
        if name == "ref_grad_le":
            return scene._replace(lights=scene.lights._replace(
                emit=jnp.ones_like(scene.lights.emit) * theta))
        if name == "ref_grad_sigma":
            return scene._replace(materials=mats._replace(
                sigma=jnp.ones_like(mats.sigma) * theta))
        if name == "ref_grad_disney_rough":
            is_d = mats.kind == MAT_DISNEY
            return scene._replace(materials=mats._replace(
                rough_u=jnp.where(is_d, mats.rough_u * theta, mats.rough_u),
                rough_v=jnp.where(is_d, mats.rough_v * theta, mats.rough_v)))
        return scene._replace(media=scene.media._replace(
            sigma_a=scene.media.sigma_a * theta,
            sigma_s=scene.media.sigma_s * theta))

    theta0 = {"ref_grad_le": 5.0, "ref_grad_sigma": 60.0}.get(name, 1.0)
    mod = V if name == "ref_grad_med_sigma" else P
    cfg = P.make_config(scene, W, H, spp=SPP, max_depth=8, spp_chunk=CHUNK)
    return scaled, theta0, mod, cfg, cam


def jax_ad(name):
    from gnxraytracer_tpu.ops import samplers

    scaled, theta0, mod, cfg, cam = _setup(name)
    smp = samplers.make_halton_sampler(SPP, W, H)

    @jax.jit
    def chunk_grad(theta, start):
        return jax.grad(lambda t: jnp.mean(mod.render_chunk(
            scaled(t), cam, smp, cfg, start, CHUNK)) / SPP)(theta)

    return sum(float(chunk_grad(jnp.float32(theta0), jnp.int32(s)))
               for s in range(0, SPP, CHUNK))


def oracle_fd(name):
    z = np.load(os.path.join(HERE, "golden", f"{name}.npz"))
    return float(((z["plus"] - z["minus"]) / (2 * float(z["h"]))).mean())


def main(names):
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(HERE))
    out = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            out = json.load(f)
    for name in names:
        t0 = time.time()
        ad = jax_ad(name)
        fd = oracle_fd(name)
        out[name] = {"jax_ad": ad, "oracle_fd": fd,
                     "jax_rel_err": abs(ad - fd) / abs(fd),
                     "width": W, "height": H, "spp": SPP, "max_depth": 8,
                     "sampler": "halton", "jax": jax.__version__}
        print(name, out[name], f"{time.time() - t0:.1f} s", flush=True)
        with open(OUT, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
            f.write("\n")


if __name__ == "__main__":
    main(sys.argv[1:] or ["ref_grad_kd", "ref_grad_le", "ref_grad_sigma",
                          "ref_grad_med_sigma", "ref_grad_disney_rough"])
