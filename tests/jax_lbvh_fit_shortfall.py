"""How far the JAX package's LBVH box fit falls short on a mesh.

    JAX_PLATFORMS=cpu python tests/jax_lbvh_fit_shortfall.py [--n-seg 229]

Builds the JAX package's LBVH (ops/lbvh.build_lbvh_device) over
make_blob_mesh(n_seg) (229: the 104,882-triangle blob of
presets.envmap_mesh), whose box fit runs a fixed ceil(log2 T) + 2 sweeps,
and prints one JSON line: the tree's height, that sweep count, the internal
nodes whose box differs from the fit run to convergence, and the triangles
that lie outside the box of one of their ancestors, which a walk that culls
by box never reaches.  tests/test_torch_lbvh.py runs `shortfall` on small
inputs.
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def shortfall(built):
    """The fit's shortfall from build_lbvh_device's dict: plain numpy over
    its links, leaf boxes and node boxes."""
    left, right = np.asarray(built["left"]), np.asarray(built["right"])
    leaf_lo, leaf_hi = np.asarray(built["leaf_lo"]), np.asarray(built["leaf_hi"])
    node_lo, node_hi = np.asarray(built["node_lo"]), np.asarray(built["node_hi"])
    n_int = len(left)
    t = n_int + 1
    # levels top down: each node's depth, and the intersection of its
    # ancestors' boxes (a box holds a leaf only if all its ancestors' do)
    depth = np.zeros(2 * t - 1, np.int64)
    anc_lo = np.full((2 * t - 1, 3), -np.inf, np.float32)
    anc_hi = np.full((2 * t - 1, 3), np.inf, np.float32)
    frontier = np.array([0])
    while len(frontier):
        for kids in (left[frontier], right[frontier]):
            depth[kids] = depth[frontier] + 1
            anc_lo[kids] = np.maximum(anc_lo[frontier], node_lo[frontier])
            anc_hi[kids] = np.minimum(anc_hi[frontier], node_hi[frontier])
        nxt = np.concatenate([left[frontier], right[frontier]])
        frontier = nxt[nxt < n_int]
    # the fit run until no box changes
    lo = np.full((n_int, 3), np.inf, np.float32)
    hi = np.full((n_int, 3), -np.inf, np.float32)
    all_lo, all_hi = np.concatenate([lo, leaf_lo]), np.concatenate([hi, leaf_hi])
    while True:
        new_lo = np.minimum(all_lo[left], all_lo[right])
        new_hi = np.maximum(all_hi[left], all_hi[right])
        if np.array_equal(new_lo, all_lo[:n_int]) and \
                np.array_equal(new_hi, all_hi[:n_int]):
            break
        all_lo[:n_int], all_hi[:n_int] = new_lo, new_hi
    short = ((node_lo != all_lo[:n_int]) | (node_hi != all_hi[:n_int])).any(1)
    outside = ((leaf_lo < anc_lo[n_int:]) | (leaf_hi > anc_hi[n_int:])).any(1)
    return {"triangles": int(t), "height": int(depth.max()),
            "fixed_sweeps": int(np.ceil(np.log2(max(t, 2)))) + 2,
            "short_nodes": int(short.sum()),
            "triangles_outside_an_ancestor_box": int(outside.sum())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-seg", type=int, default=229)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(HERE))
    from gnxraytracer_tpu.ops import lbvh
    from gnxraytracer_tpu.scene.loaders import make_blob_mesh

    v, t, _, _ = make_blob_mesh(args.n_seg)
    built = lbvh.build_lbvh_device(jnp.asarray(v, jnp.float32),
                                   jnp.asarray(t, jnp.int32))
    print(json.dumps({"mesh": f"make_blob_mesh({args.n_seg})",
                      **shortfall(built)}))


if __name__ == "__main__":
    main()
