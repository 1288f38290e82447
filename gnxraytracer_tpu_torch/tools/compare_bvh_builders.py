"""Holds the two SAH builders of ops/bvh.build_bvh against each other on
blob meshes: the C++ one (native/, compiled with g++ at first use) and the
numpy one.

    python -m gnxraytracer_tpu_torch.tools.compare_bvh_builders [n_seg ...]

Runs on the host alone (no GPU).  For each mesh (default n_seg 8, 24 and 229,
the last being the 104,882-triangle blob of presets.envmap_mesh) it prints
one JSON line: build seconds of each, which of the six arrays (lo, hi,
offset, n_prims, axis, order) are byte-equal, the share of `order` that
differs, and whether every leaf holds the same SET of triangles.  Exits 1 if
anything but the order inside a leaf differs.
"""

import json
import sys
import time

import numpy as np

from .. import native
from ..ops.bvh import LEAF_SIZE, build_bvh_numpy
from ..scene.loaders import make_blob_mesh

NAMES = ("lo", "hi", "offset", "n_prims", "axis", "order")


def compare(n_seg):
    v, t, _n, _uv = make_blob_mesh(n_seg)
    t0 = time.time()
    a = native.build_bvh_sah(v, t, LEAF_SIZE)
    native_s = time.time() - t0
    t0 = time.time()
    b = build_bvh_numpy(v, t, LEAF_SIZE)
    numpy_s = time.time() - t0
    equal = {n: bool(x.shape == y.shape and np.array_equal(x, y))
             for n, x, y in zip(NAMES, a, b)}
    same_sets = False
    if all(equal[n] for n in NAMES[:5]):
        off, npr = a[2], a[3]
        leaves = np.nonzero(npr > 0)[0]
        same_sets = all(
            sorted(a[5][off[l]:off[l] + npr[l]])
            == sorted(b[5][off[l]:off[l] + npr[l]]) for l in leaves)
    out = dict(n_seg=n_seg, triangles=len(t), nodes=len(a[2]),
               native_s=native_s, numpy_s=numpy_s, equal=equal,
               order_differs=float((a[5] != b[5]).mean())
               if a[5].shape == b[5].shape else None,
               same_triangle_set_in_every_leaf=same_sets)
    print(json.dumps(out), flush=True)
    return same_sets


def main(argv):
    segs = [int(x) for x in argv] or [8, 24, 229]
    native.get_lib()  # compile outside the timed window
    return 0 if all([compare(s) for s in segs]) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
