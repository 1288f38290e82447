"""Native host library (C++ via ctypes): the SAH BVH builder and the Halton
digit permutations.

``bvh_builder.cpp`` is compiled with g++ at first use into the package's
build directory (the one the CUDA kernels go to; not under version control)
and named after a hash of its source, so an edited source is rebuilt.
Nothing is built or loaded when the package is imported.  ``ops/bvh.py``
has a pure-numpy builder beside it, so a missing toolchain only costs speed.
"""

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..kernels.build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "bvh_builder.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lib = None


def library_path():
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgnx_native_{digest.hexdigest()[:16]}.so")


def get_lib():
    """ctypes handle of the native library, compiling it if needed."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    lib = ctypes.CDLL(out)
    p = ctypes.c_void_p
    lib.gnx_build_bvh_sah.argtypes = [
        p, ctypes.c_int, p, ctypes.c_int, ctypes.c_int, p, p, p, p, p, p,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.gnx_build_bvh_sah.restype = ctypes.c_int
    lib.gnx_halton_permutations.argtypes = [p, ctypes.c_int, p]
    lib.gnx_halton_permutations.restype = None
    _lib = lib
    return lib


def build_bvh_sah(verts, tris, leaf_size):
    """SAH build of the binary tree; returns (lo, hi, offset, n_prims, axis,
    order) in the depth-first layout of ops/bvh.py, or None when the builder
    gives up."""
    lib = get_lib()
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    n_tris = len(tris)
    max_nodes = max(2 * n_tris, 8)
    lo = np.empty((max_nodes, 3), np.float32)
    hi = np.empty((max_nodes, 3), np.float32)
    off = np.empty(max_nodes, np.int32)
    npr = np.empty(max_nodes, np.int32)
    ax = np.empty(max_nodes, np.int32)
    order = np.empty(n_tris + leaf_size, np.int32)
    order_len = ctypes.c_int(0)

    def c(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    n_nodes = lib.gnx_build_bvh_sah(
        c(verts), len(verts), c(tris), n_tris, leaf_size,
        c(lo), c(hi), c(off), c(npr), c(ax), c(order), max_nodes,
        ctypes.byref(order_len))
    if n_nodes < 0:
        return None
    ol = order_len.value
    return (lo[:n_nodes].copy(), hi[:n_nodes].copy(), off[:n_nodes].copy(),
            npr[:n_nodes].copy(), ax[:n_nodes].copy(), order[:ol].copy())


def halton_permutations(primes):
    """Flat int32 table of the scrambled-radical-inverse digit permutations
    of `primes`, one after the other (ops/lds.permutations_python is the
    same shuffle in Python)."""
    lib = get_lib()
    primes = np.ascontiguousarray(primes, np.int32)
    out = np.empty(int(primes.astype(np.int64).sum()), np.int32)
    lib.gnx_halton_permutations(primes.ctypes.data_as(ctypes.c_void_p),
                                len(primes),
                                out.ctypes.data_as(ctypes.c_void_p))
    return out
