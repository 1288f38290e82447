"""Builds the CUDA sources under csrc/ with nvcc into shared libraries with
a plain C interface and loads them with ctypes.

A library is built at first use into ``gnxraytracer_tpu_torch/build/`` (not
under version control) and named after a hash of its source, of every file
under csrc/ that the source includes, and of the flags, so an edited source
or header is rebuilt and a finished build is reused.  Nothing here runs when
the package is imported.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

from ..utils.stats import span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# sm_90a: Hopper.  --fmad=false and no fast-math: see csrc/closest_hit.cu.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_libs = {}
build_log = {}  # source name -> {"seconds", "ptxas", "path", "cached"}


def find_nvcc():
    for cand in (os.environ.get("NVCC"),
                 shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set NVCC or CUDA_HOME)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(name):
    """csrc/<name>.cu and, transitively, the files under csrc/ it includes
    with quotes, in a fixed order."""
    todo, seen = [name + ".cu"], []
    while todo:
        rel = todo.pop()
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(CSRC_DIR, rel), "rb") as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            inc = inc.decode()
            if os.path.isfile(os.path.join(CSRC_DIR, inc)):
                todo.append(inc)
    return [os.path.join(CSRC_DIR, rel) for rel in sorted(seen)]


def _target(name):
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    src = os.path.join(CSRC_DIR, name + ".cu")
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def start_build(name):
    """Start nvcc for csrc/<name>.cu; returns a handle for finish_build,
    so several sources can compile at once."""
    src, out = _target(name)
    if os.path.exists(out):
        return (name, out, None, None, time.time())
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return (name, out, tmp, proc, time.time())


def finish_build(handle):
    name, out, tmp, proc, t0 = handle
    if proc is None:
        build_log[name] = dict(seconds=0.0, ptxas="", path=out, cached=True)
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    build_log[name] = dict(seconds=time.time() - t0, ptxas=log, path=out,
                           cached=False)
    return out


def load(name):
    """ctypes handle of csrc/<name>.cu's library, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        with span("kernels.load"):
            lib = ctypes.CDLL(finish_build(start_build(name)))
        _libs[name] = lib
    return lib
