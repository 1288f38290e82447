"""Procedural meshes: the stand-ins for the reference renderer's high-poly
assets.  The '.3d' mesh and '.volume' grid parsers of the JAX package wait
for the slices that load such files.
"""

import numpy as np


def make_test_mesh(n_subdiv=4):
    """Procedural high-poly stand-in for the reference renderer's dragon
    mesh: an icosphere with sinusoidal displacement, ~20*4^n triangles, in
    the dragon's place and scale."""
    # icosahedron
    phi = (1 + 5 ** 0.5) / 2
    v = np.asarray([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(n_subdiv):
        cache = {}
        verts = v.tolist()

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2
                m = m / np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(m.tolist())
            return cache[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(nf, np.int64)
    # displacement for interesting geometry + normals
    r = 1.0 + 0.12 * np.sin(6 * v[:, 0]) * np.sin(5 * v[:, 1]) * np.sin(4 * v[:, 2])
    v = v * r[:, None] * 1.2
    return v.astype(np.float32), f.astype(np.int32)


def make_blob_mesh(n_seg=229):
    """Displaced UV sphere with vertex normals and spherical uvs:
    2*n_seg^2 triangles (n_seg=229 -> 104,882, about the reference dragon's
    scale).  Unlike make_test_mesh, triangle count is quadratic in n_seg so
    a caller can dial in an exact workload size."""
    th = np.linspace(1e-3, np.pi - 1e-3, n_seg + 1)
    ph = np.linspace(0, 2 * np.pi, n_seg + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    R = 1.0 + 0.13 * np.sin(6 * T) * np.cos(7 * P) + 0.05 * np.sin(13 * P)
    x = R * np.sin(T) * np.cos(P)
    y = R * np.cos(T)
    z = R * np.sin(T) * np.sin(P)
    v = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([P / (2 * np.pi), T / np.pi], -1).reshape(-1, 2).astype(np.float32)
    idx = np.arange((n_seg + 1) * (n_seg + 1)).reshape(n_seg + 1, n_seg + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[1:, 1:].ravel()
    d = idx[:-1, 1:].ravel()
    f = np.concatenate([np.stack([a, b, c], -1),
                        np.stack([a, c, d], -1)]).astype(np.int32)
    # area-weighted vertex normals
    n = np.zeros_like(v)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    return v, f, n.astype(np.float32), uv
