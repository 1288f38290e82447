"""Asset loaders: the reference renderer's '.3d' mesh format (reader and
writer) and its '.volume' density grids, and the procedural meshes that
stand in for its high-poly assets.

The '.3d' format is text: a header line holding "vertex N" and "face M",
then N lines "x y z" (positions, scaled x20 when loaded, as the reference
renderer's reader does) and M lines "3 i j k" (triangle indices).
"""

import numpy as np


def load_3d_mesh(path, scale=20.0):
    """Parse a '.3d' mesh.  Returns (V, 3) float32 vertices (scaled by
    scale) and (T, 3) int32 triangle indices."""
    n_verts = n_faces = None
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if n_verts is None or n_faces is None:
                # header lines: "... vertex N ... face M ..."
                for i, t in enumerate(tok):
                    if t == "vertex" and i + 1 < len(tok):
                        n_verts = int(tok[i + 1])
                    if t == "face" and i + 1 < len(tok):
                        n_faces = int(tok[i + 1])
                continue
            if len(verts) < n_verts:
                verts.append([float(tok[0]), float(tok[1]), float(tok[2])])
            elif len(faces) < n_faces:
                # "3 i j k" or "i j k"
                idx = tok[1:4] if len(tok) == 4 else tok[0:3]
                faces.append([int(idx[0]), int(idx[1]), int(idx[2])])
    v = np.asarray(verts, np.float32) * scale
    t = np.asarray(faces, np.int32)
    return v, t


def save_3d(path, vertices, triangles, scale=20.0):
    """Write a mesh in the '.3d' format: header "vertex N face M", the
    positions divided by the load-time scale, faces as "3 i j k", so that
    the reference renderer renders the geometry a preset builds."""
    v = np.asarray(vertices, np.float64) / scale
    t = np.asarray(triangles, np.int64)
    with open(path, "w") as f:
        f.write(f"vertex {len(v)} face {len(t)}\n")
        for p in v:
            f.write(f"{p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        for a, b, c in t:
            f.write(f"3 {a} {b} {c}\n")


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


def load_volume(path):
    """Load a '.volume' density grid of the reference renderer.  The format
    is text: a line "nx X ny Y nz Z", optional lines "p0 x y z", "p1 x y z"
    (grid bounds), "sigma_a a a a", "sigma_s s s s", then nx*ny*nz density
    values, whitespace separated, x fastest.

    Returns dict(density (nz, ny, nx) float32, p0, p1, sigma_a, sigma_s)."""
    with open(path, "rb") as f:
        txt = f.read().decode("ascii", errors="replace")
    lines = txt.replace("\r\n", "\n").split("\n")
    header = {}
    data_start = 0
    for i, line in enumerate(lines):
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "nx":
            header["nx"], header["ny"], header["nz"] = (
                int(tok[1]), int(tok[3]), int(tok[5]))
        elif tok[0] in ("p0", "p1", "sigma_a", "sigma_s"):
            header[tok[0]] = np.asarray([float(x) for x in tok[1:4]],
                                        np.float32)
        else:
            data_start = i
            break
    nx, ny, nz = header["nx"], header["ny"], header["nz"]
    vals = np.asarray(" ".join(lines[data_start:]).split(), dtype=np.float32)
    density = vals[:nx * ny * nz].reshape(nz, ny, nx)
    return dict(
        density=density,
        p0=header.get("p0", np.zeros(3, np.float32)),
        p1=header.get("p1", np.ones(3, np.float32)),
        sigma_a=header.get("sigma_a", np.ones(3, np.float32)),
        sigma_s=header.get("sigma_s", np.ones(3, np.float32)),
    )
