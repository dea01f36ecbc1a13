"""Minimal triangle-mesh IO + solid mass properties (host-side, numpy).

Replaces the reference's dependency stack (trimesh for loading,
warp.sim.Mesh + ModelBuilder's density-based inertia accumulation,
reference: diffphys/import_urdf.py:78-103) with self-contained loaders for
the OBJ/STL collision geometry shipped with the URDF templates.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class TriMesh:
    vertices: np.ndarray  # (V,3) float64
    faces: np.ndarray  # (F,3) int32

    def copy(self) -> "TriMesh":
        return TriMesh(self.vertices.copy(), self.faces.copy())

    def transformed(self, rmat: np.ndarray, tvec: np.ndarray) -> "TriMesh":
        return TriMesh(self.vertices @ np.asarray(rmat).T + np.asarray(tvec)[None], self.faces)


def load_obj(path: str) -> TriMesh:
    """Wavefront OBJ loader (v / f records; polygons fan-triangulated)."""
    verts, faces = [], []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return TriMesh(np.asarray(verts, np.float64), np.asarray(faces, np.int32))


def load_stl(path: str) -> TriMesh:
    """STL loader, binary or ascii, with vertex dedup."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head[:5] == b"solid":
        # could still be binary with a 'solid' header; try ascii first
        try:
            return _load_stl_ascii(path)
        except Exception:
            pass
    return _load_stl_binary(path)


def _load_stl_ascii(path: str) -> TriMesh:
    tris = []
    with open(path, "r", errors="strict") as f:
        for line in f:
            line = line.strip()
            if line.startswith("vertex"):
                parts = line.split()
                tris.append([float(parts[1]), float(parts[2]), float(parts[3])])
    if len(tris) == 0 or len(tris) % 3 != 0:
        raise ValueError("not an ascii STL")
    return _dedup(np.asarray(tris, np.float64))


def _load_stl_binary(path: str) -> TriMesh:
    with open(path, "rb") as f:
        f.seek(80)
        (n,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(n * 50), dtype=np.uint8).reshape(n, 50)
    tris = data[:, 12:48].copy().view("<f4").reshape(n * 3, 3).astype(np.float64)
    return _dedup(tris)


def _dedup(tri_verts: np.ndarray) -> TriMesh:
    uniq, inv = np.unique(tri_verts.round(9), axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    return TriMesh(uniq, faces)


def load_mesh(path: str) -> TriMesh:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".stl":
        return load_stl(path)
    raise ValueError(f"unsupported mesh format: {path}")


# ---------------------------------------------------------------------------
# solid mass properties (Eberly, "Polyhedral Mass Properties")
# ---------------------------------------------------------------------------

def mesh_mass_properties(vertices: np.ndarray, faces: np.ndarray, density: float):
    """Closed-mesh mass, center of mass and inertia about the COM.

    Equivalent role to warp's density-based mesh shape accumulation
    (reference import_urdf.py:92-103 + wp.sim.ModelBuilder.add_shape_mesh).
    Returns (mass, com(3,), inertia_about_com(3,3)).
    """
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]

    def subexpr(w0, w1, w2):
        tmp0 = w0 + w1
        f1 = tmp0 + w2
        tmp1 = w0 * w0
        tmp2 = tmp1 + w1 * tmp0
        f2 = tmp2 + w2 * f1
        f3 = w0 * tmp1 + w1 * tmp2 + w2 * f2
        g0 = f2 + w0 * (f1 + w0)
        g1 = f2 + w1 * (f1 + w1)
        g2 = f2 + w2 * (f1 + w2)
        return f1, f2, f3, g0, g1, g2

    x0, y0, z0 = v0[:, 0], v0[:, 1], v0[:, 2]
    x1, y1, z1 = v1[:, 0], v1[:, 1], v1[:, 2]
    x2, y2, z2 = v2[:, 0], v2[:, 1], v2[:, 2]
    a1, b1, c1 = x1 - x0, y1 - y0, z1 - z0
    a2, b2, c2 = x2 - x0, y2 - y0, z2 - z0
    d0 = b1 * c2 - b2 * c1
    d1 = a2 * c1 - a1 * c2
    d2 = a1 * b2 - a2 * b1

    f1x, f2x, f3x, g0x, g1x, g2x = subexpr(x0, x1, x2)
    f1y, f2y, f3y, g0y, g1y, g2y = subexpr(y0, y1, y2)
    f1z, f2z, f3z, g0z, g1z, g2z = subexpr(z0, z1, z2)

    intg = np.zeros(10)
    intg[0] = np.sum(d0 * f1x) / 6.0
    intg[1] = np.sum(d0 * f2x) / 24.0
    intg[2] = np.sum(d1 * f2y) / 24.0
    intg[3] = np.sum(d2 * f2z) / 24.0
    intg[4] = np.sum(d0 * f3x) / 60.0
    intg[5] = np.sum(d1 * f3y) / 60.0
    intg[6] = np.sum(d2 * f3z) / 60.0
    intg[7] = np.sum(d0 * (y0 * g0x + y1 * g1x + y2 * g2x)) / 120.0
    intg[8] = np.sum(d1 * (z0 * g0y + z1 * g1y + z2 * g2y)) / 120.0
    intg[9] = np.sum(d2 * (x0 * g0z + x1 * g1z + x2 * g2z)) / 120.0

    volume = intg[0]
    if volume <= 0:
        # degenerate / inverted mesh — fall back to point-cloud AABB box
        lo, hi = vertices.min(0), vertices.max(0)
        ext = np.maximum(hi - lo, 1e-6)
        mass = density * np.prod(ext)
        com = 0.5 * (lo + hi)
        I = box_inertia(mass, *(ext * 0.5))
        return mass, com, I

    mass = density * volume
    com = intg[1:4] / volume
    cx, cy, cz = com
    Ixx = intg[5] + intg[6] - volume * (cy * cy + cz * cz)
    Iyy = intg[4] + intg[6] - volume * (cz * cz + cx * cx)
    Izz = intg[4] + intg[5] - volume * (cx * cx + cy * cy)
    Ixy = -(intg[7] - volume * cx * cy)
    Iyz = -(intg[8] - volume * cy * cz)
    Ixz = -(intg[9] - volume * cz * cx)
    I = density * np.array(
        [[Ixx, Ixy, Ixz], [Ixy, Iyy, Iyz], [Ixz, Iyz, Izz]]
    )
    return mass, com, I


def box_inertia(mass: float, hx: float, hy: float, hz: float) -> np.ndarray:
    """Solid box, half-extents (hx,hy,hz), about its COM."""
    return mass / 3.0 * np.diag(
        [hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy]
    )


def sphere_inertia(mass: float, r: float) -> np.ndarray:
    return 0.4 * mass * r * r * np.eye(3)


def capsule_inertia(density: float, r: float, h: float):
    """Capsule along the x-axis, half-length h (cylinder part), radius r.

    Returns (mass, inertia about COM). Matches the cylinder->capsule mapping
    of the reference importer (import_urdf.py:61-76).
    """
    mc = density * np.pi * r * r * (2 * h)
    ms = density * 4.0 / 3.0 * np.pi * r ** 3
    Ixx = mc * r * r / 2.0 + ms * 0.4 * r * r
    d = h + 3.0 * r / 8.0
    I_hemi_perp = 0.5 * ms * (0.4 * r * r - (3.0 * r / 8.0) ** 2)
    Iperp = mc * ((2 * h) ** 2 / 12.0 + r * r / 4.0) + 2.0 * (
        I_hemi_perp + 0.5 * ms * d * d
    )
    return mc + ms, np.diag([Ixx, Iperp, Iperp])


def concatenate_meshes(meshes) -> TriMesh:
    verts, faces, base = [], [], 0
    for m in meshes:
        verts.append(m.vertices)
        faces.append(m.faces + base)
        base += len(m.vertices)
    return TriMesh(np.concatenate(verts, 0), np.concatenate(faces, 0).astype(np.int32))


def box_mesh(hx: float, hy: float, hz: float) -> TriMesh:
    corners = np.array(
        [[sx, sy, sz] for sx in (-hx, hx) for sy in (-hy, hy) for sz in (-hz, hz)]
    )
    faces = np.array(
        [
            [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
            [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
            [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
        ],
        np.int32,
    )
    return TriMesh(corners.astype(np.float64), faces)


def sphere_mesh(r: float, n: int = 8) -> TriMesh:
    """UV sphere for visualization/contact-free purposes."""
    thetas = np.linspace(0, np.pi, n + 1)
    phis = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    verts = [np.array([0.0, 0.0, r]), np.array([0.0, 0.0, -r])]
    for t in thetas[1:-1]:
        for p in phis:
            verts.append(r * np.array([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)]))
    verts = np.stack(verts, 0)
    faces = []
    rows = n - 1
    cols = 2 * n

    def vid(i, j):
        return 2 + i * cols + (j % cols)

    for j in range(cols):
        faces.append([0, vid(0, j), vid(0, j + 1)])
        faces.append([1, vid(rows - 1, j + 1), vid(rows - 1, j)])
    for i in range(rows - 1):
        for j in range(cols):
            faces.append([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)])
            faces.append([vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)])
    return TriMesh(verts, np.asarray(faces, np.int32))


def capsule_mesh(r: float, h: float, n: int = 6) -> TriMesh:
    sph = sphere_mesh(r, n)
    # rotate so the poles lie on the x-axis (warp capsules are x-aligned),
    # then split the hemispheres apart by the half-length h
    v = np.stack([sph.vertices[:, 2], sph.vertices[:, 1], -sph.vertices[:, 0]], -1)
    v[:, 0] += np.where(v[:, 0] >= 0, h, -h)
    return TriMesh(v, sph.faces)
