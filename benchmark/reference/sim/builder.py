"""Articulation model description + builder (host-side, numpy).

Numpy copy of ``ppr_diffphys_tpu/sim/builder.py`` (kept separate so the
PyTorch port never imports the JAX package). Replacement for the external
``wp.sim.ModelBuilder`` / ``wp.sim.Model`` machinery of the reference:

- ``ModelBuilder`` accumulates bodies / joints / collision shapes with
  density-based mass properties (mirrors the builder calls made by the
  reference importer, diffphys/import_urdf.py:106-291);
- ``finalize()`` produces an ``ArticulationModel`` — a plain host object of
  static numpy topology arrays. It is **not** replicated per environment:
  environments are a batch axis in the simulator;
- ``make_ground_contacts()`` generates static ground-plane contact points
  (one-time, mirrors ``wp.sim.Model.collide`` semantics: sphere center,
  capsule ends, box corners, mesh vertices; dp_model.py:401).

Differentiable quantities (masses, inertias, PD gains, joint anchor
transforms) are *initial values* here; at simulation time they are
tensors carried in ``SimParams``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .mesh import (
    TriMesh,
    box_inertia,
    sphere_inertia,
    capsule_inertia,
    mesh_mass_properties,
    box_mesh,
    sphere_mesh,
    capsule_mesh,
)

# joint type codes (static ints, equal to the JAX package's)
JOINT_FREE = 0
JOINT_REVOLUTE = 1
JOINT_PRISMATIC = 2
JOINT_FIXED = 3
JOINT_COMPOUND = 4

# dofs per joint type: (q count, qd count)
_JOINT_DOFS = {
    JOINT_FREE: (7, 6),
    JOINT_REVOLUTE: (1, 1),
    JOINT_PRISMATIC: (1, 1),
    JOINT_FIXED: (0, 0),
    JOINT_COMPOUND: (3, 3),
}

GEO_BOX = "box"
GEO_SPHERE = "sphere"
GEO_CAPSULE = "capsule"
GEO_MESH = "mesh"


def _xform(p=None, q=None) -> np.ndarray:
    out = np.zeros(7)
    out[6] = 1.0
    if p is not None:
        out[0:3] = p
    if q is not None:
        out[3:7] = q
    return out


def _quat_rotate_np(q, v):
    u, w = q[..., :3], q[..., 3:4]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _quat_to_matrix_np(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


@dataclass
class Shape:
    body: int
    xform: np.ndarray  # (7,) shape->body transform
    geo_type: str
    scale: np.ndarray  # (3,) semantic per type: box half-extents, sphere (r,r,r), capsule (r,h,0), mesh scale
    mesh: Optional[TriMesh]  # for GEO_MESH
    material: np.ndarray  # (4,) ke, kd, kf, mu


class ModelBuilder:
    """Accumulates one articulation. Finalize once; no env replication."""

    def __init__(self):
        self.joint_type: List[int] = []
        self.joint_parent: List[int] = []
        self.joint_axis: List[np.ndarray] = []
        self.joint_X_p: List[np.ndarray] = []
        self.joint_X_c: List[np.ndarray] = []
        self.joint_q_start: List[int] = []
        self.joint_qd_start: List[int] = []

        self.joint_q: List[float] = []  # initial generalized coords
        # per-dof
        self.joint_target_ke: List[float] = []
        self.joint_target_kd: List[float] = []
        self.joint_limit_lower: List[float] = []
        self.joint_limit_upper: List[float] = []
        self.joint_limit_ke: List[float] = []
        self.joint_limit_kd: List[float] = []
        self.joint_armature: List[float] = []

        # per-body mass properties (accumulated from shapes)
        self.body_mass: List[float] = []
        self.body_com: List[np.ndarray] = []
        self.body_inertia: List[np.ndarray] = []

        self.shapes: List[Shape] = []
        self.body_name: List[str] = []

    # -- bodies -------------------------------------------------------------

    @property
    def body_count(self) -> int:
        return len(self.body_mass)

    def add_body(
        self,
        parent: int = -1,
        joint_type: int = JOINT_FREE,
        joint_xform: Optional[np.ndarray] = None,
        joint_xform_child: Optional[np.ndarray] = None,
        joint_axis=(0.0, 0.0, 0.0),
        joint_limit_lower=-1e3,
        joint_limit_upper=1e3,
        joint_limit_ke=100.0,
        joint_limit_kd=10.0,
        joint_target_ke=0.0,
        joint_target_kd=0.0,
        joint_armature=0.0,
        com=np.zeros(3),
        I_m=np.zeros((3, 3)),
        m=0.0,
        name: str = "",
    ) -> int:
        body_id = self.body_count
        nq, nqd = _JOINT_DOFS[joint_type]

        self.joint_type.append(joint_type)
        self.joint_parent.append(parent)
        axis = np.asarray(joint_axis, np.float64)
        n = np.linalg.norm(axis)
        self.joint_axis.append(axis / n if n > 0 else axis)
        self.joint_X_p.append(
            joint_xform if joint_xform is not None else _xform()
        )
        self.joint_X_c.append(
            joint_xform_child if joint_xform_child is not None else _xform()
        )
        self.joint_q_start.append(len(self.joint_q))
        self.joint_qd_start.append(len(self.joint_target_ke))

        if joint_type == JOINT_FREE:
            self.joint_q.extend([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
        else:
            self.joint_q.extend([0.0] * nq)

        def _as_list(v, n):
            if np.ndim(v) == 0:
                return [float(v)] * n
            return [float(x) for x in v]

        self.joint_target_ke.extend(_as_list(joint_target_ke, nqd))
        self.joint_target_kd.extend(_as_list(joint_target_kd, nqd))
        self.joint_limit_lower.extend(_as_list(joint_limit_lower, nqd))
        self.joint_limit_upper.extend(_as_list(joint_limit_upper, nqd))
        self.joint_limit_ke.extend(_as_list(joint_limit_ke, nqd))
        self.joint_limit_kd.extend(_as_list(joint_limit_kd, nqd))
        self.joint_armature.extend(_as_list(joint_armature, nqd))

        self.body_mass.append(float(m))
        self.body_com.append(np.asarray(com, np.float64).copy())
        # joint armature is added straight into the body inertia ("additional
        # inertia", reference dp_model.py:137). This is what keeps the stiff
        # attachment springs (ke=16e3) stable at dt=5e-4 for small links:
        # without it the smallest laikago link inertia is ~3e-5 and the
        # angular attach frequency exceeds the symplectic stability bound.
        arm = float(np.ravel(joint_armature)[0]) if np.ndim(joint_armature) else float(joint_armature)
        self.body_inertia.append(
            np.asarray(I_m, np.float64).copy() + arm * np.eye(3)
        )
        self.body_name.append(name)
        return body_id

    # -- shapes -------------------------------------------------------------

    def _add_shape(self, shape: Shape, m, com_s, I_s):
        """Register shape and fold its mass properties into the body.

        Mirrors wp.sim.ModelBuilder._update_body_mass: weighted COM update +
        parallel-axis shift of both the existing body inertia and the new
        shape inertia onto the new COM.
        """
        self.shapes.append(shape)
        if m <= 0:
            return
        b = shape.body
        R = _quat_to_matrix_np(shape.xform[3:7])
        com_b = shape.xform[0:3] + R @ com_s  # shape COM in body frame
        I_b = R @ I_s @ R.T

        m0 = self.body_mass[b]
        new_mass = m0 + m
        new_com = (self.body_com[b] * m0 + com_b * m) / new_mass

        def _shift(I, mass, d):
            return I + mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

        self.body_inertia[b] = _shift(
            self.body_inertia[b], m0, new_com - self.body_com[b]
        ) + _shift(I_b, m, new_com - com_b)
        self.body_mass[b] = new_mass
        self.body_com[b] = new_com

    def add_shape_box(
        self, body, pos, rot, hx, hy, hz, density=0.0, ke=1e5, kd=1e3, kf=1e3, mu=0.5
    ):
        m = density * 8.0 * hx * hy * hz
        shape = Shape(
            body=body,
            xform=_xform(pos, rot),
            geo_type=GEO_BOX,
            scale=np.array([hx, hy, hz], np.float64),
            mesh=None,
            material=np.array([ke, kd, kf, mu]),
        )
        self._add_shape(shape, m, np.zeros(3), box_inertia(m, hx, hy, hz))

    def add_shape_sphere(
        self, body, pos, rot, radius, density=0.0, ke=1e5, kd=1e3, kf=1e3, mu=0.5
    ):
        m = density * 4.0 / 3.0 * np.pi * radius ** 3
        shape = Shape(
            body=body,
            xform=_xform(pos, rot),
            geo_type=GEO_SPHERE,
            scale=np.array([radius] * 3, np.float64),
            mesh=None,
            material=np.array([ke, kd, kf, mu]),
        )
        self._add_shape(shape, m, np.zeros(3), sphere_inertia(m, radius))

    def add_shape_capsule(
        self, body, pos, rot, radius, half_width, density=0.0, ke=1e5, kd=1e3, kf=1e3, mu=0.5
    ):
        m, I = capsule_inertia(density, radius, half_width)
        shape = Shape(
            body=body,
            xform=_xform(pos, rot),
            geo_type=GEO_CAPSULE,
            scale=np.array([radius, half_width, 0.0], np.float64),
            mesh=None,
            material=np.array([ke, kd, kf, mu]),
        )
        self._add_shape(shape, m, np.zeros(3), I)

    def add_shape_mesh(
        self, body, pos, rot, mesh: TriMesh, scale=(1.0, 1.0, 1.0), density=0.0,
        ke=1e5, kd=1e3, kf=1e3, mu=0.5,
    ):
        sc = np.asarray(scale, np.float64)
        m, com, I = mesh_mass_properties(mesh.vertices * sc[None], mesh.faces, density)
        shape = Shape(
            body=body,
            xform=_xform(pos, rot),
            geo_type=GEO_MESH,
            scale=sc,
            mesh=mesh,
            material=np.array([ke, kd, kf, mu]),
        )
        self._add_shape(shape, m, com, I)

    # -- finalize -----------------------------------------------------------

    def finalize(self) -> "ArticulationModel":
        return ArticulationModel(self)


class ArticulationModel:
    """Static articulation description (host numpy constants).

    The simulator reads these arrays as constants, while the
    differentiable leaves (mass / inertia / gains / joint anchors) are
    tensors carried in ``SimParams`` (see integrator.py).
    """

    def __init__(self, b: ModelBuilder):
        self.n_links = b.body_count
        self.joint_type = np.asarray(b.joint_type, np.int32)
        self.joint_parent = np.asarray(b.joint_parent, np.int32)
        self.joint_axis = np.asarray(np.stack(b.joint_axis, 0), np.float32)
        self.joint_X_p = np.asarray(np.stack(b.joint_X_p, 0), np.float32)
        self.joint_X_c = np.asarray(np.stack(b.joint_X_c, 0), np.float32)
        self.joint_q_start = np.asarray(b.joint_q_start, np.int32)
        self.joint_qd_start = np.asarray(b.joint_qd_start, np.int32)
        self.joint_q_init = np.asarray(b.joint_q, np.float32)

        self.n_q = len(b.joint_q)
        self.n_qd = len(b.joint_target_ke)
        self.n_dof = self.n_qd - 6  # actuated dofs (root free joint has 6)

        self.joint_target_ke = np.asarray(b.joint_target_ke, np.float32)
        self.joint_target_kd = np.asarray(b.joint_target_kd, np.float32)
        self.joint_limit_lower = np.asarray(b.joint_limit_lower, np.float32)
        self.joint_limit_upper = np.asarray(b.joint_limit_upper, np.float32)
        self.joint_limit_ke = np.asarray(b.joint_limit_ke, np.float32)
        self.joint_limit_kd = np.asarray(b.joint_limit_kd, np.float32)
        self.joint_armature = np.asarray(b.joint_armature, np.float32)

        self.body_mass = np.asarray(b.body_mass, np.float32)
        self.body_com = np.asarray(np.stack(b.body_com, 0), np.float32)
        self.body_inertia = np.asarray(np.stack(b.body_inertia, 0), np.float32)
        self.body_name = list(b.body_name)

        self.shapes = b.shapes
        self.gravity = np.array([0.0, -9.81, 0.0], np.float32)
        self.ground = True
        self.joint_attach_ke = 1600.0
        self.joint_attach_kd = 20.0

        # filled by make_ground_contacts()
        self.contact_body: Optional[np.ndarray] = None
        self.contact_point: Optional[np.ndarray] = None
        self.contact_dist: Optional[np.ndarray] = None
        self.contact_material: Optional[np.ndarray] = None
        self.contact_mode: Optional[str] = None
        self._interior_body: Optional[np.ndarray] = None
        self._interior_point: Optional[np.ndarray] = None

    @property
    def contact_count(self) -> int:
        return 0 if self.contact_body is None else len(self.contact_body)

    def make_ground_contacts(self, mode: str = "all"):
        """Generate static ground-contact candidate points from collision
        shapes, mirroring wp.sim.Model.collide (called once per env build in
        the reference, dp_model.py:401):
        sphere -> center point with dist=radius; capsule -> both axis ends
        with dist=radius; box -> 8 corners; mesh -> every vertex.
        Points are in body-local coordinates.

        mode:
          'all'        every mesh vertex (reference-exact)
          'hull'       convex-hull vertices only — for shallow ground
                       penetration only hull vertices can touch the plane,
                       so the contact set is equivalent at a fraction of
                       the cost (laikago: 3848 -> 1454 candidates)
          'hull:<eps>' hull vertices voxel-clustered at <eps> meters
                       (further decimation; slightly coarser force
                       discretization)
        """
        eps = None
        if mode.startswith("hull:"):
            eps = float(mode.split(":")[1])
            mode = "hull"

        body, point, dist, mat = [], [], [], []
        int_body, int_point = [], []  # interior vertices excluded by 'hull'
        for s in self.shapes:
            X_p, X_q = s.xform[0:3], s.xform[3:7]

            def _add(p_local_shape, d):
                p_body = X_p + _quat_rotate_np(X_q, np.asarray(p_local_shape, np.float64))
                body.append(s.body)
                point.append(p_body)
                dist.append(d)
                mat.append(s.material)

            if s.geo_type == GEO_SPHERE:
                _add(np.zeros(3), s.scale[0])
            elif s.geo_type == GEO_CAPSULE:
                r, h = s.scale[0], s.scale[1]
                _add(np.array([h, 0.0, 0.0]), r)
                _add(np.array([-h, 0.0, 0.0]), r)
            elif s.geo_type == GEO_BOX:
                hx, hy, hz = s.scale
                for sx in (-1, 1):
                    for sy in (-1, 1):
                        for sz in (-1, 1):
                            _add(np.array([sx * hx, sy * hy, sz * hz]), 0.0)
            elif s.geo_type == GEO_MESH:
                verts = s.mesh.vertices * s.scale[None]
                if mode == "hull" and len(verts) > 8:
                    from scipy.spatial import ConvexHull

                    hull_idx = ConvexHull(verts).vertices
                    interior = np.setdiff1d(np.arange(len(verts)), hull_idx)
                    # keep the excluded vertices for runtime validation:
                    # hull contacts are exact only while no interior vertex
                    # crosses the ground plane (see validate_hull_contacts)
                    for v in verts[interior]:
                        p_body = X_p + _quat_rotate_np(X_q, np.asarray(v, np.float64))
                        int_body.append(s.body)
                        int_point.append(p_body)
                    verts = verts[hull_idx]
                    if eps is not None:
                        # voxel-cluster: one representative (mean) per cell
                        keys = np.floor(verts / eps).astype(np.int64)
                        _, inv = np.unique(keys, axis=0, return_inverse=True)
                        reps = np.zeros((inv.max() + 1, 3))
                        cnt = np.zeros(inv.max() + 1)
                        np.add.at(reps, inv, verts)
                        np.add.at(cnt, inv, 1.0)
                        verts = reps / cnt[:, None]
                for v in verts:
                    _add(v, 0.0)

        self.contact_body = np.asarray(body, np.int32)
        self.contact_point = np.asarray(np.stack(point, 0), np.float32)
        self.contact_dist = np.asarray(dist, np.float32)
        self.contact_material = np.asarray(np.stack(mat, 0), np.float32)
        self.contact_mode = mode
        if int_body:
            self._interior_body = np.asarray(int_body, np.int32)
            self._interior_point = np.stack(int_point, 0).astype(np.float32)
        else:
            self._interior_body = None
            self._interior_point = None
        return self

    def validate_hull_contacts(self, body_q, margin=0.0):
        """Worst ground violation of the interior vertices 'hull' mode
        dropped, over a trajectory (host numpy; cheap).

        Hull contacts are exact while only hull vertices penetrate the
        plane: any interior vertex is a convex combination of hull vertices
        and so is never the *lowest* point, but once one crosses the plane
        it would have contributed contact force in 'all' mode. This check
        makes the equivalence assumption observable at runtime.

        body_q: (..., B, 7) trajectory states (numpy or device array).
        Returns max(0, -(min interior-vertex height) - margin); 0.0 when
        the hull assumption held (or mode is 'all' / primitive shapes only).
        """
        if self._interior_body is None:
            return 0.0
        q = np.asarray(body_q, np.float32)
        flat = q.reshape(-1, q.shape[-2], q.shape[-1])
        pts = self._interior_point
        bq = flat[:, self._interior_body]  # (N, V, 7)
        world = bq[..., 0:3] + _quat_rotate_np(bq[..., 3:7], pts[None])
        min_h = float(world[..., 1].min())
        return max(0.0, -min_h - margin)

    def collision_mesh(self, scale_override=None) -> tuple:
        """Concatenated per-body collision meshes in body-local coords.

        Returns (verts (V,3), faces (F,3), body_index_per_vertex (V,)) for
        visualization / foot-height queries (replaces trimesh-based
        articulate_robot_rbrt_batch, reference urdf_utils.py:154-201).
        """
        verts, faces, vbody, base = [], [], [], 0
        for s in self.shapes:
            if s.geo_type == GEO_MESH:
                m = TriMesh(s.mesh.vertices * s.scale[None], s.mesh.faces)
            elif s.geo_type == GEO_BOX:
                m = box_mesh(*s.scale)
            elif s.geo_type == GEO_SPHERE:
                m = sphere_mesh(s.scale[0])
            else:
                m = capsule_mesh(s.scale[0], s.scale[1])
            R = _quat_to_matrix_np(s.xform[3:7])
            v = m.vertices @ R.T + s.xform[0:3][None]
            verts.append(v)
            faces.append(m.faces + base)
            vbody.append(np.full(len(v), s.body, np.int32))
            base += len(v)
        return (
            np.concatenate(verts, 0).astype(np.float32),
            np.concatenate(faces, 0).astype(np.int32),
            np.concatenate(vbody, 0),
        )
