"""Self-contained URDF parser (host-side, numpy + ElementTree).

Replaces the urdfpy dependency of the reference (diffphys/import_urdf.py,
diffphys/robot.py) with a minimal parser covering everything the three
robot templates (laikago / quad / human) and the PPR pipeline use:
links with inertial + collision/visual geometry (box, sphere, cylinder,
mesh), joints with origin/axis/limit/dynamics, and forward kinematics for
mesh articulation (stand-in for urdfpy's link_fk / collision_trimesh_fk).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .mesh import TriMesh, load_mesh


def _parse_origin(elem) -> np.ndarray:
    """<origin xyz rpy> -> 4x4 matrix."""
    xyz = np.zeros(3)
    rpy = np.zeros(3)
    if elem is not None:
        if elem.get("xyz"):
            xyz = np.fromstring(elem.get("xyz"), sep=" ")
        if elem.get("rpy"):
            rpy = np.fromstring(elem.get("rpy"), sep=" ")
    mat = np.eye(4)
    mat[:3, :3] = rpy_to_matrix(rpy)
    mat[:3, 3] = xyz
    return mat


def rpy_to_matrix(rpy) -> np.ndarray:
    """URDF fixed-axis convention: R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def matrix_to_xyz_rpy(mat: np.ndarray) -> np.ndarray:
    """4x4 -> [x,y,z,roll,pitch,yaw] (inverse of the above, ZYX Euler)."""
    xyz = mat[:3, 3]
    R = mat[:3, :3]
    pitch = np.arcsin(np.clip(-R[2, 0], -1.0, 1.0))
    if abs(np.cos(pitch)) > 1e-8:
        roll = np.arctan2(R[2, 1], R[2, 2])
        yaw = np.arctan2(R[1, 0], R[0, 0])
    else:
        roll = np.arctan2(-R[1, 2], R[1, 1])
        yaw = 0.0
    return np.concatenate([xyz, [roll, pitch, yaw]])


@dataclass
class Geometry:
    box: Optional[np.ndarray] = None  # full size (3,)
    sphere: Optional[float] = None  # radius
    cylinder: Optional[tuple] = None  # (radius, length)
    mesh_path: Optional[str] = None
    mesh_scale: np.ndarray = field(default_factory=lambda: np.ones(3))
    _mesh_cache: Optional[TriMesh] = None

    @property
    def mesh(self) -> Optional[TriMesh]:
        if self.mesh_path is None:
            return None
        if self._mesh_cache is None:
            m = load_mesh(self.mesh_path)
            m.vertices = m.vertices * self.mesh_scale[None]
            self._mesh_cache = m
        return self._mesh_cache


@dataclass
class GeomInstance:
    origin: np.ndarray  # 4x4
    geometry: Geometry


@dataclass
class Inertial:
    origin: np.ndarray
    mass: float
    inertia: np.ndarray  # 3x3


@dataclass
class Link:
    name: str
    inertial: Optional[Inertial]
    collisions: List[GeomInstance]
    visuals: List[GeomInstance]


@dataclass
class JointLimit:
    lower: Optional[float]
    upper: Optional[float]
    effort: Optional[float]
    velocity: Optional[float]


@dataclass
class Joint:
    name: str
    joint_type: str  # revolute/continuous/prismatic/fixed/floating
    parent: str
    child: str
    origin: np.ndarray  # 4x4
    axis: np.ndarray  # (3,)
    limit: Optional[JointLimit]
    damping: Optional[float]


class URDF:
    """Parsed URDF robot description."""

    def __init__(self, name, links: List[Link], joints: List[Joint], path: str):
        self.name = name
        self.path = path
        self.links = links
        self.joints = joints
        self.link_map: Dict[str, Link] = {l.name: l for l in links}
        self.joint_map: Dict[str, Joint] = {j.name: j for j in joints}
        self._child_joint: Dict[str, Joint] = {j.child: j for j in joints}
        # attributes filled by RobotMeta (mirrors reference robot.py monkey-patching)
        self.robot_name = None
        self.ball_joint = False

    @staticmethod
    def load(path: str) -> "URDF":
        tree = ET.parse(path)
        root = tree.getroot()
        urdf_dir = os.path.dirname(os.path.abspath(path))

        links = []
        for le in root.findall("link"):
            inertial = None
            ie = le.find("inertial")
            if ie is not None:
                mass_e = ie.find("mass")
                mass = float(mass_e.get("value")) if mass_e is not None else 0.0
                inertia = np.zeros((3, 3))
                ine = ie.find("inertia")
                if ine is not None:
                    ixx = float(ine.get("ixx", 0))
                    iyy = float(ine.get("iyy", 0))
                    izz = float(ine.get("izz", 0))
                    ixy = float(ine.get("ixy", 0))
                    ixz = float(ine.get("ixz", 0))
                    iyz = float(ine.get("iyz", 0))
                    inertia = np.array(
                        [[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]]
                    )
                inertial = Inertial(_parse_origin(ie.find("origin")), mass, inertia)

            def _parse_geoms(tag):
                out = []
                for ge in le.findall(tag):
                    geom_e = ge.find("geometry")
                    if geom_e is None:
                        continue
                    geo = Geometry()
                    be = geom_e.find("box")
                    se = geom_e.find("sphere")
                    ce = geom_e.find("cylinder")
                    me = geom_e.find("mesh")
                    if be is not None:
                        geo.box = np.fromstring(be.get("size"), sep=" ")
                    elif se is not None:
                        geo.sphere = float(se.get("radius"))
                    elif ce is not None:
                        geo.cylinder = (
                            float(ce.get("radius")),
                            float(ce.get("length")),
                        )
                    elif me is not None:
                        fn = me.get("filename")
                        fn = fn.replace("package://", "")
                        geo.mesh_path = os.path.join(urdf_dir, fn)
                        if me.get("scale"):
                            geo.mesh_scale = np.fromstring(me.get("scale"), sep=" ")
                    else:
                        continue
                    out.append(GeomInstance(_parse_origin(ge.find("origin")), geo))
                return out

            links.append(
                Link(le.get("name"), inertial, _parse_geoms("collision"), _parse_geoms("visual"))
            )

        joints = []
        for je in root.findall("joint"):
            axis = np.array([1.0, 0.0, 0.0])
            ae = je.find("axis")
            if ae is not None and ae.get("xyz"):
                axis = np.fromstring(ae.get("xyz"), sep=" ")
            limit = None
            lim_e = je.find("limit")
            if lim_e is not None:
                limit = JointLimit(
                    float(lim_e.get("lower")) if lim_e.get("lower") else None,
                    float(lim_e.get("upper")) if lim_e.get("upper") else None,
                    float(lim_e.get("effort")) if lim_e.get("effort") else None,
                    float(lim_e.get("velocity")) if lim_e.get("velocity") else None,
                )
            damping = None
            dyn_e = je.find("dynamics")
            if dyn_e is not None and dyn_e.get("damping"):
                damping = float(dyn_e.get("damping"))
            joints.append(
                Joint(
                    name=je.get("name"),
                    joint_type=je.get("type"),
                    parent=je.find("parent").get("link"),
                    child=je.find("child").get("link"),
                    origin=_parse_origin(je.find("origin")),
                    axis=axis,
                    limit=limit,
                    damping=damping,
                )
            )
        return URDF(root.get("name"), links, joints, path)

    # -- kinematics helpers (stand-ins for urdfpy.link_fk etc.) -------------

    @property
    def base_link(self) -> Link:
        children = {j.child for j in self.joints}
        for l in self.links:
            if l.name not in children:
                return l
        return self.links[0]

    def link_fk(self, cfg: Optional[Dict[str, float]] = None) -> Dict[str, np.ndarray]:
        """Forward kinematics of all links in document order; cfg maps joint
        name -> angle (revolute) / displacement (prismatic)."""
        cfg = cfg or {}
        poses = {self.base_link.name: np.eye(4)}
        # iterate until fixed point (templates are topologically ordered,
        # so one pass suffices; loop defensively anyway)
        remaining = list(self.joints)
        while remaining:
            progressed = False
            still = []
            for j in remaining:
                if j.parent in poses:
                    local = j.origin.copy()
                    q = cfg.get(j.name, 0.0)
                    if j.joint_type in ("revolute", "continuous"):
                        ax = j.axis / max(np.linalg.norm(j.axis), 1e-9)
                        c, s = np.cos(q), np.sin(q)
                        K = np.array(
                            [[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]]
                        )
                        Rj = np.eye(3) + s * K + (1 - c) * K @ K
                        rot = np.eye(4)
                        rot[:3, :3] = Rj
                        local = local @ rot
                    elif j.joint_type == "prismatic":
                        ax = j.axis / max(np.linalg.norm(j.axis), 1e-9)
                        tr = np.eye(4)
                        tr[:3, 3] = ax * q
                        local = local @ tr
                    poses[j.child] = poses[j.parent] @ local
                    progressed = True
                else:
                    still.append(j)
            if not progressed:
                raise ValueError("URDF kinematic graph is not a rooted tree")
            remaining = still
        return poses

    def collision_mesh_fk(self, cfg=None):
        """List of (TriMesh, link_pose@collision_origin) over all collision
        geometries in link document order (mirrors urdfpy collision fk used by
        reference urdf_utils.py:142-151)."""
        poses = self.link_fk(cfg)
        out = []
        for link in self.links:
            for col in link.collisions:
                m = geom_to_mesh(col.geometry)
                if m is not None:
                    out.append((m, poses[link.name] @ col.origin))
        return out

    def visual_mesh_fk(self, cfg=None):
        """Same for visual geometries (urdfpy visual_trimesh_fk)."""
        poses = self.link_fk(cfg)
        out = []
        for link in self.links:
            for vis in link.visuals:
                m = geom_to_mesh(vis.geometry)
                if m is not None:
                    out.append((m, poses[link.name] @ vis.origin))
        return out


def geom_to_mesh(geo: Geometry) -> Optional[TriMesh]:
    from .mesh import box_mesh, sphere_mesh, capsule_mesh

    if geo.mesh_path is not None:
        return geo.mesh
    if geo.box is not None:
        return box_mesh(*(geo.box * 0.5))
    if geo.sphere is not None:
        return sphere_mesh(geo.sphere)
    if geo.cylinder is not None:
        r, l = geo.cylinder
        # URDF cylinders are z-aligned; capsule_mesh is x-aligned -> rotate
        cm = capsule_mesh(r, l * 0.5)
        v = cm.vertices
        cm.vertices = np.stack([v[:, 2], v[:, 1], -v[:, 0]], -1)
        return cm
    return None
