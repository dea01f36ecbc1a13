"""URDF -> ModelBuilder importer.

Re-implements the behavior of the reference's vendored Warp importer
(diffphys/import_urdf.py:106-291) on top of our own URDF parser:

- floating base (free joint) with initial pose from ``xform``;
- revolute/continuous -> revolute, prismatic, fixed, floating joints;
- the repo's ball-joint convention: a URDF joint named ``*_R`` starts a
  chain of three revolute joints (``_R``/``_P``/``_Y``) that collapse into a
  single 3-dof COMPOUND joint whose child is the ``*_Y`` link; ``_P``/``_Y``
  joints are skipped (reference import_urdf.py:192-196);
- density-based mass override (density>0 ignores URDF inertials,
  reference import_urdf.py:129-141, 221-228);
- joint limits and damping pulled from the URDF where present
  (reference import_urdf.py:209-219 — including the reference's sticky
  ``damping`` local-variable behavior, which is irrelevant in practice
  because phys_model overwrites all PD gains after import);
- collision shapes: box, sphere, cylinder->capsule (x-aligned), mesh
  (reference import_urdf.py:23-103).
"""

from __future__ import annotations

import numpy as np

from .builder import (
    JOINT_COMPOUND,
    JOINT_FIXED,
    JOINT_FREE,
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    ModelBuilder,
)
from .urdf import URDF, matrix_to_xyz_rpy, Geometry


def _quat_rpy_np(r, p, y):
    def aa(axis, ang):
        axis = np.asarray(axis, np.float64)
        q = np.zeros(4)
        q[0:3] = axis * np.sin(ang / 2)
        q[3] = np.cos(ang / 2)
        return q

    def mul(a, b):
        ax, ay, az, aw = a
        bx, by, bz, bw = b
        return np.array(
            [
                aw * bx + ax * bw + ay * bz - az * by,
                aw * by - ax * bz + ay * bw + az * bx,
                aw * bz + ax * by - ay * bx + az * bw,
                aw * bw - ax * bx - ay * by - az * bz,
            ]
        )

    return mul(aa([0, 0, 1], y), mul(aa([0, 1, 0], p), aa([1, 0, 0], r)))


def _add_collisions(builder, link_idx, collisions, density, shape_ke, shape_kd, shape_kf, shape_mu):
    """Mirror of reference urdf_add_collision (import_urdf.py:23-103)."""
    for col in collisions:
        origin = matrix_to_xyz_rpy(col.origin)
        pos = origin[0:3]
        rot = _quat_rpy_np(*origin[3:6])
        geo: Geometry = col.geometry

        if geo.box is not None:
            builder.add_shape_box(
                body=link_idx, pos=pos, rot=rot,
                hx=geo.box[0] * 0.5, hy=geo.box[1] * 0.5, hz=geo.box[2] * 0.5,
                density=density, ke=shape_ke, kd=shape_kd, kf=shape_kf, mu=shape_mu,
            )
        if geo.sphere is not None:
            builder.add_shape_sphere(
                body=link_idx, pos=pos, rot=rot, radius=geo.sphere,
                density=density, ke=shape_ke, kd=shape_kd, kf=shape_kf, mu=shape_mu,
            )
        if geo.cylinder is not None:
            # URDF cylinders are z-aligned; our capsules are x-aligned
            r90 = _quat_rpy_np(0.0, np.pi * 0.5, 0.0)
            rot_c = _quat_mul_np(rot, r90)
            builder.add_shape_capsule(
                body=link_idx, pos=pos, rot=rot_c,
                radius=geo.cylinder[0], half_width=geo.cylinder[1] * 0.5,
                density=density, ke=shape_ke, kd=shape_kd, kf=shape_kf, mu=shape_mu,
            )
        if geo.mesh_path is not None:
            builder.add_shape_mesh(
                body=link_idx, pos=pos, rot=rot, mesh=geo.mesh,
                density=density, ke=shape_ke, kd=shape_kd, kf=shape_kf, mu=shape_mu,
            )


def _quat_mul_np(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ]
    )


def parse_urdf(
    filename_or_urdf,
    builder: ModelBuilder,
    xform_p=(0.0, 0.0, 0.0),
    xform_q=(0.0, 0.0, 0.0, 1.0),
    floating: bool = False,
    density: float = 0.0,
    stiffness: float = 100.0,
    damping: float = 10.0,
    armature: float = 0.0,
    shape_ke: float = 1e4,
    shape_kd: float = 1e3,
    shape_kf: float = 1e2,
    shape_mu: float = 0.25,
    limit_ke: float = 100.0,
    limit_kd: float = 10.0,
):
    robot = (
        filename_or_urdf
        if isinstance(filename_or_urdf, URDF)
        else URDF.load(filename_or_urdf)
    )

    link_index = {}

    # base inertial (density==0 -> use URDF inertial; else zeros, geometry
    # shapes will fill in — reference import_urdf.py:129-141)
    base = robot.links[0]
    if density == 0.0 and base.inertial is not None:
        com = matrix_to_xyz_rpy(base.inertial.origin)[0:3]
        I_m = base.inertial.inertia
        m = base.inertial.mass
    else:
        com, I_m, m = np.zeros(3), np.zeros((3, 3)), 0.0

    if floating:
        root = builder.add_body(
            parent=-1,
            joint_type=JOINT_FREE,
            joint_armature=armature,
            com=com,
            I_m=I_m,
            m=m,
            name=base.name,
        )
        start = builder.joint_q_start[root]
        builder.joint_q[start + 0 : start + 3] = list(np.asarray(xform_p, np.float64))
        builder.joint_q[start + 3 : start + 7] = list(np.asarray(xform_q, np.float64))
        _add_collisions(
            builder, root, base.collisions, density, shape_ke, shape_kd, shape_kf, shape_mu
        )
    else:
        xf = np.concatenate([np.asarray(xform_p), np.asarray(xform_q)])
        root = builder.add_body(
            parent=-1, joint_type=JOINT_FIXED, joint_xform=xf, name=base.name
        )
        _add_collisions(
            builder, root, base.collisions, 0.0, shape_ke, shape_kd, shape_kf, shape_mu
        )

    link_index[base.name] = root

    for joint in robot.joints:
        jtype = None
        axis = np.zeros(3)
        child_name = joint.child

        if joint.joint_type in ("revolute", "continuous"):
            jtype = JOINT_REVOLUTE
            axis = joint.axis
        if joint.joint_type == "prismatic":
            jtype = JOINT_PRISMATIC
            axis = joint.axis
        if joint.joint_type == "fixed":
            jtype = JOINT_FIXED
        if joint.joint_type == "floating":
            jtype = JOINT_FREE
        # ball-joint collapse (reference import_urdf.py:192-196)
        if joint.name[-2:] == "_R":
            jtype = JOINT_COMPOUND
            child_name = joint.child[:-2] + "_Y"
        elif joint.name[-2:] in ("_P", "_Y"):
            continue
        if jtype is None:
            continue

        parent = link_index.get(joint.parent, root)

        origin = matrix_to_xyz_rpy(joint.origin)
        pos = origin[0:3]
        rot = _quat_rpy_np(*origin[3:6])

        lower, upper = -1e3, 1e3
        if joint.limit is not None:
            if joint.limit.lower is not None:
                lower = joint.limit.lower
            if joint.limit.upper is not None:
                upper = joint.limit.upper
        if joint.damping is not None:
            damping = joint.damping  # sticky, as in the reference

        child_link = robot.link_map[child_name]
        if density == 0.0 and child_link.inertial is not None:
            com = matrix_to_xyz_rpy(child_link.inertial.origin)[0:3]
            I_m = child_link.inertial.inertia
            m = child_link.inertial.mass
        else:
            com, I_m, m = np.zeros(3), np.zeros((3, 3)), 0.0

        if jtype == JOINT_COMPOUND:
            # the reference builds the child-frame quaternion from the three
            # axis columns [x,y,z] — an identity matrix, hence an identity
            # child transform (import_urdf.py:230-265); keep it explicit
            # because the compound force/FK math is expressed relative to it
            xf_child = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
            link = builder.add_body(
                parent=parent,
                joint_xform=np.concatenate([pos, rot]),
                joint_xform_child=xf_child,
                joint_type=jtype,
                joint_limit_lower=[lower] * 3,
                joint_limit_upper=[upper] * 3,
                joint_limit_ke=limit_ke,
                joint_limit_kd=limit_kd,
                joint_target_ke=[stiffness] * 3,
                joint_target_kd=[damping] * 3,
                joint_armature=armature,
                name=child_name,
            )
        else:
            link = builder.add_body(
                parent=parent,
                joint_xform=np.concatenate([pos, rot]),
                joint_axis=axis,
                joint_type=jtype,
                joint_limit_lower=lower,
                joint_limit_upper=upper,
                joint_limit_ke=limit_ke,
                joint_limit_kd=limit_kd,
                joint_target_ke=stiffness,
                joint_target_kd=damping,
                joint_armature=armature,
                com=com,
                I_m=I_m,
                m=m,
                name=child_name,
            )

        _add_collisions(
            builder, link, child_link.collisions, density,
            shape_ke, shape_kd, shape_kf, shape_mu,
        )
        link_index[child_name] = link

    return builder
