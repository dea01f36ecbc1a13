"""Robot template metadata (mirrors reference diffphys/robot.py).

Holds the per-template constants the pipeline needs: sim3 alignment,
rest angles, DoF counts (x3 for ball-joint robots), foot links
(``kp_links``), query links, unique-body collapse index and the symmetry
index. Built on our own URDF parser instead of urdfpy.
"""

from __future__ import annotations

import numpy as np

from ..sim.urdf import URDF


def get_joints(urdf: URDF):
    """Physical joint origins wrt parent link + name->index maps.

    Mirrors reference urdf_utils.py:71-110 (including its enumeration
    convention: ``idx`` counts all joints, the ball-joint modulo-3 picks
    the ``_R``/``_Y`` members of each chain triplet).
    """
    ball_joint = urdf.ball_joint
    name2joints_idx = {}
    name2query_idx = {}
    joints = []
    angle_names = []
    counter = 0
    for idx, joint in enumerate(urdf.joints):
        if joint.joint_type == "fixed":
            continue
        angle_names.append(joint.name)
        if ball_joint and idx % 3 != 2:
            continue
        name2query_idx[joint.name] = counter
        counter += 1
    counter = 0
    for idx, joint in enumerate(urdf.joints):
        if joint.joint_type == "fixed":
            continue
        if ball_joint and idx % 3 != 0:
            continue
        name2joints_idx[joint.name] = counter
        joints.append(joint.origin[:3, 3])
        counter += 1

    joints = np.stack(joints, 0)
    urdf.name2joints_idx = name2joints_idx
    urdf.name2query_idx = name2query_idx
    urdf.angle_names = angle_names
    return joints


def robot2parent_idx(urdf: URDF):
    """Parent index per physical joint (+1 offset, root = -1).

    Re-derivation of reference urdf_utils.py:20-68 without urdfpy
    internals: for each physical joint, walk up the link chain to the
    nearest ancestor physical joint.
    """
    physical = list(urdf.name2joints_idx.keys())
    phys_set = set(physical)
    child_joint = {j.child: j for j in urdf.joints}

    parent_idx = [-1] + [0] * len(physical)
    for jname in physical:
        joint = urdf.joint_map[jname]
        jidx = urdf.name2joints_idx[jname]
        # walk up from the parent link
        link = joint.parent
        while link in child_joint:
            up = child_joint[link]
            if up.name in phys_set:
                parent_idx[jidx + 1] = urdf.name2joints_idx[up.name] + 1
                break
            link = up.parent
    return parent_idx


class URDFRobot:
    """Per-template robot metadata (reference robot.py:9-137)."""

    def __init__(self, urdf_path: str):
        self.urdf = URDF.load(urdf_path)
        robot_name = urdf_path.split("/")[-1][:-5]
        self.urdf.robot_name = robot_name
        self.urdf.ball_joint = robot_name in ("human", "quad")

        joints = get_joints(self.urdf)
        self.urdf.parent_idx = robot2parent_idx(self.urdf)

        if robot_name == "a1":
            sim3 = np.array([0, 0, 0, 0.5, -0.5, -0.5, -0.5, -1.61, -1.61, -1.61])
            self.num_dofs = joints.shape[0]
            rest_angles = np.zeros((1, joints.shape[0]))
            rest_angles[0, [2, 5, 8, 11]] = -0.8
        elif robot_name == "laikago":
            sim3 = np.array([0, 0, 0, 1, 0, 0, 0, -1.61, -1.61, -1.61])
            self.num_dofs = joints.shape[0]
            rest_angles = np.zeros((1, joints.shape[0]))
            rest_angles[0, [2, 5, 8, 11]] = -0.8
        elif robot_name in ("laikago_toes_zup_joint_order", "laikago_mod"):
            sim3 = np.array([0, 0, 0, 0.5, -0.5, -0.5, -0.5, -1.61, -1.61, -1.61])
            self.num_dofs = joints.shape[0]
            rest_angles = np.zeros((1, joints.shape[0]))
            rest_angles[0, [2, 5, 8, 11]] = -0.8
        elif robot_name == "quad":
            sim3 = np.array([0, 0.01, -0.04, 0.5, 0.6, 0, 0, -3.1, -3.1, -3.1])
            self.num_dofs = joints.shape[0] * 3
            rest_angles = np.zeros((1, self.num_dofs))
            self.urdf.kp_links = [
                "link_155_Vorderpfote_R_Y",
                "link_150_Vorderpfote_L_Y",
                "link_170_Pfote2_R_Y",
                "link_165_Pfote2_L_Y",
            ]
            self.urdf.query_links = list(self.urdf.kp_links)
        elif robot_name == "human":
            sim3 = np.array([0, 0, 0, 1, 0, 0, 0, -3.2, -3.2, -3.2])
            self.num_dofs = joints.shape[0] * 3
            rest_angles = np.zeros((1, self.num_dofs))
            self.urdf.kp_links = [
                "link_24_mixamorig:RightFoot_Y",
                "link_19_mixamorig:LeftFoot_Y",
            ]
            self.urdf.query_links = [
                "link_24_mixamorig:RightFoot_Y",
                "link_19_mixamorig:LeftFoot_Y",
                "link_16_mixamorig:RightHand_Y",
                "link_12_mixamorig:LeftHand_Y",
            ]
        else:
            raise NotImplementedError(robot_name)

        self.sim3 = sim3[:8]
        self.joints = joints
        self.rest_angles = rest_angles.astype(np.float32)
        self.num_bones = len(self.joints) + 1

        unique_body_idx = list(range(len(self.urdf.links)))
        if self.urdf.ball_joint:
            unique_body_idx = unique_body_idx[0:1] + unique_body_idx[3::3]
        self.urdf.unique_body_idx = unique_body_idx

        if robot_name in ("a1", "laikago"):
            symm_idx = [3, 4, 5, 0, 1, 2, 9, 10, 11, 6, 7, 8]
        elif robot_name == "quad":
            symm_idx = [0, 1, 2, 3, 8, 9, 10, 11, 4, 5, 6, 7, 12, 13, 14, 15,
                        16, 21, 22, 23, 24, 17, 18, 19, 20]
        elif robot_name == "human":
            symm_idx = [0, 1, 2, 3, 8, 9, 10, 11, 4, 5, 6, 7, 15, 16, 17, 12, 13, 14]
        else:
            symm_idx = list(range(self.num_dofs))
        self.urdf.symm_idx = symm_idx
