"""Visualization and logging (reference diffphys/vis.py and urdf_utils mesh
articulation), counterpart of ``ppr_diffphys_tpu/utils/vis.py``, on the
port's own mesh types (no trimesh/pyrender).

``PhysVisualizer.show`` renders per-round videos of the target, sim and
control-reference trajectories with the software rasterizer of
``utils.render`` and exports trajectory-strip OBJs; ``write_log`` logs
scalars to tensorboard. Everything here is host numpy: ``query()`` already
returns numpy. cv2 (mp4) and tensorboard are imported where used, and
``PhysVisualizer`` checks up front that the ones it will need are installed;
the plasma colors of the mass and value streams are matplotlib's table,
carried in ``utils.colors``.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

from ..sim.builder import ArticulationModel
from ..sim.mesh import TriMesh, box_mesh, concatenate_meshes
from .colors import plasma

# packages a PhysVisualizer needs: tensorboard for write_log, cv2 to write mp4s
LOG_PACKAGES = ("tensorboard",)
VIDEO_PACKAGES = ("cv2",)


def missing_packages(names):
    """The names among ``names`` that cannot be imported here."""
    return [n for n in names if importlib.util.find_spec(n) is None]


def _quat_to_mat(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def articulate_robot_rbrt(
    model: ArticulationModel, body_q: np.ndarray,
    gforce=None, com=None, mass=None,
):
    """Pose the robot's collision mesh by maximal-coordinate body states
    (reference urdf_utils.py:204-278). Returns (TriMesh, colors (V,3)).

    gforce: (B, 6) warp layout, arrows drawn for |force| > 10.
    com: (3,) green marker. mass: (B,) plasma colormap per link.
    """
    verts, faces, vbody = model.collision_mesh()
    B = model.n_links
    out_v = verts.copy()
    for b in range(B):
        sel = vbody == b
        R = _quat_to_mat(body_q[b, 3:7])
        out_v[sel] = verts[sel] @ R.T + body_q[b, :3][None]

    colors = np.full((len(out_v), 3), 192, np.uint8)
    if mass is not None:
        for b in range(B):
            c = plasma(float(mass[b]) / float(np.max(mass)))
            colors[vbody == b] = (np.asarray(c[:3]) * 255).astype(np.uint8)

    meshes = [TriMesh(out_v.astype(np.float64), faces)]
    color_list = [colors]

    if gforce is not None:
        for b in range(B):
            force = np.asarray(gforce[b, 3:6])
            mag = np.linalg.norm(force)
            if mag > 10:
                orn = force / mag
                center = out_v[vbody == b].mean(0)
                arrow = _arrow_mesh(mag, center, orn)
                meshes.append(arrow)
                color_list.append(
                    np.tile([255, 0, 0], (len(arrow.vertices), 1)).astype(np.uint8))
    if com is not None:
        arrow = _arrow_mesh(60.0, np.asarray(com), np.array([0.0, -1.0, 0.0]))
        meshes.append(arrow)
        color_list.append(np.tile([0, 255, 0], (len(arrow.vertices), 1)).astype(np.uint8))

    return concatenate_meshes(meshes), np.concatenate(color_list, 0)


def _cone_mesh(radius, height, n=10):
    """Cone along +z with its base at z=0 (role of trimesh.creation.cone)."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang), np.zeros(n)], -1)
    verts = np.concatenate([ring, [[0, 0, height]], [[0, 0, 0]]], 0)
    apex, base = n, n + 1
    faces = []
    for i in range(n):
        faces.append([i, (i + 1) % n, apex])
        faces.append([(i + 1) % n, i, base])
    return TriMesh(verts, np.asarray(faces, np.int32))


def _arrow_mesh(mag, origin, direction):
    """Force arrow: box shaft + cone tip (reference urdf_utils.py:281-290)."""
    mag = np.clip(mag / 200.0, 0.0, 1.0)
    shaft = box_mesh(0.025, 0.025, 0.5 * mag)
    cone = _cone_mesh(0.05, 0.1)
    cone.vertices[:, 2] += 0.5 * mag
    arrow = concatenate_meshes([shaft, cone])
    v = arrow.vertices.copy()
    v[:, 2] += 0.5 * mag
    # orient +z onto direction
    z = direction / max(np.linalg.norm(direction), 1e-9)
    o1 = np.cross(z, [0.0, 0.0, 1.0])
    if np.linalg.norm(o1) < 1e-6:
        o1 = np.cross(z, [0.0, 1.0, 0.0])
    o1 /= np.linalg.norm(o1)
    o2 = np.cross(z, o1)
    R = np.stack([-o2, o1, z], axis=1)
    return TriMesh(v @ R.T + origin[None], arrow.faces)


def articulate_robot(urdf, cfg=None, use_collision=False):
    """FK-posed whole-robot mesh from joint angles (reference
    urdf_utils.py:293-317). cfg: dict joint-name -> angle, or a flat angle
    array in non-fixed-joint document order."""
    if cfg is not None and not isinstance(cfg, dict):
        names = [j.name for j in urdf.joints if j.joint_type != "fixed"]
        cfg = {n: float(a) for n, a in zip(names, np.asarray(cfg).ravel())}
    fk = urdf.collision_mesh_fk(cfg) if use_collision else urdf.visual_mesh_fk(cfg)
    return concatenate_meshes([m.transformed(p[:3, :3], p[:3, 3]) for m, p in fk])


def render_robot(urdf, save_path, cfg=None, use_collision=False, size=256):
    """Offscreen render of the robot in a given configuration (reference
    urdf_utils.py:320-366) through the software rasterizer, saved as an
    image with cv2."""
    import cv2

    from .render import SoftwareRenderer

    mesh = articulate_robot(urdf, cfg=cfg, use_collision=use_collision)
    colors = np.full((len(mesh.vertices), 3), 192, np.uint8)
    r = SoftwareRenderer(size, size)
    center = mesh.vertices.mean(0)
    extent = max(np.abs(mesh.vertices - center).max(), 1e-3)
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [0, 0, 3.0 * extent]
    m[:3, 3] -= m[:3, :3] @ center
    r.set_camera(m)
    img = r.render(mesh.vertices, mesh.faces, colors)
    cv2.imwrite(save_path, img[..., ::-1])
    return img, mesh


def create_floor_mesh(scale=20.0):
    """Reference lab4d_utils.py:548-565."""
    v = np.array([[-0.5, 0, -0.5], [0.5, 0, -0.5], [0.5, 0, 0.5], [-0.5, 0, 0.5]]) * scale
    f = np.array([[0, 2, 1], [2, 0, 3]], np.int32)
    inner = TriMesh(v / 4 + np.array([0, 0.01, 0]), f.copy())
    floor = concatenate_meshes([TriMesh(v, f), inner])
    colors = np.concatenate(
        [np.tile([10, 255, 102], (4, 1)), np.tile([10, 102, 255], (4, 1))]
    ).astype(np.uint8)
    return floor, colors


def export_obj(path, mesh: TriMesh, colors=None):
    with open(path, "w") as f:
        if colors is None:
            for v in mesh.vertices:
                f.write("v %.5f %.5f %.5f\n" % tuple(v))
        else:
            for v, c in zip(mesh.vertices, colors / 255.0):
                f.write("v %.5f %.5f %.5f %.3f %.3f %.3f\n" % (tuple(v) + tuple(c)))
        for tri in mesh.faces + 1:
            f.write("f %d %d %d\n" % tuple(tri))


class PhysVisualizer:
    """Reference-compatible surface (vis.py:37-215): tensorboard scalars
    (``write_log``), per-round videos and OBJ strips (``show``).

    ``render_video`` says whether ``show`` will be asked for videos: the
    package that needs (cv2) is checked here with tensorboard, so a missing
    one fails now, by name, and not halfway through a training round."""

    def __init__(self, save_dir, render_video=True):
        missing = missing_packages(LOG_PACKAGES + (VIDEO_PACKAGES if render_video else ()))
        if missing:
            raise ImportError(
                "PhysVisualizer needs the package(s) %s, which are not installed "
                "(tensorboard for the logs, cv2 to write videos)"
                % ", ".join(missing))
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        from torch.utils.tensorboard import SummaryWriter

        self.log = SummaryWriter(self.save_dir)
        self.floor, self.floor_colors = create_floor_mesh()

    def write_log(self, log_data, step):
        for k, v in log_data.items():
            self.log.add_scalar(k, float(v), step)

    def close(self):
        self.log.close()

    def show(self, tag, data, fps=10, view_mode="ref", render_video=True):
        """Render the target/sim/control_ref videos and export the trajectory
        OBJ strips (reference vis.py:44-200)."""
        if isinstance(tag, int):
            tag = "%05d" % tag

        model = data["model"]
        n_frm = len(data["sim_traj"])
        self.visualize_trajectory(model, data["sim_traj"], "sim_traj-" + tag,
                                  max_w=data["max_w"])
        if "distilled_traj" in data:
            self.visualize_trajectory(model, data["distilled_traj"], "distilled_traj-" + tag,
                                      max_w=data["max_w"])
        if not render_video:
            return

        from .io import save_vid
        from .render import SoftwareRenderer

        if "img_size" in data:
            isz = data["img_size"]
            img_size = (int(isz[0] * isz[2]), int(isz[1] * isz[2]))
            scale = isz[2]
        else:
            img_size = (256, 256)
            scale = 1.0
        renderer = SoftwareRenderer(*img_size)
        # world-fixed top-down light, y-up world (reference vis.py:77)
        renderer.set_light_topdown(gl=True)
        cameras = data.get("camera")  # (F, 4, 4) rt rows 0-2, intrinsics row 3
        streams = {"target": [], "sim": [], "control_ref": []}
        if "distilled_traj" in data:
            streams["distilled"] = []
        _, _, vbody = model.collision_mesh()

        for frame in range(n_frm):
            if cameras is not None:
                rtk = np.asarray(cameras[frame])
                m = np.eye(4, dtype=np.float32)
                m[:3] = rtk[:3]
                renderer.set_camera(m)
                renderer.set_intrinsics(rtk[3] * scale)
            target_mesh, tc = articulate_robot_rbrt(model, data["target_traj"][frame])
            sim_mesh, sc = articulate_robot_rbrt(
                model, data["sim_traj"][frame],
                gforce=data.get("grf", [None] * n_frm)[frame],
                com=data.get("com", [None] * n_frm)[frame],
                mass=data.get("body_mass"),
            )
            ref_mesh, rc = articulate_robot_rbrt(model, data["control_ref"][frame])

            keep = cameras is not None
            tdim = np.full_like(tc, 64)
            streams["target"].append(self._render(renderer, [(target_mesh, tc)], keep))
            streams["sim"].append(
                self._render(renderer, [(sim_mesh, sc), (target_mesh, tdim)], keep))
            streams["control_ref"].append(
                self._render(renderer, [(ref_mesh, rc), (target_mesh, tdim)], keep))
            if "distilled_traj" in data:
                dmesh, dc = articulate_robot_rbrt(model, data["distilled_traj"][frame])
                streams["distilled"].append(
                    self._render(renderer, [(dmesh, dc), (target_mesh, tdim)], keep))
            # optional value-colored streams (reference vis.py:136-162: per-body
            # error / velocity / acceleration magnitudes)
            for key, vmax in (("err", 0.1), ("as", 2.0), ("vs", 0.5)):
                if key in data:
                    val = np.asarray(data[key][frame])
                    mesh_v, _ = articulate_robot_rbrt(model, data["sim_traj"][frame])
                    v01 = np.clip(val, -vmax, vmax) / vmax / 2 + 0.5
                    colors_v = (np.asarray(plasma(v01[vbody]))[:, :3] * 255).astype(np.uint8)
                    streams.setdefault(key, []).append(
                        self._render(renderer, [(mesh_v, colors_v)], keep))

        streams["all"] = [np.concatenate([s[i] for s in streams.values()], axis=1)
                          for i in range(n_frm)]
        for key, frames in streams.items():
            save_vid("%s/%s-%s" % (self.save_dir, key, tag), frames, suffix=".mp4", fps=fps)

    def _render(self, renderer, mesh_color_pairs, keep_camera=False):
        mesh = concatenate_meshes([m for m, _ in mesh_color_pairs] + [self.floor])
        cols = np.concatenate([c for _, c in mesh_color_pairs] + [self.floor_colors], 0)
        if not keep_camera:
            renderer.set_camera_default()
        return renderer.render(mesh.vertices, mesh.faces, cols)

    def visualize_trajectory(self, model, trajs, tag, max_w=2.0):
        """OBJ strip of ~10 poses (reference vis.py:184-200)."""
        skip = max(len(trajs) // 10, 1)
        trajs = trajs[::skip]
        fl, flc = create_floor_mesh()
        flv = fl.vertices * (len(trajs) / max(fl.vertices[:, 0].max(), 1e-6) / 2 * 1.2 * max_w)
        meshes, colors = [TriMesh(flv, fl.faces)], [flc]
        for idx, bq in enumerate(trajs):
            m, c = articulate_robot_rbrt(model, bq)
            v = m.vertices.copy()
            v[:, 0] -= v[:, 0].mean()
            v[:, 0] += max_w * (idx - (len(trajs) - 1) / 2)
            meshes.append(TriMesh(v, m.faces))
            colors.append(c)
        export_obj("%s/%s.obj" % (self.save_dir, tag), concatenate_meshes(meshes),
                   np.concatenate(colors, 0))
