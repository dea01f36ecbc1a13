"""Render the trajectory OBJ strips a training run exported (one per round,
``PhysVisualizer.visualize_trajectory``) into one mp4, counterpart of the
repository's ``render_intermediate.py``:

    python -m ppr_diffphys_torch.render_intermediate --testdir logdir/mi-pace-run0/ \\
        --data_class sim

writes ``<testdir>/<data_class>_traj.mp4``.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--testdir", default="logdir/mi-pace-dynamics/", help="log dir")
    p.add_argument("--data_class", default="sim", help="sim or distilled")
    p.add_argument("--image_size", type=int, default=512, help="rendered image size")
    p.add_argument("--fps", type=float, default=10.0, help="output frame rate")
    return p.parse_args(argv)


def load_obj_with_colors(path):
    """(verts, faces, colors uint8) of an OBJ with optional per-vertex colors."""
    verts, colors, faces = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:
                    colors.append([float(x) * 255 for x in parts[4:7]])
            elif line.startswith("f "):
                faces.append([int(t.split("/")[0]) - 1 for t in line.split()[1:4]])
    verts = np.asarray(verts)
    faces = np.asarray(faces, np.int32)
    colors = (np.asarray(colors, np.uint8) if colors
              else np.full((len(verts), 3), 192, np.uint8))
    return verts, faces, colors


def render_strips(paths, image_size):
    """One frame per OBJ strip, looked at from the front and above."""
    from scipy.spatial.transform import Rotation as R

    from .utils.render import SoftwareRenderer

    renderer = SoftwareRenderer(image_size, image_size)
    frames = []
    for path in paths:
        verts, faces, colors = load_obj_with_colors(path)
        center = verts.mean(0)
        extent = max(np.abs(verts - center).max(), 1e-3)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = R.from_rotvec([np.pi / 6, 0, 0]).as_matrix() @ np.diag([1.0, -1.0, -1.0])
        m[:3, 3] = [0, 0, 2.5 * extent]
        m[:3, 3] -= m[:3, :3] @ center
        renderer.set_camera(m)
        frames.append(renderer.render(verts, faces, colors))
        print("rendered", os.path.basename(path))
    return frames


def main(argv=None):
    from .utils.io import save_vid

    opts = parse_args(argv)
    pattern = os.path.join(opts.testdir, "%s_traj-*.obj" % opts.data_class)
    paths = sorted(glob.glob(pattern))
    if not paths:
        print("no files matching", pattern)
        return None
    frames = render_strips(paths, opts.image_size)
    out = os.path.join(opts.testdir, "%s_traj" % opts.data_class)
    save_vid(out, frames, suffix=".mp4", fps=opts.fps)
    print("saved %s.mp4" % out)
    return out + ".mp4"


if __name__ == "__main__":
    main()
