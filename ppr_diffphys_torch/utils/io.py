"""Video / keypoint IO (reference diffphys/io.py), counterpart of
``ppr_diffphys_tpu/utils/io.py``. mp4 through cv2's ``VideoWriter`` (no
ffmpeg binary needed), gif through imageio; both imported where used."""

from __future__ import annotations

import numpy as np


def resize_to_nearest_multiple(image, multiple=16):
    import cv2

    h, w = image.shape[:2]
    nh = int(np.ceil(h / multiple) * multiple)
    nw = int(np.ceil(w / multiple) * multiple)
    return cv2.resize(image, (nw, nh))


def save_vid(outpath, frames, suffix=".mp4", upsample_frame=0, fps=10, target_size=None):
    """Save frames to ``outpath + suffix`` (reference io.py:33-78)."""
    import cv2

    if upsample_frame < 1:
        upsample_frame = len(frames)
    out = []
    for i in range(int(upsample_frame)):
        fid = int(i / upsample_frame * len(frames))
        frame = frames[fid]
        if frame.max() <= 1:
            frame = frame * 255
        frame = frame.astype(np.uint8)
        if target_size is not None:
            frame = cv2.resize(frame, target_size[::-1])
        if suffix == ".gif":
            h, w = frame.shape[:2]
            fxy = np.sqrt(4e4 / (h * w))
            frame = cv2.resize(frame, None, fx=fxy, fy=fxy)
        out.append(resize_to_nearest_multiple(frame))

    path = "%s%s" % (outpath, suffix)
    if suffix == ".mp4":
        h, w = out[0].shape[:2]
        vw = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), max(float(fps), 1.0), (w, h)
        )
        for frame in out:
            vw.write(frame[..., ::-1])  # RGB -> BGR
        vw.release()
    else:
        import imageio

        imageio.mimsave(path, out, fps=fps)


def vis_kps(kps, path, binary_labels=None):
    """Export keypoints (nframe, 3+, nkps) as a colored point OBJ
    (reference io.py:10-23)."""
    from ..sim.mesh import TriMesh
    from .colors import label_colormap
    from .vis import export_obj

    nframe, _, nkps = kps.shape
    colormap = label_colormap()[:nkps]
    colormap = np.tile(colormap[None], (nframe, 1, 1))
    if binary_labels is not None:
        colormap = colormap * binary_labels[..., None]
    colormap = colormap.reshape((-1, 3))
    pts = np.transpose(kps[:, :3], (0, 2, 1)).reshape((-1, 3))
    export_obj(path, TriMesh(pts, np.zeros((0, 3), np.int32)), colormap)
