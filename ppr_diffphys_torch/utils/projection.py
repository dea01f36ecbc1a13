"""2D reprojection utilities (reference diffphys/dp_utils.py:184-243),
counterpart of ``ppr_diffphys_tpu/utils/projection.py``: ``parse_rtk``
splits the packed [R|t ; intrinsics] 4x4, ``project_bodies`` projects
maximal body positions into the image (both on torch tensors),
``plot_curves`` draws the trajectories with OpenCV (numpy).
"""

from __future__ import annotations

import numpy as np
import torch


def parse_rtk(rtk):
    """rtk (..., 4, 4): rows 0-2 = [R|t], row 3 = fx, fy, px, py.
    Returns (rtmat (...,4,4), kmat (...,3,3))."""
    rtk = torch.as_tensor(rtk)
    rtmat = torch.zeros_like(rtk)
    rtmat[..., :3, :] = rtk[..., :3, :]
    rtmat[..., 3, 3] = 1.0
    kmat = torch.zeros(rtk.shape[:-2] + (3, 3), dtype=rtk.dtype, device=rtk.device)
    kmat[..., 0, 0] = rtk[..., 3, 0]
    kmat[..., 1, 1] = rtk[..., 3, 1]
    kmat[..., 0, 2] = rtk[..., 3, 2]
    kmat[..., 1, 2] = rtk[..., 3, 3]
    kmat[..., 2, 2] = 1.0
    return rtmat, kmat


def project_bodies(bodies, rtk):
    """bodies (..., K, 7) maximal body states; rtk (..., 4, 4).
    Returns pixel coordinates (..., K, 2)."""
    point = torch.as_tensor(bodies)[..., :3]
    rtmat, kmat = parse_rtk(rtk)
    rtmat = rtmat[..., None, :, :]
    kmat = kmat[..., None, :, :]
    point = torch.cat([point, torch.ones_like(point[..., :1])], -1)
    point = rtmat @ point[..., None]
    point = kmat @ point[..., :3, :]
    return point[..., :2, 0] / point[..., 2:3, 0]


def plot_curves(pts1, pts2):
    """Draw two (bs, T, K, 2) pixel trajectories (reference :217-226)."""
    img_size = int(max(pts1.max(), pts2.max())) + 1
    img = 255 * np.ones((pts1.shape[0], img_size, img_size, 3), np.uint8)
    plot_curve(img, pts1, (255, 0, 0))
    plot_curve(img, pts2, (0, 255, 0))
    return img


def plot_curve(img, pts, color=(0, 0, 255)):
    import cv2

    pts = np.asarray(pts).astype(np.int32)
    for i in range(pts.shape[0]):
        for j in range(pts.shape[1]):
            for k in range(pts.shape[2]):
                pt1 = tuple(pts[i, j, k])
                cv2.circle(img[i], pt1, 2, color, -1)
                if j + 1 < pts.shape[1]:
                    pt2 = tuple(pts[i, j + 1, k])
                    cv2.circle(img[i], pt2, 2, color, -1)
                    cv2.line(img[i], pt1, pt2, color, 1)
