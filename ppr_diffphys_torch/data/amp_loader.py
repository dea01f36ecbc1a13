"""AMP mocap data layer (mirrors reference diffphys/dataloader.py +
the bullet->GL conversion from diffphys/dp_utils.py:141-156).

The 85-dim AMP frame layout (reference dataloader.py:21-31):
pos[0:3], orn[3:7] (quat xyzw), jang[7:19], vel[31:34], avel[34:37],
jvel[37:49], kp[61:73], kp_vel[73:85].

Numpy copy of ``ppr_diffphys_tpu/data/amp_loader.py``. Instead of scipy
interp1d on the host per batch (reference dp_model.py:421-427), the whole
frame table is a device tensor and interpolation runs on the device (see
models/phys_model.py).
"""

from __future__ import annotations

import json
import os

import numpy as np


class DataLoader:
    """Loads data/motion_sequences/<seq>/amp-<seq>.txt (reference
    dataloader.py:9-18)."""

    def __init__(self, opts, cap=-1):
        datadir = os.path.join(opts.get("datadir", "./data/motion_sequences"), opts["seqname"])
        with open(os.path.join(datadir, "amp-%s.txt" % opts["seqname"]), "r") as f:
            info = json.load(f)
        self.frame_interval = info["FrameDuration"]
        self.amp_info = np.asarray(info["Frames"], np.float64)
        self.data_info = {"offset": np.asarray([0, len(self.amp_info)])}


def parse_amp(amp_info: np.ndarray) -> dict:
    """Slice the 85-dim AMP rows (reference dataloader.py:21-31)."""
    msm = {}
    msm["pos"] = amp_info[..., 0:3]
    msm["orn"] = amp_info[..., 3:7]
    msm["vel"] = amp_info[..., 31:34]
    msm["avel"] = amp_info[..., 34:37]
    msm["jang"] = amp_info[..., 7:19]
    msm["jvel"] = amp_info[..., 37:49]
    msm["kp"] = amp_info[..., 61:73]
    msm["kp_vel"] = amp_info[..., 73:85]
    return msm


ISSAC_TO_GL = np.asarray([[0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float64)


def bullet2gl(msm: dict, in_bullet: bool) -> dict:
    """Axis-permute mocap quantities from Isaac/bullet convention to the
    GL (y-up) frame used by the simulator (reference dp_utils.py:141-156).
    Mutates and returns msm.
    """
    P = ISSAC_TO_GL
    ndim = msm["pos"].ndim - 1
    Pb = P.reshape(ndim * (1,) + (3, 3))
    msm["pos"] = (Pb @ msm["pos"][..., None])[..., 0]
    if in_bullet:
        from scipy.spatial.transform import Rotation as R

        shape = msm["orn"].shape[:-1]
        orn = R.from_quat(msm["orn"].reshape((-1, 4))).as_matrix()
        msm["orn"] = R.from_matrix(orn @ P[None]).as_quat().reshape(shape + (4,))
    # P is a rotation (det=1) permutation, so permuting the quat imaginary
    # part rotates the orientation consistently
    msm["orn"] = np.concatenate(
        [(Pb @ msm["orn"][..., :3, None])[..., 0], msm["orn"][..., 3:]], -1
    )
    msm["vel"] = (Pb @ msm["vel"][..., None])[..., 0]
    msm["avel"] = (Pb @ msm["avel"][..., None])[..., 0]
    return msm


def preprocess_sequence(dataloader, in_bullet: bool) -> np.ndarray:
    """One-time host-side conversion of the whole sequence to GL coords,
    returned as an (T, 85) array ready to move to the device. Per-batch
    slicing + linear interpolation then run on the device."""
    amp = dataloader.amp_info.copy()
    msm = parse_amp(amp)
    bullet2gl(msm, in_bullet)
    out = amp.copy()
    out[..., 0:3] = msm["pos"]
    out[..., 3:7] = msm["orn"]
    out[..., 31:34] = msm["vel"]
    out[..., 34:37] = msm["avel"]
    return out.astype(np.float32)
