"""Loss functions (PyTorch), counterpart of
``ppr_diffphys_tpu/models/losses.py`` (reference diffphys/dp_utils.py).

The reference's in-place masking and per-env Python loop (reduce_loss
clipping, dp_utils.py:93-110) are masked tensor math with the JAX package's
semantics, including ``jnp.nanmedian``'s averaging of the two middle values
(``torch.nanmedian`` would return the lower one).
"""

from __future__ import annotations

import torch

from ..ops import axis_angle_to_quat, quat_normalize, quat_to_matrix, rot_angle, transform_point


def se3_loss(pred: torch.Tensor, gt: torch.Tensor, rot_ratio: float = 0.1) -> torch.Tensor:
    """Translation L2 + rot_ratio * geodesic rotation angle, NaN-masked
    (reference dp_utils.py:113-138). Accepts (...,7) quat-xyzw or (...,6)
    axis-angle rotations."""
    nanid = torch.isnan(pred.sum(-1)) | torch.isnan(gt.sum(-1))
    pred = torch.nan_to_num(pred)
    gt = torch.nan_to_num(gt)
    trn_loss = torch.sum((pred[..., :3] - gt[..., :3]) ** 2, -1)
    if pred.shape[-1] == 6:
        r_pred = quat_to_matrix(axis_angle_to_quat(pred[..., 3:]))
        r_gt = quat_to_matrix(axis_angle_to_quat(gt[..., 3:]))
    else:
        r_pred = quat_to_matrix(quat_normalize(pred[..., 3:]))
        r_gt = quat_to_matrix(quat_normalize(gt[..., 3:]))
    rot_loss = rot_angle(r_pred @ r_gt.transpose(-1, -2))
    loss = trn_loss + rot_loss * rot_ratio
    return torch.where(nanid, torch.zeros_like(loss), loss)


def _nanmedian_mean_middle(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis ignoring NaNs, averaging the two middle
    values of an even count (``jnp.nanmedian``); NaN for an all-NaN row."""
    n = (~torch.isnan(x)).sum(-1)
    srt = torch.sort(torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x), -1).values
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = 0.5 * (srt.gather(-1, lo[..., None])[..., 0] + srt.gather(-1, hi[..., None])[..., 0])
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def reduce_loss(loss_seq: torch.Tensor, clip: bool = False, env0_th: bool = False) -> torch.Tensor:
    """Masked mean over positive entries, with optional per-env divergence
    clipping: once a frame's loss exceeds 10x the env's median positive
    loss, that env's loss is zeroed from that frame on (reference
    dp_utils.py:93-110). ``env0_th`` reproduces the reference's sticky
    threshold (the first env with a nonzero median gates every env).

    loss_seq: (E, T)"""
    if clip:
        pos = loss_seq > 0
        with torch.no_grad():  # the threshold only feeds comparisons
            med = _nanmedian_mean_middle(
                torch.where(pos, loss_seq, torch.full_like(loss_seq, float("nan"))))
            th = torch.nan_to_num(med) * 10.0
            if env0_th:
                th = th[torch.argmax((th > 0).to(torch.int32))].expand(th.shape)
        exceed = loss_seq > th[:, None]
        any_exceed = exceed.any(1, keepdim=True)
        first = torch.argmax(exceed.to(torch.int32), 1)[:, None]
        idx = torch.arange(loss_seq.shape[1], device=loss_seq.device)[None]
        keep = ~any_exceed | (idx < first)
        loss_seq = torch.where(keep, loss_seq, torch.zeros_like(loss_seq))
    pos = (loss_seq > 0).to(loss_seq.dtype)
    n_pos = pos.sum()
    mean_pos = (loss_seq * pos).sum() / torch.clamp(n_pos, min=1.0)
    return torch.where(n_pos > 0, mean_pos, loss_seq.mean())


def compute_com(body_q: torch.Tensor, part_com: torch.Tensor, part_mass: torch.Tensor):
    """Whole-robot center of mass from maximal body states
    (reference dp_utils.py:86-90). body_q (..., B, 7), part_com (B, 3),
    part_mass (B,) -> (..., 3)"""
    coms = transform_point(body_q, part_com)
    w = part_mass / part_mass.sum()
    return (coms * w[..., None]).sum(-2)
