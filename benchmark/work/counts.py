"""The yardstick's counts of work: frozen copies of the port's hand counts
(``sim/soa.py:window_work``, ``sim/soa_grad.py:interval_work``) and the
time-MLPs' matrix-product operations, computed from a cell's shapes, and
the H100's published peaks. Each share of a roofline or of the peak counts
the same work whatever implements it; a change of these counts is a change
of the benchmark.

Units: an FMA counts 2 operations; sqrt, division, sin and cos 1 each (a
lower bound on their cost); bytes are each input read once and each output
written once, in fp32.
"""

from __future__ import annotations

import torch

# NVIDIA's data sheet, H100 SXM at its 700 W power limit: HBM3 bandwidth and
# fp32 outside the tensor cores. The configurations run fp32 with TF32 off
# (the stiff attach springs fail at lower precision), so every share of a
# peak is of the fp32 peak; a change of matmul precision needs a benchmark
# change of this peak.
BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# the model's joint_type codes
JOINT_REVOLUTE, JOINT_FIXED, JOINT_COMPOUND = 1, 3, 4


def bound_s(n_bytes, n_ops) -> float:
    """The least time the card could take: the larger of bytes over the
    bandwidth and operations over the fp32 peak."""
    return max(n_bytes / BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def window_work(model, E: int, substeps: int, n_frames: int) -> dict:
    """K1 (the serving window) at E envs, F frames of ``substeps``
    substeps: shared parameter planes, no acts."""
    B, C, n_qd = model.n_links, model.contact_count, model.n_qd
    jt = model.joint_type
    S = substeps * (n_frames - 1) + 1
    f4 = 4
    bytes_in = (13 * B * E + S * n_qd * E) * f4 + (
        2 * 3 * B + B + 2 * 9 * B) * f4 + (B * (5 + 32) + C * 9) * f4
    bytes_out = n_frames * (7 + 6 + 6 + 6) * B * E * f4
    # per unit: contact 128; joint frame 170; FIXED +76, REVOLUTE +133,
    # COMPOUND +430; scatter 36; integrate 287
    common, scatter, integ = 170, 36, 287
    per_joint = {JOINT_FIXED: common + 76 + scatter,
                 JOINT_REVOLUTE: common + 133 + scatter,
                 JOINT_COMPOUND: common + 430 + scatter}
    joints = sum(per_joint.get(int(t), 0) for t in jt)
    per_substep = 128 * C + joints + integ * B
    ops = E * (S * per_substep - integ * B)
    return dict(bytes=bytes_in + bytes_out, ops=ops, per_env_substep=per_substep)


def interval_work(model, E: int, substeps: int, n_active_contacts: float = 0.0,
                  xp_lanes: int = 0) -> dict:
    """K2 (``fwd_*``, with its per-substep state export) and K3 with its env
    reduction (``bwd_*``) on one interval of ``substeps`` at E envs, shared
    planes, no acts or residual forces; ``xp_lanes`` 0 (no anchor planes),
    1 (shared) or E (per env). K3 does 296 more operations per penetrating
    (env, substep, contact): the trace does not say how many there are, so
    the benchmark counts none (``n_active_contacts`` 0) and K3's share is
    a floor."""
    B, C, n_qd = model.n_links, model.contact_count, model.n_qd
    S = int(substeps)
    f4 = 4
    per = window_work(model, E, S, 2)["per_env_substep"]
    integ = 287
    planes_b = (25 * B + 10 * B * xp_lanes) * f4
    rows = 35 if xp_lanes else 25
    consts_b = (B * (5 + 32) + C * 9) * f4
    fwd_bytes = (13 * B * E + S * n_qd * E) * f4 + planes_b + consts_b + (
        13 * B * E + S * 13 * B * E) * f4
    fwd_ops = E * S * per
    per_joint = {JOINT_FIXED: 632 + 185, JOINT_REVOLUTE: 632 + 363,
                 JOINT_COMPOUND: 632 + 1360}
    joints = sum(per_joint.get(int(t), 0) for t in model.joint_type)
    bwd_ops = E * S * (per - integ * B + 809 * B + joints + 67 * C) \
        + 296 * n_active_contacts + rows * B * E
    bwd_bytes = (S * 13 * B * E + S * n_qd * E + 13 * B * E) * f4 + planes_b + consts_b + (
        13 * B * E + S * n_qd * E + rows * B * E) * f4 + (rows * B * E + rows * B) * f4
    return dict(fwd_bytes=fwd_bytes, fwd_ops=fwd_ops, bwd_bytes=bwd_bytes, bwd_ops=bwd_ops)


def linear_shapes(module) -> list:
    """(in, out) of every ``nn.Linear`` of a module, in order."""
    return [(m.in_features, m.out_features) for m in module.modules()
            if isinstance(m, torch.nn.Linear)]


def mlp_ops(module, rows: int, backward: bool) -> float:
    """Matrix-product operations of ``rows`` rows through a time-MLP or a
    camera MLP: 2*in*out a row forward; backward the weight gradient of
    every layer and the input gradient of every layer but the first (the
    time encoding needs none)."""
    shapes = linear_shapes(module)
    fwd = sum(2 * i * o for i, o in shapes)
    if not backward:
        return float(rows) * fwd
    first = 2 * shapes[0][0] * shapes[0][1]
    return float(rows) * (3 * fwd - first)
