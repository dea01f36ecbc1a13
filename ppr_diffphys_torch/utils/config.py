"""Config / flag utilities (mirrors the reference's absl-flags-to-dict
pattern + schedule helpers from lab4d_utils).

Copy of ``ppr_diffphys_tpu/utils/config.py`` with the same keys and
defaults, so one ``opts`` dict drives both packages, except ``datadir``
and ``urdf_dir``: they default to the reference repository's relative
``data/`` layout instead of the JAX package's absolute checkout paths.
Callers in this repository pass in-repo paths explicitly. The engine/tile
keys select JAX engines and are ignored by the port.

The whole pipeline is driven by a plain ``opts`` dict with the same key
names as the reference (main.py:15-47), so lab4d-side code and run scripts
carry over unchanged. Loss weights resolve by the ``<name>_wt`` naming
convention (reference dp_model.py:821-824).
"""

from __future__ import annotations

import numpy as np


DEFAULT_OPTS = dict(
    # distributed (vestigial in the reference; here they select the mesh)
    local_rank=0,
    ngpu=-1,  # -1 = every rank of the world; envs dp-shard over the mesh
    accu_steps=1,
    seqname="mi-pace",
    logroot="logdir/",
    logname="dynamics",
    phys_learning_rate=1e-4,
    num_rounds=5,
    warmup_iters=0,
    urdf_template="laikago",
    num_freq=10,
    t_embed_dim=128,
    iters_per_round=20,
    ratio_phys_cycle=1.0,
    noise_std=2e-3,
    traj_wt=0.01,
    pos_state_wt=0.01,
    vel_state_wt=1e-4,
    pos_distill_wt=0.0,
    reg_torque_wt=0.0,
    reg_res_f_wt=0.0,
    reg_foot_wt=0.0,
    reg_root_wt=0.0,
    datadir="data/motion_sequences",  # the reference repository's layout
    urdf_dir="data/urdf_templates",
    # TPU-specific
    num_envs=10,
    frames_per_wdw=24,
    mesh_shape=None,  # {"dp": 4, "tp": 2} or "dp=4,tp=2"; None = auto dp
    phys_engine="auto",  # soa | xla | auto (soa on TPU)
    eval_engine="auto",  # auto (XLA scan — measured fastest on both
    #                      first and steady eval walls, round-4/5
    #                      eval_bench.jsonl) | xla | soa (force eval to
    #                      ride the padded training soa kernels)
    contact_mode="hull",  # hull | all | hull:<margin>
    soa_e_tile=0,  # 0 = auto: largest single-kernel tile (pick_e_tile)
    soa_ksub=0,  # substeps per pallas call; 0 = auto VMEM plan
    soa_with_res=False,
    soa_with_act=False,
    rollout_unroll=4,
    ckpt_backend="pickle",
    hull_fallback_margin=3e-3,
    contact_fallback=True,
)


def build_opts(**overrides) -> dict:
    opts = dict(DEFAULT_OPTS)
    opts.update(overrides)
    return opts


def interp_wt(x, y, x2, type="linear"):
    """Schedule interpolation (reference lab4d_utils.py:622-671)."""
    x0, x1 = x
    y0, y1 = y
    if type == "linear":
        y2 = y0 + (x2 - x0) * (y1 - y0) / (x1 - x0)
    elif type == "log":
        log_y0, log_y1 = np.log10(y0), np.log10(y1)
        y2 = 10 ** (log_y0 + (x2 - x0) * (log_y1 - log_y0) / (x1 - x0))
    elif type == "exp":
        assert x0 >= 1 and x1 >= 1
        x2 = np.clip(x2, x0, x1)
        lx0, lx1, lx2 = np.log10(x0), np.log10(x1), np.log10(x2)
        y2 = y0 + (lx2 - lx0) * (y1 - y0) / (lx1 - lx0)
    else:
        raise ValueError(type)
    return float(np.clip(y2, np.min(y), np.max(y)))


def match_param_name(name, param_lr, type):
    """Name-based LR routing (reference lab4d_utils.py:587-619)."""
    matched = [
        (k, lr)
        for k, lr in param_lr.items()
        if (k in name if type == "with" else name.startswith(k))
    ]
    if len(matched) == 0:
        return False, 0.0
    if len(matched) == 1:
        return True, matched[0][1]
    raise ValueError("multiple matches found", [m[0] for m in matched])
