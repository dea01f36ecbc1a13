"""The lab4d coupling (``phys_interface``) on the a1 robot, built on either
side from a configuration and a run's seed.

The inputs, made once per run by the benchmark on the device: two synthetic
videos' worth of lab4d field stand-ins (an object field with its
articulation, a scene field, per-frame intrinsics), their MLPs drawn from
the seed and both camera fields fitted to one camera 3 m from the robot,
panning +-0.3 rad (the fit of ``chip_smoke.py``'s lab4d phase, here with
the reference's frozen ``fit_camera_mlp``), so that the object and scene
views cancel and a1 stands upright; then the interface's own time-MLPs
drawn from the seed. Each side builds its interface from copies of those
inputs, walks the scene scale until the feet cross the ground
(``correct_scale``) and trains at the traffic's envs and frames.
"""

from __future__ import annotations

import numpy as np
import torch

from ..work import counts
from . import common


def modules(side):
    if side == "program":
        from ppr_diffphys_torch.data.robot import URDFRobot
        from ppr_diffphys_torch.models import fields
        from ppr_diffphys_torch.models.interface import phys_interface
        from ppr_diffphys_torch.utils.config import build_opts
    else:
        from ..reference.data.robot import URDFRobot
        from ..reference.models import fields
        from ..reference.models.interface import phys_interface
        from ..reference.utils.config import build_opts
    return URDFRobot, fields, phys_interface, build_opts


def offsets(config):
    v = config["videos"]
    return [i * int(v["frames"]) for i in range(int(v["count"]) + 1)]


def specs(side, config):
    URDFRobot, fields, _, _ = modules(side)
    off = offsets(config)
    g = torch.Generator().manual_seed(0)  # the specs' own draws, replaced below
    robot = URDFRobot(common.checkout_path(config["robot"]["urdf"]))
    obj = fields.ObjectField(off, robot, g)
    scn = fields.CameraField(off, g, name="scene_field")
    intr = fields.IntrinsicsField(off)
    return obj, scn, intr


def camera_priors(config):
    """One camera 3 m from the robot, panning +-0.3 rad over each video."""
    n, per = offsets(config)[-1], int(config["videos"]["frames"])
    pan = 0.3 * np.sin(np.arange(n) * 2 * np.pi / per)
    rt = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    rt[:, 0, 0], rt[:, 0, 2], rt[:, 2, 0], rt[:, 2, 2] = (np.cos(pan), np.sin(pan),
                                                          -np.sin(pan), np.cos(pan))
    rt[:, 2, 3] = 3.0
    return rt


def to_device(tree, device):
    return {k: to_device(v, device) if isinstance(v, dict)
            else torch.as_tensor(v, dtype=torch.float32).to(device).clone()
            for k, v in tree.items()}


def make_inputs(run, device) -> dict:
    """The fields' parameter trees, drawn and fitted on the device."""
    cfg = run.config
    obj, scn, intr = specs("reference", cfg)
    trees = {"object_field": to_device(obj.init_params, device),
             "scene_field": to_device(scn.init_params, device),
             "intrinsics": to_device(intr.init_params, device)}
    named = []
    for path in ("object_field.camera_mlp", "scene_field.camera_mlp",
                 "object_field.articulation.mlp"):
        tree = trees
        for k in path.split("."):
            tree = tree[k]
        named += [(path + "." + k, t) for k, t in tree.items()]
    groups = [[p] for p in ("object_field.camera_mlp", "scene_field.camera_mlp",
                            "object_field.articulation.mlp")]
    common.seed_weights(named, groups, common.sub_seed(run.seed, "field_weights"), device)
    rt = camera_priors(cfg)
    for spec, key in ((obj, "object_field"), (scn, "scene_field")):
        trees[key] = spec.fit_to_priors(trees[key], rt, max_iters=int(cfg["camera_fit_steps"]))
    h, w = cfg["image_size"]
    ks = trees["intrinsics"]["ks"]
    ks[:, 2], ks[:, 3] = w / 2, h / 2  # the principal point at the frame's centre
    art = trees["object_field"]["articulation"]
    art["orient"] = torch.tensor(cfg["articulation"]["orient_wxyz"], device=device)
    art["shift"] = torch.tensor(cfg["articulation"]["shift"], device=device)
    return trees


def inputs(run, device) -> dict:
    return make_inputs(run, device)


def build(side, run, device, inputs):
    """A training interface at the traffic's envs and frames, from copies
    of ``inputs`` (``make_inputs``)."""
    cfg = run.config
    _, _, phys_interface, build_opts = modules(side)
    obj, scn, intr = specs(side, cfg)
    opts = common.opts_from(cfg, build_opts, logname="bench-" + side)
    model_dict = dict(scene_field=(scn, to_device(inputs["scene_field"], device)),
                      object_field=(obj, to_device(inputs["object_field"], device)),
                      intrinsics=(intr, to_device(inputs["intrinsics"], device)),
                      frame_interval=1.0 / float(cfg["videos"]["fps"]), frame_info=None)
    tm = phys_interface(opts, model_dict, device=device)
    tm.robot.urdf.kp_links = list(cfg["robot"]["kp_links"])
    if tm.steps_per_fr_interval != int(cfg["substeps_per_frame"]):
        raise ValueError("%d substeps a frame, the configuration %d"
                         % (tm.steps_per_fr_interval, cfg["substeps_per_frame"]))
    common.check_widths({k: tm.modules[k] for k in tm.modules}, cfg)
    common.check_widths({"camera_mlp": obj.camera_mlp, "articulation": obj.articulation_spec.mlp},
                        cfg)
    common.seed_weights(tm.named_tensors(), cfg["weights"], common.sub_seed(run.seed, "weights"),
                        device)
    tm.override_control_ref_states()
    tm.correct_scale(np.arange(int(cfg["scale_frames"])), max_steps=int(cfg["scale_steps"]))
    tm.reinit_envs(int(run.traffic["num_envs"]), int(run.traffic["frames_per_wdw"]),
                   is_eval=False)
    tm.generator.manual_seed(common.sub_seed(run.seed, "noise"))
    return tm


def draw_starts(rng, model, E, F):
    """Window starts over every video: a video drawn for each env, then a
    start uniform (not rounded) over its frames, so that no two envs share
    a window."""
    off = np.asarray(model.frame_offset_raw, np.float64)
    vid = rng.integers(0, len(off) - 1, size=E)
    span = off[vid + 1] - off[vid] - F
    return (off[vid] + rng.random(E) * span).astype(np.float32)


def train_work(run) -> dict:
    """Counted work of one step: at E x S rows the target's two camera MLPs
    and articulation MLP, the proxy's two camera MLPs, articulation MLP and
    two delta MLPs, and the velocity, torque and residual MLPs; at E x F
    rows the distilled kinematics' two camera MLPs, articulation MLP and
    two delta MLPs; all forward and backward (the step takes every tensor's
    gradient); and the with_xp interval kernels' bounds (per-env anchors).
    The shapes are the reference's, built on the CPU."""
    cfg = run.config
    _, _, phys_interface, build_opts = modules("reference")
    obj, scn, intr = specs("reference", cfg)
    opts = common.opts_from(cfg, build_opts, logname="bench-shapes")
    model_dict = dict(scene_field=(scn, scn.init_params), object_field=(obj, obj.init_params),
                      intrinsics=(intr, intr.init_params),
                      frame_interval=1.0 / float(cfg["videos"]["fps"]), frame_info=None)
    tm = phys_interface(opts, model_dict, device="cpu")
    m = tm.modules
    E, F = int(run.traffic["num_envs"]), int(run.traffic["frames_per_wdw"])
    sub = tm.steps_per_fr_interval
    N, NF = E * (sub * (F - 1) + 1), E * F
    cam, art = obj.camera_mlp, obj.articulation_spec.mlp
    ops = lambda mod, rows: counts.mlp_ops(mod, rows, backward=True)
    mlp = (4 * ops(cam, N) + 2 * ops(art, N) + ops(m["root_pose_mlp"], N)
           + ops(m["joint_angle_mlp"], N)
           + sum(ops(m[k], N) for k in ("vel_mlp", "torque_mlp", "residual_f_mlp"))
           + 2 * ops(cam, NF) + ops(art, NF) + ops(m["root_pose_mlp"], NF)
           + ops(m["joint_angle_mlp"], NF))
    iw = counts.interval_work(tm.env, E, sub, xp_lanes=E)
    return dict(mlp_ops=mlp, intervals=F - 1,
                k2=dict(bytes=iw["fwd_bytes"], ops=iw["fwd_ops"]),
                k3=dict(bytes=iw["bwd_bytes"], ops=iw["bwd_ops"]))
