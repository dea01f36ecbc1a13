"""phys_model (PyTorch), counterpart of
``ppr_diffphys_tpu/models/phys_model.py``: the differentiable-physics
optimization model.

Serving: the robot template table, URDF import and mass surgery, the
parameters (``global_q``, ``target_ke/kd``, ``body_mass``) and the five
time-MLPs, the mocap table and its interpolation, the window inputs
(``get_batch_input``), the foot height and ``init_global_q``.

Training (reference dp_model.py:56-1011, the JAX ``_forward_pure`` and
host loop API): ``forward`` computes the loss dict and, in train mode, the
gradients (the rollout runs on ``sim/soa_grad.py``'s interval kernels on
CUDA, their plain version on the CPU); ``update`` runs the grad-norm
rollback and the per-tensor median-queue clipping, then AdamW with the
OneCycle schedule per parameter group; ``save_checkpoint`` pickles the JAX
package's checkpoint layout (flax-layout MLP trees), so checkpoints move
between the two packages both ways. Eval (``is_eval``) runs the window
without gradient through ``sim/soa.py:SoaWindow`` (K1 on CUDA).

The lab4d coupling (``models/interface.py:phys_interface``) subclasses it
through the same hooks as the JAX package: ``preset_data``/``_finish_data``,
``get_batch_input`` with a per-env ``joint_X_p`` (live joint anchors, which
FK, the initial state and the rollout honour; the rollout takes them as the
interval kernels' ``with_xp`` planes, and the eval forward then chains the
no-gradient interval instead of the window, which has no anchor planes),
``_distill_rows``, ``_extend_aux`` and ``get_camera``.

Multi-GPU (``parallel/sharding.py``): ``opts["ngpu"]`` budgets the ranks
of the ``torch.distributed`` world (-1 or 0: all) and ``opts["mesh_shape"]``
({"dp": .., "tp": ..} or "dp=4,tp=2") shapes the mesh, which ``_mesh_for``
picks per env count as the JAX package does. In training each rank rolls
out its slice of the envs; the per-env loss rows are gathered so that every
rank reduces the same rows, and the gradients are summed over the ranks
before the norms, the median queue and AdamW, which then run identically
on every rank. The eval (1 env) runs whole on every rank. Host decisions
that change the model read rank 0's values, and only rank 0 writes files.

Not here: orbax.
"""

from __future__ import annotations

import copy
import os
import pickle

import numpy as np
import torch
from torch import nn

from .. import default_device
from ..parallel import sharding
from ..data.amp_loader import parse_amp, preprocess_sequence
from ..data.robot import URDFRobot
from ..ops import (
    compose_delta,
    quat_to_matrix,
    rotate_frame,
    rotate_frame_vel,
    swap_lin_ang,
)
from ..sim.builder import ModelBuilder
from ..sim.import_urdf import parse_urdf
from ..sim.integrator import SemiImplicitIntegrator, SimParams, SimState
from ..sim.kinematics import eval_fk
from ..sim.soa import SoaWindow
from ..sim.soa_grad import make_diff_interval, rollout_soa
from ..utils import spans
from ..utils.config import DEFAULT_OPTS, interp_wt, match_param_name
from .losses import compute_com, reduce_loss, se3_loss
from .mlp import (
    FrameSampler,
    TimeMLP,
    jax_param_path,
    resolve_num_freq_t,
    timemlp_params_from_jax,
    timemlp_params_to_jax,
)

MLP_NAMES = ("root_pose_mlp", "joint_angle_mlp", "vel_mlp", "torque_mlp",
             "residual_f_mlp")
PARAM_NAMES = ("global_q", "target_ke", "target_kd", "body_mass")
LOSS_KEYS = (
    "traj", "pos_state", "vel_state", "pos_distill",
    "reg_torque", "reg_res_f", "reg_foot",
)


class _ScrubGrad(torch.autograd.Function):
    """Identity whose cotangent is NaN-scrubbed and clamped to [-1, 1]
    (reference dp_model.py:1103-1127 remove_nan + clamp)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = torch.nan_to_num(g, nan=0.0, posinf=1.0, neginf=-1.0)
        return torch.clamp(g, -1.0, 1.0)


class _ScrubGradRef(torch.autograd.Function):
    """The reference-exact variant: NaN -> 0 and an upper-only clamp
    (dp_model.py:1109-1110, :1121-1123), for opts['ref_quirks']."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(torch.nan_to_num(g, nan=0.0), max=1.0)


def scrub_grad(x):
    return _ScrubGrad.apply(x)


def scrub_grad_ref(x):
    return _ScrubGradRef.apply(x)


class phys_model:
    """Reference-compatible API (dp_model.py): __init__(opts, dataloader,
    device), reinit_envs, forward, backward, update, query,
    save/load_checkpoint, check_grad, clear_grad, plus
    load_params_from_jax."""

    # True on subclasses whose batches carry a live joint_X_p (the lab4d
    # interface's query_ja): the rollout then runs the with_xp interval
    has_live_xp = False

    def __init__(self, opts, dataloader, dt=5e-4, device=None):
        self.opts = opts
        self.device = default_device(device)
        logname = "%s-%s" % (opts["seqname"], opts["logname"])
        self.save_dir = os.path.join(opts["logroot"], logname)
        self.total_iters = (
            int(opts["num_rounds"] * opts["iters_per_round"] * opts["ratio_phys_cycle"])
            + opts["warmup_iters"]
            + 1
        )
        self.progress = 0.0
        self.dt = dt
        self.noise_std = opts["noise_std"]
        self.preset_data(dataloader)

        # ---- robot template table (reference dp_model.py:76-121) ----------
        urdf_dir = opts.get("urdf_dir", DEFAULT_OPTS["urdf_dir"])
        template = opts["urdf_template"]
        if template == "a1":
            urdf_path = os.path.join(urdf_dir, "a1/urdf/a1.urdf")
            in_bullet = True
            # the reference a1 branch never sets joint_attach_ke/kd; the JAX
            # package defaults them, and so does the port
            self.joint_attach_ke, self.joint_attach_kd = 16000.0, 200.0
            kp, kd, shape_ke, shape_kd = 220.0, 2.0, 1.0e4, 0.0
        elif template == "laikago":
            urdf_path = os.path.join(urdf_dir, "laikago/laikago.urdf")
            in_bullet = False
            self.joint_attach_ke, self.joint_attach_kd = 16000.0, 200.0
            kp, kd, shape_ke, shape_kd = 220.0, 2.0, 1.0e4, 0.0
        elif template == "quad":
            urdf_path = os.path.join(urdf_dir, "quad.urdf")
            in_bullet = False
            self.joint_attach_ke, self.joint_attach_kd = 8000.0, 200.0
            kp, kd, shape_ke, shape_kd = 660.0, 5.0, 1.0e4, 0.0
        elif template == "human":
            urdf_path = os.path.join(urdf_dir, "human.urdf")
            in_bullet = False
            self.joint_attach_ke, self.joint_attach_kd = 8000.0, 200.0
            kp, kd, shape_ke, shape_kd = 660.0, 5.0, 1.0e4, 0.0
        else:
            raise NotImplementedError(template)
        self.in_bullet = in_bullet
        self.robot = URDFRobot(urdf_path)

        # ---- build articulation (reference dp_model.py:126-146) ------------
        builder = ModelBuilder()
        parse_urdf(
            urdf_path, builder,
            xform_p=(0.0, 0.417, 0.0), floating=True,
            density=1000, armature=0.01, stiffness=220.0, damping=2.0,
            shape_ke=shape_ke, shape_kd=shape_kd, shape_kf=1.0e2, shape_mu=1,
            limit_ke=0, limit_kd=0,
        )

        # ---- mass surgery (reference dp_model.py:150-196) ------------------
        if hasattr(self.robot.urdf, "kp_links"):
            # ball-joint robots: feet get 2x geometry / 8x mass / 32x inertia;
            # inertia normalized by mass; link mass = clamp(1e3*prod(scale),1,5)
            name_by_body = {n: i for i, n in enumerate(builder.body_name)}
            body_first_shape = {}
            for s in builder.shapes:
                body_first_shape.setdefault(s.body, s)
            for name, idx in name_by_body.items():
                if idx not in body_first_shape:
                    continue
                if name in self.robot.urdf.kp_links:
                    for s in builder.shapes:
                        if s.body == idx:
                            s.scale = s.scale * 2.0
                    builder.body_mass[idx] *= 2 ** 3
                    builder.body_inertia[idx] = builder.body_inertia[idx] * 2 ** 5
                builder.body_inertia[idx] = (
                    builder.body_inertia[idx] / builder.body_mass[idx]
                )
                link_weight = 1e3 * np.prod(body_first_shape[idx].scale)
                builder.body_mass[idx] = float(np.clip(link_weight, 1.0, 5.0))
        else:
            for idx in range(len(builder.body_mass)):
                builder.body_inertia[idx] = (
                    builder.body_inertia[idx] / builder.body_mass[idx]
                )

        self.n_dof = len(builder.joint_q) - 7
        self.n_links = builder.body_count

        self.env = builder.finalize().make_ground_contacts(
            opts.get("contact_mode", "hull")
        )
        self.env.joint_attach_ke = self.joint_attach_ke
        self.env.joint_attach_kd = self.joint_attach_kd
        self.integrator = SemiImplicitIntegrator(self.env)

        # normalized inertia (inertia = norm_inertia * mass at sim time)
        self.norm_body_inertia = self._t(self.env.body_inertia)

        self._mesh_verts, self._mesh_faces, self._mesh_vbody = self.env.collision_mesh()

        # ---- parameters ----------------------------------------------------
        self.generator = torch.Generator().manual_seed(int(opts.get("seed", 0)))
        target_ke = np.concatenate([np.zeros(6), kp * np.ones(self.n_dof)])
        target_kd = np.concatenate([np.zeros(6), kd * np.ones(self.n_dof)])
        self.params = {
            "global_q": self._t([0.0, 0, 0, 0, 0, 0, 1.0]),
            "target_ke": self._t(target_ke),
            "target_kd": self._t(target_kd),
            "body_mass": self._t(self.env.body_mass),
        }
        self.add_nn_modules()

        # ---- the mesh: ngpu budgets the world's ranks (-1/0 = all), and
        # mesh_shape {"dp":..,"tp":..} or "dp=4,tp=2" shapes it (JAX
        # phys_model.py:229-246)
        self._budget, self._tp, self._dp_cap = sharding.mesh_budget(
            opts.get("ngpu", -1), opts.get("mesh_shape"), sharding.world_size())
        self._mesh_cache = {}

        self.init_global_q()
        self.add_optimizer(opts)

        # 2-deep rollback caches (reference dp_model.py:232-235)
        self.model_cache = [None, None]
        self.optimizer_cache = [None, None]
        self.grad_queue = {}
        self._grad_accum = []
        self._pending_update = None
        self._kernels = {}

    def _t(self, x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------
    def preset_data(self, dataloader):
        self.frame_offset_raw = dataloader.data_info["offset"]
        self.frame_interval = dataloader.frame_interval
        self.total_frames = len(dataloader.amp_info)
        self.steps_per_fr_interval = int(self.frame_interval / self.dt)
        self._dataloader = dataloader

    def _finish_data(self):
        """Device-resident mocap table (after in_bullet is known)."""
        self.amp_table = self._t(preprocess_sequence(self._dataloader, self.in_bullet))

    # ------------------------------------------------------------------
    # networks
    # ------------------------------------------------------------------
    def add_nn_modules(self):
        """Five time-MLPs (reference dp_model.py:269-315)."""
        offsets = tuple(int(x) for x in self.frame_offset_raw)
        max_ts = int(np.max(np.diff(np.asarray(offsets))))
        nf = resolve_num_freq_t(6, max_ts)
        n_vids = len(offsets) - 1
        g = self.generator

        self.samplers = {
            "root_pose_mlp": FrameSampler(offsets, time_scale=0.1),
            "joint_angle_mlp": FrameSampler(offsets),
            "vel_mlp": FrameSampler(offsets),
            "torque_mlp": FrameSampler(offsets),
            "residual_f_mlp": FrameSampler(offsets),
        }
        self.modules = nn.ModuleDict({
            "root_pose_mlp": TimeMLP(nf, n_vids, 6, D=8, skips=(4,),
                                     output_scale=0.5, generator=g),
            "joint_angle_mlp": TimeMLP(nf, n_vids, self.n_dof, generator=g),
            "vel_mlp": TimeMLP(nf, n_vids, 6 + self.n_dof, output_scale=5.0,
                               generator=g),
            "torque_mlp": TimeMLP(nf, n_vids, self.n_dof, generator=g),
            "residual_f_mlp": TimeMLP(nf, n_vids, 6 * self.n_links, generator=g),
        }).to(self.device)

    def _mlp(self, name, steps_fr):
        """Evaluate a time-MLP at raw (fractional) frame ids (N,)."""
        sampler = self.samplers[name]
        t = sampler.frame_to_tid(steps_fr)
        vid = sampler.frame_to_vid(steps_fr)
        return self.modules[name](t, vid)

    # ------------------------------------------------------------------
    # envs / windows (reference dp_model.py:354-405 reinit_envs)
    # ------------------------------------------------------------------
    def reinit_envs(self, num_envs, frames_per_wdw, is_eval=False):
        self.num_envs = num_envs
        self.frames_per_wdw = frames_per_wdw
        self.is_eval = is_eval
        n_steps = self.steps_per_fr_interval * (frames_per_wdw - 1) + 1
        self.steps_idx = np.arange(n_steps)
        self.steps_idx_fr = self.steps_idx / self.steps_per_fr_interval
        self.frame2step = self.steps_idx[:: self.steps_per_fr_interval]

    def _interp_amp(self, steps_fr):
        """Linear interpolation of the mocap table at fractional frames, with
        linear extrapolation (replaces host scipy interp1d)."""
        T = self.amp_table.shape[0]
        i0 = torch.clamp(torch.floor(steps_fr), 0, max(T - 2, 0)).to(torch.long)
        frac = steps_fr - i0
        a = self.amp_table[i0]
        b = self.amp_table[torch.clamp(i0 + 1, max=T - 1)]
        return a + (b - a) * frac[..., None]

    def _sim_params(self, params=None, joint_X_p=None):
        params = self.params if params is None else params
        body_mass = params["body_mass"]
        inertia = self.norm_body_inertia * body_mass[:, None, None]
        return SimParams(
            body_mass=body_mass,
            body_inv_mass=1.0 / body_mass,
            body_inertia=inertia,
            body_inv_inertia=torch.linalg.inv(inertia),
            joint_target_ke=params["target_ke"],
            joint_target_kd=params["target_kd"],
            joint_X_p=joint_X_p,
        )

    # -- reference-surface compatibility helpers -----------------------
    def get_mocap_data(self, steps_fr):
        """Interpolated, GL-converted mocap slices at (possibly fractional)
        frames (reference get_mocap_data, dp_model.py:605-609); the
        bullet->GL conversion is baked into the mocap table."""
        steps_fr = torch.as_tensor(steps_fr, dtype=torch.float32, device=self.device)
        return parse_amp(self._interp_amp(steps_fr))

    def get_net_pred(self, steps_fr):
        """The five time-MLP predictions on a (bs, T) frame grid (reference
        get_net_pred, dp_model.py:518-552), from the live modules. Returns
        (torques, delta_root, delta_ja_ref, state_qd, res_f), torques and
        res_f zeroed as in the reference (parity with reference :529/:536)."""
        steps_fr = torch.as_tensor(steps_fr, dtype=torch.float32, device=self.device)
        bs, nstep = steps_fr.shape
        flat = steps_fr.reshape(-1)
        mlp = lambda name: self._mlp(name, flat).reshape(bs, nstep, -1)
        torques = mlp("torque_mlp") * 0.0
        res_f = mlp("residual_f_mlp").reshape(bs, nstep, -1, 6)
        res_f = torch.cat([res_f[..., :3] * 10.0, res_f[..., 3:]], -1).reshape(bs, nstep, -1) * 0.0
        return (torques, mlp("root_pose_mlp"), mlp("joint_angle_mlp"), mlp("vel_mlp"), res_f)

    @staticmethod
    def rearrange_pred(queried_q, queried_ja, queried_qd, torques, res_f):
        """(bs, T, .) -> (T, bs*.) layouts (reference rearrange_pred,
        dp_model.py:554-572). Returns (ref_ja, qq, qd, torques, res_f)."""
        bs, nstep, _ = queried_q.shape
        qq = torch.cat([queried_q, queried_ja], -1).permute(1, 0, 2).reshape(nstep, -1)
        qd = queried_qd.permute(1, 0, 2).reshape(nstep, -1)
        zeros = torch.zeros(queried_ja.shape[:-1] + (6,), dtype=queried_ja.dtype,
                            device=queried_ja.device)
        ref_ja = torch.cat([zeros, queried_ja], -1).permute(1, 0, 2).reshape(nstep, -1)
        return ref_ja, qq, qd, torques.reshape(nstep, -1), res_f.reshape(nstep, -1, 6)

    def get_optimizable_param_list(self):
        """(params_ref_list, params_list, lr_list) over the trainable top-level
        groups in sorted order (reference dp_model.py:478-509): each group's
        tensors, a group of one tensor named by the group as that tensor, else
        as {JAX path: tensor}."""
        params_ref_list, params_list, lr_list = [], [], []
        named = self.named_tensors()
        for name, lr in sorted(self.param_peak_lr.items()):
            if lr > 0:
                group = {n: t for n, t in named if n.split(".")[0] == name}
                value = group[name] if list(group) == [name] else group
                params_ref_list.append({name: value})
                params_list.append(value)
                lr_list.append(lr)
        return params_ref_list, params_list, lr_list

    @staticmethod
    def rm_module_prefix(states, prefix="module"):
        """Strip a DataParallel-style name prefix from a checkpoint dict
        (reference dp_model.py:345-352)."""
        out = {}
        for name, value in states.items():
            if name.startswith(prefix + "."):
                name = name[len(prefix) + 1:]
            out[name] = value
        return out

    def get_batch_input(self, params, steps_fr):
        """Targets + network predictions for a window (reference
        dp_model.py:611-662). steps_fr (E, S) fractional frames (float32
        tensor on the model's device). Returns a dict of tensors."""
        params = self.params if params is None else params
        E, S = steps_fr.shape
        msm = self.get_mocap_data(steps_fr)
        target_ja = msm["jang"][..., : self.n_dof]
        target_jad = msm["jvel"][..., : self.n_dof]
        target_q = torch.cat([msm["pos"], msm["orn"]], -1)
        target_qd = torch.cat([msm["vel"], msm["avel"]], -1)

        # ground alignment by the global SE(3)
        target_q = rotate_frame(params["global_q"], target_q)
        target_qd = rotate_frame_vel(params["global_q"], target_qd)

        torques, delta_root, delta_ja, state_qd, res_f = self.get_net_pred(steps_fr)
        res_f = res_f.reshape(E, S, -1, 6)

        queried_q = compose_delta(target_q, delta_root)
        queried_ja = target_ja + delta_ja

        return dict(
            target_q=target_q, target_qd=target_qd,
            target_ja=target_ja, target_jad=target_jad,
            queried_q=queried_q, queried_ja=queried_ja,
            queried_qd=state_qd, torques=torques, res_f=res_f,
        )

    def get_foot_height(self, body_q):
        """Min collision-mesh height (reference dp_model.py:574-579)."""
        verts = self._t(self._mesh_verts)
        vbody = torch.as_tensor(self._mesh_vbody, dtype=torch.long, device=body_q.device)
        rot = quat_to_matrix(body_q[..., 3:7])  # (..., B, 3, 3)
        row1 = rot[..., vbody, 1, :]  # (..., V, 3)
        y = torch.sum(row1 * verts, -1) + body_q[..., vbody, 1]
        return torch.amin(y, dim=-1)

    # ------------------------------------------------------------------
    # global_q init (reference init_global_q, dp_model.py:243-267)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_global_q(self):
        self._finish_data()
        self.reinit_envs(1, 1, is_eval=True)
        steps_fr = torch.zeros((1, 1), device=self.device)
        batch = self.get_batch_input(self.params, steps_fr)
        q = torch.cat([batch["queried_q"][:, 0], batch["queried_ja"][:, 0]], -1)
        body_q, _ = eval_fk(self.env, q)
        foot_height = float(self.get_foot_height(body_q[:, None])[0, 0])
        self._set_param("global_q", [0.0, -foot_height, 0.0, 0.0, 0.0, 0.0, 1.0])

    # ------------------------------------------------------------------
    # parameters from the JAX package
    # ------------------------------------------------------------------
    def load_params_from_jax(self, np_params):
        """Load a JAX parameter tree (dicts of numpy arrays, as the JAX
        package's ``save_checkpoint`` pickles it). Non-strict: keys absent
        from ``np_params`` keep their values."""
        for k in PARAM_NAMES:
            if k in np_params:
                self._set_param(k, np.array(np_params[k], np.float32))
        for k in MLP_NAMES:
            if k in np_params:
                sd = timemlp_params_from_jax(np_params[k])
                self.modules[k].load_state_dict(sd)

    def load_checkpoint(self, model_path):
        """Load a pickle checkpoint written by either package's
        ``save_checkpoint`` (a dict of numpy arrays and flax-layout MLP
        trees; reading it needs no JAX)."""
        with open(model_path, "rb") as f:
            states = pickle.load(f)
        self.load_params_from_jax(states)

    def _set_param(self, name, value):
        """Write a top-level parameter in place (the optimizer holds these
        tensors), creating it on first use."""
        value = torch.as_tensor(np.asarray(value, np.float32), device=self.device)
        if name not in self.params:
            self.params[name] = value.clone()
            return
        with torch.no_grad():
            self.params[name].copy_(value)

    # ------------------------------------------------------------------
    # forward (reference dp_model.py:664-838)
    # ------------------------------------------------------------------
    def fk_pos_vel(self, q7, ja, qd6, jad, joint_X_p=None):
        """FK of [root 7 + joint angles] with velocities given in ppr
        layout (reference dp_model.py:588-603). Inputs (..., .); joint_X_p
        an optional anchor override broadcastable to (..., B, 7)."""
        joint_q = torch.cat([q7, ja], -1)
        joint_qd = swap_lin_ang(torch.cat([qd6, jad], -1))
        body_q, body_qd = eval_fk(self.env, joint_q, joint_qd, joint_X_p=joint_X_p)
        return body_q, swap_lin_ang(body_qd)

    def _interval(self, with_xp=False):
        """The differentiable frame interval (built once per integrator),
        with the live anchor planes when ``with_xp``."""
        key = ("interval", id(self.integrator), self.steps_per_fr_interval, with_xp)
        if key not in self._kernels:
            self._kernels[key] = make_diff_interval(
                self.integrator, self.dt, self.steps_per_fr_interval,
                # residual forces and joint activations are structurally
                # zero (reference dp_model.py:529/:536)
                with_res=bool(self.opts.get("soa_with_res", False)),
                with_act=bool(self.opts.get("soa_with_act", False)),
                with_xp=with_xp,
            )
        return self._kernels[key]

    def _window(self, n_frames):
        """The no-gradient whole-window rollout used by eval."""
        key = ("window", id(self.integrator), n_frames)
        if key not in self._kernels:
            self._kernels[key] = SoaWindow(
                self.integrator, self.dt, self.steps_per_fr_interval, n_frames)
        return self._kernels[key]

    def _forward_pure(self, params, frame_start, progress, weights, is_train, shard=None):
        """The whole forward: mocap targets, MLP queries, FK, the rollout
        and the losses (JAX phys_model._forward_pure). ``frame_start`` holds
        every env; with ``shard`` (``sharding.env_sharding``) this rank runs
        its slice and the losses reduce the per-env rows of every slice."""
        shard = shard or sharding.env_sharding(None)
        E_all = frame_start.shape[0]
        envs = shard.rows(E_all)
        frame_start = frame_start[envs]
        E = frame_start.shape[0]
        S = len(self.steps_idx)
        sub = self.steps_per_fr_interval
        dev = self.device
        f2s = torch.as_tensor(self.frame2step, dtype=torch.long, device=dev)

        steps_fr = frame_start[:, None] + torch.as_tensor(
            self.steps_idx_fr, dtype=torch.float32, device=dev)[None]

        # out-of-sequence mask over frames (reference dp_model.py:677-682)
        vidid = self.samplers["joint_angle_mlp"].frame_to_vid(steps_fr[:, f2s])
        outseq = (vidid[:, :1] - vidid) != 0

        with spans.span("forward.inputs"):
            batch = self.get_batch_input(params, steps_fr)
        # the lab4d interface's per-env joint anchors (E, B, 7), or None
        xp = batch.get("joint_X_p")
        stk = lambda a, b: torch.stack([a[:, f2s], b[:, f2s]], 0)
        with spans.span("forward.fk"):
            both_position, both_velocity = self.fk_pos_vel(
                stk(batch["target_q"], batch["queried_q"]),
                stk(batch["target_ja"], batch["queried_ja"]),
                stk(batch["target_qd"], batch["queried_qd"][..., :6]),
                stk(batch["target_jad"], batch["queried_qd"][..., 6:]),
                joint_X_p=None if xp is None else xp[None, :, None],  # over (2, E, F)
            )
        target_position, queried_position = both_position[0], both_position[1]
        queried_velocity = both_velocity[1]

        # initial state (+ annealed noise, reference dp_model.py:700-712)
        q_init = torch.cat([batch["queried_q"][:, 0], batch["queried_ja"][:, 0]], -1)
        if is_train and self.noise_std > 0:
            noise_ratio = float(np.clip(1.0 - 1.5 * progress, 0.0, 1.0))
            # drawn for every env, so the generator stays in step on every rank
            noise = torch.randn((E_all, q_init.shape[1]), generator=self.generator)[envs].to(dev)
            noise = noise * self.noise_std * noise_ratio
            noise[:, :3] = 0.0
            noise[:, 3:7] *= 5.0
            q_init = q_init + noise
        qd_init = swap_lin_ang(batch["queried_qd"][:, 0])
        with spans.span("forward.fk"):
            body_q0, body_qd0 = eval_fk(self.env, q_init, qd_init, joint_X_p=xp)
        state0 = SimState(body_q0, body_qd0)

        # control reference at every substep: zeros(6) + queried joint
        # angles (reference rearrange_pred, dp_model.py:554-572)
        with spans.span("forward.rollout"):
            zeros6 = torch.zeros((E, S, 6), dtype=torch.float32, device=dev)
            ref_ja = torch.cat([zeros6, batch["queried_ja"]], -1).transpose(0, 1)
            torques = torch.cat([zeros6, batch["torques"]], -1).transpose(0, 1)
            res_f = swap_lin_ang(batch["res_f"]).transpose(0, 1)  # (S,E,B,6)

            sp = self._sim_params(params, joint_X_p=xp)
            quirks = bool(self.opts.get("ref_quirks", False))
            if is_train:
                # gradient scrubbing at the rollout boundary (reference
                # remove_nan/clamp, dp_model.py:1294-1384)
                scrub = scrub_grad_ref if quirks else scrub_grad
                sim_q, sim_qd, grfs, jafs = rollout_soa(
                    self.integrator, sp, state0, scrub(ref_ja), scrub(torques),
                    scrub(res_f), self.dt, sub, interval_fn=self._interval(xp is not None),
                )
            elif xp is not None:
                # live anchors: the window (K1) has no anchor planes, so the eval
                # chains the with_xp interval without gradient (K2 alone on CUDA)
                with torch.no_grad():
                    sim_q, sim_qd, grfs, jafs = rollout_soa(
                        self.integrator, sp, state0, ref_ja, None, None, self.dt, sub,
                        interval_fn=self._interval(True))
            else:
                # torques and residual forces are structurally zero: the window
                # takes acts as None and has no residual input
                sim_q, sim_qd, grfs, jafs = self._window(self.frames_per_wdw)(
                    state0, ref_ja, None, sp)
            sim_position = sim_q.transpose(0, 1)  # (E, F, B, 7)
            sim_velocity = swap_lin_ang(sim_qd.transpose(0, 1))

        with spans.span("forward.losses"):
            foot_height = self.get_foot_height(queried_position)

            # ---- losses (reference dp_model.py:775-838): the per-env rows of
            # every env (every dp slice's, gathered in order), then reduced
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            rows = {
                "traj": se3_loss(sim_position, target_position).mean(-1),
                "pos_state": se3_loss(queried_position, sim_position.detach()).mean(-1),
                "vel_state": se3_loss(queried_velocity, sim_velocity.detach()).mean(-1),
            }
            rows = {k: torch.where(outseq, zero, v) for k, v in rows.items()}
            distill = self._distill_rows(params, steps_fr, sim_position, outseq)
            if distill is not None:
                rows["pos_distill"] = distill
            rows["foot"] = foot_height.reshape(E, -1)
            # the regularizers' per-env sums of squares (their rows span every
            # substep, too many to gather)
            sq = {k: batch[k] ** 2 for k in ("torques", "res_f")}
            for k, v in sq.items():
                rows[k] = v.reshape(E, -1).sum(1, keepdim=True)
            width = {k: v.shape[1] for k, v in rows.items()}
            rows = dict(zip(width, torch.split(shard.gather(torch.cat(list(rows.values()), 1)),
                                               list(width.values()), 1)))
            loss_dict = {}
            loss_dict["traj"] = reduce_loss(rows["traj"], clip=True, env0_th=quirks)
            loss_dict["pos_state"] = reduce_loss(rows["pos_state"])
            loss_dict["vel_state"] = reduce_loss(rows["vel_state"])
            loss_dict["pos_distill"] = reduce_loss(rows["pos_distill"]) if distill is not None \
                else zero
            loss_dict["reg_torque"] = rows["torques"].sum() / (E_all * sq["torques"][0].numel())
            loss_dict["reg_res_f"] = rows["res_f"].sum() / (E_all * sq["res_f"][0].numel())
            loss_dict["reg_foot"] = torch.mean(rows["foot"] ** 2)

            total = zero
            for i, k in enumerate(LOSS_KEYS):
                total = total + loss_dict[k] * weights[i]
        out = {"loss_" + k: v for k, v in loss_dict.items()}
        out["total_loss"] = total
        aux = dict(
            sim_traj=sim_q[:, 0],  # (F, B, 7) env 0, for vis
            target_traj=target_position[0],
            pid_ref=queried_position[0],
            grf=grfs[:, 0],  # warp layout [torque, force]
            jaf=jafs[:, 0],
        )
        aux = self._extend_aux(aux, params, batch, steps_fr, sim_position)
        return out, aux

    def _extend_aux(self, aux, params, batch, steps_fr, sim_position):
        """Hook for subclasses to add eval observables (cameras, distilled
        trajectories)."""
        return aux

    def _distill_rows(self, params, steps_fr, sim_position, outseq):
        """pos_distill's per-env rows (E, F) (reference dp_model.py:800-804):
        None in mocap mode (the loss is zero), the lab4d interface's
        distillation otherwise."""
        return None

    # ------------------------------------------------------------------
    # host-side train loop API (reference method surface)
    # ------------------------------------------------------------------
    def set_progress(self, num_iters):
        self.progress = num_iters / self.total_iters
        self.set_loss_weight("reg_cam_prior_wt", (0, 0.5), (1, 0), self.progress)

    def set_loss_weight(self, loss_name, anchor_x, anchor_y, current_steps, type="linear"):
        if loss_name not in self.opts:
            return
        if "%s_init" % loss_name not in self.opts:
            self.opts["%s_init" % loss_name] = self.opts[loss_name]
        factor = interp_wt(anchor_x, anchor_y, current_steps, type=type)
        self.opts[loss_name] = self.opts["%s_init" % loss_name] * factor

    def _weights_vec(self):
        return [float(self.opts.get(k + "_wt", 0.0)) for k in LOSS_KEYS]

    def compute_frame_start(self):
        """Window starts of every env (on every rank the same draw)."""
        u = torch.rand((self.num_envs,), generator=self.generator)
        return torch.round(u * (self.total_frames - self.frames_per_wdw)).to(self.device)

    def _mesh_for(self, num_envs):
        """The mesh for an env count, or None for the unsharded path: dp the
        largest divisor of num_envs within the rank budget // tp, tp from
        opts["mesh_shape"] when it divides the budget (JAX
        phys_model._mesh_for). Cached per (dp, tp)."""
        dims = sharding.mesh_dims(num_envs, self._budget, self._tp, self._dp_cap)
        if dims is None:
            return None
        if dims not in self._mesh_cache:
            dp, tp = dims
            shape = {"dp": dp, "tp": tp} if tp > 1 else {"dp": dp}
            self._mesh_cache[dims] = sharding.make_mesh(shape, list(range(self._budget)))
        return self._mesh_cache[dims]

    def forward(self, frame_start=None):
        """One forward; in train mode also computes and accumulates the
        gradients (``backward`` is a no-op, as in the JAX package). On a
        mesh (``_mesh_for(num_envs)``) the train step runs this rank's env
        slice and accumulates the gradients summed over the ranks."""
        with spans.span("phys_model.forward"):
            if frame_start is None:
                frame_start = self.compute_frame_start()
            else:
                frame_start = torch.as_tensor(
                    np.asarray(frame_start, np.float32), device=self.device)[: self.num_envs]
            w = self._weights_vec()
            if self.is_eval:
                with torch.no_grad():
                    out, aux = self._forward_pure(self.params, frame_start, self.progress, w,
                                                  False)
                self._store_eval_aux(aux)
                return out
            # every tensor's gradient, frozen ones too, as jax.grad gives them
            # (``last_grads``); the update takes the trainable ones
            named = self.named_tensors()
            tensors = [t for _, t in named]
            leaves = [t for t in tensors if not isinstance(t, nn.Parameter)]

            def grad_step(shard):
                out, _ = self._forward_pure(self.params, frame_start, self.progress, w, True,
                                            shard=shard)
                with spans.span("forward.backward"):
                    grads = torch.autograd.grad(out["total_loss"], tensors, allow_unused=True)
                return out, [torch.zeros_like(t) if g is None else g
                             for t, g in zip(tensors, grads)]

            for t in leaves:
                t.requires_grad_(True)
            try:
                out, grads = sharding.shard_train_step(
                    grad_step, self._mesh_for(self.num_envs), named)()
            finally:
                for t in leaves:
                    t.requires_grad_(False)
            self.last_grads = {n: g for (n, _), g in zip(named, grads)}
            grads = [self.last_grads[n] for n, _ in self._trainable]
            # per-tensor norms over trainable tensors: the reference's grad
            # queue keys are per named parameter (dp_model.py:969-975)
            with spans.span("forward.grad_norms"):
                norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
                gnorm = torch.sqrt(torch.sum(norms ** 2))
            self._grad_accum.append((grads, norms, gnorm))
            return {k: v.detach() for k, v in out.items()}

    def _store_eval_aux(self, aux):
        self.sim_trajs = aux["sim_traj"].cpu().numpy()
        self.target_trajs = aux["target_traj"].cpu().numpy()
        self.pid_ref = aux["pid_ref"].cpu().numpy()
        self.grfs = aux["grf"].cpu().numpy()
        self.jafs = aux["jaf"].cpu().numpy()
        self._check_hull_contacts(self.sim_trajs)

    def _check_hull_contacts(self, body_q):
        """'hull' contact candidates are exact only while no interior mesh
        vertex crosses the ground plane (builder.validate_hull_contacts).
        On a violation beyond the margin, fall back to the every-vertex
        contact set for all later rollouts (contact_fallback=False warns
        only)."""
        if self.env.contact_mode != "hull":
            return
        # rank 0's reading decides on every rank
        viol, = sharding.broadcast_from_rank0([self.env.validate_hull_contacts(body_q)])
        margin = float(self.opts.get("hull_fallback_margin", 3e-3))
        if viol <= margin:
            return
        print("hull-contact assumption violated (interior vertex %.4f m below "
              "ground)" % viol)
        if self.opts.get("contact_fallback", True):
            print("falling back to contact_mode='all' (reference-exact)")
            self.env.make_ground_contacts("all")
            self.integrator = SemiImplicitIntegrator(self.env)
            self._kernels.clear()

    def backward(self, loss):
        """No-op bridge: gradients were produced in forward()."""
        return

    # ------------------------------------------------------------------
    # optimizer (reference add_optimizer/get_lr_dict, dp_model.py:429-509)
    # ------------------------------------------------------------------
    def get_lr_dict(self):
        lr_base = self.opts["phys_learning_rate"]
        lr_explicit = lr_base * 10
        param_lr_startwith = {
            "global_q": lr_explicit,
            "target_ke": lr_explicit,
            "target_kd": lr_explicit,
            "attach_ke": lr_explicit,
            "attach_kd": lr_explicit,
            "body_mass": lr_explicit,
            "root_pose_mlp": lr_base,
            "joint_angle_mlp": lr_base,
            "vel_mlp": lr_base,
            "torque_mlp": lr_base,
            "residual_f_mlp": lr_base,
        }
        param_lr_with = {"root_pose_mlp.base_quat": lr_explicit}
        return param_lr_startwith, param_lr_with

    def named_tensors(self):
        """(dotted name, tensor) of every parameter tensor, named by the JAX
        package's parameter-tree paths (``root_pose_mlp.trunk.linear_1.kernel``)."""
        out = [(k, self.params[k]) for k in PARAM_NAMES]
        for m in MLP_NAMES:
            for k, t in self.modules[m].named_parameters():
                out.append((m + "." + ".".join(jax_param_path(k)[0]), t))
        return out

    def _param_lr(self, name):
        """Peak lr of a dotted tensor name: 'with' matches take priority over
        'startwith' (reference match_param_name, dp_model.py:478-509)."""
        startwith, withmap = self.get_lr_dict()
        matched_loose, lr_loose = match_param_name(name, withmap, "with")
        matched, lr = match_param_name(name, startwith, "startwith")
        if matched_loose:
            return lr_loose
        return lr if matched else 0.0

    def add_optimizer(self, opts):
        total = max(2, self.total_iters)
        pct_start = 2.0 / total
        div, final_div = 25.0, 100.0
        f32 = np.float32

        def onecycle(step):
            # torch OneCycleLR with linear anneal and its phase boundaries
            # (warmup ends at pct_start*total - 1, the anneal at total - 1),
            # in the JAX package's fp32 lerp form
            end1 = f32(max(pct_start * total - 1.0, 1e-6))
            end2 = f32(max(total - 1.0, 1.0))
            t = min(f32(step), end2)
            init, fin = f32(1.0 / div), f32(1.0 / (div * final_div))
            if t <= end1:
                f1 = t / end1
                return float((f32(1.0) - f1) * init + f1 * f32(1.0))
            f2 = (t - end1) / (end2 - end1)
            return float((f32(1.0) - f2) * f32(1.0) + f2 * fin)

        self._lr_schedule = onecycle
        self._trainable = []
        groups = []
        for name, t in self.named_tensors():
            lr = self._param_lr(name)
            if lr > 0:
                self._trainable.append((name, t))
                groups.append({"params": [t], "lr": lr, "peak_lr": lr})
        self.param_peak_lr = {}
        for name, _ in self.named_tensors():
            top = name.split(".")[0]
            self.param_peak_lr[top] = max(self.param_peak_lr.get(top, 0.0), self._param_lr(name))
        for top, lr in sorted(self.param_peak_lr.items()):
            if lr > 0:
                n = sum(1 for name, _ in self._trainable if name.split(".")[0] == top)
                print("%-24s lr=%g (%d tensors)" % (top, lr, n))
        # scale_by_adam + add_decayed_weights(1e-4) + per-group lr x schedule
        # is AdamW (tests/test_optimizer_parity.py)
        self.optimizer = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=1e-4)
        self._sched_step = 0  # the schedule's own count (advances on rollback too)

    def check_grad(self, thresh=10.0):
        """Aggregate the accumulated gradients, run the grad-norm rollback
        and per-tensor median-queue clipping, and stage the surviving
        (grads, scales) for update(). Returns the grad-statistics dict ({}
        when the step was rolled back)."""
        assert self._grad_accum, "forward() must run before update()"
        n = len(self._grad_accum)
        if n == 1:
            grads, norms_dev, gnorm_dev = self._grad_accum[0]
        else:
            grads = [sum(gs) / n for gs in zip(*(a[0] for a in self._grad_accum))]
            norms_dev = sum(a[1] for a in self._grad_accum) / n
            gnorm_dev = sum(a[2] for a in self._grad_accum) / n
        # one host transfer for all grad statistics (the host waits for the
        # device here); rank 0's decide the rollback and the median queue on
        # every rank
        with spans.span("update.grad_read"):
            stats = torch.cat([gnorm_dev[None], norms_dev]).cpu().tolist()
        stats = sharding.broadcast_from_rank0(stats)
        gnorm = float(stats[0])
        norms = {name: float(v) for (name, _), v in zip(self._trainable, stats[1:])}
        self._grad_accum = []
        res = self.check_grad_dict(grads, norms, gnorm, thresh)
        if res is None:
            self._pending_update = None
            return {}
        scales, grad_dict = res
        self._pending_update = (grads, scales)
        return grad_dict

    def update(self):
        """Grad safety then the optimizer step (reference update,
        dp_model.py:511-516)."""
        with spans.span("phys_model.update"):
            grad_dict = self.check_grad()
            if self._pending_update is None:
                return grad_dict
            grads, scales = self._pending_update
            self._pending_update = None
            for (name, t), g in zip(self._trainable, grads):
                t.grad = g * self._scale_of(name, scales)
            sched = self._lr_schedule(self._sched_step)
            for group in self.optimizer.param_groups:
                group["lr"] = group["peak_lr"] * sched
            with spans.span("update.adamw"):
                self.optimizer.step()
                self.optimizer.zero_grad(set_to_none=True)
            self._sched_step += 1
            return grad_dict

    def check_grad_dict(self, grads, norms, gnorm, thresh=10.0):
        """Grad-norm rollback + per-tensor median-queue clipping
        (reference check_grad, dp_model.py:936-999)."""
        if not np.isfinite(gnorm) or gnorm > thresh:
            print("large grad: %.2f, clear gradients" % gnorm)
            if self.model_cache[0] is not None:
                print("fallback to cached model")
                self._restore(self.model_cache[0], self.optimizer_cache[0])
            # the reference steps its LR scheduler on a rolled-back iter
            # while AdamW skips the params: advance the schedule count only
            self._sched_step += 1
            return None

        grad_dict = {}
        scales = {}
        queue_length = 10
        for name, g in norms.items():
            grad_dict["grad/" + name] = g
            scales[name] = 1.0
            scale_threshold = 5.0
            q = self.grad_queue.setdefault(name, [])
            if len(q) > queue_length:
                # torch.median semantics (dp_model.py:989): the LOWER middle
                # element of the even-length slice
                arr = np.sort(np.asarray(q[:-1]))
                med = float(arr[(len(arr) - 1) // 2])
                grad_dict["grad_med/" + name] = med
                if g > scale_threshold * med and g > 0:
                    scales[name] = med / g
                    print("large grad: %.2f, clear %s" % (g, name))
                else:
                    q.append(g)
                    q.pop(0)
            else:
                q.append(g)
        return scales, grad_dict

    @staticmethod
    def _scale_of(name, scales):
        """Exact dotted name first, else the longest dotted-prefix match,
        else 0 (JAX phys_model._scales_tree)."""
        if name in scales:
            return scales[name]
        best, blen = 0.0, -1
        for k, v in scales.items():
            if name.startswith(k + ".") and len(k) > blen:
                best, blen = v, len(k)
        return best

    def clear_grad(self):
        self._grad_accum = []
        if self.model_cache[0] is not None:
            print("fallback to cached model")
            self._restore(self.model_cache[0], self.optimizer_cache[0])

    def _restore(self, state_np, opt_cache):
        self.load_params_from_jax(state_np)
        opt_state, sched_step = opt_cache
        self.optimizer.load_state_dict(copy.deepcopy(opt_state))
        self._sched_step = sched_step

    # ------------------------------------------------------------------
    # checkpoints (reference dp_model.py:912-934)
    # ------------------------------------------------------------------
    def state_np(self):
        """The parameters as the JAX package's checkpoint tree: numpy
        arrays, the MLPs as flax-layout parameter trees."""
        out = {k: self.params[k].detach().cpu().numpy().copy() for k in PARAM_NAMES}
        for m in MLP_NAMES:
            out[m] = timemlp_params_to_jax(self.modules[m])
        return out

    def save_checkpoint(self, steps_count):
        self.model_cache[0] = self.model_cache[1]
        self.optimizer_cache[0] = self.optimizer_cache[1]
        self.model_cache[1] = self.state_np()
        self.optimizer_cache[1] = (copy.deepcopy(self.optimizer.state_dict()), self._sched_step)
        if sharding.rank() != 0:
            return  # every rank keeps the rollback caches; rank 0 writes
        os.makedirs(self.save_dir, exist_ok=True)
        save_dict = self.model_cache[1]
        for name in ("ckpt_phys_%04d.pth" % steps_count, "ckpt_phys_latest.pth"):
            with open(os.path.join(self.save_dir, name), "wb") as f:
                pickle.dump(save_dict, f)

    def get_camera(self):
        """World-to-view matrices with the intrinsics packed into row 3
        (reference dp_model.py:904-910); the matrices come from the lab4d
        interface's eval forward (``phys_interface._store_eval_aux``)."""
        w2v = self.world2view_vis.copy()
        w2v[..., 3, :] = self.ks_vis
        return w2v

    # ------------------------------------------------------------------
    # query for visualization (reference dp_model.py:843-902)
    # ------------------------------------------------------------------
    def query(self, img_size=None):
        part_com = torch.as_tensor(self.env.body_com, dtype=torch.float32)
        part_mass = torch.as_tensor(self.env.body_mass, dtype=torch.float32)
        com = lambda t: compute_com(torch.as_tensor(t), part_com, part_mass).numpy()
        data = {
            "sim_traj": self.sim_trajs,  # (F, B, 7)
            "target_traj": self.target_trajs,
            "control_ref": self.pid_ref,
            "grf": self.grfs,
            "com": np.stack([com(t) for t in self.sim_trajs], 0),
            "com_k": [com(t) for t in self.target_trajs],
            "body_mass": self.params["body_mass"].detach().cpu().numpy(),
        }
        verts = self._mesh_verts
        data["max_w"] = 3 * np.abs(verts[:, [0, 2]]).max()
        return data
