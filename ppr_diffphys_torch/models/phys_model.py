"""phys_model (PyTorch), counterpart of
``ppr_diffphys_tpu/models/phys_model.py`` — the **serving subset**.

What is here: the robot template table, URDF import and mass surgery, the
parameters (``global_q``, ``target_ke/kd``, ``body_mass``) and the five
time-MLPs, the mocap table and its interpolation, the window inputs
(``get_batch_input``), the foot height, ``init_global_q``, and loading of
parameters and pickle checkpoints written by the JAX package.

Not here yet (the training slice): losses, ``forward``/``update``, the
optimizer, rollback and multi-device placement.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
from torch import nn

from .. import default_device
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
from ..sim.integrator import SemiImplicitIntegrator, SimParams
from ..sim.kinematics import eval_fk
from ..utils.config import DEFAULT_OPTS
from .mlp import FrameSampler, TimeMLP, resolve_num_freq_t, timemlp_params_from_jax

MLP_NAMES = ("root_pose_mlp", "joint_angle_mlp", "vel_mlp", "torque_mlp",
             "residual_f_mlp")
PARAM_NAMES = ("global_q", "target_ke", "target_kd", "body_mass")


class phys_model:
    """Reference-compatible model surface (dp_model.py), serving subset:
    __init__(opts, dataloader, device), reinit_envs, get_batch_input,
    get_foot_height, init_global_q, load_checkpoint,
    load_params_from_jax."""

    def __init__(self, opts, dataloader, dt=5e-4, device=None):
        self.opts = opts
        self.device = default_device(device)
        self.dt = dt
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
        self.init_global_q()

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

    def _sim_params(self, params=None):
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
        )

    @torch.no_grad()
    def get_batch_input(self, params, steps_fr):
        """Targets + network predictions for a window (reference
        dp_model.py:611-662). steps_fr (E, S) fractional frames (float32
        tensor on the model's device). Returns a dict of tensors."""
        params = self.params if params is None else params
        E, S = steps_fr.shape
        amp = self._interp_amp(steps_fr)
        msm = parse_amp(amp)
        target_ja = msm["jang"][..., : self.n_dof]
        target_jad = msm["jvel"][..., : self.n_dof]
        target_q = torch.cat([msm["pos"], msm["orn"]], -1)
        target_qd = torch.cat([msm["vel"], msm["avel"]], -1)

        # ground alignment by the global SE(3)
        target_q = rotate_frame(params["global_q"], target_q)
        target_qd = rotate_frame_vel(params["global_q"], target_qd)

        flat = steps_fr.reshape(-1)
        torques = self._mlp("torque_mlp", flat).reshape(E, S, -1) * 0.0
        res_f = self._mlp("residual_f_mlp", flat).reshape(E, S, -1, 6)
        res_f = torch.cat([res_f[..., :3] * 10.0, res_f[..., 3:]], -1)
        res_f = res_f * 0.0  # disabled, parity with reference :529/:536
        delta_root = self._mlp("root_pose_mlp", flat).reshape(E, S, -1)
        delta_ja = self._mlp("joint_angle_mlp", flat).reshape(E, S, -1)
        state_qd = self._mlp("vel_mlp", flat).reshape(E, S, -1)

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
        self.params["global_q"] = self._t([0.0, -foot_height, 0.0, 0.0, 0.0, 0.0, 1.0])

    # ------------------------------------------------------------------
    # parameters from the JAX package
    # ------------------------------------------------------------------
    def load_params_from_jax(self, np_params):
        """Load a JAX parameter tree (dicts of numpy arrays, as the JAX
        package's ``save_checkpoint`` pickles it). Non-strict: keys absent
        from ``np_params`` keep their values."""
        for k in PARAM_NAMES:
            if k in np_params:
                self.params[k] = self._t(np.array(np_params[k], np.float32))
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
