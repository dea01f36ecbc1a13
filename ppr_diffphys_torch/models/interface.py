"""phys_interface (PyTorch) — the lab4d DiffRen+DiffSim coupling layer,
counterpart of ``ppr_diffphys_tpu/models/interface.py`` (reference
diffphys/dp_interface.py), with the same API: ``phys_interface``,
``KinematicsProxy``, ``query_q``, ``query_ja``, the ``override_*`` state
syncs, per-video window sampling, foot-height-driven scene-scale
calibration and kinematics distillation.

The fields are ``models/fields.py``'s spec objects with parameter trees.
The interface's own parameters are one nested tree, ``params``, in the JAX
package's layout: the mocap model's top-level tensors, then
``object_field``, ``scene_field``, ``intrinsics``, ``kinematics_proxy``
(field copies + ``delta_root_mlp``/``delta_joint_angle_mlp``) and
``kinematics_distilled``; the MLP subtrees are ``module_params`` dicts,
evaluated with ``torch.func.functional_call`` on the spec's module (the
delta MLPs on the mocap model's ``root_pose_mlp``/``joint_angle_mlp``
modules, whose own weights then take no part). ``vel_mlp``, ``torque_mlp``
and ``residual_f_mlp`` stay modules, as in the mocap model.
``named_tensors`` names every tensor by its JAX path, so the lr routing,
the median queue and checkpoints work as there. Where the reference
live-mutates the simulator's anchors, ``query_ja`` gives a per-env
``joint_X_p`` that FK and the rollout take as an input (the interval
kernels' ``with_xp`` planes on CUDA), so gradients reach the rest-joint
parameters. ``override_*`` copy values into the existing tensors, so the
optimizer keeps its state per position in the tree, as optax's does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops import compose_delta, matrix_to_quat, quat_to_matrix, se3_mat2vec
from ..sim.kinematics import eval_fk
from ..utils import spans
from .losses import se3_loss
from .mlp import (
    cameramlp_params_from_jax,
    jax_param_path,
    module_params,
    se3_matrix,
    timemlp_params_from_jax,
    timemlp_params_to_jax,
)
from .phys_model import PARAM_NAMES, phys_model

# subtrees holding an MLP's module_params dict, and the modules that stay
CAMERA_SUBTREES = ("camera_mlp",)
TIMEMLP_SUBTREES = ("mlp", "delta_root_mlp", "delta_joint_angle_mlp")
MODULE_NAMES = ("vel_mlp", "torque_mlp", "residual_f_mlp")


def _is_mlp(key):
    return key in CAMERA_SUBTREES or key in TIMEMLP_SUBTREES


def tree_items(tree, prefix=""):
    """(dotted JAX name, tensor) of every tensor of a parameter tree; an MLP
    subtree's tensors are named by their flax paths."""
    out = []
    for k, v in tree.items():
        name = prefix + k
        if _is_mlp(k):
            out += [(name + "." + ".".join(jax_param_path(sk)[0]), t) for sk, t in v.items()]
        elif isinstance(v, dict):
            out += tree_items(v, name + ".")
        else:
            out.append((name, v))
    return out


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def copy_tree_(dst, src):
    """Copy src's values into dst's tensors, in place (no gradient)."""
    with torch.no_grad():
        for k, v in src.items():
            if isinstance(v, dict):
                copy_tree_(dst[k], v)
            else:
                dst[k].copy_(v)


def tree_to_jax(tree):
    """A parameter tree as the JAX package pickles it: numpy arrays, MLP
    subtrees as flax trees."""
    out = {}
    for k, v in tree.items():
        if _is_mlp(k):
            out[k] = timemlp_params_to_jax(v)
        elif isinstance(v, dict):
            out[k] = tree_to_jax(v)
        else:
            out[k] = v.detach().cpu().numpy().copy()
    return out


def interface_params_from_jax(np_tree):
    """The JAX interface's parameter tree (nested dicts of numpy arrays, as
    its ``save_checkpoint`` pickles it) in the port's layout: tensors, the
    CameraMLP trees of the fields (``camera_mlp``), the TimeMLP trees
    (``articulation.mlp``, the delta MLPs, ``vel_mlp``, ``torque_mlp``,
    ``residual_f_mlp``) as state dicts; CPU float32."""
    out = {}
    for k, v in np_tree.items():
        if k in CAMERA_SUBTREES:
            out[k] = cameramlp_params_from_jax(v)
        elif k in TIMEMLP_SUBTREES or k in MODULE_NAMES:
            out[k] = timemlp_params_from_jax(v)
        elif isinstance(v, dict):
            out[k] = interface_params_from_jax(v)
        else:
            out[k] = torch.tensor(np.asarray(v, np.float32))
    return out


def remat(fn, *args):
    """fn(*args), its intermediates recomputed in the backward pass instead
    of kept (activation checkpointing) while autograd records: the proxy's
    joint-angle MLPs run at every substep of every env (389k rows at 512
    envs x 24 frames), the fields and the other MLPs at every frame, where
    each 256-wide trunk would keep ~5k floats per row of layer inputs and
    activations. The values are the same."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def query_q(steps_fr, object_spec, object_params, scene_spec, scene_params,
            articulation_spec, articulation_params):
    """urdf->world transform chain with learnable scales (reference
    dp_interface.py:381-435):

    urdf_to_world = (scene_to_world @ scene_to_view^-1)
                    @ (object_to_view @ urdf_to_object), with translations
    rescaled into urdf units by view_to_obj_scale / urdf_to_obj_scale.
    Returns (urdf_to_world_vec (N,7) xyzw, world_to_view (N,4,4))."""
    vidid = scene_spec.sampler.frame_to_vid(steps_fr)
    view_to_obj_scale = torch.exp(object_params["logscale"])
    urdf_to_obj_scale = torch.exp(articulation_params["logscale"])

    obj_to_view = object_spec.get_camera(object_params, steps_fr)
    scene_to_view = scene_spec.get_camera(scene_params, steps_fr)
    scene_to_world = scene_spec.get_field2world(scene_params, vidid)
    world_to_view = scene_to_view @ torch.linalg.inv(scene_to_world)

    # urdf to object (urdf scale)
    orient = articulation_params["orient"]
    orient = orient / torch.clamp(torch.linalg.vector_norm(orient), min=1e-8)
    rmat = quat_to_matrix(torch.cat([orient[1:], orient[:1]]))
    urdf_to_object = se3_matrix(rmat, articulation_params["shift"] / urdf_to_obj_scale)

    # scales the translation column of a 4x4 by view_to_urdf_scale
    tcol = torch.zeros((4, 4), dtype=torch.bool, device=rmat.device)
    tcol[:3, 3] = True
    scale_t = torch.where(tcol, view_to_obj_scale / urdf_to_obj_scale,
                          torch.ones((), device=rmat.device))
    urdf_to_view = (obj_to_view * scale_t) @ urdf_to_object[None]
    world_to_view_surdf = world_to_view * scale_t
    urdf_to_world = torch.linalg.inv(world_to_view_surdf) @ urdf_to_view

    # cv -> gl coords (reference :425-429)
    cv2gl = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0], device=rmat.device))
    urdf_to_world = cv2gl[None] @ urdf_to_world
    world_to_view_surdf = world_to_view_surdf @ cv2gl.T[None]
    return se3_mat2vec(urdf_to_world), world_to_view_surdf


def query_ja(steps_fr, articulation_spec, articulation_params, n_links):
    """Predicted joint angles + live joint rest coordinates (reference
    dp_interface.py:438-466). Returns (pred_joints (N, n_dof),
    joint_X_p (N, B, 7))."""
    inst_id = articulation_spec.sampler.frame_to_vid(steps_fr)
    pred_joints = articulation_spec.get_vals(articulation_params, steps_fr, return_so3=True)

    rel_rest_joints = articulation_spec.compute_rel_rest_joints(articulation_params, inst_id)
    rel_rest_joints = rel_rest_joints / torch.exp(articulation_params["logscale"])
    rest_rmat = articulation_spec.local_rest_coord[None, :, :3, :3].to(rel_rest_joints.device)
    rest_quat = matrix_to_quat(rest_rmat)  # xyzw
    rest_quat = rest_quat.expand(rel_rest_joints.shape[:-1] + (4,))
    rel_rest_coords = torch.cat([rel_rest_joints, rest_quat], -1)

    # the first joint (free root) gets the identity anchor (reference :459-461)
    ident = torch.zeros(rel_rest_coords.shape[:-2] + (1, 7), device=rel_rest_coords.device)
    ident[..., 0, 6] = 1.0
    joint_X_p = torch.cat([ident, rel_rest_coords], -2)
    assert joint_X_p.shape[-2] == n_links, (joint_X_p.shape, n_links)
    return pred_joints, joint_X_p


class phys_interface(phys_model):
    """Reference dp_interface.py:17-325."""

    has_live_xp = True  # query_ja threads joint_X_p into every forward
    # the step keeps its activation checkpointing, field gathers and host
    # reads: it runs eagerly
    step_graph = False
    FRAME_KEYS = phys_model.FRAME_KEYS + ("world2view", "ks")

    def __init__(self, opts, model_dict, dt=5e-4, copy_weights=False, device=None):
        self.copy_weights = copy_weights
        super().__init__(opts, model_dict, dt, device)

    # -- data ----------------------------------------------------------
    def preset_data(self, model_dict):
        self.scene_field = model_dict["scene_field"]  # (spec, params)
        self.object_field = model_dict["object_field"]
        self.intrinsics = model_dict["intrinsics"]

        scene_spec, _ = self.scene_field
        self.frame_offset_raw = np.asarray(scene_spec.frame_offset_raw)
        self.frame_interval = model_dict["frame_interval"]
        self.frame_info = model_dict.get("frame_info")

        self.total_frames = int(self.frame_offset_raw[-1])
        self.steps_per_fr_interval = int(self.frame_interval / self.dt)

    def _finish_data(self):
        pass  # no mocap table in lab4d mode

    def init_global_q(self):
        # reference dp_interface.py:103-104: alignment is carried by the
        # field transforms
        self.reinit_envs(1, 1, is_eval=True)

    # -- networks ------------------------------------------------------
    def add_nn_modules(self):
        super().add_nn_modules()
        obj_spec, obj_params = self.object_field
        scn_spec, scn_params = self.scene_field
        intr_spec, intr_params = self.intrinsics
        self.object_spec = obj_spec
        self.scene_spec = scn_spec
        self.articulation_spec = obj_spec.articulation_spec
        self.intrinsics_spec = intr_spec

        copy = lambda tree: tree_map(
            lambda t: torch.as_tensor(t, dtype=torch.float32).detach().to(self.device).clone(),
            tree)
        root = module_params(self.modules["root_pose_mlp"])
        ja = module_params(self.modules["joint_angle_mlp"])
        # external field params (frozen except the logscales, see
        # get_lr_dict); the articulation params live inside object_field
        self.params["object_field"] = copy(obj_params)
        self.params["scene_field"] = copy(scn_params)
        self.params["intrinsics"] = copy(intr_params)
        # updated to minimize the physics loss (reference :40-47)
        self.params["kinematics_proxy"] = {
            "object_field": copy(obj_params),
            "scene_field": copy(scn_params),
            "delta_root_mlp": copy(root),
            "delta_joint_angle_mlp": copy(ja),
        }
        # distilled from physics to regularize diff rendering (:48-60)
        distilled = {"object_field": copy(obj_params), "scene_field": copy(scn_params)}
        if not self.copy_weights:
            distilled["delta_root_mlp"] = copy(root)
            distilled["delta_joint_angle_mlp"] = copy(ja)
        self.params["kinematics_distilled"] = distilled

    def get_lr_dict(self):
        """Reference dp_interface.py:106-163."""
        lr_base = self.opts["phys_learning_rate"]
        lr_explicit = lr_base * 10
        startwith, withmap = super().get_lr_dict()
        for k in ("root_pose_mlp", "joint_angle_mlp"):
            startwith.pop(k, None)
        startwith.update({
            "object_field": 0.0,
            "scene_field": 0.0,
            "intrinsics": 0.0,
            "kinematics_distilled": lr_base,
            "kinematics_proxy": lr_base,
        })
        withmap.update({
            "object_field.logscale": lr_explicit,
            "scene_field.logscale": lr_explicit,
        })
        return startwith, withmap

    def named_tensors(self):
        """(JAX path, tensor) of every parameter tensor: the top-level
        tensors, the three remaining modules, then the field trees (the
        root/joint-angle modules are only templates of the delta MLPs)."""
        out = [(k, self.params[k]) for k in PARAM_NAMES]
        for m in MODULE_NAMES:
            out += [(m + "." + ".".join(jax_param_path(k)[0]), t)
                    for k, t in self.modules[m].named_parameters()]
        trees = {k: v for k, v in self.params.items() if k not in PARAM_NAMES}
        return out + tree_items(trees)

    def state_np(self):
        """The parameter tree as the JAX interface's checkpoint pickles it."""
        out = {k: self.params[k].detach().cpu().numpy().copy() for k in PARAM_NAMES}
        for m in MODULE_NAMES:
            out[m] = timemlp_params_to_jax(self.modules[m])
        out.update(tree_to_jax({k: v for k, v in self.params.items() if k not in PARAM_NAMES}))
        return out

    def load_params_from_jax(self, np_params):
        """Load the JAX interface's parameter tree (numpy, as pickled) in
        place; keys absent from ``np_params`` keep their values."""
        tree = interface_params_from_jax(np_params)
        for k in PARAM_NAMES:
            if k in tree:
                self._set_param(k, tree[k].numpy())
        for m in MODULE_NAMES:
            if m in tree:
                self.modules[m].load_state_dict(tree[m])
        copy_tree_(self.params, {k: v for k, v in tree.items()
                                 if k not in PARAM_NAMES and k not in MODULE_NAMES
                                 and k in self.params})

    # -- proxy queries -------------------------------------------------
    def _delta(self, name, sub_params, steps_fr):
        sampler = self.samplers[name]
        return functional_call(self.modules[name], sub_params,
                               (sampler.frame_to_tid(steps_fr), sampler.frame_to_vid(steps_fr)))

    def _query_q(self, obj, scn, steps_fr):
        return remat(lambda f: query_q(f, self.object_spec, obj, self.scene_spec, scn,
                                       self.articulation_spec, obj["articulation"]), steps_fr)

    def _proxy_root(self, params, subtree, steps_fr):
        """KinematicsProxy.forward (reference :340-345)."""
        sub = params[subtree]
        out, _ = self._query_q(sub["object_field"], sub["scene_field"], steps_fr)
        if "delta_root_mlp" in sub:
            out = compose_delta(out, remat(
                lambda f: self._delta("root_pose_mlp", sub["delta_root_mlp"], f), steps_fr))
        return out

    def _proxy_ja(self, params, subtree, steps_fr):
        """KinematicsProxy.get_joint_angles (reference :374-378)."""
        sub = params[subtree]
        art = sub["object_field"]["articulation"]
        out = remat(lambda f: self.articulation_spec.get_vals(art, f, return_so3=True),
                    steps_fr)
        if "delta_joint_angle_mlp" in sub:
            out = out + remat(lambda f: self._delta(
                "joint_angle_mlp", sub["delta_joint_angle_mlp"], f), steps_fr)
        return out

    # -- state sync (reference :188-197) -------------------------------
    def override_control_ref_states(self):
        for k in ("object_field", "scene_field"):
            copy_tree_(self.params["kinematics_proxy"][k], self.params[k])

    def override_distilled_states(self):
        for k in ("object_field", "scene_field"):
            copy_tree_(self.params["kinematics_distilled"][k], self.params[k])

    def override_states_inv(self):
        for k in ("object_field", "scene_field"):
            copy_tree_(self.params[k], self.params["kinematics_distilled"][k])

    # -- window sampling over selected videos (reference :199-218) -----
    def compute_frame_start(self):
        off = self.frame_offset_raw
        phys_vid = self.opts.get("phys_vid", list(range(len(off) - 1)))
        u = torch.rand((self.num_envs,), generator=self.generator)
        starts = []
        for vidid in phys_vid:
            span = float(off[vidid + 1] - off[vidid] - self.frames_per_wdw)
            starts.append(torch.clamp(torch.round(u * span), min=0.0) + float(off[vidid]))
        starts = torch.cat(starts)
        perm = torch.randperm(starts.shape[0], generator=self.generator)
        return starts[perm[: self.num_envs]].to(torch.float32)

    # -- batch input (reference :220-249) ------------------------------
    def query_kinematics_groundtruth(self, params, steps_fr):
        E, S = steps_fr.shape
        flat = steps_fr.reshape(-1)
        art = params["object_field"]["articulation"]
        target_q, world2view = self._query_q(params["object_field"], params["scene_field"],
                                             flat)
        target_ja, joint_X_p = remat(
            lambda f: query_ja(f, self.articulation_spec, art, self.n_links), flat)
        ks = self.intrinsics_spec.get_vals(params["intrinsics"], flat)
        zeros = lambda n: torch.zeros((E, S, n), dtype=torch.float32, device=flat.device)
        return dict(
            target_q=target_q.reshape(E, S, -1),
            target_ja=target_ja.reshape(E, S, -1),
            target_qd=zeros(6),
            target_jad=zeros(target_ja.shape[-1]),
            world2view=world2view.reshape(E, S, 4, 4),
            ks=ks.reshape(E, S, -1),
            # anchors are per env (constant over the window): step 0's
            joint_X_p=joint_X_p.reshape(E, S, -1, 7)[:, 0],
        )

    def _frame_inputs(self, params, frames):
        """The entries that the step reads at the frames alone, queried at
        ``frames`` (E, F): the ground truth, the proxy's root and
        ``vel_mlp``."""
        E, F = frames.shape
        flat = frames.reshape(-1)
        batch = self.query_kinematics_groundtruth(params, frames)
        state_qd = remat(lambda f: self._mlp("vel_mlp", f), flat).reshape(E, F, -1)
        batch.update(
            queried_q=self._proxy_root(params, "kinematics_proxy", flat).reshape(E, F, -1),
            queried_qd=state_qd)
        return batch

    def _substep_inputs(self, params, steps_fr):
        """The entries that the step reads at every substep of ``steps_fr``
        (E, S): the proxy's joint angles and the zeroed torque and
        residual-force MLPs."""
        E, S = steps_fr.shape
        flat = steps_fr.reshape(-1)
        mlp = lambda name: remat(lambda f: self._mlp(name, f), flat)
        torques = mlp("torque_mlp").reshape(E, S, -1) * 0.0
        res_f = mlp("residual_f_mlp").reshape(E, S, -1, 6)
        res_f = torch.cat([res_f[..., :3] * 10.0, res_f[..., 3:]], -1) * 0.0
        return dict(
            queried_ja=self._proxy_ja(params, "kinematics_proxy", flat).reshape(E, S, -1),
            torques=torques, res_f=res_f)

    def get_batch_input(self, params, steps_fr):
        params = self.params if params is None else params
        batch = self._frame_inputs(params, steps_fr)
        batch.update(self._substep_inputs(params, steps_fr))
        return batch

    def _step_inputs(self, params, steps_fr):
        """The step's inputs with the ``FRAME_KEYS`` entries queried at the
        frame boundaries alone, where the step reads them, and the rest at
        every substep; the time-MLPs' rows counted as ``inputs.rows_frame``
        and ``inputs.rows_substep``. The rows left out took no part in the
        losses."""
        with spans.rows("inputs.rows_frame"):
            batch = self._frame_inputs(params, steps_fr[:, self._frame2step_t])
        with spans.rows("inputs.rows_substep"):
            batch.update(self._substep_inputs(params, steps_fr))
        return batch

    # -- distillation (reference :305-325 + dp_model.py:800-804) -------
    def _distilled_body_q(self, params, steps_fr):
        """FK (the model's anchors) of the distilled kinematics at frames
        steps_fr (E, F): (E, F, B, 7)."""
        E, F = steps_fr.shape
        flat = steps_fr.reshape(-1)
        droot = self._proxy_root(params, "kinematics_distilled", flat).reshape(E, F, -1)
        dja = self._proxy_ja(params, "kinematics_distilled", flat).reshape(E, F, -1)
        body_q, _ = eval_fk(self.env, torch.cat([droot, dja], -1))
        return body_q

    def _distill_rows(self, params, steps_fr, sim_position, outseq):
        if float(self.opts.get("pos_distill_wt", 0.0)) <= 0.0:
            return super()._distill_rows(params, steps_fr, sim_position, outseq)
        with spans.span("losses.distill"):
            body_q = self._distilled_body_q(params, steps_fr[:, self.frame2step])
            loss = se3_loss(body_q, sim_position.detach()).mean(-1)
            return torch.where(outseq, torch.zeros_like(loss), loss)

    @torch.no_grad()
    def get_distilled_kinematics(self, steps_fr):
        """FK-posed body trajectory of the distilled kinematics (reference
        dp_interface.py:305-325). steps_fr: (E, S) raw frame ids over the
        window, evaluated at the frame boundaries. Returns (F, E, B, 7)."""
        steps_fr = torch.as_tensor(np.asarray(steps_fr, np.float32), device=self.device)
        body_q = self._distilled_body_q(self.params, steps_fr[:, self.frame2step])
        self.distilled_trajs = body_q[0].cpu().numpy()
        return body_q.transpose(0, 1)

    # -- foot height via kp links (reference :251-277) ------------------
    def get_foot_height(self, state_body_q):
        kp_idxs = [self.env.body_name.index(n) for n in self.robot.urdf.kp_links]
        return state_body_q[..., kp_idxs, 1]

    @torch.no_grad()
    def get_foot_height_frame(self, frame_ids):
        fr = torch.as_tensor(np.asarray(frame_ids, np.float32), device=self.device)[None]
        batch = self.query_kinematics_groundtruth(self.params, fr)
        target_position, _ = self.fk_pos_vel(
            batch["target_q"], batch["target_ja"], batch["target_qd"], batch["target_jad"],
            joint_X_p=batch["joint_X_p"][:, None])
        return self.get_foot_height(target_position)[0].cpu().numpy()

    def correct_scale(self, frame_ids, increment=0.01, max_steps=2000):
        """Scale walk until the feet cross the ground (reference :279-303).
        max_steps caps the walk (the reference loops without a bound)."""
        self.reinit_envs(1, frames_per_wdw=int(self.frame_offset_raw[-1]), is_eval=True)
        foot_height = self.get_foot_height_frame(frame_ids)
        direction = 1 if foot_height.min() > 0 else -1
        for _ in range(max_steps):
            with torch.no_grad():
                for tree in (self.params["scene_field"],
                             self.params["kinematics_proxy"]["scene_field"],
                             self.params["kinematics_distilled"]["scene_field"]):
                    tree["logscale"].add_(increment * direction)
            foot_height = self.get_foot_height_frame(frame_ids)
            print("foot height:", foot_height.min())
            if foot_height.min() * direction < 0:
                break
        else:
            print("correct_scale: foot height did not cross zero within %d steps" % max_steps)

    def _extend_aux(self, aux, params, batch, steps_fr, sim_position):
        """Eval observables: the vis cameras (reference dp_interface.py:
        233-235) and the distilled trajectory."""
        aux["target_q_vis"] = batch["target_q"][0]
        aux["world2view_vis"] = batch["world2view"][0]
        aux["ks_vis"] = batch["ks"][0]
        if float(self.opts.get("pos_distill_wt", 0.0)) > 0.0:
            aux["distilled_traj"] = self._distilled_body_q(
                params, steps_fr[:1, self._frame2step_t])[0]
        return aux

    def _store_eval_aux(self, aux):
        super()._store_eval_aux(aux)
        self.target_q_vis = aux["target_q_vis"].cpu().numpy()
        self.world2view_vis = aux["world2view_vis"].cpu().numpy()
        self.ks_vis = aux["ks_vis"].cpu().numpy()
        if "distilled_traj" in aux:
            self.distilled_trajs = aux["distilled_traj"].cpu().numpy()

    def query(self, img_size=None):
        data = super().query()
        if hasattr(self, "distilled_trajs"):
            data["distilled_traj"] = self.distilled_trajs
        if img_size is not None:
            data["camera"] = self.get_camera()
            data["img_size"] = img_size
        return data


class KinematicsProxy:
    """Name-compatible view of a proxy parameter subtree (reference
    dp_interface.py:328-378): ``forward``/``__call__`` (root poses),
    ``get_joint_angles``, ``override_states`` and ``override_states_inv``
    over ``interface.params[subtree]``."""

    def __init__(self, interface: phys_interface, subtree: str = "kinematics_proxy"):
        self.interface = interface
        self.subtree = subtree

    def _frames(self, x):
        return torch.as_tensor(np.asarray(x, np.float32), device=self.interface.device)

    def forward(self, x):
        """x: (N,) raw frame ids -> (N, 7) root poses (reference :340-345)."""
        return self.interface._proxy_root(self.interface.params, self.subtree, self._frames(x))

    __call__ = forward

    def get_joint_angles(self, x):
        """x: (N,) raw frame ids -> (N, n_dof) (reference :374-378)."""
        return self.interface._proxy_ja(self.interface.params, self.subtree, self._frames(x))

    def override_states(self, object_field=None, scene_field=None):
        """Pull DR weights into the proxy (reference :347-350); with no
        arguments, from the interface's live field params."""
        p = self.interface.params
        sub = p[self.subtree]
        copy_tree_(sub["object_field"], p["object_field"] if object_field is None
                   else object_field)
        copy_tree_(sub["scene_field"], p["scene_field"] if scene_field is None else scene_field)

    def override_states_inv(self, object_field=None, scene_field=None):
        """Push proxy weights back into the DR fields (reference :352-372).
        Returns copies of the proxy's (object_field, scene_field) trees; with
        no arguments also writes them into the interface's live fields."""
        p = self.interface.params
        sub = p[self.subtree]
        if object_field is None and scene_field is None:
            copy_tree_(p["object_field"], sub["object_field"])
            copy_tree_(p["scene_field"], sub["scene_field"])
        clone = lambda tree: tree_map(lambda t: t.detach().clone(), tree)
        return clone(sub["object_field"]), clone(sub["scene_field"])
