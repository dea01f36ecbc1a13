"""Stand-ins for the lab4d neural fields the physics interface couples to
(PyTorch), counterpart of ``ppr_diffphys_tpu/models/fields.py``.

The physics cycle touches a narrow query surface of lab4d's fields
(reference dp_interface.py:381-466):
- ``get_camera(frame_id)``        field -> view SE(3) per frame
- ``get_field2world(inst_id)``    field -> world SE(3) per video
- ``logscale``                    learnable view-to-field log-scale
- articulation: ``get_vals(frame_id, return_so3=True)`` joint angles,
  ``compute_rel_rest_joints(inst_id)``, ``local_rest_coord``,
  ``logscale`` / ``orient`` / ``shift`` urdf-to-object alignment
- intrinsics: ``get_vals(frame_id)``

As in the JAX package, each field is a spec object (its sampler, its MLP
module, ``local_rest_coord``) and a parameter tree kept apart from it:
``init_params``, nested dicts of tensors whose MLP subtrees are
``mlp.module_params`` dicts, evaluated with ``torch.func.functional_call``.
The queries take the tree, so the interface can hold several copies of a
field's parameters (live, proxy, distilled) over one spec. Initial values
come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.func import functional_call

from ..ops import quat_normalize, quat_to_matrix
from .mlp import (
    CameraMLP,
    FrameSampler,
    TimeMLP,
    camera_matrix,
    fit_camera_mlp,
    module_params,
    resolve_num_freq_t,
    se3_matrix,
)


class CameraField:
    """SE(3)-over-time field with a learnable log-scale and per-video
    field-to-world transforms."""

    def __init__(self, frame_offset_raw, generator: torch.Generator, name="field"):
        self.name = name
        self.offsets = tuple(int(x) for x in frame_offset_raw)
        self.sampler = FrameSampler(self.offsets)
        n_vids = len(self.offsets) - 1
        nf = resolve_num_freq_t(6, self.sampler.max_ts)
        self.camera_mlp = CameraMLP(nf, n_vids, generator=generator)
        self.init_params: Dict[str, Any] = {
            "camera_mlp": module_params(self.camera_mlp),
            "logscale": torch.zeros(()),
            # per-video field->world SE(3) as (V, 7) [t, quat xyzw]
            "field2world": torch.tensor([[0.0, 0, 0, 0, 0, 0, 1.0]]).repeat(n_vids, 1),
        }

    @property
    def frame_offset_raw(self):
        return np.asarray(self.offsets)

    def get_camera(self, params, frame_id):
        """(N,) raw frame ids -> (N,4,4) field-to-view transforms; the
        translations scale with exp(logscale) (lab4d's view-to-field scale,
        which the interface's correct_scale walks)."""
        t = self.sampler.frame_to_tid(frame_id)
        vid = self.sampler.frame_to_vid(frame_id)
        quat, trans = functional_call(self.camera_mlp, params["camera_mlp"], (t, vid))
        return camera_matrix(quat, trans * torch.exp(params["logscale"]))

    def get_field2world(self, params, inst_id):
        vec = params["field2world"][inst_id]
        return se3_matrix(quat_to_matrix(quat_normalize(vec[..., 3:7])), vec[..., :3])

    def fit_to_priors(self, params, rtmat, **kw):
        """Fit the camera MLP to (N,4,4) per-frame SE(3) priors (reference
        CameraMLPWrapper.mlp_init)."""
        params = dict(params)
        params["camera_mlp"] = fit_camera_mlp(
            self.camera_mlp, params["camera_mlp"], self.sampler, rtmat, **kw)
        return params


class ArticulationField:
    """Joint-angle-over-time field + urdf-to-object alignment (the slice of
    lab4d's ``object_field.warp.articulation`` the interface needs)."""

    def __init__(self, frame_offset_raw, robot, generator: torch.Generator):
        self.offsets = tuple(int(x) for x in frame_offset_raw)
        self.sampler = FrameSampler(self.offsets)
        n_vids = len(self.offsets) - 1
        nf = resolve_num_freq_t(6, self.sampler.max_ts)
        self.n_dof = robot.num_dofs
        self.num_bones = robot.num_bones
        self.mlp = TimeMLP(nf, n_vids, self.n_dof, generator=generator)

        # rest joint coordinates relative to the parent link (J, 3) from the
        # robot template; local_rest_coord mirrors lab4d's per-joint rest
        # SE(3)s (identity rotations)
        rest_joints = np.asarray(robot.joints, np.float64)
        local_rest = np.tile(np.eye(4)[None], (len(rest_joints), 1, 1))
        local_rest[:, :3, 3] = rest_joints
        self.local_rest_coord = torch.as_tensor(local_rest, dtype=torch.float32)

        self.init_params: Dict[str, Any] = {
            "mlp": module_params(self.mlp),
            "logscale": torch.zeros(()),
            "orient": torch.tensor([1.0, 0.0, 0.0, 0.0]),  # wxyz
            "shift": torch.zeros(3),
            "rest_offsets": torch.zeros((len(rest_joints), 3)),
        }

    def get_vals(self, params, frame_id, return_so3=True):
        t = self.sampler.frame_to_tid(frame_id)
        vid = self.sampler.frame_to_vid(frame_id)
        return functional_call(self.mlp, params["mlp"], (t, vid))

    def compute_rel_rest_joints(self, params, inst_id):
        """Per-instance rest joint positions (reference
        dp_interface.py:452): the template's plus learnable offsets."""
        base = self.local_rest_coord[:, :3, 3].to(params["rest_offsets"].device)
        out = base + params["rest_offsets"]
        return out.expand(inst_id.shape + out.shape)


class ObjectField(CameraField):
    """Camera field + articulation sub-field (lab4d's ``object_field``
    slice: ``get_camera``, ``logscale``, ``warp.articulation``)."""

    def __init__(self, frame_offset_raw, robot, generator: torch.Generator,
                 name="object_field"):
        super().__init__(frame_offset_raw, generator, name=name)
        self.articulation_spec = ArticulationField(frame_offset_raw, robot, generator)
        self.init_params["articulation"] = self.articulation_spec.init_params


class IntrinsicsField:
    """Per-frame pinhole intrinsics (lab4d's intrinsics.get_vals)."""

    def __init__(self, frame_offset_raw, fx=1000.0):
        n = int(frame_offset_raw[-1])
        self.init_params = {"ks": torch.tensor([[fx, fx, 0.0, 0.0]]).repeat(n, 1)}

    def get_vals(self, params, frame_id):
        """Intrinsics of each frame; an index past either end takes the
        nearest frame's, as JAX's gather clamps (a negative index counts
        from the end first, as in jnp indexing)."""
        ks = params["ks"]
        i = frame_id.to(torch.long)
        i = torch.where(i < 0, i + ks.shape[0], i).clamp(0, ks.shape[0] - 1)
        return ks[i]
