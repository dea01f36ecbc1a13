"""Torch-lab4d field adapter (PyTorch), counterpart of
``ppr_diffphys_tpu/models/torch_adapter.py``: live lab4d torch fields become
the port's ``models/fields.py`` (spec, params) pairs, and the port's params
go back into the live fields.

The reference's phys_interface consumes torch ``nn.Module`` fields from
lab4d (reference dp_interface.py:17-36); their camera and joint-angle MLPs
are the vendored CameraMLPWrapper / TimeMLPWrapper architectures
(torch_utils.py:116-304, lab4d_utils.py:137-521). The port's ``TimeMLP``
uses lab4d's state-dict keys, so a TimeMLP maps by a copy of its state
dict; the port's ``CameraMLP`` names its heads ``trans`` and ``quat`` where
lab4d has ``trans.0`` and ``quat.0``. The fields are read duck-typed:
``.camera_mlp`` (with ``.time_embedding.frame_offset_raw``), ``.logscale``,
optional ``.field2world`` (V, 7) and ``.warp.articulation`` (``.mlp``,
``.logscale``, ``.orient`` wxyz, ``.shift``, optional ``.rest_offsets``).
Plain numpy state dicts work too.

Key mapping (lab4d state-dict key -> port state-dict key):
  time_embedding.*, linear_<i>.0.*, linear_final.0.*, head.0.*  -> the same
  trans.0.{weight,bias} / quat.0.{weight,bias}                  -> trans.* / quat.*
  base_quat                                                     -> base_quat
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .mlp import CameraMLP, FrameSampler, TimeMLP

# the port's CameraMLP heads and their lab4d names
_CAMERA_HEADS = {"trans": "trans.0", "quat": "quat.0"}


def _np(v):
    """torch tensor / numpy -> float32 numpy."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def _t(v) -> torch.Tensor:
    return torch.tensor(_np(v))


def _infer_arch(sd: Dict[str, Any]) -> Tuple[int, int, int, int, tuple]:
    """(num_freq_t, num_inst, W, D, skips) from weight shapes: mapping1's
    in_features = 1 + 2*num_freq_t (the PosEmbedding of a scalar); skip
    layers are the trunk linears whose in_features exceed W."""
    m1 = _np(sd["time_embedding.mapping1.weight"])
    W = m1.shape[0]
    num_freq_t = (m1.shape[1] - 1) // 2
    num_inst = _np(sd["time_embedding.inst_embedding.mapping.weight"]).shape[0]
    D = 0
    while ("linear_%d.0.weight" % (D + 1)) in sd:
        D += 1
    skips = tuple(i for i in range(D) if _np(sd["linear_%d.0.weight" % (i + 1)]).shape[1] > W)
    return num_freq_t, num_inst, W, D, skips


def _trunk_keys(sd: Dict[str, Any]):
    return [k for k in sd if k.startswith(("time_embedding.", "linear_"))]


def timemlp_from_torch(state_dict: Dict[str, Any],
                       output_scale: float = 1.0) -> Tuple[TimeMLP, Dict[str, torch.Tensor]]:
    """TimeMLPWrapper state dict -> (TimeMLP module, its params: a
    ``module_params`` dict, loaded into the module too)."""
    sd = dict(state_dict)
    num_freq_t, num_inst, W, D, skips = _infer_arch(sd)
    params = {k: _t(sd[k]) for k in _trunk_keys(sd) + ["head.0.weight", "head.0.bias"]}
    module = TimeMLP(num_freq_t, num_inst, int(params["head.0.bias"].shape[0]), D=D, W=W,
                     skips=skips, output_scale=output_scale)
    module.load_state_dict(params)
    return module, params


def cameramlp_from_torch(state_dict: Dict[str, Any]) -> Tuple[CameraMLP, Dict[str, torch.Tensor]]:
    """CameraMLPWrapper state dict -> (CameraMLP module, its params)."""
    sd = dict(state_dict)
    num_freq_t, num_inst, W, D, skips = _infer_arch(sd)
    params = {k: _t(sd[k]) for k in _trunk_keys(sd)}
    for ours, theirs in _CAMERA_HEADS.items():
        for leaf in ("weight", "bias"):
            params["%s.%s" % (ours, leaf)] = _t(sd["%s.%s" % (theirs, leaf)])
    params["base_quat"] = _t(sd["base_quat"])
    module = CameraMLP(num_freq_t, num_inst, D=D, W=W, skips=skips)
    module.load_state_dict(params)
    return module, params


def sampler_from_torch(torch_time_mlp) -> FrameSampler:
    """FrameSampler matching a torch TimeMLP's time_embedding bookkeeping."""
    te = torch_time_mlp.time_embedding
    return FrameSampler(tuple(int(x) for x in np.asarray(te.frame_offset_raw)))


def _num_freq_t(module) -> int:
    return module.time_embedding.num_freq_t


def _check(what, got, want):
    """The JAX adapter's architecture checks, as errors that -O keeps."""
    if got != want:
        raise ValueError("torch field's %s is %s, the port's field has %s" % (what, got, want))


def articulation_params_from_torch(torch_art, art_spec):
    """Torch articulation module -> params of a fields.ArticulationField.

    ``torch_art`` is the ``object_field.warp.articulation`` surface the
    reference interface queries (dp_interface.py:400-466): a joint-angle
    TimeMLP as ``.mlp``, the urdf-to-object alignment ``logscale`` /
    ``orient`` (wxyz) / ``shift`` and optional per-joint ``rest_offsets``."""
    module, mlp_params = timemlp_from_torch(torch_art.mlp.state_dict())
    _check("joint-angle MLP num_freq_t", _num_freq_t(module), _num_freq_t(art_spec.mlp))
    _check("joint-angle MLP n_dof", module.head[0].out_features, art_spec.n_dof)
    params = dict(art_spec.init_params)
    params["mlp"] = mlp_params
    params["logscale"] = _t(torch_art.logscale).reshape(())
    params["orient"] = _t(torch_art.orient).reshape(4)
    params["shift"] = _t(torch_art.shift).reshape(3)
    if getattr(torch_art, "rest_offsets", None) is not None:
        params["rest_offsets"] = _t(torch_art.rest_offsets)
    return params


def object_field_from_torch(torch_field, robot, generator, name="object_field"):
    """Live torch lab4d object field -> (fields.ObjectField, params):
    ``.camera_mlp``, ``.logscale``, optional ``.field2world`` and
    ``.warp.articulation`` (see :func:`articulation_params_from_torch`).
    ``generator`` seeds the field's own initial values, as ``rng`` does in
    the JAX package."""
    from .fields import ObjectField

    sampler = sampler_from_torch(torch_field.camera_mlp)
    field = ObjectField(sampler.offsets, robot, generator, name=name)
    module, cam_params = cameramlp_from_torch(torch_field.camera_mlp.state_dict())
    _check("camera MLP num_freq_t", _num_freq_t(module), _num_freq_t(field.camera_mlp))
    params = dict(field.init_params)
    params["camera_mlp"] = cam_params
    params["logscale"] = _t(torch_field.logscale).reshape(())
    if getattr(torch_field, "field2world", None) is not None:
        params["field2world"] = _t(torch_field.field2world)
    params["articulation"] = articulation_params_from_torch(
        torch_field.warp.articulation, field.articulation_spec)
    return field, params


def scene_field_from_torch(torch_field, generator, name="scene_field"):
    """Live torch lab4d scene field -> (fields.CameraField, params)."""
    return camera_field_from_torch(
        torch_field.camera_mlp, generator, name=name, logscale=torch_field.logscale,
        field2world=getattr(torch_field, "field2world", None))


def camera_field_from_torch(torch_camera_mlp, generator, name: str = "field",
                            logscale=None, field2world=None):
    """A live torch CameraMLPWrapper as a fields.CameraField (spec, params)
    whose queries equal the torch get_vals(). logscale / field2world: values
    of the enclosing lab4d field (the camera MLP carries neither)."""
    from .fields import CameraField

    sampler = sampler_from_torch(torch_camera_mlp)
    field = CameraField(sampler.offsets, generator, name=name)
    module, cam_params = cameramlp_from_torch(torch_camera_mlp.state_dict())
    # the architecture must agree with what CameraField builds for this frame
    # layout (both derive num_freq_t the same way)
    _check("camera MLP num_freq_t", _num_freq_t(module), _num_freq_t(field.camera_mlp))
    params = dict(field.init_params)
    params["camera_mlp"] = cam_params
    if logscale is not None:
        params["logscale"] = _t(logscale).reshape(())
    if field2world is not None:
        params["field2world"] = _t(field2world)
    return field, params


# ---------------------------------------------------------------------------
# the other direction: the port's params -> lab4d state dicts (pushing the
# physics-refined proxy weights back into lab4d's DR cycle, the
# override_states_inv leg of the reference's alternation,
# dp_interface.py:352-372)
# ---------------------------------------------------------------------------

def timemlp_state_to_torch(params) -> Dict[str, np.ndarray]:
    """Inverse of :func:`timemlp_from_torch`: params -> a numpy state dict
    loadable into the vendored TimeMLPWrapper (the keys agree)."""
    return {k: _np(v).copy() for k, v in params.items()}


def cameramlp_state_to_torch(params) -> Dict[str, np.ndarray]:
    """Inverse of :func:`cameramlp_from_torch`."""
    out = {}
    for k, v in params.items():
        head, _, leaf = k.partition(".")
        out["%s.%s" % (_CAMERA_HEADS[head], leaf) if head in _CAMERA_HEADS else k] = \
            _np(v).copy()
    return out


def _load_into(torch_module, np_state: Dict[str, np.ndarray]):
    sd = torch_module.state_dict()
    for k, v in np_state.items():
        sd[k] = torch.as_tensor(v)
    torch_module.load_state_dict(sd)


def _copy_into(dst, value):
    with torch.no_grad():
        dst.copy_(_t(value).reshape(dst.shape))


def export_camera_field_to_torch(params, torch_field):
    """Write CameraField params back into a live torch field (the camera
    weights, logscale and field2world)."""
    _load_into(torch_field.camera_mlp, cameramlp_state_to_torch(params["camera_mlp"]))
    _copy_into(torch_field.logscale, params["logscale"])
    if getattr(torch_field, "field2world", None) is not None:
        _copy_into(torch_field.field2world, params["field2world"])


def export_object_field_to_torch(params, torch_field):
    """Write ObjectField params (the articulation's included) back into a
    live torch object field: the DP->DR hand-off."""
    export_camera_field_to_torch(params, torch_field)
    art, p = torch_field.warp.articulation, params["articulation"]
    _load_into(art.mlp, timemlp_state_to_torch(p["mlp"]))
    for k in ("logscale", "orient", "shift"):
        _copy_into(getattr(art, k), p[k])
    if getattr(art, "rest_offsets", None) is not None:
        _copy_into(art.rest_offsets, p["rest_offsets"])
