"""Time-conditioned MLPs (PyTorch), counterpart of
``ppr_diffphys_tpu/models/mlp.py``.

- ``posenc``: Fourier embedding with the optional cosine annealing window;
- ``TimeMLP``: TimeEmbedding (fourier -> linear, concat per-video instance
  code -> linear) + trunk with skip connections + scaled output head, with
  the state-dict keys of the reference's torch TimeMLPWrapper
  (``time_embedding.mapping1.*``, ``time_embedding.inst_embedding.mapping.weight``,
  ``linear_<i>.0.*``, ``linear_final.0.*``, ``head.0.*``), so the keys
  written by ``ppr_diffphys_tpu.models.torch_adapter.timemlp_state_to_torch``
  load directly; inside ``parallel.sharding.tp_scope`` the embedding and
  trunk layers split their output features over tp;
- ``CameraMLP``: the same embedding and trunk with SE(3)-valued heads
  (``trans``, ``quat``) and per-video base quaternions (``CameraMLPFlax``),
  and ``fit_camera_mlp``, its Adam fit to per-frame SE(3) priors;
- ``FrameSampler``: raw (possibly fractional) frame ids -> normalized time
  and video id on the device;
- ``timemlp_params_from_jax``: a flax TimeMLP parameter tree of numpy
  arrays (as the JAX package pickles it) -> a ``TimeMLP`` state dict, and
  ``timemlp_params_to_jax`` the other way (``cameramlp_params_from_jax`` /
  ``cameramlp_params_to_jax`` for CameraMLP); ``jax_param_path`` names each
  tensor by its flax path (the JAX package's per-tensor names).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..parallel.sharding import tp_linear


def posenc(x: torch.Tensor, n_freqs: int, alpha: Optional[float] = None) -> torch.Tensor:
    """(..., C) -> (..., C*(1+2*n_freqs)): [x, sin(2^k x), cos(2^k x), ...]."""
    if n_freqs == -1:
        return x[..., :0]
    if n_freqs == 0:
        return x
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    sig = x[..., None, :] * freqs[:, None]  # (..., n_freqs, C)
    bands = torch.stack([torch.sin(sig), torch.cos(sig)], dim=-2)  # (..., n, 2, C)
    if alpha is not None:
        aw = alpha * n_freqs - torch.arange(n_freqs, dtype=x.dtype, device=x.device)
        window = 0.5 * (1 + torch.cos(math.pi * torch.clamp(aw, 0.0, 1.0) + math.pi))
        bands = bands * window[:, None, None]
    out_bands = bands.reshape(bands.shape[:-3] + (-1,))
    return torch.cat([x, out_bands], dim=-1)


@dataclass(frozen=True)
class FrameSampler:
    """Static frame bookkeeping; methods are device tensor math.

    frame_offset_raw: (V+1,) cumulative raw frame counts per video."""

    frame_offset_raw: tuple
    time_scale: float = 1.0

    @property
    def offsets(self):
        return np.asarray(self.frame_offset_raw)

    @property
    def num_vids(self):
        return len(self.frame_offset_raw) - 1

    @property
    def max_ts(self):
        off = self.offsets
        return int((off[1:] - off[:-1]).max())

    def _off(self, like):
        return torch.as_tensor(self.offsets, dtype=torch.float32, device=like.device)

    def frame_to_vid(self, frame_id: torch.Tensor) -> torch.Tensor:
        """Video id of (possibly fractional) raw frame ids."""
        off = self._off(frame_id)
        vid = torch.searchsorted(off, frame_id.to(torch.float32).contiguous(), right=True) - 1
        return torch.clamp(vid, 0, self.num_vids - 1)

    def frame_to_tid(self, frame_id: torch.Tensor) -> torch.Tensor:
        """Normalized in-video time in [-1, 1] * time_scale."""
        off = self._off(frame_id)
        vid = self.frame_to_vid(frame_id)
        vstart = off[vid]
        vlen = off[vid + 1] - off[vid]
        tid = (frame_id.to(torch.float32) - vstart - vlen / 2) / self.max_ts * 2
        return tid * self.time_scale


def resolve_num_freq_t(num_freq_t: int, max_ts: int) -> int:
    """Frequency count scaled to sequence length: num_frames=64 -> freq 6."""
    if num_freq_t <= 0:
        return num_freq_t
    return int(np.rint(np.log2(max_ts / 64.0) + num_freq_t))


def _init_linear(lin: nn.Linear, gen: torch.Generator):
    """LeCun-normal weights and zero bias (flax Dense's default scale)."""
    with torch.no_grad():
        lin.weight.normal_(0.0, 1.0 / math.sqrt(lin.in_features), generator=gen)
        lin.bias.zero_()


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``lin(x)``, its output features split over tp inside
    ``parallel.sharding.tp_scope`` (the trunk and time-embedding layers)."""
    return tp_linear(x, lin.weight, lin.bias)


class _InstEmbedding(nn.Module):
    def __init__(self, num_inst: int, dim: int):
        super().__init__()
        self.mapping = nn.Embedding(num_inst, dim)


class TimeEmbedding(nn.Module):
    """fourier(t) -> mapping1; concat instance code -> mapping2."""

    def __init__(self, num_freq_t: int, num_inst: int, out_channels: int = 256):
        super().__init__()
        self.num_freq_t = num_freq_t
        self.num_inst = num_inst
        in_ch = 1 + 2 * num_freq_t if num_freq_t > 0 else (1 if num_freq_t == 0 else 0)
        self.mapping1 = nn.Linear(in_ch, out_channels)
        self.inst_embedding = _InstEmbedding(max(num_inst, 1), out_channels)
        self.mapping2 = nn.Linear(2 * out_channels, out_channels)

    def forward(self, t_sample: torch.Tensor, inst_id: torch.Tensor) -> torch.Tensor:
        coeff = _linear(self.mapping1, posenc(t_sample[..., None], self.num_freq_t))
        ids = torch.zeros_like(inst_id) if self.num_inst == 1 else inst_id
        inst_code = self.inst_embedding.mapping(ids)
        return _linear(self.mapping2, torch.cat([coeff, inst_code], dim=-1))


class _TimeTrunk(nn.Module):
    """Time embedding -> D-layer ReLU trunk with skip concats and a final
    ReLU layer (the trunk TimeMLP and CameraMLP share). Defaults D=5,
    W=256, skips=(1,2,3,4)."""

    def __init__(self, num_freq_t: int, num_inst: int, D: int = 5, W: int = 256,
                 skips: Sequence[int] = (1, 2, 3, 4)):
        super().__init__()
        self.D, self.W = D, W
        self.skips = tuple(skips)
        self.time_embedding = TimeEmbedding(num_freq_t, num_inst, W)
        for i in range(D):
            in_ch = 2 * W if i in self.skips else W
            setattr(self, "linear_%d" % (i + 1), nn.Sequential(nn.Linear(in_ch, W)))
        self.linear_final = nn.Sequential(nn.Linear(W, W))

    def _init(self, generator: Optional[torch.Generator]):
        if generator is None:
            return
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _init_linear(m, generator)
            elif isinstance(m, nn.Embedding):
                with torch.no_grad():
                    m.weight.normal_(0.0, 1.0, generator=generator)

    def features(self, t_sample: torch.Tensor, inst_id: torch.Tensor) -> torch.Tensor:
        x = self.time_embedding(t_sample, inst_id)
        out = x
        for i in range(self.D):
            if i in self.skips:
                out = torch.cat([x, out], dim=-1)
            out = torch.relu(_linear(getattr(self, "linear_%d" % (i + 1))[0], out))
        return torch.relu(_linear(self.linear_final[0], out))


class TimeMLP(_TimeTrunk):
    """The trunk -> head, scaled by ``output_scale``."""

    def __init__(self, num_freq_t: int, num_inst: int, out_channels: int,
                 D: int = 5, W: int = 256, skips: Sequence[int] = (1, 2, 3, 4),
                 output_scale: float = 1.0, generator: Optional[torch.Generator] = None):
        super().__init__(num_freq_t, num_inst, D, W, skips)
        self.output_scale = output_scale
        self.head = nn.Sequential(nn.Linear(W, out_channels))
        self._init(generator)

    def forward(self, t_sample: torch.Tensor, inst_id: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(t_sample, inst_id)) * self.output_scale


def _quat_mul_wxyz(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def _unit(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-8)


class CameraMLP(_TimeTrunk):
    """SE(3)-valued time MLP with per-video base rotations (CameraMLPFlax,
    reference CameraMLPWrapper): the trunk -> ``trans`` (3) and ``quat``
    (4, normalized) heads, the quaternion composed with the video's
    normalized ``base_quat`` (wxyz, initialized to identity). Returns
    (quat wxyz, trans)."""

    def __init__(self, num_freq_t: int, num_inst: int, D: int = 5, W: int = 256,
                 skips: Sequence[int] = (1, 2, 3, 4),
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_freq_t, num_inst, D, W, skips)
        self.trans = nn.Linear(W, 3)
        self.quat = nn.Linear(W, 4)
        self.base_quat = nn.Parameter(torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(num_inst, 1))
        self._init(generator)

    def forward(self, t_sample: torch.Tensor, inst_id: torch.Tensor):
        feat = self.features(t_sample, inst_id)
        trans = self.trans(feat)
        quat = _unit(self.quat(feat))
        quat = _quat_mul_wxyz(quat, _unit(self.base_quat[inst_id]))
        return quat, trans


def module_params(module: nn.Module) -> dict:
    """A module's tensors as a plain dict (state-dict keys -> detached
    copies): the parameter trees the fields keep apart from their modules
    and evaluate with ``torch.func.functional_call``."""
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def camera_matrix(quat_wxyz: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion and (..., 3) translation -> (..., 4, 4) SE(3)
    with the normalized quaternion's rotation."""
    from ..ops import quat_normalize, quat_to_matrix

    q = torch.cat([quat_wxyz[..., 1:], quat_wxyz[..., :1]], -1)
    return se3_matrix(quat_to_matrix(quat_normalize(q)), trans)


def se3_matrix(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation and (..., 3) translation -> (..., 4, 4) (the JAX
    package writes these with ``.at[].set`` on a zero matrix)."""
    top = torch.cat([rot, trans[..., None]], -1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype, device=top.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def fit_camera_mlp(module: CameraMLP, params: dict, sampler: "FrameSampler", rtmat,
                   lr: float = 1e-3, termination_loss: float = 1e-4,
                   max_iters: int = 5000) -> dict:
    """Fit a CameraMLP's parameters (a ``module_params`` dict) to per-frame
    SE(3) priors rtmat (N,4,4) over all raw frames (fit_camera_mlp of the
    JAX package, reference TimeMLP.mlp_init + CameraMLPWrapper.base_init):
    ``base_quat`` from each video's first frame, then Adam on the mean
    squared error of the 4x4 matrices. The loss is read on the host once
    per chunk of 100 iterations (its last iteration's), where the fit stops
    below ``termination_loss``; the budget rounds up to whole chunks
    (max_iters=250 runs 300). Returns the fitted parameter dict."""
    from ..ops import matrix_to_quat

    CHUNK = 100
    dev = next(iter(params.values())).device
    rtmat = torch.as_tensor(rtmat, dtype=torch.float32, device=dev)
    n = rtmat.shape[0]
    frame_ids = torch.arange(n, dtype=torch.float32, device=dev)
    t, vid = sampler.frame_to_tid(frame_ids), sampler.frame_to_vid(frame_ids)
    starts = torch.as_tensor(np.asarray(sampler.offsets[:-1]), dtype=torch.long, device=dev)
    base_xyzw = matrix_to_quat(rtmat[starts, :3, :3])
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    with torch.no_grad():
        p["base_quat"].copy_(torch.cat([base_xyzw[..., 3:4], base_xyzw[..., 0:3]], -1))
    opt = torch.optim.Adam(list(p.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def loss_fn():
        quat, trans = torch.func.functional_call(module, p, (t, vid))
        return torch.mean((camera_matrix(quat, trans) - rtmat) ** 2)

    for _ in range(max(1, -(-max_iters // CHUNK))):
        for _ in range(CHUNK):
            loss = loss_fn()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        if float(loss.detach()) < termination_loss:
            break
    return {k: v.detach() for k, v in p.items()}


def _dense(p, key: str) -> dict:
    return {
        key + ".weight": torch.as_tensor(np.asarray(p["kernel"], np.float32).T.copy()),
        key + ".bias": torch.as_tensor(np.asarray(p["bias"], np.float32).copy()),
    }


def timemlp_params_from_jax(np_tree) -> dict:
    """Flax TimeMLP params (nested dicts of arrays) -> TimeMLP state dict.

    Flax ``Dense.kernel`` is (in, out) and transposes to torch's (out, in);
    ``Embed.embedding`` maps to ``inst_embedding.mapping.weight``."""
    te = np_tree["time_embedding"]
    sd = {}
    sd.update(_dense(te["mapping1"], "time_embedding.mapping1"))
    sd.update(_dense(te["mapping2"], "time_embedding.mapping2"))
    sd["time_embedding.inst_embedding.mapping.weight"] = torch.as_tensor(
        np.asarray(te["inst_embedding"]["embedding"], np.float32).copy()
    )
    for k, v in np_tree["trunk"].items():
        sd.update(_dense(v, k + ".0"))
    if "head" in np_tree:
        sd.update(_dense(np_tree["head"], "head.0"))
    return sd


def cameramlp_params_from_jax(np_tree) -> dict:
    """Flax CameraMLP params -> CameraMLP state dict: the TimeMLP layout
    without ``head``, the ``trans`` and ``quat`` Dense heads and
    ``base_quat`` (V, 4) as it is."""
    sd = timemlp_params_from_jax(np_tree)
    sd.update(_dense(np_tree["trans"], "trans"))
    sd.update(_dense(np_tree["quat"], "quat"))
    sd["base_quat"] = torch.as_tensor(np.asarray(np_tree["base_quat"], np.float32).copy())
    return sd


def jax_param_path(torch_key: str):
    """(flax path tuple, transposed) of a TimeMLP state-dict key: Dense
    ``weight`` is the transposed ``kernel``; trunk layers live under
    ``trunk``."""
    parts = torch_key.split(".")
    if parts[0] == "base_quat":
        return ("base_quat",), False
    if parts[0] == "time_embedding":
        if parts[1] == "inst_embedding":
            return ("time_embedding", "inst_embedding", "embedding"), False
        mod = ("time_embedding", parts[1])
    elif parts[0] in ("head", "trans", "quat"):
        mod = (parts[0],)
    else:  # linear_<i>.0 / linear_final.0
        mod = ("trunk", parts[0])
    leaf = parts[-1]
    return mod + ("kernel" if leaf == "weight" else "bias",), leaf == "weight"


def timemlp_params_to_jax(module) -> dict:
    """A ``TimeMLP``'s (or ``CameraMLP``'s) tensors, or its ``module_params``
    dict, as the flax parameter tree of numpy arrays that the JAX package
    pickles (inverse of ``timemlp_params_from_jax`` and
    ``cameramlp_params_from_jax``)."""
    sd = module.state_dict() if isinstance(module, nn.Module) else module
    tree = {}
    for k, v in sd.items():
        path, transposed = jax_param_path(k)
        a = v.detach().cpu().numpy()
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(a.T if transposed else a, order="C", copy=True)
    return tree

# a CameraMLP carries across the same way
cameramlp_params_to_jax = timemlp_params_to_jax
