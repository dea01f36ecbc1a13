"""Stand-ins for live lab4d torch fields: plain torch modules with lab4d's
state-dict layout (TimeMLPWrapper / CameraMLPWrapper keys,
reference torch_utils.py:116-304) and the field surface phys_interface
reads (dp_interface.py:17-36, :381-466): ``field.camera_mlp`` (with
``time_embedding.frame_offset_raw``), ``field.logscale``,
``field.field2world`` and ``field.warp.articulation`` (``mlp``,
``logscale``, ``orient`` wxyz, ``shift``, ``rest_offsets``).

They carry weights only (no forward): the adapters of both packages read
their state dicts, so the JAX adapter and the port's can be held against
each other without lab4d's own modules. Weights come from a seeded numpy
generator.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _linear(rng, n_in, n_out):
    lin = nn.Linear(n_in, n_out)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(rng.normal(0, 1 / np.sqrt(n_in), (n_out, n_in)),
                                      dtype=torch.float32))
        lin.bias.copy_(torch.tensor(rng.normal(0, 0.1, n_out), dtype=torch.float32))
    return lin


class _InstEmbedding(nn.Module):
    def __init__(self, rng, num_inst, W):
        super().__init__()
        self.mapping = nn.Embedding(num_inst, W)
        with torch.no_grad():
            self.mapping.weight.copy_(torch.tensor(rng.normal(0, 1, (num_inst, W)),
                                                   dtype=torch.float32))


class _TimeEmbedding(nn.Module):
    def __init__(self, rng, offsets, num_freq_t, W):
        super().__init__()
        self.frame_offset_raw = np.asarray(offsets)
        self.mapping1 = _linear(rng, 1 + 2 * num_freq_t, W)
        self.inst_embedding = _InstEmbedding(rng, len(offsets) - 1, W)
        self.mapping2 = _linear(rng, 2 * W, W)


class _Trunk(nn.Module):
    """time_embedding + linear_<i>.0 (skips at 1-4) + linear_final.0, D=5."""

    def __init__(self, rng, offsets, num_freq_t, W=256, D=5, skips=(1, 2, 3, 4)):
        super().__init__()
        self.time_embedding = _TimeEmbedding(rng, offsets, num_freq_t, W)
        for i in range(D):
            setattr(self, "linear_%d" % (i + 1),
                    nn.Sequential(_linear(rng, 2 * W if i in skips else W, W)))
        self.linear_final = nn.Sequential(_linear(rng, W, W))


class TimeMLPWrapper(_Trunk):
    def __init__(self, rng, offsets, num_freq_t, out_channels):
        super().__init__(rng, offsets, num_freq_t)
        self.head = nn.Sequential(_linear(rng, 256, out_channels))


class CameraMLPWrapper(_Trunk):
    def __init__(self, rng, offsets, num_freq_t):
        super().__init__(rng, offsets, num_freq_t)
        self.trans = nn.Sequential(_linear(rng, 256, 3))
        self.quat = nn.Sequential(_linear(rng, 256, 4))
        q = rng.normal(0, 1, (len(offsets) - 1, 4))
        self.base_quat = nn.Parameter(torch.tensor(q / np.linalg.norm(q, axis=-1,
                                                                      keepdims=True),
                                                   dtype=torch.float32))


class Articulation(nn.Module):
    def __init__(self, rng, offsets, num_freq_t, n_dof, n_joints):
        super().__init__()
        self.mlp = TimeMLPWrapper(rng, offsets, num_freq_t, n_dof)
        f = lambda *shape, s=1.0: nn.Parameter(
            torch.tensor(rng.normal(0, s, shape), dtype=torch.float32))
        self.logscale = f(1, s=0.1)
        self.orient = nn.Parameter(torch.tensor([1.0, 0.02, -0.01, 0.03]))
        self.shift = f(3, s=0.05)
        self.rest_offsets = f(n_joints, 3, s=1e-2)


class _Warp(nn.Module):
    def __init__(self, articulation):
        super().__init__()
        self.articulation = articulation


class Field(nn.Module):
    """A lab4d field: camera MLP, logscale, field2world, and the
    articulation when ``articulation`` is given (an object field)."""

    def __init__(self, rng, offsets, num_freq_t, articulation=None):
        super().__init__()
        self.camera_mlp = CameraMLPWrapper(rng, offsets, num_freq_t)
        self.logscale = nn.Parameter(torch.tensor([rng.normal(0, 0.1)], dtype=torch.float32))
        f2w = np.concatenate([rng.normal(0, 0.2, (len(offsets) - 1, 3)),
                              rng.normal(0, 1, (len(offsets) - 1, 4))], -1)
        f2w[:, 3:] /= np.linalg.norm(f2w[:, 3:], axis=-1, keepdims=True)
        self.field2world = nn.Parameter(torch.tensor(f2w, dtype=torch.float32))
        if articulation is not None:
            self.warp = _Warp(articulation)


def build_fields(offsets, num_freq_t, n_dof, n_joints, seed=0):
    """(scene_field, object_field) stand-ins with seeded weights."""
    rng = np.random.default_rng(seed)
    scene = Field(rng, offsets, num_freq_t)
    obj = Field(rng, offsets, num_freq_t,
                Articulation(rng, offsets, num_freq_t, n_dof, n_joints))
    return scene, obj
