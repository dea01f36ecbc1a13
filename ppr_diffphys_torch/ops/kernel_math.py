"""Polynomial transcendentals shared by the plain path and the CUDA kernel.

Counterpart of ``ppr_diffphys_tpu/ops/kernel_math.py`` with the same
coefficients (the minimax ``atan`` of Ukil et al., max error ~1e-5 rad on
[-1, 1]). The plain PyTorch path and ``csrc/soa_window.cu`` both use this
polynomial rather than ``torch.atan2``/``atan2f``, so the two stay close to
each other and to the JAX package.
"""

from __future__ import annotations

import math

import torch

_C1 = 0.99997726
_C3 = -0.33262347
_C5 = 0.19354346
_C7 = -0.11643287
_C9 = 0.05265332
_C11 = -0.01172120


def _atan_poly(t):
    """atan on |t| <= 1."""
    s = t * t
    return t * (
        _C1 + s * (_C3 + s * (_C5 + s * (_C7 + s * (_C9 + s * _C11))))
    )


def atan2(y, x):
    """Four-quadrant arctangent, polynomial."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    big = torch.maximum(ax, ay)
    small = torch.minimum(ax, ay)
    t = small / torch.clamp(big, min=1e-30)
    a = _atan_poly(t)
    # undo the min/max swap
    a = torch.where(ay > ax, 0.5 * math.pi - a, a)
    # quadrants
    a = torch.where(x < 0, math.pi - a, a)
    a = torch.where(y < 0, -a, a)
    return a


def asin(x):
    x = torch.clamp(x, -1.0, 1.0)
    return atan2(x, torch.sqrt(torch.clamp(1.0 - x * x, min=1e-30)))


def acos(x):
    return 0.5 * math.pi - asin(x)
