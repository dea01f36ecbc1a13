"""Autodiff helpers (PyTorch), counterpart of
``ppr_diffphys_tpu/utils/autodiff.py`` (reference diffphys/torch_utils.py:
24-47): ``compute_gradient``, the per-sample Jacobian of a batched function
(the reference differentiates pose MLPs with respect to time for velocity
estimates), here ``torch.func.vmap`` of ``torch.func.jacfwd``.
"""

from __future__ import annotations

import torch


def compute_gradient(fn, x: torch.Tensor) -> torch.Tensor:
    """Jacobian of a batched function.

    fn: maps (N, D_in) -> (N, D_out); x: (N, D_in).
    Returns (N, D_in, D_out), the JAX package's (and the reference's)
    layout."""

    def single(xi):
        return fn(xi[None])[0]

    jac = torch.func.vmap(torch.func.jacfwd(single))(x)  # (N, D_out, D_in)
    return jac.transpose(-1, -2)
