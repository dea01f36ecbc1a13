"""ppr_diffphys_torch — the PyTorch/CUDA port of ``ppr_diffphys_tpu``.

A second package beside the JAX one, with the same module layout so each
counterpart sits at the same relative path. It imports torch, numpy and
scipy only: never jax, flax, optax or ``ppr_diffphys_tpu`` (whose
``__init__`` imports jax), so it keeps its own copies of the numpy-only
host modules (URDF parser, model builder, mocap loader, config).

Plain tensor math is PyTorch; the simulator's hot loops are hand-written
CUDA kernels (``csrc/``: the serving window, the training interval pair,
also with live joint anchors for the lab4d coupling of
``models/interface.py``, and the bench rollout) with plain PyTorch versions
beside them (``sim/integrator.py``) that CPU tensors take.

Entry points take ``device=`` and default to ``"cuda"``; asking for cuda
without a GPU raises instead of falling back to the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

# The stiff attach springs (joint_attach_ke=16e3 at dt=5e-4) do not
# survive TF32 matmul inputs, the same reason the JAX package pins float32
# matmul precision (ppr_diffphys_tpu/__init__.py:24-30).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

DEFAULT_DEVICE = "cuda"


def default_device(device=None) -> _torch.device:
    """Resolve an entry point's ``device=`` argument (None -> cuda).

    Raises when CUDA is asked for and absent: nothing silently runs on the
    CPU unless the caller says ``device="cpu"``."""
    dev = _torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "device=%r requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path" % str(dev)
        )
    return dev
