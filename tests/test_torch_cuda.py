"""The port's CUDA kernels on the card (marked ``cuda``; they skip on a
machine without a GPU, since a CUDA kernel has no CPU mode). This file
imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which configures jax.)
"""

import numpy as np
import pytest
import torch

from ppr_diffphys_torch.csrc import build as kbuild
from ppr_diffphys_torch.sim import integrator as tint
from ppr_diffphys_torch.sim import soa, synthetic
import ppr_diffphys_torch.sim.builder as tbuilder
import ppr_diffphys_torch.sim.import_urdf as timport
from ppr_diffphys_torch.sim.kinematics import eval_fk

import port_helpers as H

DT, SUB = 5e-4, 33


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the soa_window kernel has no CPU mode")


def _model(name):
    if name == "chain":
        return synthetic.chain_model()
    return H.a1_model(tbuilder, timport)


def _inputs(model, E, F, per_env, dev, seed=5):
    q, qd, tgt, act = synthetic.window_problem(model, E, SUB, F, seed)
    bq, bqd = eval_fk(model, torch.as_tensor(q), torch.as_tensor(qd))
    bq = synthetic.grounded(model, bq.numpy(), seed)
    ke, kd, mass, norm_I = synthetic.sim_params_np(model, E if per_env else None, seed)
    t = lambda x: torch.as_tensor(x, device=dev)
    I = t(norm_I) * t(mass)[..., None, None]
    params = tint.SimParams(t(mass), 1.0 / t(mass), I, torch.linalg.inv(I), t(ke), t(kd))
    state = tint.SimState(t(bq), bqd.to(dev))
    return state, t(tgt), t(act), params


def test_library_path_tracks_the_source():
    """The built library's name carries a hash of the source and flags, in
    the package's git-ignored build directory."""
    p = kbuild.library_path(soa.KERNEL)
    assert p.parent == kbuild.BUILD_DIR
    assert p.name.startswith("libsoa_window-") and p.suffix == ".so"
    assert "--use_fast_math" not in kbuild.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kbuild.NVCC_FLAGS


@pytest.mark.cuda
@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
@pytest.mark.parametrize("name", ["a1", "chain"])
def test_window_kernel_matches_plain(name, per_env):
    """Kernel vs plain on the card, 66 substeps with penetrating contacts.
    Tolerance: fp32 in another order (FMA contraction) drifts ~linearly with
    the substeps; measured q ~5e-7 after 99 substeps on an H100."""
    _need_gpu()
    dev = torch.device("cuda")
    model = _model(name)
    F = 3
    state, tgt, act, params = _inputs(model, 64, F, per_env, dev)
    integ = tint.SemiImplicitIntegrator(model)
    window = soa.SoaWindow(integ, DT, SUB, F)
    for acts in (act, None):
        out = window(state, tgt, acts, params)
        ref = tint.rollout(integ, params, state, tgt, acts, None, DT, SUB)
        torch.cuda.synchronize()
        for a, b, tol in zip(out, ref, (1e-5, 5e-3, 0.1, 0.5)):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=0, atol=tol)
    assert window.launches == 2


@pytest.mark.cuda
def test_server_on_cuda_runs_the_kernel():
    _need_gpu()
    from ppr_diffphys_torch.models.serve import RolloutServer

    server = RolloutServer(H.serve_opts(), num_envs=32, frames=4, device="cuda")
    out = server.rollout(np.arange(32) % 10)
    torch.cuda.synchronize()
    assert server.window.launches == 1
    assert out.is_cuda and out.shape == (4, 32, 13, 7)
    assert torch.isfinite(out).all()
