"""The slice as a whole: the port's RolloutServer (device="cpu", i.e. the
plain window) against the JAX package's RolloutServer (engine="xla") on a1
with the committed clip, after carrying the JAX parameters across — on
grid starts (grid prologue) and on fractional / out-of-range starts
(per-env prologue, linear extrapolation) — plus init_global_q, loading a
JAX pickle checkpoint, the frame_start checks, and a check that the port
imports neither jax nor the JAX package.

Tolerance: 2 frame intervals of 33 substeps through the same fp32 math;
frame states agree to 1e-5 (measured ~3e-7).
"""

import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from ppr_diffphys_tpu.models.serve import RolloutServer as JServer
from ppr_diffphys_torch.models.serve import RolloutServer as TServer

import port_helpers as H

E, F = 4, 3
TOL = 1e-5
REPO = os.path.dirname(H.TESTS_DIR)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    opts = H.serve_opts(logroot=str(tmp_path_factory.mktemp("logs")))
    js = JServer(opts, num_envs=E, frames=F, engine="xla")
    ts = TServer(opts, num_envs=E, frames=F, device="cpu")
    return js, ts


def _sync(js, ts):
    ts.model.load_params_from_jax(jax.tree.map(np.asarray, js.model.params))


@pytest.mark.parametrize("starts", [
    [0.0, 1.0, 7.0, 45.0],        # grid prologue
    [0.0, 1.5, 2.25, 30.1],       # fractional: per-env prologue
    [-0.5, 3.0, 46.0, 47.5],      # out of range: linear extrapolation
], ids=["grid", "fractional", "out_of_range"])
def test_rollout_matches_jax(servers, starts):
    js, ts = servers
    _sync(js, ts)
    fs = np.asarray(starts, np.float32)
    want = np.asarray(js.rollout(fs))
    got = ts.rollout(fs)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == (F, E, 13, 7) == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # the robot moved between frames (the window really simulated)
    assert np.abs(got[-1] - got[0]).max() > 1e-3


def test_init_global_q_matches_jax(servers):
    js, ts = servers
    _sync(js, ts)
    js.model.init_global_q()
    ts.model.init_global_q()
    np.testing.assert_allclose(
        ts.model.params["global_q"].numpy(), np.asarray(js.model.params["global_q"]),
        atol=1e-6, rtol=0,
    )
    for s in (js, ts):  # init_global_q re-windows the model to 1 env
        s.model.reinit_envs(E, frames_per_wdw=F, is_eval=True)


def test_jax_checkpoint_loads_into_port(servers, tmp_path):
    """A JAX save_checkpoint pickle (numpy trees, readable without jax)
    gives the port the JAX rollout."""
    js, ts = servers
    rng = np.random.RandomState(4)
    js.model.params["body_mass"] = js.model.params["body_mass"] * (
        1.0 + 0.1 * rng.rand(13).astype(np.float32))
    js.model.save_checkpoint(7)
    path = os.path.join(js.model.save_dir, "ckpt_phys_0007.pth")
    assert os.path.exists(path)
    ts.load_checkpoint(path)
    np.testing.assert_array_equal(
        ts.model.params["body_mass"].numpy(), np.asarray(js.model.params["body_mass"]))
    fs = np.array([0.0, 2.0, 4.0, 6.0], np.float32)
    np.testing.assert_allclose(ts.rollout(fs).numpy(), np.asarray(js.rollout(fs)),
                               atol=TOL, rtol=0)


def test_frame_start_checks(servers):
    _, ts = servers
    with pytest.raises(ValueError, match="frame_start shape"):
        ts.rollout(np.zeros(E + 1))
    with pytest.raises(ValueError, match="frame_start shape"):
        ts.rollout(np.zeros((E, 1)))
    with pytest.raises(ValueError, match="exceeds the sequence"):
        TServer(H.serve_opts(), num_envs=2, frames=49, device="cpu")


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing falls back here")
    with pytest.raises(RuntimeError, match="cuda"):
        TServer(H.serve_opts(), num_envs=2, frames=3)


def test_port_imports_no_jax():
    """Every module of ppr_diffphys_torch imports with jax and the JAX
    package made unimportable."""
    code = r"""
import sys, pkgutil, importlib
for name in ("jax", "jaxlib", "flax", "optax", "ppr_diffphys_tpu"):
    sys.modules[name] = None
import ppr_diffphys_torch
mods = [m.name for m in pkgutil.walk_packages(ppr_diffphys_torch.__path__, "ppr_diffphys_torch.")]
for m in mods:
    importlib.import_module(m)
bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ppr_diffphys_tpu") and sys.modules[n] is not None]
assert not bad, bad
print(" ".join(mods))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = out.stdout.split()
    assert len(mods) >= 41
    for m in ("sim.soa_grad", "models.losses", "models.phys_model", "main", "bench",
              "utils.h100", "models.fields", "models.interface", "utils.autodiff",
              "utils.vis", "utils.render", "utils.io", "utils.projection", "utils.colors",
              "models.torch_adapter", "render_intermediate", "parallel.sharding"):
        assert "ppr_diffphys_torch." + m in mods, m
