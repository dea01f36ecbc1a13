"""Multi-GPU training of the port (parallel/sharding.py and the sharded
phys_model path) on the CPU: ranks are spawned processes joined by gloo
through a FileStore (tests/port_helpers.py: ``Ranks``, each run with a
timeout), against the port run in one process and the JAX package.

- The mesh choice (``_mesh_for``) against the JAX phys_model's on its
  virtual CPU devices, and ``param_shardings`` naming the same tensors.
- ``gather_envs`` and the tp-split linear against their unsharded
  counterparts, values and gradients (2 ranks).
- The a1 training step (4 envs, 3 frames, 33 substeps a frame, noise 0,
  the same frame starts): losses of 3 forward()+update() steps and the
  parameters after them at dp=2 (2 ranks) and dp=2,tp=2 (4 ranks) against
  the port in one process and the JAX package's model on the same weights;
  then one more step from frame starts and init noise drawn from the
  model's generator against the port in one process. With 4 ranks and 2
  envs, ranks 2 and 3 sit outside the mesh.
- The lab4d interface step at dp=2 against one process.
- Every rank's parameters bit-identical after the updates (compared here,
  and by each world's own ``replicas_agree`` checksum).
- The CLI at ``--ngpu 2 --mesh_shape dp=2``: rank 0 alone writes.

Tolerances. Sharded and unsharded runs compute the same fp32 functions in
other row blocks (each rank's MLP products, FK and rollout over its own
envs) and add the gradient in another order (each rank's env sum, then the
ranks'), so values differ by rounding: the port-to-JAX yardstick of
tests/test_torch_train.py holds, losses to rtol 1e-4 and parameters after
the updates to 1e-5 relative plus 1e-5 absolute (the lab4d step: see its
test), and every tensor's first-step gradient within 5e-4 of its largest
entry (Adam's steps do not scale with the gradient, so the parameters
alone would not show a gradient summed wrongly). The collectives themselves
move data unchanged: gather_envs and the split linear's values are held to
1e-6, their gradients to 1e-5 relative.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ppr_diffphys_tpu.data.amp_loader import DataLoader as JDataLoader
from ppr_diffphys_tpu.models.phys_model import phys_model as JModel
from ppr_diffphys_tpu.parallel import sharding as jsharding
from ppr_diffphys_torch.models import phys_model as tpm
from ppr_diffphys_torch.parallel import sharding

import port_helpers as H

REPO = os.path.dirname(H.TESTS_DIR)
LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds, with the single-process and JAX references computed
    while they run."""
    root = tmp_path_factory.mktemp("par")
    dp = H.Ranks(H.rank_dp, 2, root / "dp")
    tp = H.Ranks(H.rank_tp, 4, root / "tp")
    single = H.a1_train_run(str(root / "single"))
    single2 = H.a1_train_run(str(root / "single2"), envs=2)
    lab4d = H.lab4d_run(str(root / "lab4d"))

    opts = H.serve_opts(logroot=str(root / "jax"), num_rounds=1,
                        iters_per_round=H.TRAIN_STEPS + 1)
    jm = JModel(dict(opts), JDataLoader(opts))
    jm.params = jax.tree.map(jnp.asarray, single["init"])
    jm.reinit_envs(H.TRAIN_E, frames_per_wdw=H.TRAIN_F, is_eval=False)
    jlosses = []
    for i in range(H.TRAIN_STEPS):
        jlosses.append({k: float(v) for k, v in jm.forward(frame_start=H.TRAIN_STARTS).items()})
        if i == 0:
            jgrads0 = {jm._leaf_name(p): np.asarray(g) for p, g in
                       jax.tree_util.tree_flatten_with_path(jm._grad_accum[-1][0])[0]}
        jm.update()
    jparams = jax.tree.map(np.asarray, jm.params)
    dp_out = dp.join()
    tp_out = tp.join()
    return dict(dp=dp_out, tp=tp_out, single=single, single2=single2, lab4d=lab4d,
                jax=(jlosses, jparams, jgrads0), jm=jm)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _check_losses(got, want, n=None):
    for i, (g, w) in enumerate(zip(got[:n], want[:n])):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, atol=1e-9,
                                       err_msg="step %d %s" % (i, k))


def _check_params(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **PARAM_TOL)


def _check_grads(got, want, transpose=False):
    """Every tensor's first-step gradient within 5e-4 of its largest entry
    (the same parameters on both sides; Adam's steps do not scale with the
    gradient, so the parameters alone would not show a gradient summed
    wrongly)."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].T if transpose and k.endswith("kernel") else got[k]
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(g / scale, w / scale, atol=5e-4, rtol=0, err_msg=k)


def _check_replicas(outs):
    for o in outs[1:]:
        for k, v in _leaves(outs[0]["params"]).items():
            np.testing.assert_array_equal(_leaves(o["params"])[k], v, err_msg=k)
    assert all(o["agree"] for o in outs)


# ---------------------------------------------------------------------------
# the mesh choice and the tp names, against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_mesh_for_matches_jax(world, monkeypatch):
    """For num_envs (1, 2, 3, 8, 12), ngpu (-1, 1, 4) and mesh_shape (None,
    dp=2, tp=2, dp=2,tp=2): the port's _mesh_for gives JAX's (dp, tp), the
    JAX side on a stand-in whose devices are the first ``world`` of the 8
    virtual CPU devices, set up as JAX phys_model.__init__ sets them."""
    monkeypatch.setattr(sharding, "make_mesh", lambda shape, devices=None: dict(shape))
    for ngpu in (-1, 1, 4):
        for ms in (None, "dp=2", "tp=2", "dp=2,tp=2"):
            devs = jax.devices()[:world]
            if ngpu > 0:
                devs = devs[: min(ngpu, len(devs))]
            shape = sharding.parse_mesh_shape(ms)
            jstand = types.SimpleNamespace(
                _devices=devs, _tp=max(1, int(shape.get("tp", 1))),
                _dp_cap=int(shape["dp"]) if "dp" in shape else None, _mesh_cache={})
            budget, tp, cap = sharding.mesh_budget(ngpu, ms, world)
            tstand = types.SimpleNamespace(_budget=budget, _tp=tp, _dp_cap=cap, _mesh_cache={})
            for n in (1, 2, 3, 8, 12):
                jmesh = JModel._mesh_for(jstand, n)
                want = None if jmesh is None else (jmesh.shape["dp"], jmesh.shape.get("tp", 1))
                got = tpm.phys_model._mesh_for(tstand, n)
                got = None if got is None else (got["dp"], got.get("tp", 1))
                assert got == want, (world, ngpu, ms, n)


def test_param_shardings_match_jax(runs):
    """At tp=2 the port splits exactly the tensors JAX shards over tp, by
    JAX name (axis 0 of torch's (out, in) weight, JAX's axis 1)."""
    jm, model = runs["jm"], runs["single"]["model"]
    jmesh = jsharding.make_mesh({"dp": 4, "tp": 2})
    want = {jm._leaf_name(p) for p, s in jax.tree_util.tree_flatten_with_path(
        jsharding.param_shardings(jmesh, jm.params))[0] if "tp" in tuple(s.spec)}
    mesh = sharding.Mesh(dp=4, tp=2, rank=0, world=8)
    got = sharding.param_shardings(mesh, model.named_tensors())
    assert {n for n, ax in got.items() if ax is not None} == want
    assert len(want) > 30 and set(got) == set(jm._leaf_name(p) for p, _ in
                                               jax.tree_util.tree_flatten_with_path(jm.params)[0])
    assert all(ax is None for ax in sharding.param_shardings(
        sharding.Mesh(dp=8, tp=1, rank=0, world=8), model.named_tensors()).values())


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------
def test_gather_envs_matches_unsharded(runs):
    rng = np.random.RandomState(0)
    X, W = rng.randn(6, 5).astype(np.float32), rng.randn(6, 5).astype(np.float32)
    for full, g, rows in (o["gather"] for o in runs["dp"]):
        np.testing.assert_allclose(full, X, rtol=0, atol=1e-6)
        # one rank's slice of the gradient of the loss of every row: not
        # summed over the ranks
        np.testing.assert_allclose(g, (2 * W * X)[rows], rtol=1e-5, atol=0)


def test_split_linear_matches_unsharded(runs):
    rng = np.random.RandomState(0)
    rng.randn(6, 5), rng.randn(6, 5)
    x = torch.tensor(rng.randn(7, 8).astype(np.float32), requires_grad=True)
    w = torch.tensor(rng.randn(6, 8).astype(np.float32), requires_grad=True)
    b = torch.tensor(rng.randn(6).astype(np.float32), requires_grad=True)
    v = torch.tensor(rng.randn(7, 6).astype(np.float32))
    y = torch.nn.functional.linear(x, w, b)
    gx, gw, gb = torch.autograd.grad((v * torch.relu(y)).sum(), (x, w, b))
    for r, (ys, gxs, gws, gw_sum, gb_sum) in enumerate(o["split"] for o in runs["dp"]):
        np.testing.assert_allclose(ys, y.detach().numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(gxs, gx.numpy(), rtol=1e-5, atol=1e-6)
        # each rank's weight gradient holds its own output rows only
        rows = slice(3 * r, 3 * r + 3)
        np.testing.assert_allclose(gws[rows], gw.numpy()[rows], rtol=1e-5, atol=1e-6)
        assert not np.delete(gws, np.arange(6)[rows], 0).any()
        np.testing.assert_allclose(gw_sum, gw.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gb_sum, gb.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the a1 training step
# ---------------------------------------------------------------------------
def test_a1_dp2_matches_single_and_jax(runs):
    slosses, sparams = runs["single"]["losses"], runs["single"]["params"]
    jlosses, jparams, jgrads = runs["jax"]
    for o in (o["a1"] for o in runs["dp"]):
        assert o["mesh"] == (2, 1)
        _check_grads(o["grads0"], runs["single"]["grads0"])
        _check_grads(o["grads0"], jgrads, transpose=True)
        _check_losses(o["losses"], slosses)
        _check_losses(o["losses"], jlosses, H.TRAIN_STEPS)
        _check_params(o["params"], sparams)
        _check_params(o["params"], jparams)


def test_a1_dp2_tp2_matches_single_and_jax(runs):
    slosses, sparams = runs["single"]["losses"], runs["single"]["params"]
    jlosses, jparams, jgrads = runs["jax"]
    for o in (o["tp"] for o in runs["tp"]):
        assert o["mesh"] == (2, 2)
        _check_grads(o["grads0"], runs["single"]["grads0"])
        _check_grads(o["grads0"], jgrads, transpose=True)
        _check_losses(o["losses"], slosses)
        _check_losses(o["losses"], jlosses, H.TRAIN_STEPS)
        _check_params(o["params"], sparams)
        _check_params(o["params"], jparams)


def test_ranks_outside_the_mesh(runs):
    """2 envs on 4 ranks: dp=2 over ranks 0 and 1; ranks 2 and 3 repeat
    their work, add nothing, and end with the same parameters."""
    slosses, sparams = runs["single2"]["losses"], runs["single2"]["params"]
    outs = [o["outside"] for o in runs["tp"]]
    assert [o["active"] for o in outs] == [True, True, False, False]
    for o in outs:
        assert o["mesh"] == (2, 1)
        _check_grads(o["grads0"], runs["single2"]["grads0"])
        _check_losses(o["losses"], slosses)
        _check_params(o["params"], sparams)


def test_lab4d_dp2_matches_single(runs):
    """The lab4d interface step (live per-env joint anchors from the
    fields, pos_distill on, the frozen fields' gradients summed too)."""
    slosses, sparams, sgrads = runs["lab4d"]
    for o in (o["lab4d"] for o in runs["dp"]):
        _check_losses(o["losses"], slosses)
        assert o["losses"][-1]["loss_pos_distill"] > 0
        got, want = _leaves(o["params"]), _leaves(sparams)
        assert set(got) == set(want)
        for k in want:
            # an entry whose gradient is within rounding of Adam's eps (1e-8)
            # may take another step: at most 1e-4 of a tensor's entries, and
            # within Adam's step bound (the largest peak lr, 1e-3, a step)
            d = np.abs(got[k] - want[k])
            off = d > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(want[k])
            assert off.sum() <= max(1, 1e-4 * d.size) and d.max() <= 1e-3 * H.LAB4D_STEPS, k
        assert set(o["grads"]) == set(sgrads)
        for k, g in sgrads.items():
            scale = np.abs(g).max() + 1e-12
            np.testing.assert_allclose(o["grads"][k] / scale, g / scale, atol=5e-4, rtol=0,
                                       err_msg=k)
        assert np.abs(o["grads"]["object_field.articulation.rest_offsets"]).max() > 0


def test_replicas_are_bit_identical(runs):
    """After the updates every rank holds the same parameters, bit for bit;
    only rank 0 writes its checkpoint."""
    for outs in ([o["a1"] for o in runs["dp"]], [o["tp"] for o in runs["tp"]],
                 [o["outside"] for o in runs["tp"]]):
        _check_replicas(outs)
    a, b = (_leaves(o["lab4d"]["params"]) for o in runs["dp"])
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert [o["a1"]["wrote"] for o in runs["dp"]] == [True, False]


def test_cli_ngpu2_only_rank0_writes(tmp_path):
    """python -m ppr_diffphys_torch.main in 2 processes (RANK/WORLD_SIZE as
    torchrun sets them, gloo through a FileStore), --ngpu 2 --mesh_shape
    dp=2: both ranks run every iteration; rank 0 alone prints the JSON lines
    and writes the checkpoints, OBJ strips and tensorboard."""
    cmd = [sys.executable, "-m", "ppr_diffphys_torch.main", "--device", "cpu",
           "--urdf_template", "a1", "--seqname", H.SEQNAME, "--datadir", H.MOTION_DIR,
           "--urdf_dir", H.FIXTURES, "--logroot", str(tmp_path), "--num_rounds", "1",
           "--iters_per_round", "2", "--num_envs", "2", "--frames_per_wdw", "3",
           "--no-render_vis", "--ngpu", "2", "--mesh_shape", "dp=2",
           "--dist_url", "file://" + str(tmp_path / "store")]
    procs = []
    for r in (0, 1):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK="0",
                   OMP_NUM_THREADS=str(H.RANK_THREADS))
        procs.append(subprocess.Popen(cmd, cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    lines = [[json.loads(l) for l in o.splitlines() if l.startswith("{")] for o, _ in outs]
    assert [l["it"] for l in lines[0] if "total_loss" in l] == [0, 1, 2]
    assert [l["it"] for l in lines[0] if "eval/traj" in l] == [0, 2]
    assert lines[1] == []
    save = tmp_path / ("%s-dynamics" % H.SEQNAME)
    names = sorted(os.listdir(save))
    events = [n for n in names if n.startswith("events.out.tfevents.")]
    assert len(events) == 1
    assert sorted(n for n in names if n not in events) == sorted(
        ["ckpt_phys_%s.pth" % s for s in ("0000", "0002", "best", "latest")]
        + ["sim_traj-%s.obj" % it for it in ("00000", "00002")])
