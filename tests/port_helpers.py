"""Shared inputs for the port tests (tests/test_torch_*.py): in-repo model
fixtures built by both packages, and seeded numpy problems handed to both.
"""

from __future__ import annotations

import contextlib
import os
import shutil

import numpy as np

# numpy generators of window inputs, shared with chip_smoke.py
from ppr_diffphys_torch.sim.synthetic import (  # noqa: F401
    grounded,
    random_joint_state,
    sim_params_np,
    window_problem,
)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(TESTS_DIR, "fixtures")
A1_URDF = os.path.join(FIXTURES, "a1", "urdf", "a1.urdf")
MOTION_DIR = os.path.join(FIXTURES, "motion_sequences")
SEQNAME = "a1-synth"

# the a1 template's import arguments (models/phys_model.py in both packages)
A1_IMPORT = dict(
    xform_p=(0.0, 0.417, 0.0), floating=True, density=1000, armature=0.01,
    stiffness=220.0, damping=2.0, shape_ke=1.0e4, shape_kd=0.0,
    shape_kf=1.0e2, shape_mu=1, limit_ke=0, limit_kd=0,
)


def serve_opts(**kw):
    """Options for the a1 serving slice on the committed clip."""
    from ppr_diffphys_torch.utils.config import build_opts

    opts = dict(
        seqname=SEQNAME, urdf_template="a1", datadir=MOTION_DIR,
        urdf_dir=FIXTURES, noise_std=0.0, seed=0,
    )
    opts.update(kw)
    return build_opts(**opts)


def a1_model(builder, import_urdf, contact_mode="hull"):
    """The a1 ArticulationModel built by either package's ``sim.builder``
    and ``sim.import_urdf`` modules, attach gains set."""
    b = builder.ModelBuilder()
    import_urdf.parse_urdf(A1_URDF, b, **A1_IMPORT)
    model = b.finalize().make_ground_contacts(contact_mode)
    model.joint_attach_ke, model.joint_attach_kd = 16000.0, 200.0
    return model


@contextlib.contextmanager
def private_jax_rasterizer(tmpdir):
    """The JAX package's SoftwareRenderer with its library built by its own
    ``_load_lib`` (its g++ flags) into ``tmpdir``: the package rebuilds
    ``csrc/librasterizer.so`` in place when it is missing, which is not safe
    while several test processes render at once."""
    import pytest
    import ppr_diffphys_tpu.utils.render as jrender

    shutil.copy(os.path.join(os.path.dirname(TESTS_DIR), "csrc", "rasterizer.cpp"), tmpdir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrender, "_find_csrc", lambda: str(tmpdir))
        mp.setattr(jrender, "_LIB", None)
        yield


# ---------------------------------------------------------------------------
# torch.distributed ranks on the CPU (tests/test_torch_parallel.py): gloo
# through a FileStore in a temporary directory, one spawned process per rank
# ---------------------------------------------------------------------------
RANK_THREADS = 2  # torch threads per rank process


def _rank_main(fn, rank, world, tmpdir, args, timeout_s):
    import pickle
    import traceback

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    try:
        import torch
        import torch.distributed as dist
        from ppr_diffphys_torch.parallel import sharding

        torch.set_num_threads(RANK_THREADS)
        sharding.init_distributed(device="cpu", init_method="file://" + os.path.join(
            tmpdir, "store"), timeout_s=timeout_s)
        out = fn(rank, world, tmpdir, *args)
        dist.destroy_process_group()
        with open(os.path.join(tmpdir, "rank%d.pkl" % rank), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmpdir, "rank%d.err" % rank), "w") as f:
            f.write(traceback.format_exc())
        raise


class Ranks:
    """``fn(rank, world, tmpdir, *args)`` in ``world`` spawned processes
    joined by gloo; ``join()`` returns each rank's result and raises if a
    rank failed or ``timeout_s`` passed (the ranks are then killed, so a hung
    collective fails its test)."""

    def __init__(self, fn, world, tmpdir, args=(), timeout_s=240):
        import multiprocessing as mp
        import time

        self.tmpdir, self.timeout_s = str(tmpdir), timeout_s
        os.makedirs(self.tmpdir, exist_ok=True)
        self.deadline = time.time() + timeout_s
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(fn, r, world, self.tmpdir, args, timeout_s / 2))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def join(self):
        import pickle
        import time

        for p in self.procs:
            p.join(max(0.0, self.deadline - time.time()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        errs = {}
        for r in range(len(self.procs)):
            path = os.path.join(self.tmpdir, "rank%d.err" % r)
            if os.path.exists(path):
                errs[r] = open(path).read()[-3000:]
        if hung or errs:
            raise AssertionError("ranks %s still running after %d s; failures: %s"
                                 % (hung, self.timeout_s, errs))
        out = []
        for r in range(len(self.procs)):
            with open(os.path.join(self.tmpdir, "rank%d.pkl" % r), "rb") as f:
                out.append(pickle.load(f))
        return out


# the a1 training case of the parallel tests: E envs, F frames, noise 0,
# explicit frame starts for STEPS steps, then one step with the starts and
# the init noise drawn from the model's generator
TRAIN_E, TRAIN_F, TRAIN_STEPS = 4, 3, 3
TRAIN_STARTS = np.array([0.0, 5.0, 20.0, 40.0], np.float32)
DRAW_NOISE = 2e-3


def a1_train_run(logroot, envs=TRAIN_E, **opts):
    """The a1 model (seeded weights) after TRAIN_STEPS forward()+update()
    steps at TRAIN_STARTS[:envs] and one more from drawn starts with init
    noise: dict(model, losses (one dict per step), params (the JAX layout,
    after the TRAIN_STEPS steps), init (the seeded start, the JAX layout),
    grads0 (every tensor's gradient of the first step, by JAX name))."""
    from ppr_diffphys_torch.data.amp_loader import DataLoader
    from ppr_diffphys_torch.models.phys_model import phys_model

    o = serve_opts(logroot=logroot, num_rounds=1, iters_per_round=TRAIN_STEPS + 1, **opts)
    m = phys_model(dict(o), DataLoader(o), device="cpu")
    m.reinit_envs(envs, frames_per_wdw=TRAIN_F, is_eval=False)
    init = m.state_np()
    losses = []
    for i in range(TRAIN_STEPS):
        losses.append({k: float(v) for k, v in m.forward(frame_start=TRAIN_STARTS[:envs]).items()})
        if i == 0:
            grads0 = {k: v.numpy().copy() for k, v in m.last_grads.items()}
        m.update()
    params = m.state_np()
    m.noise_std = DRAW_NOISE
    losses.append({k: float(v) for k, v in m.forward().items()})
    m.update()
    return dict(model=m, losses=losses, params=params, init=init, grads0=grads0)


def lab4d_interface(logroot, **opts):
    """The port's lab4d interface on a1 (its calf links as kp links) over two
    videos (offsets [0, 12, 30]), 4 substeps a frame, seeded fields moved off
    their identity start."""
    import torch
    from ppr_diffphys_torch.data.robot import URDFRobot
    from ppr_diffphys_torch.models import fields, interface
    from ppr_diffphys_torch.utils.config import build_opts

    offsets = [0, 12, 30]
    g = torch.Generator().manual_seed(0)
    obj = fields.ObjectField(offsets, URDFRobot(A1_URDF), g)
    scn = fields.CameraField(offsets, g, name="scene_field")
    intr = fields.IntrinsicsField(offsets)
    o = build_opts(seqname="lab4d-a1", logname="t", urdf_template="a1", urdf_dir=FIXTURES,
                   num_rounds=1, iters_per_round=2, logroot=logroot, pos_distill_wt=0.1,
                   phys_vid=[0, 1], noise_std=0.0, **opts)
    md = dict(scene_field=(scn, scn.init_params), object_field=(obj, obj.init_params),
              intrinsics=(intr, intr.init_params), frame_interval=4 * 5e-4, frame_info=None)
    tm = interface.phys_interface(o, md, device="cpu")
    tm.robot.urdf.kp_links = ["FR_calf", "FL_calf", "RR_calf", "RL_calf"]
    tree = tm.state_np()
    rng = np.random.RandomState(3)
    art = tree["object_field"]["articulation"]
    art["rest_offsets"] = (rng.randn(*art["rest_offsets"].shape) * 0.01).astype(np.float32)
    art["shift"] = (rng.randn(3) * 0.02).astype(np.float32)
    tree["scene_field"]["field2world"] = np.concatenate(
        [rng.randn(2, 3) * 0.05, [[0.02, 0.0, 0.01, 1.0], [0.0, -0.03, 0.0, 1.0]]],
        -1).astype(np.float32)
    for sub in ("kinematics_proxy", "kinematics_distilled"):
        for k in ("object_field", "scene_field"):
            tree[sub][k] = tree[k]
    tm.load_params_from_jax(tree)
    return tm


LAB4D_E, LAB4D_F, LAB4D_STEPS = 4, 3, 2


def lab4d_run(logroot, **opts):
    """The lab4d interface after LAB4D_STEPS forward()+update() steps from
    drawn frame starts: (losses, parameters in the JAX layout, the last
    step's gradients)."""
    tm = lab4d_interface(logroot, **opts)
    tm.reinit_envs(LAB4D_E, frames_per_wdw=LAB4D_F, is_eval=False)
    losses = []
    for _ in range(LAB4D_STEPS):
        losses.append({k: float(v) for k, v in tm.forward().items()})
        tm.update()
    grads = {k: v.numpy().copy() for k, v in tm.last_grads.items()}
    return losses, tm.state_np(), grads


def _named_arrays(model):
    return [t.detach() for _, t in model.named_tensors()]


def rank_dp(rank, world, tmpdir):
    """A 2-rank world: gather_envs and the tp-split linear on seeded data,
    the a1 step at dp=2, the checkpoint writes, and the lab4d step at dp=2."""
    import torch
    from ppr_diffphys_torch.parallel import sharding

    out = {}
    # gather_envs: each rank's rows of X, a loss of the gathered rows
    rng = np.random.RandomState(0)
    X, W = rng.randn(6, 5).astype(np.float32), rng.randn(6, 5).astype(np.float32)
    mesh = sharding.make_mesh({"dp": 2})
    rows = sharding.env_sharding(mesh).rows(6)
    x = torch.tensor(X[rows], requires_grad=True)
    full = sharding.gather_envs(x, mesh)
    (g,) = torch.autograd.grad((torch.tensor(W) * full ** 2).sum(), x)
    out["gather"] = (full.detach().numpy(), g.numpy(), rows)

    # the tp-split linear (dp=1, tp=2) under a loss of its relu
    tmesh = sharding.make_mesh({"dp": 1, "tp": 2})
    xs = torch.tensor(rng.randn(7, 8).astype(np.float32), requires_grad=True)
    ws = torch.tensor(rng.randn(6, 8).astype(np.float32), requires_grad=True)
    bs = torch.tensor(rng.randn(6).astype(np.float32), requires_grad=True)
    v = torch.tensor(rng.randn(7, 6).astype(np.float32))
    with sharding.tp_scope(tmesh):
        y = sharding.tp_linear(xs, ws, bs)
        gx, gw, gb = torch.autograd.grad((v * torch.relu(y)).sum(), (xs, ws, bs))
    gw_sum, gb_sum = sharding.sum_grads(tmesh, [gw, gb], [0, None])
    out["split"] = tuple(a.detach().numpy() for a in (y, gx, gw, gw_sum, gb_sum))

    # the a1 step at dp=2; each rank its own logroot, so a write shows
    logroot = os.path.join(tmpdir, "logs%d" % rank)
    run = a1_train_run(logroot)
    m = run.pop("model")
    mdims = m._mesh_for(TRAIN_E)
    m.save_checkpoint(0)
    out["a1"] = dict(run, agree=sharding.replicas_agree(_named_arrays(m)),
                     mesh=(mdims.dp, mdims.tp), wrote=os.path.exists(logroot))

    losses, params, grads = lab4d_run(os.path.join(tmpdir, "lab4d%d" % rank))
    out["lab4d"] = dict(losses=losses, params=params, grads=grads)
    return out


def rank_tp(rank, world, tmpdir):
    """A 4-rank world: the a1 step at dp=2,tp=2, then 2 envs at dp=2, where
    ranks 2 and 3 are outside the mesh."""
    from ppr_diffphys_torch.parallel import sharding

    out = {}
    run = a1_train_run(os.path.join(tmpdir, "tp%d" % rank), mesh_shape="dp=2,tp=2")
    m = run.pop("model")
    mdims = m._mesh_for(TRAIN_E)
    out["tp"] = dict(run, agree=sharding.replicas_agree(_named_arrays(m)),
                     mesh=(mdims.dp, mdims.tp))
    run = a1_train_run(os.path.join(tmpdir, "out%d" % rank), envs=2)
    m = run.pop("model")
    mdims = m._mesh_for(2)
    out["outside"] = dict(run, agree=sharding.replicas_agree(_named_arrays(m)),
                          mesh=(mdims.dp, mdims.tp), active=mdims.active)
    return out
