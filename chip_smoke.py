#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ppr_diffphys_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
 1. device: torch's device name, and name + power limit from nvidia-smi;
 2. build: every CUDA kernel of the serving path with nvcc (sm_90a), timed;
 3. kernel vs plain: the soa_window kernel against its plain PyTorch
    version (sim/integrator.rollout) on the card, on a1 and on the
    FIXED/COMPOUND/REVOLUTE chain, with shared and per-env parameter
    planes, E=256 envs, F=4 frames of 33 substeps, penetrating contacts;
 4. main path: RolloutServer(num_envs=4096, frames=24, device="cuda") on a1
    with the committed 48-frame clip and random seeded MLP weights, integer
    frame starts spread over [0, 24]: one warm-up and 3 timed rollouts, with
    the launch counts set to 0 just before and read just after; then the
    kernel held against the plain version on the main path's own inputs,
    each timed with CUDA events;
 5. a ``kernels`` JSON line, the nvidia-smi line, and as the last line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

It imports nothing of JAX. Without a GPU, or run from a directory that
lacks the repository, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores, H100 SXM data sheet
E_MAIN, F_MAIN, SEED = 4096, 24, 0
E_CHECK, F_CHECK = 256, 4

# Kernel vs plain tolerances (absolute). Both run fp32 on the card; the
# kernel contracts multiply-adds into FMAs and sums in another order, so the
# two drift apart by rounding that the stiff attach springs (ke=16000 N/m,
# kd=200 N s/m) amplify, and the drift grows about linearly with the
# substep count (measured on an H100 80GB HBM3 at 700 W: q 5e-7 after 99
# substeps, 7e-6 after 759). The limits sit ~10x above that: q (m, unit
# quaternion), qd (rad/s, m/s), grf and jaf (N, N m; jaf carries
# ke * (q error)). Phase 3 runs 99 substeps, the main path 759.
TOL_CHECK = dict(q=1e-5, qd=5e-3, grf=0.1, jaf=0.5)
TOL_MAIN = dict(q=1e-4, qd=2e-2, grf=1.0, jaf=3.0)


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print("chip_smoke FAILED: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail("nvidia-smi failed: " + out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps):
    """Mean ms of fn() over reps runs, by CUDA events (after fn ran once)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def max_errs(a, b):
    return {k: float((x - y).abs().max()) for k, x, y in zip(("q", "qd", "grf", "jaf"), a, b)}


def check_errs(label, errs, tol):
    log("  %s max|kernel-plain|: %s (tol %s)" % (label, json.dumps(errs), json.dumps(tol)))
    for k, v in errs.items():
        if not np.isfinite(v) or v > tol[k]:
            fail("%s: %s error %.3g exceeds %.3g" % (label, k, v, tol[k]))


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, REPO)
    try:
        import ppr_diffphys_torch  # noqa: F401
        from ppr_diffphys_torch.csrc import build as kbuild
    except ImportError as e:
        fail("the ppr_diffphys_torch package is not beside this script (%s)" % e)
    from ppr_diffphys_torch.models.serve import RolloutServer
    from ppr_diffphys_torch.sim import integrator as tint
    from ppr_diffphys_torch.sim import soa, synthetic
    from ppr_diffphys_torch.sim.builder import ModelBuilder
    from ppr_diffphys_torch.sim.import_urdf import parse_urdf
    from ppr_diffphys_torch.sim.kinematics import eval_fk
    from ppr_diffphys_torch.utils.config import build_opts

    dev = torch.device("cuda")
    t_all = time.time()

    # ---- 1. device --------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log("phase 1 device: torch %s cuda %s, %s (count %d), nvidia-smi: %s"
        % (torch.__version__, torch.version.cuda, kind, count, smi))

    # ---- 2. build ---------------------------------------------------------
    t0 = time.time()
    logs = kbuild.build([soa.KERNEL], ptxas_verbose=True)
    log("phase 2 build: %.1f s" % (time.time() - t0))
    for name, text in logs.items():
        for line in text.strip().splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                log("  %s ptxas: %s" % (name, line.strip()))

    # ---- 3. kernel vs plain on the card ------------------------------------
    opts = build_opts(
        seqname="a1-synth", urdf_template="a1",
        datadir=os.path.join(REPO, "tests", "fixtures", "motion_sequences"),
        urdf_dir=os.path.join(REPO, "tests", "fixtures"), seed=SEED,
    )
    t0 = time.time()
    server = RolloutServer(opts, num_envs=E_MAIN, frames=F_MAIN, device="cuda")
    m = server.model
    sub = m.steps_per_fr_interval
    log("server built: %.1f s (B=%d, n_qd=%d, contacts=%d, substeps/frame=%d)"
        % (time.time() - t0, m.n_links, m.env.n_qd, m.env.contact_count, sub))
    # phase 3 uses the a1 articulation as imported (the server's copy holds
    # mass-normalized inertias, which sim_params_np would normalize twice)
    a1_builder = ModelBuilder()
    parse_urdf(
        os.path.join(opts["urdf_dir"], "a1/urdf/a1.urdf"), a1_builder,
        xform_p=(0.0, 0.417, 0.0), floating=True, density=1000, armature=0.01,
        stiffness=220.0, damping=2.0, shape_ke=1.0e4, shape_kd=0.0,
        shape_kf=1.0e2, shape_mu=1, limit_ke=0, limit_kd=0,
    )
    a1 = a1_builder.finalize().make_ground_contacts("hull")
    a1.joint_attach_ke, a1.joint_attach_kd = m.joint_attach_ke, m.joint_attach_kd
    t0 = time.time()
    for mname, model in (("a1", a1), ("chain", synthetic.chain_model())):
        q, qd, tgt, act = synthetic.window_problem(model, E_CHECK, sub, F_CHECK, seed=SEED)
        bq, bqd = eval_fk(model, torch.as_tensor(q), torch.as_tensor(qd))
        bq = synthetic.grounded(model, bq.numpy(), seed=SEED)
        state = tint.SimState(torch.as_tensor(bq, device=dev), bqd.to(dev))
        tgt, act = torch.as_tensor(tgt, device=dev), torch.as_tensor(act, device=dev)
        integ = tint.SemiImplicitIntegrator(model)
        window = soa.SoaWindow(integ, m.dt, sub, F_CHECK)
        for planes in ("shared", "per_env"):
            ke, kd, mass, norm_I = synthetic.sim_params_np(
                model, E_CHECK if planes == "per_env" else None, seed=SEED)
            t = lambda x: torch.as_tensor(x, device=dev)
            I = t(norm_I) * t(mass)[..., None, None]
            params = tint.SimParams(t(mass), 1.0 / t(mass), I, torch.linalg.inv(I),
                                    t(ke), t(kd))
            for acts in (act, None):
                out = window(state, tgt, acts, params)
                ref = tint.rollout(integ, params, state, tgt, acts, None, m.dt, sub)
                torch.cuda.synchronize()
                for x in out:
                    if not torch.isfinite(x).all():
                        fail("phase 3 %s/%s: non-finite kernel output" % (mname, planes))
                if float(out[2][..., 3:].abs().max()) < 1.0:
                    fail("phase 3 %s: no contact force: the check is vacuous" % mname)
                check_errs("phase 3 %s/%s/%s" % (mname, planes,
                                                 "act" if acts is not None else "no-act"),
                           max_errs(out, ref), TOL_CHECK)
        # the plain version's time at this shape is a yardstick only
        k_ms, _ = cuda_time_ms(lambda: window(state, tgt, None, params), 3)
        p_ms, _ = cuda_time_ms(
            lambda: tint.rollout(integ, params, state, tgt, None, None, m.dt, sub), 1)
        log("  phase 3 %s E=%d F=%d: soa_window %.3f ms, plain %.1f ms"
            % (mname, E_CHECK, F_CHECK, k_ms, p_ms))
    log("phase 3 kernel vs plain: ok (%.1f s)" % (time.time() - t0))

    # ---- 4. the main path ---------------------------------------------------
    frame_start = (np.arange(E_MAIN) % (m.total_frames - F_MAIN + 1)).astype(np.float32)
    server.window.launches = 0
    torch.cuda.synchronize()
    out = server.rollout(frame_start)  # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        out = server.rollout(frame_start)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    launches = {soa.KERNEL: server.window.launches}
    log("phase 4 launches during the main path: %s" % json.dumps(launches))
    if launches[soa.KERNEL] < 1:
        fail("the main path never launched the %s kernel" % soa.KERNEL)
    if tuple(out.shape) != (F_MAIN, E_MAIN, m.n_links, 7):
        fail("rollout shape %s" % (tuple(out.shape),))
    if not torch.isfinite(out).all():
        fail("non-finite rollout output")
    quat_norm = out[..., 3:7].norm(dim=-1)
    if float((quat_norm - 1).abs().max()) > 1e-3:
        fail("rollout quaternions are not unit")
    env_steps = E_MAIN * (F_MAIN - 1) * sub
    wall = float(np.median(walls))
    log("phase 4 rollout wall ms (3 runs): %s; median %.3f ms; %.4g env-steps/s"
        % ([round(w * 1e3, 3) for w in walls], wall * 1e3, env_steps / wall))

    # kernel against plain on the main path's own inputs, each timed
    state, ref_t = server.prologue(frame_start)
    params = m._sim_params()
    prologue_ms, _ = cuda_time_ms(lambda: server.prologue(frame_start), 3)
    kern_ms, kout = cuda_time_ms(lambda: server.window(state, ref_t, None, params), 3)
    plain_ms, pout = cuda_time_ms(
        lambda: tint.rollout(m.integrator, params, state, ref_t, None, None, m.dt, sub), 1)
    errs = max_errs(kout, pout)
    check_errs("phase 4 main-path shapes", errs, TOL_MAIN)
    per_frame = (kout[0] - pout[0]).abs().amax(dim=(1, 2, 3)).tolist()
    log("  body_q max|kernel-plain| per frame: %s" % [float("%.3g" % x) for x in per_frame])
    work = soa.window_work(m.env, E_MAIN, sub, F_MAIN)
    t_bytes = work["bytes"] / H100_BYTES_PER_S
    t_ops = work["ops"] / H100_FP32_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    log("phase 4 times: prologue %.3f ms, soa_window %.3f ms, plain %.1f ms; bound %.4f ms "
        "(%d bytes -> %.4f ms, %d fp32 ops (%d per env-substep) -> %.4f ms)"
        % (prologue_ms, kern_ms, plain_ms, bound_ms, work["bytes"], t_bytes * 1e3,
           work["ops"], work["per_env_substep"], t_ops * 1e3))
    log("total %.1f s" % (time.time() - t_all))

    # ---- 5. results ------------------------------------------------------------
    kernels = [{
        "name": soa.KERNEL,
        "route": "cuda",
        "source": "ppr_diffphys_torch/csrc/soa_window.cu",
        "replaces": "ppr_diffphys_tpu/sim/pallas_soa.py:1244",
        "launches": int(launches[soa.KERNEL]),
        "max_abs_err": errs["q"],
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
