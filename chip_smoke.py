#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ppr_diffphys_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
 1. device: torch's device name, and name + power limit from nvidia-smi;
 2. build: every CUDA kernel (soa_window, soa_interval, soa_rollout) with
    nvcc (sm_90a),
    one nvcc per source, all started together, timed, with ptxas' registers,
    stack and spills;
 3. kernel vs plain: the soa_window kernel K1 against its plain PyTorch
    version (sim/integrator.rollout) on the card, on a1 and on the
    FIXED/COMPOUND/REVOLUTE chain at E=256 envs and on the chain with 45
    contacts (two chunks of 32 lanes) at E=1027 (8 envs per CTA, the last
    CTA holding 3), with shared and per-env parameter planes, F=4 frames of
    33 substeps, penetrating contacts;
 4. main path: RolloutServer(num_envs=4096, frames=24, device="cuda") on a1
    with the committed 48-frame clip and random seeded MLP weights, integer
    frame starts spread over [0, 24]: one warm-up and 3 timed rollouts, with
    the launch counts set to 0 just before and read just after; then the
    kernel held against the plain version on the main path's own inputs,
    each timed with CUDA events, the kernel also by its device time (CUDA
    events around calls queued behind a device sleep);
 5. interval kernels vs plain: K2 (soa_interval_fwd) values and K3
    (soa_interval_bwd + its env reduction) gradients against the plain
    interval with autograd, on a1 and the chain at E=256 and on the chain
    with 45 contacts (two chunks of 32 lanes) at E=1027 (8 envs per CTA, the
    last CTA holding 3), shared and per-env planes, with and without acts,
    33 substeps, penetrating contacts, for the loss sum(w * outputs) with
    seeded weights: K3 on the plain forward's own substep states, every
    env, and (at E=256) end to end; and K2 chained over a window against
    K1, bit for bit (both run the warp substep);
 6. training main path: the port's phys_model on a1 with the committed clip,
    num_envs=512, frames_per_wdw=24, default loss weights and noise_std:
    one warm-up and 3 timed forward()+update() steps, with the launch counts
    set to 0 just before and read just after (one K2, K3 and reduction per
    interval and step); the peak device memory; 2 more steps under
    torch.profiler (device busy share, time by kernel); then K2 and K3 timed
    alone on the main path's own first-interval inputs (each wrapper by
    CUDA events; each call's device time, and K2's with and without its
    export, by CUDA events around calls queued behind a device sleep) and
    held
    against the plain interval with autograd there; last the training loop's
    full-sequence eval (1 env, K1, no gradient), its launch count read, and
    K1 held against the plain rollout on that eval's inputs;
 7. the bench rollout kernel K4 (soa_rollout) vs plain
    (integrator.rollout_substeps) on a1 and the chain at E=256 and the
    45-contact chain at E=1027, shared planes, 33 substeps, penetrating
    contacts, random and zero acts; K4's final state equal to K2's
    (soa_interval_fwd without export) bit for bit, no acts equal to zero
    acts, per-env parameters rejected, K4 timed;
 8. the bench main path through ppr_diffphys_torch.bench's own functions,
    on a1 at the bench's width: rollout, 4096 envs x 990 substeps (30 K4
    calls of 33 substeps per rep), one warm-up and 3 timed reps with the
    launch count set to 0 just before and read just after (exactly 30 per
    rep), the busy share of one profiled rep, K4 alone on the main path's
    inputs timed (its wrapper by CUDA events, its device time by CUDA events
    around calls queued behind a device sleep) and held against plain, and a whole rep held against
    plain on 64 envs; train, 4096 envs x 10 intervals of 33 substeps, the same
    way (exactly 10 K2, K3 and reduction launches per rep, finite loss,
    finite non-zero gradients), K2's device time with and without its
    export, K2 values and K3 gradients (every env, and
    the env reduction over the 4096 envs' partials) at the plain
    linearization on the first and the last interval's own inputs, then
    the same workload at 8 envs against
    the plain version on the CPU; last K2 values and K3 gradients of one
    83-substep interval (the 24 Hz case) at E=256 at the plain
    linearization point;
 9. the interval kernels with live joint anchors (K2/K3 ``with_xp``) vs
    the plain interval with the anchor planes, on a1 and the 45-contact
    chain at E=256, anchors moved ~1e-2 m and ~0.05 rad from the model's
    (seeded), per env (lane E) and shared (lane 1), with acts and residual
    forces on and off: K2 values over one interval and chained over 3,
    K3 gradients (the three anchor planes included) at the plain
    linearization, shared planes through the env reduction; and at the
    model's own anchors (lane 1) K2's states and K3's other gradients equal
    to the baked kernels' bit for bit;
10. the lab4d main path: phys_interface on a1 (kp links: its four calf
    links) with random seeded fields over two synthetic videos of 64 frames,
    both camera fields fitted (fit_camera_mlp) to one camera so the robot
    stands upright, 512 envs x 24 frames at 33 substeps a frame,
    pos_distill_wt 0.1, noise_std 0: override_control_ref_states,
    correct_scale (4 frames, at most 8 steps), one warm-up and 3 timed
    forward()+update() steps with the launch counts set to 0 just before and
    read just after (the with_xp K2, K3 and reduction once per interval and
    step, K1 never), finite losses with pos_distill > 0, a non-zero
    gradient of object_field.articulation.rest_offsets (the anchors'
    gradient reached the fields), some kinematics_proxy tensor changed,
    peak device memory, a profiled step; the with_xp K2 and K3 alone on the
    main path's last interval (after the landing), timed (device time by
    CUDA events behind a device sleep) and held against plain; the eval forward over both videos (the with_xp K2 chained, no
    K1), get_camera, override_states_inv; then at 8 envs the same step over
    8 frames on the kernels and on the plain interval on the card: losses
    within TOL_GRAD_SUM, and every tensor's gradient within TOL_GRAD_SUM of
    the plain interval's autograd at the kernels' own trajectory (check (a)
    for the whole step); end to end, each side on its own trajectory, every
    gradient within TOL_GRAD_SUM unless some env took another branch of the
    plain substep (``branch_bits``: a contact, friction-cone, joint-limit or
    clamp kink crossed) on the two trajectories; then each env alone (1 env
    x 8 frames) on the kernels and on the plain interval: an env whose
    gradients differ beyond TOL_GRAD_SUM fails unless its two trajectories
    took different branches;
11. vis and IO on the card's paths: which of cv2 and tensorboard the machine
    has decides what is written (a missing cv2 is printed, and the frames
    are still rendered in memory and checked); (a) the training CLI
    (``main.train_one``) on a1 at 512 envs x 24 frames, one round of 2
    iterations (the loop runs 3, and rounds start at iterations 0 and 2),
    with --render_vis and --profile_dir under a temporary logroot: the launch
    counts of its own kernels (one K1 per eval, one K2, K3 and reduction per
    interval and iteration), its checkpoint, videos, OBJ strip, profiler
    trace and tensorboard scalars (equal to its JSON lines), the robot drawn
    in the first and last sim frames (pixels that differ from the floor
    alone); (b) the lab4d eval's query(img_size) from phase 10 rendered with
    its cameras: the distilled and camera-posed streams written and not
    blank, the robot drawn in their first frames (phase 10's intrinsics put
    the principal point at the centre of lab4d's 480 x 640 frames); (c)
    render_intermediate over (a)'s OBJ strips; the host time of vis.show per
    round and of the rasterizer per stream frame, beside the nvidia-smi line;
12. multi-GPU on one card (``parallel/sharding.py``): two ranks as spawned
    processes, both on cuda:0 (gloo through a FileStore: NCCL takes one rank
    per card), against this process's one-process runs of the same paths:
    (a) the training CLI (``main.train_one``) on a1 at 512 envs x 24 frames
    with --ngpu 2 --mesh_shape dp=2 (256 envs a rank), one round of 2
    iterations (the loop runs 3; evals at 0 and 2) without videos; (b) the
    same with --mesh_shape dp=1,tp=2 at 64 envs (each rank holds every env,
    and every trunk layer's activations cross the host through gloo, E_TP);
    (c) the lab4d step (phase 10's interface and parameters) at 8 envs x 8
    frames, dp=2, 2 steps. Per rank the launch counts (one K1 per eval; one K2, K3 and
    reduction per interval and iteration); losses and parameters after the
    updates against one process within the stated tolerance; every rank's
    parameters bit-identical (compared, and by ``replicas_agree``); rank 0
    alone writes (the files, and no pickle.dump on rank 1); the step median
    and the CUDA-event time of ``sum_grads`` and ``gather_envs`` per step.
    (d) the comm helpers under a world-1 NCCL group on the card. NCCL
    across two or more cards is not run here. A ``parallel`` JSON line
    ("2 ranks sharing one card; not a scaling figure") holds the numbers;
 then a line quoting (not measuring) each kernel's wrapper time before
    its warp-per-env redesign, a ``kernels`` JSON line (``ms`` the
    wrapper's time by CUDA events, ``device_ms`` the device time of one
    wrapper call by CUDA events around calls queued behind a device sleep,
    both measured in this run; ``design``; the with_xp
    pair as ``soa_interval_fwd[with_xp]`` and ``soa_interval_bwd[with_xp]``
    from phase 10), the
    nvidia-smi line, and as the last line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

It imports nothing of JAX. Without a GPU, or run from a directory that
lacks the repository, it exits non-zero and prints no result.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
E_MAIN, F_MAIN, SEED = 4096, 24, 0
E_CHECK, F_CHECK = 256, 4
E_TRAIN, F_TRAIN = 512, 24
BENCH_STEPS = 990  # the bench's substeps per rep (ppr_diffphys_torch/bench.py)
E_DEEP = 64  # envs of the bench rollout held against plain over a whole rep
E_SMALL = 8  # envs of the bench training workload held against plain on the CPU
# envs of the 45-contact chain's cases: 8 envs per CTA (sim/soa.py:envs_per_cta),
# 129 CTAs, the last holding 3
E_RAGGED = 1027
# the lab4d main path (phase 10): two synthetic videos of this many frames,
# and a1's four calf links as the interface's kp links (its template table
# names none; the lab4d quad and human templates have theirs)
LAB4D_FRAMES = 64
# phase 11 (b): the lab4d eval's query(img_size) as (H, W, render scale): lab4d's
# 480 x 640 frames rendered at half scale (240 x 320, the intrinsics halved)
LAB4D_IMG_SIZE = (480, 640, 0.5)
# frames of the lab4d step held against the plain version at E_SMALL envs
# (8: 231 substeps, a third of the plain version's time at 24). Every
# gradient there is summed over envs and frames, and where the two sides'
# FMA rounding carries one env across a contact kink it moves by that env's
# jump: measured on an NVIDIA H100 80GB HBM3 at 700 W, 8.5e-4 of its max
# over 24 frames, and 4.8e-6, 8.0e-4 and 1.32e-3 over 8 frames from three
# model states (the lab4d step is not deterministic run to run). So the
# gradients are held to the plain interval's at the kernels' own trajectory,
# and end to end only where no env's branches differ (each env also alone)
F_SMALL = 8
KP_LINKS_A1 = ("FR_calf", "FL_calf", "RR_calf", "RL_calf")
# Quoted, not measured by this run: each kernel's wrapper time by CUDA
# events at the main path's shapes when it ran one thread per env, before
# its warp-per-env redesign (this script, NVIDIA H100 80GB HBM3 at 700 W;
# PERF.md's kernel table: K1 and K2 from the last run before their
# redesign, K3 and K4 from the last run before theirs). Printed on a line
# of its own, never in the kernels line.
QUOTED_THREAD_PER_ENV_MS = {"soa_window": 19.831, "soa_interval_fwd": 0.823,
                            "soa_interval_bwd": 1.850, "soa_rollout": 0.871}

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
# Interval kernels vs plain, one interval of 33 substeps: values as above.
# Gradients are errors max|kernel - plain| over max|plain| of that gradient,
# and are checked twice:
# (a) K3 at the plain forward's linearization point: the plain interval's
#     own substep entry states (its export) feed K3, so both differentiate
#     the same trajectory. The planes get one lane per env, so that K3's
#     per-env plane partials are compared too: every entry of every
#     gradient, in every env, within TOL_GRAD. For shared planes, K3's
#     fixed-order env reduction is held to the float64 sum of those
#     partials within twice the bound of recursive fp32 summation,
#     (E-1) 2^-24 sum|partial|. Gradients without an env axis (shared ke,
#     kd, mass) within TOL_GRAD_SUM.
# (b) End to end, autograd through K2+K3 against autograd of the plain
#     interval: each differentiates its own forward, and the two forwards
#     differ by FMA rounding (~1e-7 in the state). Where that carries an env
#     across a contact kink (the friction cone's min, the penetration sign),
#     that env's adjoint jumps. So per env within TOL_GRAD_ENV except for at
#     most TOL_GRAD_ENVS of the envs, every entry within TOL_GRAD_REL, and
#     gradients without an env axis within TOL_GRAD_SUM. Measured for (b) on
#     an H100 80GB HBM3 at 700 W (this script): 1e-6 to 1.8e-5 in every env
#     but one env in each of two of the eight phase-5 configurations
#     (1.9e-2 there), and up to 3.5e-4 for the env sums of phase 6.
TOL_INTERVAL = dict(q=1e-5, qd=5e-3)
# A whole bench rollout rep (990 substeps) against plain: the a1 falls from
# its 0.417 m start and lands, and the impact on the stiff contacts
# (ke=1e4 N/m, a force that switches on with the penetration's sign)
# amplifies the two sides' rounding differences (measured on an H100 80GB
# HBM3 at 700 W: q 6e-8 until the landing, then 2.4e-5, growing to 1.6e-4
# and qd 1.5e-3 over 64 envs). Held ~6x above that; the plain rollout's own
# change when its start moves by 1e-7 is logged beside it as a yardstick.
TOL_DEEP = dict(q=1e-3, qd=2e-2)
TOL_GRAD = 1e-4
TOL_GRAD_SUM = 1e-3
TOL_GRAD_ENV = 1e-3
TOL_GRAD_ENVS = 0.02
TOL_GRAD_REL = 0.1


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print("chip_smoke FAILED: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


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


def queued_ms(fn, n):
    """Device ms per call of fn(), by CUDA events around n calls queued
    behind a device sleep of 5e7 cycles (>= 25 ms at the H100's 1.98 GHz
    boost clock): the host enqueues every call before the first one starts,
    so the events time the device running them back to back, not the
    host's pace (fn() must launch without synchronizing)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if host_ms > 15.0:
        fail("queued_ms: enqueuing %d calls took %.1f ms of host time, near the sleep"
             % (n, host_ms))
    return start.elapsed_time(end) / n


def export_share(label, di, call):
    """K2's device time on one recorded interval call (the arguments of
    ``di._forward``) with and without its (S,E,13,B) export, in turns, by
    ``queued_ms``: logged with the share the export adds."""
    bq, bqd, tgt, act, res, planes = call[:6]
    t = [queued_ms(lambda: di._forward(bq, bqd, tgt, act, res, planes, x), 20)
         for x in (True, False, False, True)]
    log("%s K2 device time (CUDA events behind a device sleep, 20 calls each; export, bare, "
        "bare, export): %s ms; the export adds %.1f %%"
        % (label, [round(x, 4) for x in t], 100 * ((t[0] + t[3]) / (t[1] + t[2]) - 1)))


def profile_steps(step, n, E, F):
    """Profile n calls of step() with torch.profiler and print where the
    device time goes: wall per step on the host clock, the device busy share
    (summed kernel time over the wall; one stream, so kernels do not
    overlap), the device time of the interval kernels, the window kernel,
    matrix products and everything else, and the kernels that take most."""
    from ppr_diffphys_torch.utils import h100

    wall_ms, rows = h100.kernel_times(step, n)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        log("  profiler: no device time recorded; device busy share not measured")
        return
    group = lambda pred: sum(r[0] for r in rows if pred(r[2].lower()))
    interval = group(lambda k: "soa_interval" in k)
    window = group(lambda k: "soa_window" in k)
    mm = group(lambda k: "gemm" in k or "sgemm" in k or "cutlass" in k or "matmul" in k)
    log("  profiled train step (%d envs x %d frames, %d steps): wall %.3f ms, device busy "
        "%.3f ms (%.1f%%), idle %.1f%%; interval kernels %.3f ms, window kernel %.3f ms, "
        "matrix products %.3f ms, other kernels %.3f ms; %d kernel launches per step"
        % (E, F, n, wall_ms, busy, 100 * busy / wall_ms, 100 - 100 * busy / wall_ms,
           interval, window, mm, busy - interval - window - mm, sum(r[1] for r in rows)))
    log("  top kernels (ms per step, launches per step, name):")
    for ms, c, k in rows[:12]:
        log("    %9.3f %6d  %s" % (ms, c, k[:100]))


def max_errs(a, b):
    return {k: float((x - y).abs().max()) for k, x, y in zip(("q", "qd", "grf", "jaf"), a, b)}


def check_errs(label, errs, tol):
    log("  %s max|kernel-plain|: %s (tol %s)" % (label, json.dumps(errs), json.dumps(tol)))
    for k, v in errs.items():
        if not np.isfinite(v) or v > tol[k]:
            fail("%s: %s error %.3g exceeds %.3g" % (label, k, v, tol[k]))


def param_planes(model, params):
    """Leaves ke, kd and mass, and the four traced planes built from them
    (inertia keeps its normalized shape), differentiable back to the
    leaves."""
    import torch
    from ppr_diffphys_torch.sim import integrator as tint
    from ppr_diffphys_torch.sim import soa

    ke = params.joint_target_ke.clone().requires_grad_()
    kd = params.joint_target_kd.clone().requires_grad_()
    mass = params.body_mass.clone().requires_grad_()
    norm_I = params.body_inertia / params.body_mass[..., None, None]
    I = norm_I * mass[..., None, None]
    p = tint.SimParams(mass, 1.0 / mass, I, torch.linalg.inv(I), ke, kd)
    planes = soa.traced_planes(model, p)
    return {"ke": ke, "kd": kd, "mass": mass}, [planes[n] for n in soa.TRACED_NAMES]


def state_names(act, res=None):
    return ["bq0", "bqd0", "tgt"] + (["act"] if act is not None else []) + (
        ["res"] if res is not None else [])


def interval_grads(fn, bq, bqd, tgt, act, leaves, pl, w):
    """Values and gradients of sum(w * outputs) of one interval: fn(bq,
    bqd, tgt, act, res=None, *planes). Gradients with respect to bq, bqd,
    tgt, act (when given), the planes ``pl``, and through them ``leaves``."""
    import torch
    from ppr_diffphys_torch.sim import soa

    pl_leaf = [x.detach().clone().requires_grad_() for x in pl]
    ins = [x.clone().requires_grad_() for x in (bq, bqd, tgt) + (
        (act,) if act is not None else ())]
    q, qd = fn(ins[0], ins[1], ins[2], ins[3] if act is not None else None, None, *pl_leaf)
    loss = (q * w[0]).sum() + (qd * w[1]).sum()
    g = torch.autograd.grad(loss, ins + pl_leaf)
    g_par = torch.autograd.grad(pl, list(leaves.values()), g[len(ins):]) if leaves else ()
    names = state_names(act) + list(soa.TRACED_NAMES) + list(leaves)
    return q.detach(), qd.detach(), dict(zip(names, list(g) + list(g_par)))


def linearized_grads(label, di, bq, bqd, tgt, act, leaves, pl, w, res=None):
    """Check (a)'s gradients: autograd of the plain interval, and K3 fed the
    plain forward's own substep entry states, with every plane widened to
    one lane per env. For shared planes, also K3 with the lane-1 planes
    (its env reduction), held to the float64 sum of the per-env partials
    and returned as ``sum_<plane>`` beside the plain gradient's env sum;
    ``leaves`` get their gradients from the reduced planes. The planes are
    the interval's (``di.names``: with live anchors the three anchor planes
    too); ``res`` optional residual forces."""
    import torch
    from ppr_diffphys_torch.sim import integrator as tint

    E = bq.shape[-1]
    wide = [p.detach().expand(*p.shape[:-1], E).contiguous().requires_grad_() for p in pl]
    seq = [None if x is None else x.clone().requires_grad_() for x in (act, res)]
    ins = [x.clone().requires_grad_() for x in (bq, bqd, tgt)]
    q, qd, sst = tint.interval(di.integrator, di.dt, *ins, *seq, *wide, export=True)
    ins += [x for x in seq if x is not None]
    gp = torch.autograd.grad((q * w[0]).sum() + (qd * w[1]).sum(), ins + wide)
    dbq, dbqd, dtgt, dact, dres, dwide = di._backward(
        sst, tgt, act, res, [x.detach() for x in wide], w[0], w[1])
    names = state_names(act, res) + list(di.names)
    got = [dbq, dbqd, dtgt] + [g for g, x in ((dact, act), (dres, res)) if x is not None] + list(
        dwide)
    ref, got = dict(zip(names, gp)), dict(zip(names, got))
    shared = [p.shape[-1] == 1 for p in pl]
    dplanes = list(dwide)
    if any(shared):
        reduced = di._backward(sst, tgt, act, res, [p.detach() for p in pl], w[0], w[1])[5]
        for n, sh, s, g in zip(di.names, shared, reduced, dwide):
            if not sh:
                continue
            g64 = g.double()
            bound = 2 * (E - 1) * 2.0 ** -24 * g64.abs().sum(-1, keepdim=True)
            excess = float(((s.double() - g64.sum(-1, keepdim=True)).abs() - bound).max())
            if not np.isfinite(excess) or excess > 0:
                fail("%s: K3's env reduction of %s is off the float64 sum of its "
                     "per-env partials by %.3g beyond the fp32 summation bound"
                     % (label, n, excess))
        dplanes = [s if sh else g for s, sh, g in zip(reduced, shared, dwide)]
        for n, sh, s, g in zip(di.names, shared, reduced, gp[len(ins):]):
            if sh:  # the env sum, a gradient without an env axis
                ref["sum_" + n], got["sum_" + n] = g.sum(-1, keepdim=True), s
    if leaves:
        fold = [g.sum(-1, keepdim=True) if sh else g for g, sh in zip(gp[len(ins):], shared)]
        ref.update(zip(leaves, torch.autograd.grad(pl, list(leaves.values()), fold,
                                                   retain_graph=True)))
        got.update(zip(leaves, torch.autograd.grad(pl, list(leaves.values()), dplanes)))
    return ref, got


def grad_errors(ref, got, E):
    """{name: (max|got - ref| / max|ref| over every entry, the same per env
    (a tensor of E), or None for a gradient without an env axis: a shared
    parameter, summed over the envs)}."""
    import torch

    out = {}
    for n, a in ref.items():
        b = got[n]
        if not bool(torch.isfinite(b).all()):
            fail("non-finite kernel gradient " + n)
        d = (a - b).abs() / (float(a.abs().max()) + 1e-30)
        per_env = None
        if a.ndim > 1 and a.shape[-1] == E:
            per_env = d.reshape(-1, E).amax(0)
        elif a.ndim > 1 and a.shape[0] == E:  # per-env ke/kd/mass (E, .)
            per_env = d.reshape(E, -1).amax(1)
        out[n] = (float(d.max()), per_env)
    return out


def check_grads(label, gerr, E, linearized, yard=None):
    """Check (a) when ``linearized``, else check (b) (see the tolerances).
    ``yard`` ({name: the plain gradient's own change when the start moves
    by 1e-7, over its max}) raises check (a)'s limit of each gradient to
    that change where it is larger."""
    env_tol = TOL_GRAD if linearized else TOL_GRAD_ENV
    shown = {k: [float("%.3g" % v), None if pe is None else int((pe > env_tol).sum())]
             for k, (v, pe) in gerr.items()}
    log("  %s K3 grads %s (max|kernel-plain|/max|plain|, envs beyond %g): %s"
        % (label, "at the plain linearization" if linearized else "end to end", env_tol,
           json.dumps(shown)))
    y = yard or {}
    for k, (v, pe) in gerr.items():
        if pe is None:
            ok = v <= max(TOL_GRAD_SUM, y.get(k, 0.0))
        elif linearized:
            ok = v <= max(TOL_GRAD, y.get(k, 0.0))
        else:
            ok = v <= TOL_GRAD_REL and int((pe > TOL_GRAD_ENV).sum()) <= TOL_GRAD_ENVS * E
        if not (np.isfinite(v) and ok):
            fail("%s: gradient %s error %.3g (%s envs beyond %g) exceeds tolerance"
                 % (label, k, v, shown[k][1], env_tol))


def plain_grads(di, bq, bqd, tgt, pl, w):
    """Autograd of the plain interval (no acts) for the loss sum(w *
    outputs), named as ``linearized_grads`` names them: per env, the planes
    widened to one lane per env, and ``sum_<plane>`` for the shared ones."""
    import torch
    from ppr_diffphys_torch.sim import integrator as tint
    from ppr_diffphys_torch.sim import soa

    E = bq.shape[-1]
    wide = [p.detach().expand(*p.shape[:-1], E).contiguous().requires_grad_() for p in pl]
    ins = [x.clone().requires_grad_() for x in (bq, bqd, tgt)]
    q, qd = tint.interval(di.integrator, di.dt, *ins, None, None, *wide)
    g = torch.autograd.grad((q * w[0]).sum() + (qd * w[1]).sum(), ins + wide)
    out = dict(zip(state_names(None) + list(soa.TRACED_NAMES), g))
    out.update({"sum_" + n: x.sum(-1, keepdim=True)
                for n, p, x in zip(soa.TRACED_NAMES, pl, g[3:]) if p.shape[-1] == 1})
    return out


def interval_at_width(label, di, call, w, yardstick):
    """One recorded training interval (the arguments of ``di._forward``):
    K2's values against the plain interval (TOL_INTERVAL), and K3's
    gradients, every env and its env reduction, at the plain
    linearization (check (a)). With ``yardstick``, each gradient's limit is
    raised to the plain gradient's own change when the interval's start
    moves by 1e-7 (seeded), where that is larger."""
    import torch
    from ppr_diffphys_torch.sim import integrator as tint
    from ppr_diffphys_torch.sim import soa_grad

    bq, bqd, tgt, act, res, planes = call[:6]
    if act is not None or res is not None or not all(p.shape[-1] == 1 for p in planes):
        fail(label + ": the interval got acts, residual forces or per-env planes")
    E = bq.shape[-1]
    with torch.no_grad():
        kq, kqd, sst = di._forward(bq, bqd, tgt, None, None, planes, True)
        pq, pqd = tint.interval(di.integrator, di.dt, bq, bqd, tgt, None, None, *planes)
    check_errs(label + " K2 values", {"q": float((kq - pq).abs().max()),
                                      "qd": float((kqd - pqd).abs().max())}, TOL_INTERVAL)
    n_act = soa_grad.active_contacts(di.model, sst)
    del kq, kqd, sst, pq, pqd
    ref, got = linearized_grads(label, di, bq, bqd, tgt, None, {}, list(planes), w)
    yard = None
    if yardstick:
        rng = np.random.RandomState(SEED + 11)
        nudge = lambda x: x + 1e-7 * torch.as_tensor(rng.randn(*x.shape).astype(np.float32),
                                                     device=x.device)
        moved = plain_grads(di, nudge(bq), nudge(bqd), tgt, planes, w)
        yard = {k: float((moved[k] - ref[k]).abs().max() / (ref[k].abs().max() + 1e-30))
                for k in ref}
        log("  %s yardstick: the plain gradients from a start moved by 1e-7, "
            "max|moved-plain|/max|plain|: %s"
            % (label, json.dumps({k: float("%.3g" % v) for k, v in yard.items()})))
        del moved
    check_grads(label, grad_errors(ref, got, E), E, linearized=True, yard=yard)
    log("  %s: %d penetrating contact-substeps; peak device memory %.3f GB"
        % (label, n_act, torch.cuda.max_memory_allocated() / 1e9))


def offset_workload(pbench, E, device, seed):
    """The bench's workload at E envs with seeded offsets of the joint
    targets (0.3 rad) and of the initial joint angles about them (0.1 rad).
    At the bench's own start the joints sit at their targets and the hips
    at exactly 0 rad, on the polynomial atan2's kink, and a free fall does
    not depend on mass: there the gains, mass and inertia gradients are
    rounding noise that a 1e-7 change of the start moves by more than their
    size. The offsets give them signal."""
    import torch
    from ppr_diffphys_torch.sim import integrator as tint
    from ppr_diffphys_torch.sim.kinematics import eval_fk

    base = pbench.build_workload(envs=E, device="cpu", seed=SEED)
    rng = np.random.RandomState(seed)
    n_dof = base.model.n_dof
    tgt = base.target + torch.as_tensor(np.concatenate(
        [np.zeros((E, 6)), 0.3 * rng.randn(E, n_dof)], 1).astype(np.float32))
    qs = np.tile(np.array(base.model.joint_q_init, np.float32)[None], (E, 1))
    qs[:, 7:] = tgt[:, 6:].numpy() + 0.1 * rng.randn(E, n_dof)
    st = tint.SimState(*eval_fk(base.model, torch.as_tensor(qs)))
    work = base if device == "cpu" else pbench.build_workload(envs=E, device=device, seed=SEED)
    return work._replace(target=tgt.to(device),
                         state=tint.SimState(st[0].to(device), st[1].to(device)))


def record_calls(obj, method, box, n=1):
    """Wrap ``obj.method`` on this instance only: append a detached copy of
    the arguments of each of its first ``n`` calls to ``box``, as a list.
    ``del obj.<method>`` restores the class's."""
    inner = getattr(obj, method)

    def copy(a):
        if hasattr(a, "_fields"):  # SimState, SimParams
            return type(a)(*(copy(x) for x in a))
        if isinstance(a, (tuple, list)):
            return type(a)(copy(x) for x in a)
        return a.detach().clone() if hasattr(a, "detach") else a

    def wrapped(*args):
        if len(box) < n:
            box.append([copy(a) for a in args])
        return inner(*args)

    setattr(obj, method, wrapped)


def anchor_checks(dev, a1, sub, dt):
    """Phase 9: K2/K3 with live joint anchors (with_xp) against the plain
    interval with the anchor planes, and at the model's own anchors against
    the baked kernels bit for bit."""
    import torch
    from ppr_diffphys_torch.sim import integrator as tint
    from ppr_diffphys_torch.sim import soa, soa_grad, synthetic
    from ppr_diffphys_torch.sim.kinematics import eval_fk

    t0 = time.time()
    for mname, model in (("a1", a1), ("chain45", synthetic.chain_model(extra_boxes=True))):
        E = E_CHECK
        q, qd, tgt, act = synthetic.window_problem(model, E, sub, F_CHECK, seed=SEED + 9)
        bq, bqd = eval_fk(model, torch.as_tensor(q), torch.as_tensor(qd))
        bq = synthetic.grounded(model, bq.numpy(), seed=SEED + 9)
        state = tint.SimState(torch.as_tensor(bq, device=dev), bqd.to(dev))
        with torch.no_grad():
            cforce = tint.eval_body_contacts(model, tint.default_sim_params(model, dev), state)
        if float(cforce[..., 3:].abs().max()) < 1.0:
            fail("phase 9 %s: no contact force: the check is vacuous" % mname)
        integ = tint.SemiImplicitIntegrator(model)
        rng = np.random.RandomState(SEED + 10)
        B = model.n_links
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        w = (t(rng.randn(7, B, E)), t(rng.randn(6, B, E)))
        res = t(rng.randn(sub, 6, B, E) * 0.1)
        bq_p = state.body_q.permute(2, 1, 0).contiguous()
        bqd_p = state.body_qd.permute(2, 1, 0).contiguous()
        tgt_p = t(tgt).permute(0, 2, 1).contiguous()
        act_p = t(act).permute(0, 2, 1).contiguous()
        params = tint.default_sim_params(model, dev)
        planes = soa.traced_planes(model, params)
        base = [planes[n] for n in soa.TRACED_NAMES]
        for lanes in ("per_env", "shared"):
            xp = soa.xp_planes(model, t(synthetic.perturbed_anchors(
                model, E if lanes == "per_env" else None, seed=SEED + 5)))
            pl = base + [xp[n] for n in soa.XP_NAMES]
            for ar in (True, False):
                di = soa_grad.DiffInterval(integ, dt, sub, with_act=ar, with_res=ar,
                                           with_xp=True)
                label = "phase 9 %s/%s anchors/%s (E=%d, %d contacts)" % (
                    mname, lanes, "act+res" if ar else "no act/res", E, model.contact_count)
                a_in, r_in = (act_p[:sub], res) if ar else (None, None)
                # values: one interval, then K2 chained over the window's intervals
                x, xd, px, pxd = bq_p, bqd_p, bq_p, bqd_p
                with torch.no_grad():
                    for f in range(F_CHECK - 1):
                        sl = slice(f * sub, (f + 1) * sub)
                        a_f = act_p[sl] if ar else None
                        x, xd = di(x, xd, tgt_p[sl], a_f, r_in, *pl)
                        px, pxd = tint.interval(integ, dt, px, pxd, tgt_p[sl], a_f, r_in, *pl)
                        if f == 0:
                            check_errs(label + " K2 values, 1 interval",
                                       {"q": float((x - px).abs().max()),
                                        "qd": float((xd - pxd).abs().max())}, TOL_INTERVAL)
                torch.cuda.synchronize()
                check_errs(label + " K2 chained over %d intervals" % (F_CHECK - 1),
                           {"q": float((x - px).abs().max()),
                            "qd": float((xd - pxd).abs().max())},
                           {"q": TOL_CHECK["q"], "qd": TOL_CHECK["qd"]})
                ref, got = linearized_grads(label, di, bq_p, bqd_p, tgt_p[:sub], a_in, {}, pl,
                                            w, res=r_in)
                check_grads(label, grad_errors(ref, got, E), E, linearized=True)
        # the model's own anchors as lane-1 planes: the baked kernels' results bit for bit
        own = soa.xp_planes(model, torch.as_tensor(model.joint_X_p, device=dev))
        baked = soa_grad.DiffInterval(integ, dt, sub, with_act=True)
        live = soa_grad.DiffInterval(integ, dt, sub, with_act=True, with_xp=True)
        args = (bq_p, bqd_p, tgt_p[:sub], act_p[:sub], None)
        k0 = baked._forward(*args, base, True)
        k1 = live._forward(*args, base + [own[n] for n in soa.XP_NAMES], True)
        g0 = baked._backward(k0[2], tgt_p[:sub], act_p[:sub], None, base, w[0], w[1])
        g1 = live._backward(k1[2], tgt_p[:sub], act_p[:sub], None,
                            base + [own[n] for n in soa.XP_NAMES], w[0], w[1])
        same = all(torch.equal(a, b) for a, b in zip(k0, k1)) and all(
            torch.equal(a, b) for a, b in zip(g0[:4] + tuple(g0[5]), g1[:4] + tuple(g1[5][:4])))
        if not same:
            fail("phase 9 %s: with_xp at the model's own anchors differs from the baked "
                 "kernels" % mname)
        log("  phase 9 %s: K2 states and K3's other gradients at the model's own anchors == "
            "the baked kernels', bit for bit" % mname)
    log("phase 9 with_xp interval kernels vs plain: ok (%.1f s)" % (time.time() - t0))


class PlainInterval:
    """The plain interval (integrator.interval, autograd) behind a
    DiffInterval's interface, on any device: the stand-in that holds the
    lab4d step on the kernels against the same step on the plain version."""

    def __init__(self, di):
        self.S, self.with_xp, self.names = di.S, di.with_xp, di.names
        self.integrator, self.dt = di.integrator, di.dt
        self.with_act, self.with_res = di.with_act, di.with_res

    def __call__(self, bq, bqd, tgt, act, res, *planes):
        from ppr_diffphys_torch.sim import integrator as tint

        return tint.interval(self.integrator, self.dt, bq, bqd, tgt,
                             act if self.with_act else None, res if self.with_res else None,
                             *planes)


class LinearizedPlainInterval(PlainInterval):
    """K2's values forward and the plain interval's autograd backward at the
    same inputs: a step through it has the kernels' own trajectory and the
    plain version's gradients there (phase 5's check (a) for a whole step),
    so a contact kink that the two forwards' FMA rounding crosses differently
    moves neither side."""

    def __init__(self, di):
        super().__init__(di)
        self.di = di

    def __call__(self, bq, bqd, tgt, act, res, *planes):
        import torch

        di, plain = self.di, super().__call__

        class KernelValuesPlainGrads(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *ins):
                ctx.save_for_backward(*ins)
                return di(ins[0], ins[1], ins[2], act, res, *ins[3:])

            @staticmethod
            def backward(ctx, gq, gqd):
                need = ctx.needs_input_grad
                with torch.enable_grad():
                    xs = [x.detach().requires_grad_(n) for x, n in zip(ctx.saved_tensors, need)]
                    q, qd = plain(xs[0], xs[1], xs[2], act, res, *xs[3:])
                    grads = iter(torch.autograd.grad((q, qd), [x for x in xs if x.requires_grad],
                                                     (gq, gqd), allow_unused=True))
                return tuple(next(grads) if n else None for n in need)

        return KernelValuesPlainGrads.apply(bq, bqd, tgt, *planes)


def branch_bits(integrator, dt, sst, tgt, act, res, planes):
    """The plain substep's branch decisions at each state of a (S,E,13,B)
    export, per env, as an (E, n) bool tensor: every comparison's result,
    and which side of each clamp, minimum, maximum, abs and sign the value
    fell on (contacts' penetration, damping and friction cone, joint
    limits, atan2's octants, the velocity clamps). Where two trajectories'
    bits differ in an env, that env crossed a kink between them."""
    import torch
    from torch.overrides import TorchFunctionMode
    from ppr_diffphys_torch.sim import integrator as tint

    E = sst.shape[1]
    bits = []

    class Recorder(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = getattr(func, "__name__", "")
            if name in ("__lt__", "__gt__", "__le__", "__ge__", "lt", "gt", "le", "ge"):
                masks = [out]
            elif name in ("minimum", "maximum"):
                masks = [args[0] < args[1]]
            elif name in ("abs", "sign"):
                masks = [args[0] < 0, args[0] > 0]
            elif name == "clamp":
                lo = args[1] if len(args) > 1 else kwargs.get("min")
                hi = args[2] if len(args) > 2 else kwargs.get("max")
                masks = [args[0] < b if k == 0 else args[0] > b
                         for k, b in enumerate((lo, hi)) if b is not None]
            else:
                masks = []
            # state-dependent decisions lead with the env axis; the others
            # depend on the parameters alone, which both sides share
            bits.extend(m.reshape(E, -1) for m in masks
                        if isinstance(m, torch.Tensor) and m.ndim and m.shape[0] == E)
            return out

    params, gains3 = tint.plane_params(*planes[:4], E, *planes[4:6])
    rpl = tint._plane_aos(planes[6], E) if len(planes) > 6 else None
    with torch.no_grad(), Recorder():
        for s in range(sst.shape[0]):
            state = tint.SimState(sst[s, :, :7].transpose(1, 2), sst[s, :, 7:].transpose(1, 2))
            integrator.step_only(params, state, tgt[s].T, None if act is None else act[s].T,
                                 None if res is None else res[s].permute(2, 1, 0), dt, gains3,
                                 rpl)
    return torch.cat(bits, 1)


class BranchTracked(PlainInterval):
    """The kernels (``kernels``: the DiffInterval itself) or the plain
    interval behind the DiffInterval's interface, keeping for each call the
    branch decisions (``branch_bits``) along the trajectory that side
    computed: ``bits()`` gives them for every call so far, (E, n)."""

    def __init__(self, di, kernels):
        super().__init__(di)
        self.di, self.kernels, self.calls = di, kernels, []

    def __call__(self, bq, bqd, tgt, act, res, *planes):
        import torch
        from ppr_diffphys_torch.sim import integrator as tint

        act = act if self.with_act else None
        res = res if self.with_res else None
        d = lambda x: None if x is None else x.detach()
        if self.kernels:
            out = self.di(bq, bqd, tgt, act, res, *planes)
            with torch.no_grad():  # K2 again, with its export
                sst = self.di._forward(d(bq), d(bqd), d(tgt), d(act), d(res),
                                       [p.detach() for p in planes], True)[2]
        else:
            q, qd, sst = tint.interval(self.integrator, self.dt, bq, bqd, tgt, act, res,
                                       *planes, export=True)
            out = (q, qd)
        self.calls.append(branch_bits(self.integrator, self.dt, sst, d(tgt), d(act), d(res),
                                      [p.detach() for p in planes]))
        return out

    def bits(self):
        import torch

        return torch.cat(self.calls, 1)


def lab4d_main_path(dev, sub_expect):
    """Phase 10: the lab4d coupling's main path on the card (see the module
    docstring). Returns the two with_xp kernel rows of the kernels line."""
    import torch
    from ppr_diffphys_torch.data.robot import URDFRobot
    from ppr_diffphys_torch.models import fields
    from ppr_diffphys_torch.models.interface import phys_interface
    from ppr_diffphys_torch.sim import integrator as tint
    from ppr_diffphys_torch.sim import soa_grad
    from ppr_diffphys_torch.utils import h100
    from ppr_diffphys_torch.utils.config import build_opts

    t0 = time.time()
    urdf_dir = os.path.join(REPO, "tests", "fixtures")
    offsets = [0, LAB4D_FRAMES, 2 * LAB4D_FRAMES]
    g = torch.Generator().manual_seed(SEED)
    robot = URDFRobot(os.path.join(urdf_dir, "a1", "urdf", "a1.urdf"))
    obj = fields.ObjectField(offsets, robot, g)
    scn = fields.CameraField(offsets, g, name="scene_field")
    intr = fields.IntrinsicsField(offsets)
    # the intrinsics of lab4d's 480 x 640 frames (LAB4D_IMG_SIZE): the field's
    # fx = fy = 1000 and the principal point at the image centre. Only the
    # eval's vis cameras (ks_vis) read them, which phase 11 (b) renders
    intr.init_params["ks"][:, 2] = LAB4D_IMG_SIZE[1] / 2
    intr.init_params["ks"][:, 3] = LAB4D_IMG_SIZE[0] / 2
    # Random weights, then a scene a user would have: both camera fields
    # fitted (fit_camera_mlp) to one camera 3 m from the robot, panning
    # +-0.3 rad, so the object and scene views cancel and the urdf frame maps
    # to the world by the articulation's orient and shift alone: a1 upright
    # (urdf z up), its trunk 0.45 m above the ground
    n = offsets[-1]
    pan = 0.3 * np.sin(np.arange(n) * 2 * np.pi / LAB4D_FRAMES)
    rt = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    rt[:, 0, 0], rt[:, 0, 2], rt[:, 2, 0], rt[:, 2, 2] = (np.cos(pan), np.sin(pan),
                                                          -np.sin(pan), np.cos(pan))
    rt[:, 2, 3] = 3.0
    t1 = time.perf_counter()
    for spec in (obj, scn):
        params = dict(spec.init_params)
        params["camera_mlp"] = {k: v.to(dev) for k, v in params["camera_mlp"].items()}
        spec.init_params.update(spec.fit_to_priors(params, rt, max_iters=300))
    art = obj.init_params["articulation"]
    art["orient"] = torch.tensor([np.sqrt(0.5), np.sqrt(0.5), 0.0, 0.0])  # wxyz, +90 deg about x
    art["shift"] = torch.tensor([0.0, -0.45, 0.0])
    log("phase 10 camera fields fitted to the camera priors (%d frames, 300 Adam steps "
        "each): %.3f s" % (n, time.perf_counter() - t1))
    opts = build_opts(seqname="lab4d-a1", logname="chip", urdf_template="a1", urdf_dir=urdf_dir,
                      logroot=os.path.join(REPO, "logdir", "chip_smoke"), seed=SEED,
                      pos_distill_wt=0.1, phys_vid=[0, 1], noise_std=0.0)
    model_dict = dict(scene_field=(scn, scn.init_params), object_field=(obj, obj.init_params),
                      intrinsics=(intr, intr.init_params), frame_interval=1.0 / 60,
                      frame_info=None)
    tm = phys_interface(opts, model_dict, device=dev)
    tm.robot.urdf.kp_links = list(KP_LINKS_A1)
    if tm.steps_per_fr_interval != sub_expect:
        fail("phase 10: %d substeps a frame, %d expected" % (tm.steps_per_fr_interval,
                                                              sub_expect))
    sub = tm.steps_per_fr_interval
    log("phase 10 interface built: %.1f s (a1, fields over videos %s, %d substeps a frame, "
        "pos_distill_wt %g, noise_std %g)" % (time.time() - t0, offsets, sub,
                                              opts["pos_distill_wt"], tm.noise_std))
    tm.override_control_ref_states()
    t1 = time.perf_counter()
    tm.correct_scale(np.arange(4), max_steps=8)
    log("phase 10 correct_scale (4 frames, at most 8 steps): %.3f s, scene logscale %.4f"
        % (time.perf_counter() - t1, float(tm.params["scene_field"]["logscale"])))

    tm.reinit_envs(E_TRAIN, frames_per_wdw=F_TRAIN, is_eval=False)
    di = tm._interval(True)
    calls = []  # the warm-up step's intervals; the last one, after the landing, is timed
    record_calls(di, "_forward", calls, n=F_TRAIN - 1)

    def step():
        out = tm.forward()
        gd = tm.update()
        torch.cuda.synchronize()
        return out, gd

    step()  # warm-up (records the intervals' inputs)
    del di._forward
    proxy = [t.detach().clone() for n, t in tm.named_tensors() if n.startswith("kinematics_proxy")]
    for k in di.launches:
        di.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(3):
        t1 = time.perf_counter()
        out, gd = step()
        walls.append(time.perf_counter() - t1)
        losses = {k: float(v) for k, v in out.items()}
        log("  phase 10 step %d: wall %.3f ms, losses %s" % (i, walls[-1] * 1e3,
                                                            json.dumps(losses)))
        if not all(np.isfinite(v) for v in losses.values()):
            fail("phase 10: non-finite loss")
        if not losses["loss_pos_distill"] > 0:
            fail("phase 10: pos_distill is not positive")
    launches = dict(di.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ro_main = float(tm.last_grads["object_field.articulation.rest_offsets"].abs().max())
    if not (np.isfinite(ro_main) and ro_main > 0):
        fail("phase 10: no gradient reached object_field.articulation.rest_offsets")
    n_int = F_TRAIN - 1
    want = {soa_grad.KERNEL_FWD: 3 * n_int, soa_grad.KERNEL_BWD: 3 * n_int,
            soa_grad.KERNEL_REDUCE: 3 * n_int}
    log("phase 10 launches during the main path (with_xp): %s" % json.dumps(launches))
    if launches != want:
        fail("phase 10: launches %s, expected %s (one of each per interval and step)"
             % (json.dumps(launches), json.dumps(want)))
    if any(isinstance(k, tuple) and k[0] in ("window",) for k in tm._kernels) or any(
            isinstance(k, tuple) and k[0] == "interval" and not k[-1] for k in tm._kernels):
        fail("phase 10: the lab4d path built a kernel without anchor planes: %s"
             % list(tm._kernels))
    bq0, bqd0, tgt0, act0, res0, planes0 = calls[-1][:6]
    del calls
    if len(planes0) != 7 or planes0[4].shape[-1] != E_TRAIN:
        fail("phase 10: the interval did not get per-env anchor planes")
    changed = sum(int(not torch.equal(a, t)) for a, (n, t) in zip(
        proxy, [(n, t) for n, t in tm.named_tensors() if n.startswith("kinematics_proxy")]))
    if changed == 0:
        fail("phase 10: no kinematics_proxy tensor changed over 3 steps")
    log("phase 10 train step wall ms (3 steps, %d envs x %d frames): %s; median %.3f ms; "
        "peak device memory %.3f GB; %d launches of each with_xp kernel per step; %d "
        "kinematics_proxy tensors changed; object_field.articulation.rest_offsets "
        "gradient max %.3g (the anchors' gradient reached the fields)"
        % (E_TRAIN, F_TRAIN, [round(x * 1e3, 3) for x in walls],
           float(np.median(walls)) * 1e3, peak_gb, n_int, changed, ro_main))
    profile_steps(step, 2, E_TRAIN, F_TRAIN)

    # the with_xp K2 and K3 alone on the main path's last-interval inputs
    rng = np.random.RandomState(SEED + 12)
    B = tm.n_links
    w = (torch.as_tensor(rng.randn(7, B, E_TRAIN).astype(np.float32), device=dev),
         torch.as_tensor(rng.randn(6, B, E_TRAIN).astype(np.float32), device=dev))
    k2_call = lambda: di._forward(bq0, bqd0, tgt0, None, None, planes0, True)
    k2_ms, (kq, kqd, sstate) = cuda_time_ms(k2_call, 10)
    k2_dev_ms = queued_ms(k2_call, 20)
    k3_call = lambda: di._backward(sstate, tgt0, None, None, planes0, w[0], w[1])
    k3_ms, _ = cuda_time_ms(k3_call, 10)
    k3_dev_ms = queued_ms(k3_call, 20)
    p2_ms, (pq, pqd) = cuda_time_ms(lambda: tint.interval(di.integrator, di.dt, bq0, bqd0,
                                                          tgt0, None, None, *planes0), 1)

    def plain_bwd():
        ins = [x.clone().requires_grad_() for x in (bq0, bqd0, tgt0) + tuple(planes0)]
        q, qd = tint.interval(di.integrator, di.dt, ins[0], ins[1], ins[2], None, None,
                              *ins[3:])
        return torch.autograd.grad((q * w[0]).sum() + (qd * w[1]).sum(), ins)

    p3_ms, _ = cuda_time_ms(plain_bwd, 1)
    label = "phase 10 main-path with_xp interval"
    k2_err = {"q": float((kq - pq).abs().max()), "qd": float((kqd - pqd).abs().max())}
    check_errs(label + " K2 values", k2_err, TOL_INTERVAL)
    ref, got = linearized_grads(label, di, bq0, bqd0, tgt0, None, {}, list(planes0), w)
    check_grads(label, grad_errors(ref, got, E_TRAIN), E_TRAIN, linearized=True)
    k3_abs = max(float((got[n] - ref[n]).abs().max()) for n in ("xp_t", "xp_q", "rp_local"))
    del ref, got
    n_act = soa_grad.active_contacts(tm.env, sstate)
    iw = soa_grad.interval_work(tm.env, E_TRAIN, sub, n_active_contacts=n_act, xp_lanes=E_TRAIN)
    k2_roof = h100.roofline(iw["fwd_bytes"], iw["fwd_ops"])
    k3_roof = h100.roofline(iw["bwd_bytes"], iw["bwd_ops"])
    log("phase 10 with_xp interval times (E=%d, %d substeps, per-env anchors, the last "
        "interval of the main path's warm-up step; wrappers by CUDA events over 10 calls, "
        "device time by CUDA events around 20 calls queued behind a device sleep): K2 %.3f "
        "ms (%.3f ms of "
        "device time; bound %.4f ms by %s), plain forward %.1f ms; K3 incl. reduce %.3f ms "
        "(%.3f ms of device time; bound %.4f ms by %s; %d active contact-substeps), plain "
        "backward %.1f ms"
        % (E_TRAIN, sub, k2_ms, k2_dev_ms, k2_roof["ms"], k2_roof["by"], p2_ms, k3_ms,
           k3_dev_ms, k3_roof["ms"], k3_roof["by"], n_act, p3_ms))
    del sstate, kq, kqd, pq, pqd

    # the eval forward over both videos (1 env): the with_xp K2 chained, no K1
    tm.reinit_envs(1, frames_per_wdw=tm.total_frames, is_eval=True)
    for k in di.launches:
        di.launches[k] = 0
    t1 = time.perf_counter()
    ev = tm.forward()
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t1) * 1e3
    log("phase 10 eval (1 env x %d frames): %.3f ms, losses %s, launches %s"
        % (tm.frames_per_wdw, eval_ms, json.dumps({k: float(v) for k, v in ev.items()}),
           json.dumps(di.launches)))
    if di.launches != {soa_grad.KERNEL_FWD: tm.frames_per_wdw - 1, soa_grad.KERNEL_BWD: 0,
                       soa_grad.KERNEL_REDUCE: 0}:
        fail("phase 10 eval: launches %s, expected %d K2 and nothing else"
             % (json.dumps(di.launches), tm.frames_per_wdw - 1))
    if any(isinstance(k, tuple) and k[0] == "window" for k in tm._kernels):
        fail("phase 10 eval: the window kernel K1 was built")
    if not all(np.isfinite(float(v)) for v in ev.values()):
        fail("phase 10 eval: non-finite loss")
    cam = tm.get_camera()
    if cam.shape != (tm.frames_per_wdw, 4, 4) or not np.isfinite(cam).all():
        fail("phase 10: get_camera gave %s" % (cam.shape,))
    tm.params["kinematics_distilled"]["scene_field"]["logscale"].add_(0.01)
    tm.override_states_inv()
    if not torch.equal(tm.params["scene_field"]["logscale"],
                       tm.params["kinematics_distilled"]["scene_field"]["logscale"]):
        fail("phase 10: override_states_inv did not copy the distilled fields back")
    log("phase 10 get_camera %s, override_states_inv ok" % (cam.shape,))
    vis_data = tm.query(img_size=LAB4D_IMG_SIZE)  # phase 11 (b) renders it
    vis_data["model"] = tm.env

    # at E_SMALL envs: the same step on the kernels and on the plain version,
    # over F_SMALL frames
    tm.reinit_envs(E_SMALL, frames_per_wdw=F_SMALL, is_eval=False)
    half = E_SMALL // 2
    fs = np.concatenate([o + np.round(np.linspace(0, LAB4D_FRAMES - F_SMALL, E_SMALL - half
                                                  if o else half))
                         for o in offsets[:2]]).astype(np.float32)
    outs, bits = {}, {}
    key = ("interval", id(tm.integrator), sub, True)
    kernel_di = tm._kernels[key]
    for name, fn in (("kernels", BranchTracked(kernel_di, True)),
                     ("plain", BranchTracked(kernel_di, False)),
                     ("linearized", LinearizedPlainInterval(kernel_di))):
        tm._kernels[key] = fn
        out = tm.forward(frame_start=fs)
        torch.cuda.synchronize()
        outs[name] = ({k: float(v) for k, v in out.items()}, dict(tm.last_grads))
        if isinstance(fn, BranchTracked):
            bits[name] = fn.bits()
    (lk, gk), (lp, gp), (ll, gl) = outs["kernels"], outs["plain"], outs["linearized"]
    err = lambda g, ref: {n: float((g[n] - ref[n]).abs().max() / (ref[n].abs().max() + 1e-30))
                          for n in ref}
    rel, e2e = err(gk, gl), err(gk, gp)
    flips = (bits["kernels"] != bits["plain"]).sum(1).tolist()
    top = lambda d: json.dumps({k: float("%.3g" % v)
                                for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:5]})
    log("  phase 10 step at %d envs x %d frames on the card: total loss on the kernels %.9g, "
        "on the plain interval %.9g; %d gradients, the largest max|kernel-plain|/max|plain| at "
        "the kernels' trajectory %s (tol %g); end to end, each side on its own trajectory, %s; "
        "branch decisions that differ between the two trajectories, per env, %s of %d"
        % (E_SMALL, F_SMALL, lk["total_loss"], lp["total_loss"], len(rel), top(rel),
           TOL_GRAD_SUM, top(e2e), flips, bits["plain"].shape[1]))
    # each env alone, end to end: an env whose gradients leave TOL_GRAD_SUM
    # must have crossed a kink, i.e. taken another branch somewhere
    t1 = time.perf_counter()
    tm.reinit_envs(1, frames_per_wdw=F_SMALL, is_eval=False)
    alone = []
    for i in range(E_SMALL):
        got = {}
        for kernels in (True, False):
            fn = BranchTracked(kernel_di, kernels)
            tm._kernels[key] = fn
            tm.forward(frame_start=fs[i:i + 1])
            got[kernels] = (dict(tm.last_grads), fn.bits())
        (gk1, bk1), (gp1, bp1) = got[True], got[False]
        worst = max(err(gk1, gp1).items(), key=lambda kv: kv[1])
        alone.append((float("%.3g" % worst[1]), worst[0], int((bk1 != bp1).sum())))
    torch.cuda.synchronize()
    tm._kernels[key] = kernel_di
    tm._grad_accum = []
    log("  phase 10 each env alone (1 env x %d frames, frame starts %s), end to end: per env "
        "[largest max|kernel-plain|/max|plain|, its gradient, branch decisions that differ "
        "of %d] %s (%.1f s)"
        % (F_SMALL, fs.astype(int).tolist(), bp1.shape[1], json.dumps(alone),
           time.perf_counter() - t1))
    if any(abs(lk[k] - lp[k]) > TOL_GRAD_SUM * max(abs(lp[k]), 1e-12) for k in lp):
        fail("phase 10: losses on the kernels and the plain version disagree: %s vs %s"
             % (json.dumps(lk), json.dumps(lp)))
    if ll != lk:
        fail("phase 10: the linearized step's losses %s are not the kernels' %s"
             % (json.dumps(ll), json.dumps(lk)))
    if not all(np.isfinite(v) and v <= TOL_GRAD_SUM for v in rel.values()):
        fail("phase 10: gradients on the kernels and the plain version at the kernels' "
             "trajectory disagree")
    if not all(np.isfinite(v) for v in e2e.values()) or (
            max(e2e.values()) > TOL_GRAD_SUM and not any(flips)):
        fail("phase 10: end-to-end gradients on the kernels and the plain version disagree "
             "beyond %g with the same branches taken in every env" % TOL_GRAD_SUM)
    odd = [i for i, (e, _, n) in enumerate(alone) if not np.isfinite(e)
           or (e > TOL_GRAD_SUM and n == 0)]
    if odd:
        fail("phase 10: envs %s alone: end-to-end gradients on the kernels and the plain "
             "version disagree beyond %g with the same branches taken" % (odd, TOL_GRAD_SUM))
    ro = float(gk["object_field.articulation.rest_offsets"].abs().max())
    if not ro > 0:
        fail("phase 10: no gradient reached object_field.articulation.rest_offsets")
    log("phase 10 lab4d main path: ok (%.1f s); rest_offsets gradient max %.3g"
        % (time.time() - t0, ro))
    tree = tm.state_np()  # phase 12 (c) starts from these parameters
    del tm
    torch.cuda.empty_cache()
    row = lambda name, launches, err, ms, pms, roof, dms: {
        "name": name, "route": "cuda", "source": "ppr_diffphys_torch/csrc/soa_interval.cu",
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": pms,
        "bound_ms": roof["ms"], "bound_by": roof["by"], "library_ms": None,
        "design": "warp-per-env", "device_ms": dms}
    return [dict(row(soa_grad.KERNEL_FWD + "[with_xp]", launches[soa_grad.KERNEL_FWD],
                     k2_err["q"], k2_ms, p2_ms, k2_roof, k2_dev_ms),
                 replaces="ppr_diffphys_tpu/sim/pallas_soa_grad.py:473"),
            dict(row(soa_grad.KERNEL_BWD + "[with_xp]",
                     launches[soa_grad.KERNEL_BWD] + launches[soa_grad.KERNEL_REDUCE], k3_abs,
                     k3_ms, p3_ms, k3_roof, k3_dev_ms),
                 replaces="ppr_diffphys_tpu/sim/pallas_soa_grad.py:526")], vis_data, tree


class FrameRecorder:
    """Wraps ``utils.io.save_vid``: keeps every stream's frames in memory (by
    file name) and writes the mp4 only where cv2 is installed."""

    def __init__(self, tio, write):
        self.tio, self.write, self.real = tio, write, tio.save_vid
        self.frames = {}

    def __call__(self, outpath, frames, *a, **kw):
        self.frames[os.path.basename(outpath)] = np.stack(frames)
        if self.write:
            self.real(outpath, frames, *a, **kw)

    def __enter__(self):
        self.tio.save_vid = self
        return self

    def __exit__(self, *exc):
        self.tio.save_vid = self.real


class RenderTimer:
    """Counts and times ``SoftwareRenderer.render`` calls (host clock)."""

    def __init__(self, cls):
        self.cls, self.real, self.n, self.s = cls, cls.render, 0, 0.0

    def __enter__(self):
        real = self.real

        def render(renderer, *a, **kw):
            t = time.perf_counter()
            out = real(renderer, *a, **kw)
            self.s += time.perf_counter() - t
            self.n += 1
            return out

        self.cls.render = render
        return self

    def __exit__(self, *exc):
        self.cls.render = self.real

    def ms(self):
        return self.s * 1e3 / max(self.n, 1)


def robot_pixels(frame, floor):
    """Pixels where a rendered frame differs from the floor alone under the
    same camera and light: the robot (and its arrows) drawn."""
    return int(np.any(frame != floor, axis=-1).sum())


def vis_and_io(smi, lab4d_vis):
    """Phase 11: the port's visualization and IO on the card's two user paths
    (see the module docstring)."""
    import contextlib
    import io
    import tempfile

    import torch
    from ppr_diffphys_torch import main as tmain, render_intermediate
    from ppr_diffphys_torch.models import phys_model as pm_mod
    from ppr_diffphys_torch.sim import soa, soa_grad
    from ppr_diffphys_torch.utils import io as tio, vis as tvis
    from ppr_diffphys_torch.utils.render import SoftwareRenderer

    t0 = time.time()
    missing = tvis.missing_packages(("cv2", "tensorboard"))
    if "tensorboard" in missing:
        fail("phase 11: tensorboard is not installed: the CLI's logs cannot be written")
    write_mp4 = "cv2" not in missing
    if not write_mp4:
        log("vis: mp4 not written: cv2 absent (every frame is still rendered in memory and "
            "checked)")
        tvis.VIDEO_PACKAGES = ()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_vis")
    root = tmp.name

    # (a) the training CLI: one round of 2 iterations at the main path's width;
    # the loop runs num_rounds * iters_per_round + 1 iterations, and a round
    # (checkpoint, eval, videos) starts at iterations 0 and 2
    argv = ["--urdf_template", "a1", "--seqname", "a1-synth",
            "--datadir", os.path.join(REPO, "tests", "fixtures", "motion_sequences"),
            "--urdf_dir", os.path.join(REPO, "tests", "fixtures"), "--logroot", root,
            "--logname", "smoke", "--num_rounds", "1", "--iters_per_round", "2",
            "--num_envs", str(E_TRAIN), "--frames_per_wdw", str(F_TRAIN), "--seed", str(SEED),
            "--render_vis", "--profile_dir", os.path.join(root, "prof")]
    built = []

    class Recorded(pm_mod.phys_model):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    out = io.StringIO()
    pm_mod.phys_model = Recorded
    try:
        with FrameRecorder(tio, write_mp4) as rec, RenderTimer(SoftwareRenderer) as rt, \
                contextlib.redirect_stdout(out):
            t1 = time.perf_counter()
            tmain.train_one(tmain.parse_args(argv))
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t1
    finally:
        pm_mod.phys_model = Recorded.__bases__[0]
    lines = [json.loads(l) for l in out.getvalue().splitlines() if l.startswith("{")]
    evals = [l for l in lines if "eval/traj" in l]
    iters = [l for l in lines if "total_loss" in l]
    if [l["it"] for l in evals] != [0, 2] or [l["it"] for l in iters] != [0, 1, 2]:
        fail("phase 11 CLI: JSON lines for evals %s and iterations %s"
             % ([l["it"] for l in evals], [l["it"] for l in iters]))
    if not (all(np.isfinite(l["total_loss"]) for l in iters)
            and all(np.isfinite(l["eval/traj"]) for l in evals)):
        fail("phase 11 CLI: non-finite loss")
    (model,) = built
    window = [k for key, k in model._kernels.items() if key[0] == "window"]
    interval = [k for key, k in model._kernels.items() if key[0] == "interval"]
    launches = {soa.KERNEL: sum(w.launches for w in window)}
    for di in interval:
        for k, v in di.launches.items():
            launches[k] = launches.get(k, 0) + v
    n_int = F_TRAIN - 1
    want = {soa.KERNEL: len(evals), soa_grad.KERNEL_FWD: len(iters) * n_int,
            soa_grad.KERNEL_BWD: len(iters) * n_int, soa_grad.KERNEL_REDUCE: len(iters) * n_int}
    log("phase 11 CLI (%d envs x %d frames, %d iterations, evals at iterations %s): %.1f s; "
        "iteration walls (iter_time) %s s; eval/traj %s; losses %s; launches %s"
        % (E_TRAIN, F_TRAIN, len(iters), [l["it"] for l in evals], cli_s,
           [l["iter_time"] for l in iters], [l["eval/traj"] for l in evals],
           [l["loss"] for l in iters], json.dumps(launches)))
    if launches != want:
        fail("phase 11 CLI: launches %s, expected %s (one K1 per eval; one K2, K3 and "
             "reduction per interval and iteration)" % (json.dumps(launches), json.dumps(want)))
    save = os.path.join(root, "a1-synth-smoke")
    names = ["ckpt_phys_0000.pth", "sim_traj-00000.obj"]
    if write_mp4:
        names += ["%s-00000.mp4" % k for k in ("target", "sim", "control_ref", "all")]
    for n in names:
        path = os.path.join(save, n)
        if not (os.path.exists(path) and os.path.getsize(path) > 0):
            fail("phase 11 CLI: %s missing or empty" % n)
    trace = os.path.join(root, "prof", "trace.json")
    if not (os.path.exists(trace) and os.path.getsize(trace) > 0):
        fail("phase 11 CLI: no profiler trace")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(save, size_guidance={"scalars": 0})
    acc.Reload()
    for key, recs in (("eval/traj", evals), ("loss", iters)):
        got = [(e.step, e.value) for e in acc.Scalars(key)]
        want_tb = [(r["it"], float(np.float32(r[key]))) for r in recs]
        if got != want_tb:
            fail("phase 11 CLI: tensorboard %s %s, JSON lines %s" % (key, got, want_tb))
    streams = sorted(k for k in rec.frames if k.endswith("-00000"))
    sim = rec.frames["sim-00000"]
    floor_r = SoftwareRenderer(256, 256)
    floor_r.set_light_topdown(gl=True)
    vis = tvis.PhysVisualizer(os.path.join(root, "floor"), render_video=False)
    floor = vis._render(floor_r, [])
    vis.close()
    drawn = [robot_pixels(sim[i], floor) for i in (0, len(sim) - 1)]
    vis_s = [l["vis_time"] for l in evals]
    t1 = time.perf_counter()
    for _ in range(20):
        model.env.collision_mesh()
    mesh_ms = (time.perf_counter() - t1) / 20 * 1e3
    log("phase 11 CLI outputs: %s; streams %s of %s frames; robot pixels in the first and "
        "last sim frames %s; profiler trace %.1f MB; tensorboard eval/traj and loss == the "
        "JSON lines" % (", ".join(names), streams, sim.shape, drawn,
                        os.path.getsize(trace) / 1e6))
    if sim.shape[0] != model.total_frames or min(drawn) < 100:
        fail("phase 11 CLI: the sim video does not show the robot (%s frames, %s pixels)"
             % (sim.shape[0], drawn))
    log("phase 11 vis host time: vis.show %s s per round (query() and show(), %d frames, %d "
        "streams); rasterizer %.3f ms per stream frame over %d renders; collision_mesh() %.3f "
        "ms per call, one per posed robot, 3 a frame here (%s)"
        % (vis_s, model.total_frames, len(streams), rt.ms(), rt.n, mesh_ms, smi))
    ri_dir = save
    del built, model, window, interval
    torch.cuda.empty_cache()

    # (b) the lab4d eval's query(img_size), rendered with its cameras
    H, W, scale = LAB4D_IMG_SIZE
    with FrameRecorder(tio, write_mp4) as rec, RenderTimer(SoftwareRenderer) as rt:
        vis = tvis.PhysVisualizer(os.path.join(root, "lab4d"), render_video=write_mp4)
        t1 = time.perf_counter()
        vis.show(0, lab4d_vis, fps=30.0)
        show_s = time.perf_counter() - t1
        vis.close()
    want_streams = ["target", "sim", "control_ref", "distilled", "all"]
    if sorted(rec.frames) != sorted("%s-00000" % k for k in want_streams):
        fail("phase 11 lab4d: streams %s" % sorted(rec.frames))
    for k, fr in rec.frames.items():
        n_frames = len(lab4d_vis["sim_traj"])
        width = int(W * scale) * (len(want_streams) - 1 if k.startswith("all") else 1)
        if fr.shape != (n_frames, int(H * scale), width, 3) or not (fr != 255).any():
            fail("phase 11 lab4d: stream %s is %s or blank" % (k, fr.shape))
    cam0 = lab4d_vis["camera"][0]
    r = SoftwareRenderer(int(H * scale), int(W * scale))
    r.set_light_topdown(gl=True)
    m = np.eye(4, dtype=np.float32)
    m[:3] = cam0[:3]
    r.set_camera(m)
    r.set_intrinsics(cam0[3] * scale)
    floor0 = vis._render(r, [], keep_camera=True)
    drawn = {k: robot_pixels(rec.frames[k + "-00000"][0], floor0) for k in want_streams[:4]}
    objs = [n for n in os.listdir(os.path.join(root, "lab4d")) if n.endswith(".obj")]
    log("phase 11 lab4d vis: query(img_size=%s) over %d frames, streams %s at %dx%d, OBJ "
        "strips %s; robot pixels in frame 0 %s; vis.show %.3f s, rasterizer %.3f ms per "
        "stream frame over %d renders (%s)"
        % (LAB4D_IMG_SIZE, len(lab4d_vis["sim_traj"]), want_streams, int(H * scale),
           int(W * scale), sorted(objs), json.dumps(drawn), show_s, rt.ms(), rt.n, smi))
    if sorted(objs) != ["distilled_traj-00000.obj", "sim_traj-00000.obj"]:
        fail("phase 11 lab4d: OBJ strips %s" % objs)
    if min(drawn.values()) < 100:
        fail("phase 11 lab4d: the robot is not drawn in frame 0 with its camera: %s"
             % json.dumps(drawn))

    # (c) render_intermediate over the CLI's OBJ strips
    with FrameRecorder(tio, write_mp4) as rec, contextlib.redirect_stdout(io.StringIO()):
        mp4 = render_intermediate.main(["--testdir", ri_dir, "--image_size", "256"])
    fr = rec.frames.get("sim_traj")
    if mp4 is None or fr is None or fr.shape != (2, 256, 256, 3) or not (fr != 255).any():
        fail("phase 11 render_intermediate: %s" % (None if fr is None else fr.shape,))
    if write_mp4 and not os.path.getsize(mp4) > 0:
        fail("phase 11 render_intermediate: %s is empty" % mp4)
    tmp.cleanup()
    log("phase 11 render_intermediate: %s frames from the CLI's 2 OBJ strips%s" % (
        fr.shape, ", written to sim_traj.mp4" if write_mp4 else ""))
    log("phase 11 vis and IO: ok (%.1f s)" % (time.time() - t0))


# ---------------------------------------------------------------------------
# phase 12: multi-GPU on one card
# ---------------------------------------------------------------------------
def cli_argv(logroot, envs, *extra):
    """The training CLI's arguments of phase 12: a1 at ``envs`` envs x
    F_TRAIN frames, one round of 2 iterations (the loop runs 3; evals at 0
    and 2), no videos."""
    return ["--urdf_template", "a1", "--seqname", "a1-synth",
            "--datadir", os.path.join(REPO, "tests", "fixtures", "motion_sequences"),
            "--urdf_dir", os.path.join(REPO, "tests", "fixtures"), "--logroot", logroot,
            "--logname", "smoke", "--num_rounds", "1", "--iters_per_round", "2",
            "--num_envs", str(envs), "--frames_per_wdw", str(F_TRAIN), "--seed", str(SEED),
            "--no-render_vis"] + list(extra)


def model_launches(model):
    """Launches of a phys_model's own kernels: K1 (window) and the interval
    kernels."""
    from ppr_diffphys_torch.sim import soa

    out = {soa.KERNEL: sum(k.launches for key, k in model._kernels.items()
                           if key[0] == "window")}
    for key, di in model._kernels.items():
        if key[0] == "interval":
            for k, v in di.launches.items():
                out[k] = out.get(k, 0) + v
    return out


class CommTimer:
    """CUDA-event times of ``sharding.sum_grads`` and ``sharding.gather_envs``
    calls on a mesh (the sharded train step's two collectives), while
    active."""

    NAMES = ("sum_grads", "gather_envs")

    def __init__(self):
        from ppr_diffphys_torch.parallel import sharding

        self.mod, self.events = sharding, {n: [] for n in self.NAMES}

    def __enter__(self):
        import torch

        self.saved = {n: getattr(self.mod, n) for n in self.NAMES}
        for n in self.NAMES:
            inner, box = self.saved[n], self.events[n]

            def timed(*a, _inner=inner, _box=box, _mesh_at=0 if n == "sum_grads" else 1):
                if a[_mesh_at] is None:
                    return _inner(*a)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = _inner(*a)
                ev[1].record()
                _box.append(ev)
                return out

            setattr(self.mod, n, timed)
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.mod, n, f)

    def ms(self, steps):
        import torch

        torch.cuda.synchronize()
        return {n + "_ms_per_step": sum(a.elapsed_time(b) for a, b in ev) / steps
                for n, ev in self.events.items()}


def run_cli(argv):
    """``main.train_one`` on argv in this process: (its model, its JSON
    lines, wall s, how many pickle.dump calls it made)."""
    import contextlib
    import io
    import pickle

    import torch
    from ppr_diffphys_torch import main as tmain
    from ppr_diffphys_torch.models import phys_model as pm_mod

    built, dumps = [], []

    class Recorded(pm_mod.phys_model):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    dump = pickle.dump

    def counted(*a, **kw):
        dumps.append(1)
        return dump(*a, **kw)

    out = io.StringIO()
    pm_mod.phys_model, pickle.dump = Recorded, counted
    try:
        with contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            tmain.train_one(tmain.parse_args(argv))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        pm_mod.phys_model, pickle.dump = Recorded.__bases__[0], dump
    lines = [json.loads(l) for l in out.getvalue().splitlines() if l.startswith("{")]
    return built[0], lines, wall, len(dumps)


def lab4d_from_tree(tree, dev, logroot):
    """Phase 10's interface (its fields' specs from the same seed, a1 with
    its calf links as kp links) with the parameters ``tree`` (the JAX
    layout, as ``state_np`` gives them)."""
    import torch
    from ppr_diffphys_torch.data.robot import URDFRobot
    from ppr_diffphys_torch.models import fields
    from ppr_diffphys_torch.models.interface import phys_interface
    from ppr_diffphys_torch.utils.config import build_opts

    urdf_dir = os.path.join(REPO, "tests", "fixtures")
    offsets = [0, LAB4D_FRAMES, 2 * LAB4D_FRAMES]
    g = torch.Generator().manual_seed(SEED)
    obj = fields.ObjectField(offsets, URDFRobot(os.path.join(urdf_dir, "a1", "urdf", "a1.urdf")),
                             g)
    scn = fields.CameraField(offsets, g, name="scene_field")
    intr = fields.IntrinsicsField(offsets)
    opts = build_opts(seqname="lab4d-a1", logname="chip", urdf_template="a1", urdf_dir=urdf_dir,
                      logroot=logroot, seed=SEED, pos_distill_wt=0.1, phys_vid=[0, 1],
                      noise_std=0.0)
    md = dict(scene_field=(scn, scn.init_params), object_field=(obj, obj.init_params),
              intrinsics=(intr, intr.init_params), frame_interval=1.0 / 60, frame_info=None)
    tm = phys_interface(opts, md, device=dev)
    tm.robot.urdf.kp_links = list(KP_LINKS_A1)
    tm.load_params_from_jax(tree)
    return tm


def lab4d_steps(tm, n):
    """n forward()+update() steps of the interface at E_SMALL envs x F_SMALL
    frames from drawn frame starts: (per step its losses and grad/ norms,
    walls s)."""
    import torch

    tm.reinit_envs(E_SMALL, frames_per_wdw=F_SMALL, is_eval=False)
    losses, walls = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        out = tm.forward()
        gd = tm.update()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(dict({k: float(v) for k, v in out.items()}, **gd))
    return losses, walls


LAB4D_PAR_STEPS = 2  # phase 12 (c)'s steps
# phase 12 (b)'s envs: under tp every trunk layer's activations cross the
# host through gloo forward and backward (~0.1-0.4 GB a layer a rank at 256
# envs x 24 frames, 43 split layers a step), so (b) runs at 64 envs
E_TP = 64


def _rank_job(job, rank, dev, tmpdir):
    import torch
    from ppr_diffphys_torch.parallel import sharding

    import contextlib
    import io

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with CommTimer() as ct, contextlib.redirect_stdout(io.StringIO()):
        if job["kind"] == "cli":
            model, lines, wall, dumps = run_cli(job["argv"])
            steps = len([l for l in lines if "total_loss" in l]) or 3
            res = dict(lines=lines, wall_s=wall, pickle_dumps=dumps)
        else:
            with open(job["tree"], "rb") as f:
                import pickle

                tree = pickle.load(f)
            model = lab4d_from_tree(tree, dev, os.path.join(tmpdir, "lab4d%d" % rank))
            losses, walls = lab4d_steps(model, LAB4D_PAR_STEPS)
            steps = LAB4D_PAR_STEPS
            res = dict(losses=losses, walls=walls)
    mesh = model._mesh_for(model.num_envs if job["kind"] == "lab4d" else job["envs"])
    res.update(ct.ms(steps), job_s=time.perf_counter() - t0, launches=model_launches(model),
               params=model.state_np(),
               agree=sharding.replicas_agree([t for _, t in model.named_tensors()]),
               mesh=None if mesh is None else mesh.shape,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model
    torch.cuda.empty_cache()
    return res


def rank_main(rank, world, tmpdir, jobs):
    """One rank of phase 12: gloo through a FileStore, on cuda:0 (every
    rank shares the one card), the jobs in order; writes its results."""
    import pickle
    import traceback

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    sys.path.insert(0, REPO)
    try:
        import torch.distributed as dist
        import ppr_diffphys_torch  # noqa: F401  (fp32, TF32 off)
        from ppr_diffphys_torch.parallel import sharding

        _, _, dev = sharding.init_distributed(
            "cuda", backend="gloo", init_method="file://" + os.path.join(tmpdir, "store"),
            timeout_s=300)
        out = {job["name"]: _rank_job(job, rank, dev, tmpdir) for job in jobs}
        out["backend"] = dist.get_backend()
        dist.destroy_process_group()
        with open(os.path.join(tmpdir, "rank%d.pkl" % rank), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmpdir, "rank%d.err" % rank), "w") as f:
            f.write(traceback.format_exc())
        raise


def tree_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# Sharded vs one process, on the card: each rank's MLP products, FK and
# rollout run over its own envs (other row blocks, other cuBLAS choices) and
# the gradient is summed in another order, so the two differ by rounding,
# which the a1 landing amplifies over 759 substeps (measured: 1.05e-4 of
# loss_reg_foot after the updates, NVIDIA H100 80GB HBM3 at 700 W), and
# across a contact kink one env's gradient may jump (PERF.md §6). So losses,
# and every tensor's gradient norm at the first step (the same parameters
# on both sides: Adam's steps do not scale with the gradient, so the
# parameters alone would not show a gradient summed wrongly), to
# TOL_GRAD_SUM relative, as phase 10 holds two roundings of one step;
# parameters after the updates to 1e-5 relative plus 1e-5 absolute, except
# entries whose gradient is within rounding of Adam's eps (1e-8), which may
# take another step: at most 1e-4 of a tensor's entries, each within Adam's
# step bound (the largest peak lr, 1e-3, per update). The lab4d step (c) runs
# 8 envs, each 1/8 of a gradient: one env's kink moves a gradient norm by up
# to 2.5e-4 there, and more entries take another Adam step (measured: 57 of
# ~1.9M, the largest 9.9e-5; one process alone gives the same bits run to
# run at that size), so (c)'s entries are held to the step bound alone.
PAR_LOSS_RTOL = TOL_GRAD_SUM


def par_compare(label, losses, ref_losses, params, ref_params, updates, entry_rule=True):
    """Largest loss, first-step gradient-norm and parameter differences
    against one process, and the problems beyond the tolerances above (the
    caller logs, then fails); ``entry_rule`` False holds the parameters to
    Adam's step bound alone."""
    loss_rel, worst_loss = max((abs(a[k] - b[k]) / max(abs(b[k]), 1e-12), "%s at step %d"
                                % (k, i)) for i, (a, b) in enumerate(zip(losses, ref_losses))
                               for k in b if k.startswith("loss") or k == "total_loss")
    norms = {k: v for k, v in ref_losses[0].items() if k.startswith("grad/")}
    grad_rel, worst_grad = max(((abs(losses[0].get(k, np.inf) - v) / max(abs(v), 1e-12), k)
                                for k, v in norms.items()), default=(np.inf, "none"))
    got, want = tree_leaves(params), tree_leaves(ref_params)
    if set(got) != set(want):
        fail("%s: parameter names differ from one process's" % label)
    worst, off, problems = 0.0, {}, []
    for k, w in want.items():
        d = np.abs(got[k] - w)
        worst = max(worst, float(d.max()))
        n_off = int((d > 1e-5 + 1e-5 * np.abs(w)).sum())
        if n_off:
            off[k] = n_off
        if (entry_rule and n_off > max(1, 1e-4 * d.size)) or d.max() > 1e-3 * updates:
            problems.append("parameter %s differs from one process's by %.3g (%d entries "
                            "beyond 1e-5 + 1e-5 |p|)" % (k, float(d.max()), n_off))
    if not loss_rel <= PAR_LOSS_RTOL:
        problems.append("losses differ from one process's by %.3g relative (%s)"
                        % (loss_rel, worst_loss))
    if not grad_rel <= PAR_LOSS_RTOL:
        problems.append("first-step gradient norms differ from one process's by %.3g "
                        "relative (%s)" % (grad_rel, worst_grad))
    return dict(max_loss_rel_diff=loss_rel, max_loss_rel_diff_at=worst_loss,
                first_step_grad_norms=len(norms), max_grad_norm_rel_diff=grad_rel,
                max_grad_norm_rel_diff_at=worst_grad, max_param_abs_diff=worst,
                entries_beyond_1e5=sum(off.values())), problems


def multi_gpu(smi, lab4d_tree):
    """Phase 12 (see the module docstring). Returns the ``parallel`` line."""
    import contextlib
    import io
    import multiprocessing as mp
    import pickle
    import tempfile

    import torch
    import torch.distributed as dist
    from ppr_diffphys_torch.parallel import sharding
    from ppr_diffphys_torch.sim import soa, soa_grad

    t0 = time.time()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_par")
    root = tmp.name
    n_int = F_TRAIN - 1
    want_launches = {soa.KERNEL: 2, soa_grad.KERNEL_FWD: 3 * n_int,
                     soa_grad.KERNEL_BWD: 3 * n_int, soa_grad.KERNEL_REDUCE: 3 * n_int}

    # one process: the references
    refs = {}
    for name, envs in (("dp2", E_TRAIN), ("tp2", E_TP)):
        model, lines, wall, _ = run_cli(cli_argv(os.path.join(root, "one%d" % envs), envs))
        refs[name] = dict(losses=[l for l in lines if "total_loss" in l],
                          params=model.state_np(),
                          step_ms=float(np.median([l["iter_time"] for l in lines
                                                   if "iter_time" in l])) * 1e3)
        del model
    with contextlib.redirect_stdout(io.StringIO()):  # its lr table
        tm = lab4d_from_tree(lab4d_tree, torch.device("cuda"), os.path.join(root, "one_lab4d"))
    losses, walls = lab4d_steps(tm, LAB4D_PAR_STEPS)
    refs["lab4d"] = dict(losses=losses, params=tm.state_np(),
                         step_ms=float(np.median(walls)) * 1e3)
    del tm
    torch.cuda.empty_cache()
    log("phase 12 one-process references (a1 CLI at %d and %d envs x %d frames, the lab4d "
        "step at %d envs x %d frames): %.1f s"
        % (E_TRAIN, E_TP, F_TRAIN, E_SMALL, F_SMALL, time.time() - t0))

    # two ranks on the card, gloo: (a) dp=2, (b) dp=1,tp=2, (c) the lab4d step
    tree_path = os.path.join(root, "lab4d_tree.pkl")
    with open(tree_path, "wb") as f:
        pickle.dump(lab4d_tree, f)
    dp_root, tp_root = os.path.join(root, "dp2"), os.path.join(root, "tp2")
    jobs = [dict(name="dp2", kind="cli", envs=E_TRAIN,
                 argv=cli_argv(dp_root, E_TRAIN, "--ngpu", "2", "--mesh_shape", "dp=2")),
            dict(name="tp2", kind="cli", envs=E_TP,
                 argv=cli_argv(tp_root, E_TP, "--ngpu", "2", "--mesh_shape", "dp=1,tp=2")),
            dict(name="lab4d", kind="lab4d", tree=tree_path)]
    t1 = time.time()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, 2, root, jobs)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(1.0, 600 - (time.time() - t1)))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errs = {r: open(os.path.join(root, "rank%d.err" % r)).read()[-3000:] for r in range(2)
            if os.path.exists(os.path.join(root, "rank%d.err" % r))}
    if hung or errs or any(p.exitcode != 0 for p in procs):
        fail("phase 12: ranks %s still running after 600 s; exit codes %s; failures %s"
             % (hung, [p.exitcode for p in procs], errs))
    ranks = []
    for r in range(2):
        with open(os.path.join(root, "rank%d.pkl" % r), "rb") as f:
            ranks.append(pickle.load(f))
    log("phase 12 two ranks (gloo, both on cuda:0): %.1f s incl. start-up" % (time.time() - t1))

    configs = []
    for name, mesh, envs, root_dir in (("dp2", {"dp": 2, "tp": 1}, E_TRAIN, dp_root),
                                       ("tp2", {"dp": 1, "tp": 2}, E_TP, tp_root)):
        rs = [rk[name] for rk in ranks]
        label = "phase 12 (%s) CLI %s at %d envs x %d frames" % (
            "a" if name == "dp2" else "b", name, envs, F_TRAIN)
        if [r["mesh"] for r in rs] != [mesh, mesh]:
            fail("%s: meshes %s" % (label, [r["mesh"] for r in rs]))
        for r, res in enumerate(rs):
            if res["launches"] != want_launches:
                fail("%s: rank %d launches %s, expected %s" % (label, r, res["launches"],
                                                                 want_launches))
        lines0 = rs[0]["lines"]
        iters = [l for l in lines0 if "total_loss" in l]
        if [l["it"] for l in iters] != [0, 1, 2] or rs[1]["lines"]:
            fail("%s: rank 0 printed iterations %s, rank 1 %d lines" % (
                label, [l["it"] for l in iters], len(rs[1]["lines"])))
        cmp, problems = par_compare(label, iters, refs[name]["losses"], rs[0]["params"],
                                    refs[name]["params"], 3)
        a, b = tree_leaves(rs[0]["params"]), tree_leaves(rs[1]["params"])
        if not (all(np.array_equal(a[k], b[k]) for k in a) and rs[0]["agree"]
                and rs[1]["agree"]):
            fail("%s: the ranks' parameters are not bit-identical" % label)
        save = os.path.join(root_dir, "a1-synth-smoke")
        names = sorted(os.listdir(save))
        events = [n for n in names if n.startswith("events.out.tfevents.")]
        want_files = sorted(["ckpt_phys_%s.pth" % s for s in ("0000", "0002", "best", "latest")]
                            + ["sim_traj-%s.obj" % i for i in ("00000", "00002")])
        if len(events) != 1 or sorted(set(names) - set(events)) != want_files \
                or rs[1]["pickle_dumps"] != 0:
            fail("%s: files %s, rank 1 pickled %d times: rank 0 alone must write"
                 % (label, names, rs[1]["pickle_dumps"]))
        step_ms = float(np.median([l["iter_time"] for l in iters])) * 1e3
        configs.append(dict(
            name=name, path="main.train_one (a1 CLI)", mesh=mesh, backend=ranks[0]["backend"],
            ranks=2, envs=envs, frames=F_TRAIN, step_median_ms=step_ms,
            one_process_step_median_ms=refs[name]["step_ms"],
            sum_grads_ms_per_step=rs[0]["sum_grads_ms_per_step"],
            gather_envs_ms_per_step=rs[0]["gather_envs_ms_per_step"],
            peak_gb_per_rank=[r["peak_gb"] for r in rs], launches_per_rank=rs[0]["launches"],
            job_s_per_rank=[r["job_s"] for r in rs],
            **cmp))
        log("%s: step median %.3f ms (one process %.3f ms); sum_grads %.3f and gather_envs "
            "%.3f ms per step; peak %s GB and job %s s per rank; launches per rank %s; "
            "against one process %s; ranks bit-identical; rank 0 alone wrote %s"
            % (label, step_ms, refs[name]["step_ms"], rs[0]["sum_grads_ms_per_step"],
               rs[0]["gather_envs_ms_per_step"], [round(r["peak_gb"], 3) for r in rs],
               [round(r["job_s"], 1) for r in rs], json.dumps(rs[0]["launches"]),
               json.dumps(cmp), names))
        if problems:
            fail("%s: %s" % (label, "; ".join(problems)))

    # (c) the lab4d step at dp=2
    rs = [rk["lab4d"] for rk in ranks]
    label = "phase 12 (c) lab4d step dp2 at %d envs x %d frames" % (E_SMALL, F_SMALL)
    want_xp = {soa_grad.KERNEL_FWD: LAB4D_PAR_STEPS * (F_SMALL - 1),
               soa_grad.KERNEL_BWD: LAB4D_PAR_STEPS * (F_SMALL - 1),
               soa_grad.KERNEL_REDUCE: LAB4D_PAR_STEPS * (F_SMALL - 1), soa.KERNEL: 0}
    for r, res in enumerate(rs):
        if res["mesh"] != {"dp": 2, "tp": 1} or res["launches"] != want_xp:
            fail("%s: rank %d mesh %s, launches %s, expected %s"
                 % (label, r, res["mesh"], res["launches"], want_xp))
        if not all(np.isfinite(v) for l in res["losses"] for v in l.values()) \
                or not res["losses"][-1]["loss_pos_distill"] > 0:
            fail("%s: rank %d losses %s" % (label, r, res["losses"]))
    cmp, problems = par_compare(label, rs[0]["losses"], refs["lab4d"]["losses"],
                                rs[0]["params"], refs["lab4d"]["params"], LAB4D_PAR_STEPS,
                                entry_rule=False)
    a, b = tree_leaves(rs[0]["params"]), tree_leaves(rs[1]["params"])
    if not (all(np.array_equal(a[k], b[k]) for k in a) and rs[0]["agree"] and rs[1]["agree"]):
        fail("%s: the ranks' parameters are not bit-identical" % label)
    step_ms = float(np.median(rs[0]["walls"])) * 1e3
    configs.append(dict(
        name="lab4d_dp2", path="phys_interface forward()+update()", mesh={"dp": 2, "tp": 1},
        backend=ranks[0]["backend"], ranks=2, envs=E_SMALL, frames=F_SMALL,
        step_median_ms=step_ms, one_process_step_median_ms=refs["lab4d"]["step_ms"],
        sum_grads_ms_per_step=rs[0]["sum_grads_ms_per_step"],
        gather_envs_ms_per_step=rs[0]["gather_envs_ms_per_step"],
        peak_gb_per_rank=[r["peak_gb"] for r in rs], launches_per_rank=rs[0]["launches"],
        job_s_per_rank=[r["job_s"] for r in rs],
        **cmp))
    log("%s: step median %.3f ms (one process %.3f ms); sum_grads %.3f and gather_envs %.3f ms "
        "per step; job %s s per rank; launches per rank %s; against one process %s; ranks "
        "bit-identical"
        % (label, step_ms, refs["lab4d"]["step_ms"], rs[0]["sum_grads_ms_per_step"],
           rs[0]["gather_envs_ms_per_step"], [round(r["job_s"], 1) for r in rs],
           json.dumps(rs[0]["launches"]), json.dumps(cmp)))
    if problems:
        fail("%s: %s" % (label, "; ".join(problems)))

    # (d) the comm helpers under a world-1 NCCL group on the card
    dist.init_process_group("nccl", init_method="file://" + os.path.join(root, "nccl_store"),
                            rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh({"dp": 1})
        rng = np.random.RandomState(SEED + 20)
        x = torch.tensor(rng.randn(E_TRAIN, 4 * F_TRAIN + 2).astype(np.float32), device="cuda",
                         requires_grad=True)
        full = sharding.gather_envs(x, mesh)
        (g,) = torch.autograd.grad((full * 3.0).sum(), x)
        grads = [torch.tensor(rng.randn(*s).astype(np.float32), device="cuda")
                 for s in ((256, 256),) * 30 + ((256,),) * 30]
        summed = sharding.sum_grads(mesh, grads, [None] * len(grads))
        ok = (torch.equal(full, x) and torch.equal(g, torch.full_like(x, 3.0))
              and all(torch.equal(a, b) for a, b in zip(summed, grads))
              and sharding.replicas_agree(grads)
              and sharding.broadcast_from_rank0([1.5, -2.0]) == [1.5, -2.0])
        n_floats = sum(t.numel() for t in grads)
        sg_ms, _ = cuda_time_ms(lambda: sharding.sum_grads(mesh, grads, [None] * len(grads)), 10)
        ge_ms, _ = cuda_time_ms(lambda: sharding.gather_envs(x.detach(), mesh), 10)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
        sharding._mesh_cache.clear()
    if not ok or backend != "nccl":
        fail("phase 12 (d): the comm helpers under a world-1 %s group disagree" % backend)
    nccl = dict(backend=backend, ranks=1, sum_grads_ms=sg_ms, sum_grads_floats=n_floats,
                gather_envs_ms=ge_ms, gather_envs_rows=E_TRAIN)
    log("phase 12 (d) comm helpers under a world-1 NCCL group on the card: gather_envs "
        "(values, slice-only backward), sum_grads, replicas_agree, broadcast_from_rank0 ok; "
        "sum_grads of %d floats %.3f ms, gather_envs of %d rows %.3f ms (CUDA events, 10 "
        "calls)" % (n_floats, sg_ms, E_TRAIN, ge_ms))
    tmp.cleanup()
    log("phase 12 multi-GPU on one card: ok (%.1f s)" % (time.time() - t0))
    return dict(note="2 ranks sharing one card; not a scaling figure", device=smi,
                configs=configs, nccl_world1=nccl)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, REPO)
    try:
        import ppr_diffphys_torch  # noqa: F401
        from ppr_diffphys_torch.csrc import build as kbuild
        from ppr_diffphys_torch import bench as pbench
    except ImportError as e:
        fail("the ppr_diffphys_torch package is not beside this script (%s)" % e)
    from ppr_diffphys_torch.models.serve import RolloutServer
    from ppr_diffphys_torch.sim import integrator as tint
    from ppr_diffphys_torch.models.phys_model import phys_model
    from ppr_diffphys_torch.data.amp_loader import DataLoader
    from ppr_diffphys_torch.sim import soa, soa_grad, synthetic
    from ppr_diffphys_torch.sim.builder import ModelBuilder
    from ppr_diffphys_torch.sim.import_urdf import parse_urdf
    from ppr_diffphys_torch.sim.kinematics import eval_fk
    from ppr_diffphys_torch.utils import h100
    from ppr_diffphys_torch.utils.config import build_opts

    dev = torch.device("cuda")
    t_all = time.time()

    # ---- 1. device --------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    try:
        smi = h100.nvidia_smi_line()
    except RuntimeError as e:
        fail(str(e))
    log("phase 1 device: torch %s cuda %s, %s (count %d), nvidia-smi: %s"
        % (torch.__version__, torch.version.cuda, kind, count, smi))

    # ---- 2. build ---------------------------------------------------------
    t0 = time.time()
    logs = kbuild.build([soa.KERNEL, soa_grad.KERNEL, soa.KERNEL_ROLLOUT], ptxas_verbose=True)
    log("phase 2 build: %.1f s" % (time.time() - t0))
    for name, text in logs.items():
        for line in text.strip().splitlines():
            if ("registers" in line or "spill" in line or "stack frame" in line
                    or "Compiling entry" in line):
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
    for mname, model, Ec in (("a1", a1, E_CHECK), ("chain", synthetic.chain_model(), E_CHECK),
                             ("chain45", synthetic.chain_model(extra_boxes=True), E_RAGGED)):
        q, qd, tgt, act = synthetic.window_problem(model, Ec, sub, F_CHECK, seed=SEED)
        bq, bqd = eval_fk(model, torch.as_tensor(q), torch.as_tensor(qd))
        bq = synthetic.grounded(model, bq.numpy(), seed=SEED)
        state = tint.SimState(torch.as_tensor(bq, device=dev), bqd.to(dev))
        tgt, act = torch.as_tensor(tgt, device=dev), torch.as_tensor(act, device=dev)
        integ = tint.SemiImplicitIntegrator(model)
        window = soa.SoaWindow(integ, m.dt, sub, F_CHECK)
        for planes in ("shared", "per_env"):
            ke, kd, mass, norm_I = synthetic.sim_params_np(
                model, Ec if planes == "per_env" else None, seed=SEED)
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
                check_errs("phase 3 %s/%s/%s (E=%d, %d contacts)"
                           % (mname, planes, "act" if acts is not None else "no-act", Ec,
                              model.contact_count), max_errs(out, ref), TOL_CHECK)
        # the plain version's time at this shape is a yardstick only
        k_ms, _ = cuda_time_ms(lambda: window(state, tgt, None, params), 3)
        p_ms, _ = cuda_time_ms(
            lambda: tint.rollout(integ, params, state, tgt, None, None, m.dt, sub), 1)
        log("  phase 3 %s E=%d F=%d: soa_window %.3f ms, plain %.1f ms"
            % (mname, Ec, F_CHECK, k_ms, p_ms))
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
    k1_call = lambda: server.window(state, ref_t, None, params)
    kern_ms, kout = cuda_time_ms(k1_call, 3)
    k1_dev_ms = queued_ms(k1_call, 3)
    plain_ms, pout = cuda_time_ms(
        lambda: tint.rollout(m.integrator, params, state, ref_t, None, None, m.dt, sub), 1)
    errs = max_errs(kout, pout)
    check_errs("phase 4 main-path shapes", errs, TOL_MAIN)
    per_frame = (kout[0] - pout[0]).abs().amax(dim=(1, 2, 3)).tolist()
    log("  body_q max|kernel-plain| per frame: %s" % [float("%.3g" % x) for x in per_frame])
    work = soa.window_work(m.env, E_MAIN, sub, F_MAIN)
    k1_roof = h100.roofline(work["bytes"], work["ops"])
    log("phase 4 times: prologue %.3f ms, soa_window %.3f ms by CUDA events (%.3f ms of "
        "device time), plain %.1f ms; bound %.4f ms "
        "(%d bytes -> %.4f ms, %d fp32 ops (%d per env-substep) -> %.4f ms)"
        % (prologue_ms, kern_ms, k1_dev_ms, plain_ms, k1_roof["ms"], work["bytes"],
           k1_roof["bytes_ms"],
           work["ops"], work["per_env_substep"], k1_roof["ops_ms"]))

    # ---- 5. interval kernels vs plain on the card ----------------------------
    t0 = time.time()
    S_i = sub
    cases = (("a1", a1, E_CHECK), ("chain", synthetic.chain_model(), E_CHECK),
             ("chain45", synthetic.chain_model(extra_boxes=True), E_RAGGED))
    for mname, model, Ec in cases:
        q, qd, tgt, act = synthetic.window_problem(model, Ec, sub, 2, seed=SEED + 1)
        bq, bqd = eval_fk(model, torch.as_tensor(q), torch.as_tensor(qd))
        bq = synthetic.grounded(model, bq.numpy(), seed=SEED + 1)
        state = tint.SimState(torch.as_tensor(bq, device=dev), bqd.to(dev))
        with torch.no_grad():
            cforce = tint.eval_body_contacts(model, tint.default_sim_params(model, dev), state)
        if float(cforce[..., 3:].abs().max()) < 1.0:
            fail("phase 5 %s: no contact force: the check is vacuous" % mname)
        integ = tint.SemiImplicitIntegrator(model)
        rng = np.random.RandomState(SEED + 3)
        B = model.n_links
        w = (torch.as_tensor(rng.randn(7, B, Ec).astype(np.float32), device=dev),
             torch.as_tensor(rng.randn(6, B, Ec).astype(np.float32), device=dev))
        bq_p = state.body_q.permute(2, 1, 0).contiguous()
        bqd_p = state.body_qd.permute(2, 1, 0).contiguous()
        tgt_p = torch.as_tensor(tgt[:S_i], device=dev).permute(0, 2, 1).contiguous()
        act_p = torch.as_tensor(act[:S_i], device=dev).permute(0, 2, 1).contiguous()
        for planes in ("shared", "per_env"):
            ke, kd, mass, norm_I = synthetic.sim_params_np(
                model, Ec if planes == "per_env" else None, seed=SEED)
            t = lambda x: torch.as_tensor(x, device=dev)
            I = t(norm_I) * t(mass)[..., None, None]
            params = tint.SimParams(t(mass), 1.0 / t(mass), I, torch.linalg.inv(I),
                                    t(ke), t(kd))
            for acts in (act_p, None):
                di = soa_grad.DiffInterval(integ, m.dt, S_i, with_act=acts is not None)
                qk, qdk, gk = interval_grads(di, bq_p, bqd_p, tgt_p, acts,
                                             *param_planes(model, params), w)
                qp, qdp, gp = interval_grads(
                    lambda *a: tint.interval(integ, m.dt, *a),
                    bq_p, bqd_p, tgt_p, acts, *param_planes(model, params), w)
                torch.cuda.synchronize()
                label = "phase 5 %s/%s/%s (E=%d, %d contacts)" % (
                    mname, planes, "act" if acts is not None else "no-act", Ec, model.contact_count)
                verr = {"q": float((qk - qp).abs().max()), "qd": float((qdk - qdp).abs().max())}
                check_errs(label + " K2 values", verr, TOL_INTERVAL)
                want = {"fwd": 1, "bwd": 1, "reduce": 0 if planes == "per_env" else 1}
                got = {k: di.launches["soa_interval_" + k] for k in want}
                if got != want:
                    fail("%s: launches %s, expected %s" % (label, got, want))
                ref, got = linearized_grads(label, di, bq_p, bqd_p, tgt_p, acts,
                                            *param_planes(model, params), w)
                check_grads(label, grad_errors(ref, got, Ec), Ec, linearized=True)
                # check (b) on the 256-env cases only: at 1027 envs and 45
                # contacts more envs cross a contact kink between the two
                # forwards, and an env sum (shared ke, kd, mass) carries each
                # such env's jump (measured 2.4e-3 for the sum of one jump)
                if Ec == E_CHECK:
                    check_grads(label, grad_errors(gp, gk, Ec), Ec, linearized=False)
    # K2 chained over a window reproduces K1 bit for bit (both run the warp substep)
    q, qd, tgt, _ = synthetic.window_problem(a1, E_CHECK, sub, F_CHECK, seed=SEED)
    bq, bqd = eval_fk(a1, torch.as_tensor(q), torch.as_tensor(qd))
    bq = synthetic.grounded(a1, bq.numpy(), seed=SEED)
    state = tint.SimState(torch.as_tensor(bq, device=dev), bqd.to(dev))
    tgt = torch.as_tensor(tgt, device=dev)
    integ = tint.SemiImplicitIntegrator(a1)
    params = tint.default_sim_params(a1, dev)
    win = soa.SoaWindow(integ, m.dt, sub, F_CHECK)(state, tgt, None, params)
    di = soa_grad.DiffInterval(integ, m.dt, sub)
    pl = soa.traced_planes(a1, params)
    x, xd = state.body_q.permute(2, 1, 0), state.body_qd.permute(2, 1, 0)
    tp = tgt.permute(0, 2, 1).contiguous()
    with torch.no_grad():
        for f in range(F_CHECK - 1):
            x, xd = di(x, xd, tp[f * sub:(f + 1) * sub], None, None,
                       *(pl[n] for n in soa.TRACED_NAMES))
            if not (torch.equal(x.permute(2, 1, 0), win[0][f + 1])
                    and torch.equal(xd.permute(2, 1, 0), win[1][f + 1])):
                fail("phase 5: K2 chained differs from K1 at frame %d" % (f + 1))
    log("  phase 5 K2 chained over %d intervals == K1 frame states, bit for bit" % (F_CHECK - 1))
    log("phase 5 interval kernels vs plain: ok (%.1f s)" % (time.time() - t0))

    # ---- 6. the training main path -------------------------------------------
    t0 = time.time()
    topts = build_opts(
        seqname="a1-synth", urdf_template="a1",
        datadir=os.path.join(REPO, "tests", "fixtures", "motion_sequences"),
        urdf_dir=os.path.join(REPO, "tests", "fixtures"), seed=SEED,
        logroot=os.path.join(REPO, "logdir", "chip_smoke"),
    )
    tm = phys_model(topts, DataLoader(topts), device="cuda")
    tm.reinit_envs(E_TRAIN, frames_per_wdw=F_TRAIN, is_eval=False)
    di = tm._interval()
    first = []
    record_calls(di, "_forward", first)
    log("phase 6 model built: %.1f s; noise_std %g, loss weights %s"
        % (time.time() - t0, tm.noise_std, tm._weights_vec()))

    def train_step():
        out = tm.forward()
        gd = tm.update()
        torch.cuda.synchronize()
        return out, gd

    train_step()  # warm-up (records the first interval's inputs)
    del di._forward
    if not first:
        fail("phase 6: the training step never called the interval kernels' wrapper")
    before = [t.detach().clone() for _, t in tm._trainable]
    for k in di.launches:
        di.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    steps = []
    for i in range(3):
        t1 = time.perf_counter()
        out, gd = train_step()
        wall = time.perf_counter() - t1
        losses = {k: float(v) for k, v in out.items()}
        gnorm = float(np.sqrt(sum(v * v for k, v in gd.items() if k.startswith("grad/"))))
        log("  step %d: wall %.3f ms, losses %s, grad norm %s"
            % (i, wall * 1e3, json.dumps(losses), "%.6g" % gnorm if gd else "rolled back"))
        if not all(np.isfinite(v) for v in losses.values()) or not np.isfinite(gnorm):
            fail("phase 6: non-finite loss or gradient")
        steps.append(wall)
    train_launches = dict(di.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    changed = sum(int(not torch.equal(b, t)) for b, (_, t) in zip(before, tm._trainable))
    log("phase 6 launches during the main path: %s" % json.dumps(train_launches))
    n_int = F_TRAIN - 1
    log("phase 6 train step wall ms (3 steps): %s; median %.3f ms; peak device memory "
        "%.3f GB; %d of %d parameter tensors changed"
        % ([round(x * 1e3, 3) for x in steps], float(np.median(steps)) * 1e3, peak_gb,
           changed, len(before)))
    bq0, bqd0, tgt0, act0, res0, planes0 = first[0][:6]
    shared = all(p.shape[-1] == 1 for p in planes0)
    want = {soa_grad.KERNEL_FWD: 3 * n_int, soa_grad.KERNEL_BWD: 3 * n_int,
            soa_grad.KERNEL_REDUCE: 3 * n_int if shared else 0}
    for k in (soa_grad.KERNEL_FWD, soa_grad.KERNEL_BWD):
        if train_launches[k] < 1:
            fail("the training main path never launched %s" % k)
    if train_launches != want:
        fail("phase 6: launches %s, expected %s (one of each per interval and step)"
             % (json.dumps(train_launches), json.dumps(want)))
    if changed == 0:
        fail("phase 6: no parameter changed over 3 training steps")
    if act0 is not None or res0 is not None:
        fail("phase 6: the training interval got acts or residual forces")

    # where a step's device time goes, by torch.profiler over 2 more steps
    profile_steps(train_step, 2, E_TRAIN, F_TRAIN)

    # K2 and K3 alone on the main path's first-interval inputs, vs plain
    rng = np.random.RandomState(SEED + 4)
    B = tm.n_links
    dq = torch.as_tensor(rng.randn(7, B, E_TRAIN).astype(np.float32), device=dev)
    dqd = torch.as_tensor(rng.randn(6, B, E_TRAIN).astype(np.float32), device=dev)
    k2_call = lambda: di._forward(bq0, bqd0, tgt0, None, None, planes0, True)
    k2_ms, (kq, kqd, sstate) = cuda_time_ms(k2_call, 10)
    k2_dev_ms = queued_ms(k2_call, 10)
    export_share("phase 6 (E=%d)" % E_TRAIN, di, first[0])
    k3_call = lambda: di._backward(sstate, tgt0, None, None, planes0, dq, dqd)
    k3_ms, kg = cuda_time_ms(k3_call, 10)
    k3_dev_ms = queued_ms(k3_call, 10)

    def plain_fwd():
        ins = [bq0.clone().requires_grad_(), bqd0.clone().requires_grad_(),
               tgt0.clone().requires_grad_()] + [x.clone().requires_grad_() for x in planes0]
        return ins, tint.interval(di.integrator, di.dt, ins[0], ins[1], ins[2], None, None,
                                  *ins[3:])

    p2_ms, (pins, (pq, pqd)) = cuda_time_ms(plain_fwd, 1)
    p3_ms, pg = cuda_time_ms(
        lambda: torch.autograd.grad((pq, pqd), pins, (dq, dqd), retain_graph=True), 1)
    label = "phase 6 main-path interval"
    k2_err = {"q": float((kq - pq.detach()).abs().max()),
              "qd": float((kqd - pqd.detach()).abs().max())}
    check_errs(label + " K2 values", k2_err, TOL_INTERVAL)
    names = state_names(None) + list(soa.TRACED_NAMES)
    ref, got = linearized_grads(label, di, bq0, bqd0, tgt0, None, {}, list(planes0), (dq, dqd))
    check_grads(label, grad_errors(ref, got, E_TRAIN), E_TRAIN, linearized=True)
    k3_abs = float((got["tgt"] - ref["tgt"]).abs().max())
    check_grads(label, grad_errors(dict(zip(names, pg)), dict(zip(names, list(kg[:3]) + list(kg[5]))),
                                   E_TRAIN), E_TRAIN, linearized=False)
    del pins, pq, pqd, pg, ref, got
    n_act = soa_grad.active_contacts(tm.env, sstate)
    iw = soa_grad.interval_work(tm.env, E_TRAIN, sub, n_active_contacts=n_act)
    k2_roof = h100.roofline(iw["fwd_bytes"], iw["fwd_ops"])
    k3_roof = h100.roofline(iw["bwd_bytes"], iw["bwd_ops"])
    step_ms = float(np.median(steps)) * 1e3
    log("phase 6 interval times (E=%d, %d substeps, first interval of the main path; "
        "wrappers by CUDA events over 10 calls, device time by CUDA events around 10 calls "
        "queued behind a device sleep): "
        "K2 %.3f ms (%.3f ms of device time; bound %.4f ms: bytes %.4f, ops %.4f), plain "
        "forward %.1f ms; K3 incl. reduce %.3f ms (%.3f ms of device time; bound %.4f ms: "
        "bytes %.4f, ops %.4f; %d active "
        "contact-substeps of %d), plain backward %.1f ms; per step %d+%d launches -> "
        "device time of K2 %.1f%% and of K3 %.1f%% of the median step"
        % (E_TRAIN, sub, k2_ms, k2_dev_ms, k2_roof["ms"], k2_roof["bytes_ms"],
           k2_roof["ops_ms"], p2_ms,
           k3_ms, k3_dev_ms, k3_roof["ms"], k3_roof["bytes_ms"], k3_roof["ops_ms"], n_act,
           E_TRAIN * sub * tm.env.contact_count, p3_ms, n_int, n_int,
           100 * n_int * k2_dev_ms / step_ms, 100 * n_int * k3_dev_ms / step_ms))

    # the training loop's full-sequence eval (ppr_diffphys_torch/main.py):
    # no gradient, the whole window on K1, held against the plain rollout
    tm.reinit_envs(1, frames_per_wdw=tm.total_frames, is_eval=True)
    win = tm._window(tm.frames_per_wdw)
    wargs = []
    record_calls(win, "_launch", wargs)
    win.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev = tm.forward()
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t1) * 1e3
    eval_launches = win.launches
    del win._launch
    log("phase 6 eval (1 env x %d frames): %.3f ms, loss_traj %.6g, launches %s"
        % (tm.frames_per_wdw, eval_ms, float(ev["loss_traj"]),
           json.dumps({soa.KERNEL: eval_launches})))
    if eval_launches != 1 or not wargs:
        fail("phase 6 eval launched %s %d times, 1 expected" % (soa.KERNEL, eval_launches))
    if not all(np.isfinite(float(v)) for v in ev.values()):
        fail("phase 6 eval: non-finite loss")
    with torch.no_grad():
        wargs = wargs[0]
        kout = win(*wargs)
        pout = tint.rollout(win.integrator, wargs[3], wargs[0], wargs[1], wargs[2], None,
                            tm.dt, sub)
    check_errs("phase 6 eval window", max_errs(kout, pout), TOL_MAIN)
    del tm, di, first, sstate, kg, planes0, bq0, bqd0, tgt0
    torch.cuda.empty_cache()

    # ---- 7. the bench rollout kernel K4 vs plain on the card --------------------
    t0 = time.time()
    cases = (("a1", a1, E_CHECK), ("chain", synthetic.chain_model(), E_CHECK),
             ("chain45", synthetic.chain_model(extra_boxes=True), E_RAGGED))
    for mname, model, Ec in cases:
        q, qd, tgt, act = synthetic.window_problem(model, Ec, sub, 2, seed=SEED + 5)
        bq, bqd = eval_fk(model, torch.as_tensor(q), torch.as_tensor(qd))
        bq = synthetic.grounded(model, bq.numpy(), seed=SEED + 5)
        state = tint.SimState(torch.as_tensor(bq, device=dev), bqd.to(dev))
        tgt = torch.as_tensor(tgt[:sub], device=dev)
        act = torch.as_tensor(act[:sub], device=dev)
        integ = tint.SemiImplicitIntegrator(model)
        with torch.no_grad():
            cforce = tint.eval_body_contacts(model, tint.default_sim_params(model, dev), state)
        if float(cforce[..., 3:].abs().max()) < 1.0:
            fail("phase 7 %s: no contact force: the check is vacuous" % mname)
        ke, kd, mass, norm_I = synthetic.sim_params_np(model, None, seed=SEED)
        t = lambda x: torch.as_tensor(x, device=dev)
        I = t(norm_I) * t(mass)[..., None, None]
        params = tint.SimParams(t(mass), 1.0 / t(mass), I, torch.linalg.inv(I), t(ke), t(kd))
        k4 = soa.build_soa_rollout(integ, params, m.dt, sub)
        pl = soa.traced_planes(model, params)
        x0, xd0 = state.body_q.permute(2, 1, 0), state.body_qd.permute(2, 1, 0)
        for aname, acts in (("act", act), ("zero-act", torch.zeros_like(act))):
            label = "phase 7 %s/%s (E=%d, %d contacts)" % (mname, aname, Ec, model.contact_count)
            out = k4(state, tgt, acts)
            ref = tint.rollout_substeps(integ, params, state, tgt, acts, m.dt)
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(x).all()) for x in out):
                fail(label + ": non-finite K4 output")
            check_errs(label + " K4 values", {"q": float((out[0] - ref[0]).abs().max()),
                                              "qd": float((out[1] - ref[1]).abs().max())},
                       TOL_INTERVAL)
            # K2 without its export runs the same warp substep
            di = soa_grad.DiffInterval(integ, m.dt, sub, with_act=True)
            with torch.no_grad():
                x, xd = di(x0, xd0, tgt.permute(0, 2, 1), acts.permute(0, 2, 1), None,
                           *(pl[n] for n in soa.TRACED_NAMES))
            if not (torch.equal(x.permute(2, 1, 0), out[0])
                    and torch.equal(xd.permute(2, 1, 0), out[1])):
                fail(label + ": K4 differs from K2 (soa_interval_fwd) on the same inputs")
        if not (torch.equal(k4(state, tgt, None)[0], out[0])):
            fail("phase 7 %s: K4 with no acts differs from K4 with zero acts" % mname)
        if k4.launches != 3:
            fail("phase 7 %s: %d K4 launches, 3 expected" % (mname, k4.launches))
        log("  phase 7 %s: K4 == K2 (soa_interval_fwd) final state, bit for bit; "
            "acts None == zero acts" % mname)
        try:
            ke, kd, mass, norm_I = synthetic.sim_params_np(model, Ec, seed=SEED)
            I = t(norm_I) * t(mass)[..., None, None]
            soa.build_soa_rollout(integ, tint.SimParams(
                t(mass), 1.0 / t(mass), I, torch.linalg.inv(I), t(ke), t(kd)), m.dt, sub)
            fail("phase 7 %s: build_soa_rollout took per-env parameters" % mname)
        except ValueError:
            pass
        k4_ms, _ = cuda_time_ms(lambda: k4(state, tgt, act), 10)
        w4 = soa.rollout_work(model, Ec, sub)
        roof = h100.roofline(w4["bytes"], w4["ops"])
        log("  phase 7 %s E=%d, %d substeps: soa_rollout %.3f ms (bound %.4f ms by %s)"
            % (mname, Ec, sub, k4_ms, roof["ms"], roof["by"]))
    log("phase 7 K4 vs plain: ok, per-env parameters rejected (%.1f s)" % (time.time() - t0))

    # ---- 8. the bench main path (ppr_diffphys_torch.bench) -------------------------
    t0 = time.time()
    work = pbench.build_workload(envs=E_MAIN, contacts="hull", device="cuda", seed=SEED)
    rb = pbench.Bench(work, "rollout", BENCH_STEPS, sub)
    rb.reset_launches()
    walls, final = rb.measure(pbench.REPS)
    roll_launches = rb.launches()
    log("phase 8 rollout launches during the main path: %s" % json.dumps(roll_launches))
    want = rb.n_iv * (pbench.REPS + 1)
    if roll_launches[soa.KERNEL_ROLLOUT] != want:
        fail("phase 8 rollout: %d K4 launches, %d expected (%d per rep, warm-up + %d reps)"
             % (roll_launches[soa.KERNEL_ROLLOUT], want, rb.n_iv, pbench.REPS))
    B = work.model.n_links
    if tuple(final.body_q.shape) != (E_MAIN, B, 7) or tuple(final.body_qd.shape) != (E_MAIN, B, 6):
        fail("phase 8 rollout: final state shape %s" % (tuple(final.body_q.shape),))
    if not (torch.isfinite(final.body_q).all() and torch.isfinite(final.body_qd).all()):
        fail("phase 8 rollout: non-finite final state")
    if float((final.body_q[..., 3:7].norm(dim=-1) - 1).abs().max()) > 1e-3:
        fail("phase 8 rollout: final quaternions are not unit")
    wall = float(np.mean(walls))
    busy, _ = rb.profile(wall)
    roof = rb.work_bound()
    log("phase 8 rollout %d envs x %d substeps (%d K4 calls of %d): rep walls ms %s, mean "
        "%.3f ms, %.6g env-steps/s; device busy %s of the rep; bound %.4f ms by %s"
        % (E_MAIN, rb.steps, rb.n_iv, sub, [w * 1e3 for w in walls], wall * 1e3,
           E_MAIN * rb.steps / wall, "not measured" if busy is None else "%.4f" % busy,
           roof["ms"], roof["by"]))
    # K4 alone on the main path's first-call inputs, vs plain
    k4_call = lambda: rb.kernel(work.state, rb.tgt, rb.act)
    k4_ms, k4_out = cuda_time_ms(k4_call, 10)
    k4_dev_ms = queued_ms(k4_call, 10)
    p4_ms, p4_out = cuda_time_ms(lambda: tint.rollout_substeps(
        work.integrator, rb.kernel.params, work.state, rb.tgt, rb.act, m.dt), 1)
    k4_err = {"q": float((k4_out[0] - p4_out[0]).abs().max()),
              "qd": float((k4_out[1] - p4_out[1]).abs().max())}
    check_errs("phase 8 main-path K4 call", k4_err, TOL_INTERVAL)
    w4 = soa.rollout_work(work.model, E_MAIN, sub)
    k4_roof = h100.roofline(w4["bytes"], w4["ops"])
    log("phase 8 K4 per launch (E=%d, %d substeps): %.3f ms by CUDA events over 10 calls "
        "(%.3f ms of device time by CUDA events behind a device sleep), plain %.1f ms; bound %.4f ms "
        "(%d bytes -> %.4f ms, %d fp32 ops -> %.4f ms)"
        % (E_MAIN, sub, k4_ms, k4_dev_ms, p4_ms, k4_roof["ms"], w4["bytes"], k4_roof["bytes_ms"],
           w4["ops"], k4_roof["ops_ms"]))
    # the whole rep against the plain version on the first E_DEEP envs
    sl = tint.SimState(work.state.body_q[:E_DEEP].contiguous(),
                       work.state.body_qd[:E_DEEP].contiguous())
    tgt_d, act_d = rb.tgt[:, :E_DEEP].contiguous(), rb.act[:, :E_DEEP].contiguous()
    kfin, pfin, per_iv, contact = sl, sl, [], []
    for _ in range(rb.n_iv):
        kfin = rb.kernel(kfin, tgt_d, act_d)
        pfin = tint.rollout_substeps(work.integrator, rb.kernel.params, pfin, tgt_d, None, m.dt)
        per_iv.append(float((kfin[0] - pfin[0]).abs().max()))
        with torch.no_grad():
            f = tint.eval_body_contacts(work.model, rb.kernel.params, pfin)
        contact.append(float(f[..., 3:].abs().max()))
    check_errs("phase 8 rollout, %d envs x %d substeps" % (E_DEEP, rb.steps),
               {"q": float((kfin[0] - pfin[0]).abs().max()),
                "qd": float((kfin[1] - pfin[1]).abs().max())}, TOL_DEEP)
    log("  q error after each K4 call: %s; largest contact force after each call (N): %s"
        % ([float("%.3g" % x) for x in per_iv], [float("%.3g" % x) for x in contact]))
    # yardstick: the plain rollout's own sensitivity to a 1e-7 change of its start
    rng = np.random.RandomState(SEED + 9)
    nudge = lambda x: x + 1e-7 * torch.as_tensor(rng.randn(*x.shape).astype(np.float32),
                                                 device=dev)
    pert = tint.SimState(nudge(sl[0]), nudge(sl[1]))
    for _ in range(rb.n_iv):
        pert = tint.rollout_substeps(work.integrator, rb.kernel.params, pert, tgt_d, None, m.dt)
    log("  yardstick: the plain rollout from a start moved by 1e-7 ends q %.3g, qd %.3g away"
        % (float((pert[0] - pfin[0]).abs().max()), float((pert[1] - pfin[1]).abs().max())))

    tb = pbench.Bench(work, "train", BENCH_STEPS, sub)
    calls = []
    record_calls(tb.kernel, "_forward", calls, tb.n_iv)  # the warm-up rep's intervals
    tb.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    walls, (loss, grads) = tb.measure(pbench.REPS)
    bench_train_launches = tb.launches()
    del tb.kernel._forward
    if len(calls) != tb.n_iv:
        fail("phase 8 train: %d interval calls recorded, %d expected" % (len(calls), tb.n_iv))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log("phase 8 train launches during the main path: %s" % json.dumps(bench_train_launches))
    n = tb.n_iv * (pbench.REPS + 1)
    want = {soa_grad.KERNEL_FWD: n, soa_grad.KERNEL_BWD: n, soa_grad.KERNEL_REDUCE: n}
    if bench_train_launches != want:
        fail("phase 8 train: launches %s, expected %s (%d of each per rep, warm-up + %d reps)"
             % (json.dumps(bench_train_launches), json.dumps(want), tb.n_iv, pbench.REPS))
    if not np.isfinite(float(loss)):
        fail("phase 8 train: non-finite loss")
    for k, g in grads.items():
        if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
            fail("phase 8 train: gradient %s is not finite and non-zero" % k)
    wall = float(np.mean(walls))
    busy, rows = tb.profile(wall)
    roof = tb.work_bound()
    log("phase 8 train %d envs x %d substeps (%d intervals of %d): loss %.6g, grad norms %s; "
        "rep walls ms %s, mean %.3f ms, %.6g env-steps/s; device busy %s of the rep; peak "
        "device memory %.3f GB; interval kernels' bound %.4f ms by %s"
        % (E_MAIN, tb.steps, tb.n_iv, sub, float(loss),
           json.dumps({k: float("%.4g" % float(g.norm())) for k, g in grads.items()}),
           [w * 1e3 for w in walls], wall * 1e3, E_MAIN * tb.steps / wall,
           "not measured" if busy is None else "%.4f" % busy, peak_gb, roof["ms"], roof["by"]))
    log("  profiled train rep: top kernels (ms, launches, name):")
    for ms, c, k in rows[:8]:
        log("    %9.3f %6d  %s" % (ms, c, k[:100]))
    log("  interval kernels %.3f ms of %.3f ms device time, %d launches in all"
        % (sum(r[0] for r in rows if "soa_interval" in r[2]), sum(r[0] for r in rows),
           sum(r[1] for r in rows)))
    # K2 values and K3 gradients at the main path's width (4096 envs, shared
    # planes, K3's reduction over 4096 partials), at the plain linearization
    # for seeded cotangents, on the first and the last interval: first on
    # the warm-up rep's own inputs, with each gradient's limit raised to the
    # plain gradient's own change for a 1e-7 change of the start (the
    # bench's start sits on the atan2 kink, see offset_workload), then on
    # the same training path from offset targets and joint angles, where
    # every gradient is held to its tolerance
    rng = np.random.RandomState(SEED + 10)
    w = (torch.as_tensor(rng.randn(7, B, E_MAIN).astype(np.float32), device=dev),
         torch.as_tensor(rng.randn(6, B, E_MAIN).astype(np.float32), device=dev))
    export_share("phase 8 (E=%d)" % E_MAIN, tb.kernel, calls[0])
    for i in (0, tb.n_iv - 1):
        interval_at_width("phase 8 train interval %d of %d (E=%d)" % (i + 1, tb.n_iv, E_MAIN),
                          tb.kernel, calls[i], w, yardstick=True)
    del tb, grads, calls
    ob = pbench.Bench(offset_workload(pbench, E_MAIN, "cuda", SEED + 8), "train",
                      BENCH_STEPS, sub)
    calls = []
    record_calls(ob.kernel, "_forward", calls, ob.n_iv)
    ob.loss_and_grads()
    del ob.kernel._forward
    for i in (0, ob.n_iv - 1):
        interval_at_width("phase 8 offset train interval %d of %d (E=%d)"
                          % (i + 1, ob.n_iv, E_MAIN), ob.kernel, calls[i], w, yardstick=False)
    del ob, calls
    # the training workload's loss and gradients on the kernels against the
    # plain version on the CPU, at a small size, from the same kind of
    # offset start (offset_workload)
    small_cpu = offset_workload(pbench, E_SMALL, "cpu", SEED + 8)
    small = offset_workload(pbench, E_SMALL, "cuda", SEED + 8)
    lk, gk = pbench.Bench(small, "train", 6 * sub, sub).loss_and_grads()
    lp, gp = pbench.Bench(small_cpu, "train", 6 * sub, sub).loss_and_grads()
    rel = {k: float((gk[k].cpu() - gp[k]).abs().max() / (gp[k].abs().max() + 1e-30))
           for k in gp}
    log("  phase 8 train at %d envs x 2 intervals, kernels vs plain on the CPU: loss %.9g vs "
        "%.9g; gradient max|kernel-plain|/max|plain| %s (tol %g)"
        % (E_SMALL, float(lk), float(lp), json.dumps({k: float("%.3g" % v) for k, v in rel.items()}),
           TOL_GRAD_SUM))
    if abs(float(lk) - float(lp)) > 1e-4 * abs(float(lp)) or not all(
            np.isfinite(v) and v <= TOL_GRAD_SUM for v in rel.values()):
        fail("phase 8 train: kernels and plain version disagree at %d envs" % E_SMALL)

    # K2 and K3 at the 24 Hz interval (83 substeps), at the plain linearization
    S83 = 83
    q, qd, tgt, _ = synthetic.window_problem(a1, E_CHECK, S83, 2, seed=SEED + 6)
    bq, bqd = eval_fk(a1, torch.as_tensor(q), torch.as_tensor(qd))
    bq = synthetic.grounded(a1, bq.numpy(), seed=SEED + 6)
    bq_p = torch.as_tensor(bq, device=dev).permute(2, 1, 0).contiguous()
    bqd_p = bqd.to(dev).permute(2, 1, 0).contiguous()
    tgt_p = torch.as_tensor(tgt[:S83], device=dev).permute(0, 2, 1).contiguous()
    integ = tint.SemiImplicitIntegrator(a1)
    rng = np.random.RandomState(SEED + 7)
    w = (torch.as_tensor(rng.randn(7, B, E_CHECK).astype(np.float32), device=dev),
         torch.as_tensor(rng.randn(6, B, E_CHECK).astype(np.float32), device=dev))
    params = tint.default_sim_params(a1, dev)
    di = soa_grad.DiffInterval(integ, m.dt, S83)
    label = "phase 8 a1 %d-substep interval" % S83
    qk, qdk, _ = interval_grads(di, bq_p, bqd_p, tgt_p, None, *param_planes(a1, params), w)
    qp, qdp, _ = interval_grads(lambda *a: tint.interval(integ, m.dt, *a),
                                bq_p, bqd_p, tgt_p, None, *param_planes(a1, params), w)
    check_errs(label + " K2 values", {"q": float((qk - qp).abs().max()),
                                      "qd": float((qdk - qdp).abs().max())}, TOL_INTERVAL)
    ref, got = linearized_grads(label, di, bq_p, bqd_p, tgt_p, None,
                                *param_planes(a1, params), w)
    check_grads(label, grad_errors(ref, got, E_CHECK), E_CHECK, linearized=True)
    log("phase 8 bench main path: ok (%.1f s)" % (time.time() - t0))

    # ---- 9. the with_xp interval kernels vs plain on the card ---------------------
    anchor_checks(dev, a1, sub, m.dt)

    # ---- 10. the lab4d main path ---------------------------------------------------
    xp_rows, lab4d_vis, lab4d_tree = lab4d_main_path(dev, sub)

    # ---- 11. vis and IO on the card's paths ---------------------------------------
    vis_and_io(smi, lab4d_vis)

    # ---- 12. multi-GPU on one card ---------------------------------------------------
    parallel = multi_gpu(smi, lab4d_tree)
    log("total %.1f s" % (time.time() - t_all))

    # ---- results -----------------------------------------------------------------
    kernels = [{
        "name": soa.KERNEL,
        "route": "cuda",
        "source": "ppr_diffphys_torch/csrc/soa_window.cu",
        "replaces": "ppr_diffphys_tpu/sim/pallas_soa.py:1244",
        "launches": int(launches[soa.KERNEL]),
        "max_abs_err": errs["q"],
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_roof["ms"],
        "bound_by": k1_roof["by"],
        "library_ms": None,
        "design": "warp-per-env",
        "device_ms": k1_dev_ms,
    }, {
        "name": soa_grad.KERNEL_FWD,
        "route": "cuda",
        "source": "ppr_diffphys_torch/csrc/soa_interval.cu",
        "replaces": "ppr_diffphys_tpu/sim/pallas_soa_grad.py:473",
        "launches": int(train_launches[soa_grad.KERNEL_FWD]),
        "max_abs_err": k2_err["q"],
        "ms": k2_ms,
        "plain_ms": p2_ms,
        "bound_ms": k2_roof["ms"],
        "bound_by": k2_roof["by"],
        "library_ms": None,
        "design": "warp-per-env",
        "device_ms": k2_dev_ms,
    }, {
        # K3's row counts its launches together with the env reduction's
        "name": soa_grad.KERNEL_BWD,
        "route": "cuda",
        "source": "ppr_diffphys_torch/csrc/soa_interval.cu",
        "replaces": "ppr_diffphys_tpu/sim/pallas_soa_grad.py:526",
        "launches": int(train_launches[soa_grad.KERNEL_BWD]
                        + train_launches[soa_grad.KERNEL_REDUCE]),
        "max_abs_err": k3_abs,
        "ms": k3_ms,
        "plain_ms": p3_ms,
        "bound_ms": k3_roof["ms"],
        "bound_by": k3_roof["by"],
        "library_ms": None,
        "design": "warp-per-env",
        "device_ms": k3_dev_ms,
    }, {
        "name": soa.KERNEL_ROLLOUT,
        "route": "cuda",
        "source": "ppr_diffphys_torch/csrc/soa_rollout.cu",
        "replaces": "ppr_diffphys_tpu/sim/pallas_soa.py:1329",
        "launches": int(roll_launches[soa.KERNEL_ROLLOUT]),
        "max_abs_err": k4_err["q"],
        "ms": k4_ms,
        "plain_ms": p4_ms,
        "bound_ms": k4_roof["ms"],
        "bound_by": k4_roof["by"],
        "library_ms": None,
        "design": "warp-per-env",
        "device_ms": k4_dev_ms,
    }] + xp_rows
    log("quoted from PERF.md, not measured in this run: wrapper ms by CUDA events when each "
        "kernel ran one thread per env, each from the last run before its warp-per-env "
        "redesign (NVIDIA H100 80GB HBM3 at 700 W): %s"
        % json.dumps(QUOTED_THREAD_PER_ENV_MS))
    print(json.dumps({"parallel": parallel}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
