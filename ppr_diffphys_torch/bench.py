"""The port's bench: batched simulator throughput in env-steps/s, counterpart
of the repository's root ``bench.py`` (which is the JAX package's):

    python -m ppr_diffphys_torch.bench                   # rollout, 4096 envs x 990 substeps
    python -m ppr_diffphys_torch.bench --mode train      # training, 4096 envs x 10 intervals
    python -m ppr_diffphys_torch.bench --device cpu --envs 4 --steps 8 --interval 4

Prints ONE JSON line: {"metric": "batched_<urdf>_<rollout|training>_throughput",
"value": env-steps/s, "unit": "env-steps/sec", "detail": {...}}.

The workload is ``bench.py``'s, built from the same source lines: the URDF
imported with the template arguments, ground contacts (``--contacts
hull|all``), attach gains 16000/200, PD gains 220/2 on the DoFs and zero on
the root, the rest pose (DoFs 2, 5, 8, 11 at -0.8 on a 12-DoF robot), and
per-env initial states whose x and z are perturbed by U(-0.05, 0.05) from
``np.random.RandomState(0)``; targets are the tiled rest pose, acts zero,
dt = 5e-4.

- **rollout:** ``steps // interval`` calls of the bench rollout kernel K4
  (``sim/soa.py:build_soa_rollout``, ``csrc/soa_rollout.cu``) of
  ``interval`` substeps each, the state carried from call to call.
- **train:** the loss ``mean(q^2) + mean(qd^2)`` of ``soa_grad.rollout_soa``
  over ``max(1, steps // interval // 3)`` intervals and its gradients with
  respect to ke, kd, mass, the initial body_q and body_qd (inertia =
  normalized inertia x mass), on the interval kernels K2/K3.

One warm-up, then 3 reps on the host clock, each ending in a device
synchronize; the value is envs x substeps over the mean rep wall. The
detail holds the kernel launches per rep, the card's name and power limit,
the device busy share (the device time of the kernels in one extra rep
under torch.profiler over the mean unprofiled rep wall) and the least time
the card could take for the kernels' work of one rep (``bound_ms``,
``bound_by``: ``rollout_work`` / ``interval_work`` at the H100's peaks,
``utils/h100.py``).

The default URDF is the a1 fixture, the one robot URDF in the repository.
Left out of ``bench.py``: the ``engine`` switch and its fallback to another
engine, the TPU tile and memory planner fields and peaks, and
``vs_baseline``. ``--device cuda`` (the default) runs the kernels and
raises without a GPU; ``--device cpu`` runs their plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from . import default_device
from .sim import soa, soa_grad
from .sim import integrator as tint
from .sim.builder import ModelBuilder
from .sim.import_urdf import parse_urdf
from .sim.kinematics import eval_fk
from .utils import h100

DT = 5e-4
REPS = 3
A1_URDF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "tests", "fixtures", "a1", "urdf", "a1.urdf")
GRAD_NAMES = ("ke", "kd", "mass", "bq0", "bqd0")


class Workload(NamedTuple):
    model: object
    integrator: tint.SemiImplicitIntegrator
    params: tint.SimParams  # bench gains, the model's masses and inertias
    state: tint.SimState  # (E,B,7), (E,B,6) perturbed initial states
    target: torch.Tensor  # (E, n_qd) the rest pose


def build_workload(urdf: str = A1_URDF, envs: int = 4096, contacts: str = "hull",
                   device=None, seed: int = 0) -> Workload:
    """The bench's model, parameters and initial states (bench.py:176-207)."""
    dev = default_device(device)
    b = ModelBuilder()
    parse_urdf(
        urdf, b, xform_p=(0, 0.417, 0), floating=True, density=1000,
        armature=0.01, stiffness=220.0, damping=2.0, shape_ke=1e4,
        shape_kd=0, shape_kf=1e2, shape_mu=1, limit_ke=0, limit_kd=0,
    )
    model = b.finalize().make_ground_contacts(contacts)
    model.joint_attach_ke = 16000.0
    model.joint_attach_kd = 200.0

    f32 = dict(dtype=torch.float32, device=dev)
    ke = torch.cat([torch.zeros(6, **f32), 220.0 * torch.ones(model.n_dof, **f32)])
    kd = torch.cat([torch.zeros(6, **f32), 2.0 * torch.ones(model.n_dof, **f32)])
    params = tint.default_sim_params(model, dev)._replace(joint_target_ke=ke,
                                                           joint_target_kd=kd)

    q = np.array(model.joint_q_init, np.float32)
    rest = np.zeros(model.n_dof, np.float32)
    if model.n_dof == 12:
        rest[[2, 5, 8, 11]] = -0.8
    q[7:] = rest
    rng = np.random.RandomState(seed)
    qs = np.tile(q[None], (envs, 1))
    qs[:, 0:3:2] += rng.uniform(-0.05, 0.05, (envs, 2))
    body_q, body_qd = eval_fk(model, torch.as_tensor(qs))
    state = tint.SimState(body_q.to(dev), body_qd.to(dev))
    target = torch.as_tensor(np.concatenate([np.zeros(6, np.float32), rest]), **f32)
    return Workload(model, tint.SemiImplicitIntegrator(model), params, state,
                    target[None].expand(envs, -1).contiguous())


class Bench:
    """One bench mode on a workload: ``rep()`` runs one rep, ``measure()``
    the warm-up and the timed reps; the wrapper's launch counts
    (``launches``, ``reset_launches``) show which kernels ran."""

    def __init__(self, work: Workload, mode: str = "rollout", steps: int = 990,
                 interval: int = 33):
        self.work, self.mode, self.interval = work, mode, int(interval)
        E, n_qd = work.target.shape
        if mode == "rollout":
            self.n_iv = int(steps) // self.interval
            if self.n_iv < 1:
                raise ValueError("steps=%d gives no interval of %d substeps"
                                 % (steps, self.interval))
            self.steps = self.n_iv * self.interval
            self.kernel = soa.build_soa_rollout(work.integrator, work.params, DT,
                                                self.interval)
            self.tgt = work.target[None].expand(self.interval, E, n_qd).contiguous()
            self.act = torch.zeros_like(self.tgt)
        elif mode == "train":
            self.n_iv = max(1, int(steps) // self.interval // 3)
            self.steps = self.interval * self.n_iv + 1
            self.kernel = soa_grad.make_diff_interval(work.integrator, DT, self.interval)
            self.tgt = work.target[None].expand(self.steps, E, n_qd).contiguous()
            model = work.model
            self.norm_I = torch.as_tensor(
                np.asarray(model.body_inertia) / np.asarray(model.body_mass)[:, None, None],
                dtype=torch.float32, device=work.target.device)
        else:
            raise ValueError("mode must be rollout or train, not %r" % mode)
        self.device = work.target.device

    def launches(self) -> dict:
        if self.mode == "rollout":
            return {soa.KERNEL_ROLLOUT: self.kernel.launches}
        return dict(self.kernel.launches)

    def reset_launches(self):
        if self.mode == "rollout":
            self.kernel.launches = 0
        else:
            for k in self.kernel.launches:
                self.kernel.launches[k] = 0

    def rollout(self, state: tint.SimState) -> tint.SimState:
        """``n_iv`` rollout-kernel calls from ``state``."""
        for _ in range(self.n_iv):
            state = self.kernel(state, self.tgt, self.act)
        return state

    def loss_and_grads(self):
        """(loss, {name: gradient}) of the training workload (bench.py:321-333)."""
        w = self.work
        p = w.params
        leaves = [x.detach().clone().requires_grad_() for x in (
            p.joint_target_ke, p.joint_target_kd, p.body_mass, w.state.body_q, w.state.body_qd)]
        ke, kd, mass, bq0, bqd0 = leaves
        inertia = self.norm_I * mass[:, None, None]
        params = p._replace(body_mass=mass, body_inv_mass=1.0 / mass, body_inertia=inertia,
                            body_inv_inertia=torch.linalg.inv(inertia),
                            joint_target_ke=ke, joint_target_kd=kd)
        q, qd, _, _ = soa_grad.rollout_soa(
            w.integrator, params, tint.SimState(bq0, bqd0), self.tgt, None, None, DT,
            self.interval, interval_fn=self.kernel, observables=False)
        loss = q.pow(2).mean() + qd.pow(2).mean()
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), dict(zip(GRAD_NAMES, grads))

    def rep(self, state=None):
        if self.mode == "rollout":
            return self.rollout(self.work.state if state is None else state)
        return self.loss_and_grads()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def measure(self, reps: int = REPS):
        """One warm-up rep, then ``reps`` timed reps (rollout: the state
        carried from rep to rep, as bench.py does). Returns (walls in s,
        the last rep's output)."""
        self.rep()
        self.sync()
        walls, out = [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            out = self.rep(out if self.mode == "rollout" else None)
            self.sync()
            walls.append(time.perf_counter() - t0)
        return walls, out

    def profile(self, wall_s: float):
        """One rep under torch.profiler: (device busy share = the kernels'
        device time over the unprofiled rep wall ``wall_s``, or None when
        the profiler records no device time; [(device ms, launches, kernel
        name)], largest first). Needs the card."""
        if self.device.type != "cuda":
            raise ValueError("the device busy share is measured on the card only")
        _, rows = h100.kernel_times(self.rep, 1)
        busy_ms = sum(r[0] for r in rows)
        return (busy_ms / (wall_s * 1e3) if busy_ms > 0 else None), rows

    def work_bound(self) -> dict:
        """The least time (``utils/h100.py:roofline``) for the kernels' work
        of one rep: rollout, ``n_iv`` launches of ``rollout_work``; train,
        ``n_iv`` K2 (with its export) + K3 (+ reduction) of
        ``interval_work``, with the contacts this workload's trajectory
        has penetrating."""
        model, E = self.work.model, self.work.target.shape[0]
        if self.mode == "rollout":
            w = soa.rollout_work(model, E, self.interval)
            return h100.roofline(self.n_iv * w["bytes"], self.n_iv * w["ops"])
        n_act = self._active_contacts()
        w = soa_grad.interval_work(model, E, self.interval, n_active_contacts=n_act / self.n_iv)
        return h100.roofline(self.n_iv * (w["fwd_bytes"] + w["bwd_bytes"]),
                             self.n_iv * (w["fwd_ops"] + w["bwd_ops"]))

    def _active_contacts(self) -> float:
        """Penetrating (substep, env, contact) triples over the training
        rollout, counted in the substep states K2 exports (the plain
        interval's on the CPU). Its K2 launches are counted."""
        w = self.work
        planes = soa.traced_planes(w.model, w.params)
        tr = [planes[n] for n in soa.TRACED_NAMES]
        bq = w.state.body_q.permute(2, 1, 0).contiguous()
        bqd = w.state.body_qd.permute(2, 1, 0).contiguous()
        tgt = self.tgt.permute(0, 2, 1).contiguous()
        n = 0.0
        with torch.no_grad():
            for f in range(self.n_iv):
                sl = tgt[f * self.interval:(f + 1) * self.interval]
                if self.device.type == "cuda":
                    bq, bqd, sst = self.kernel._forward(bq, bqd, sl, None, None, tr, True)
                else:
                    bq, bqd, sst = tint.interval(w.integrator, DT, bq, bqd, sl, None, None,
                                                 *tr, export=True)
                n += soa_grad.active_contacts(w.model, sst)
        return n


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add = p.add_argument
    add("--envs", type=int, default=4096, help="parallel envs (PPR_BENCH_ENVS)")
    add("--steps", type=int, default=990, help="substeps per rep (PPR_BENCH_STEPS)")
    add("--contacts", default="hull", help="hull | all | hull:<eps> (PPR_BENCH_CONTACTS)")
    add("--mode", default="rollout", choices=("rollout", "train"), help="PPR_BENCH_MODE")
    add("--interval", type=int, default=33,
        help="substeps per kernel call (rollout) or frame interval (train; 83 is the "
             "24 Hz case) (PPR_BENCH_INTERVAL)")
    add("--urdf", default=A1_URDF, help="robot URDF (PPR_URDF)")
    add("--profile", type=int, default=1, help="1: profile one more rep for the busy share")
    add("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    work = build_workload(a.urdf, a.envs, a.contacts, a.device)
    bench = Bench(work, a.mode, a.steps, a.interval)
    bench.reset_launches()
    walls, _ = bench.measure(REPS)
    launches = {k: v / (REPS + 1) for k, v in bench.launches().items()}
    wall = float(np.mean(walls))
    on_card = bench.device.type == "cuda"
    busy = bench.profile(wall)[0] if a.profile and on_card else None
    bound = bench.work_bound()
    model = work.model
    out = {
        "metric": "batched_%s_%s_throughput" % (
            os.path.basename(a.urdf).split(".")[0],
            "training" if a.mode == "train" else "rollout"),
        "value": a.envs * bench.steps / wall,
        "unit": "env-steps/sec",
        "detail": {
            "envs": a.envs,
            "steps": bench.steps,
            "wall_sec": wall,
            "walls_sec": walls,
            "contacts": int(model.contact_count),
            "contact_mode": a.contacts,
            "mode": a.mode,
            "interval": bench.interval,
            "launches_per_rep": launches,
            "device": torch.cuda.get_device_name(bench.device) if on_card else "cpu",
            "nvidia_smi": h100.nvidia_smi_line() if on_card else None,
            "device_busy_frac": busy,
            "bound_ms": bound["ms"],
            "bound_by": bound["by"],
        },
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
