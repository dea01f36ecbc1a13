"""Training CLI of the PyTorch/CUDA port, counterpart of the repository's
``main.py`` (reference main.py):

    python -m ppr_diffphys_torch.main --urdf_template a1 --seqname a1-synth \\
        --datadir tests/fixtures/motion_sequences --urdf_dir tests/fixtures

Round-based loop: per round, checkpoint -> full-sequence eval -> videos and
trajectory OBJ strips of the eval (``--render_vis``, ``utils/vis.py``) ->
train iterations on windowed envs with gradient accumulation and grad
safety. The eval score and every iteration's loss dict are written to
tensorboard in the run's directory and printed as JSON lines on stdout;
``--profile_dir`` traces iterations 2-4 with ``torch.profiler`` into a
Chrome trace there (``trace.json``, where the program's spans are ranges
over their kernels) and writes the spans' and counters' summary beside it
(``spans.json``, ``utils/spans.py``). Flags carry ``main.py``'s names and
defaults, plus ``--device`` (default cuda; ``--device cpu`` runs the plain
PyTorch versions of the kernels) and ``--dist_url``. Left out: the TPU
engine and tiling flags (``phys_engine``, ``eval_engine``, ``soa_e_tile``,
``soa_ksub``, ``rollout_unroll``); ``ckpt_backend`` (orbax is a JAX library;
checkpoints are pickles).

Multi-GPU, one process per card (``parallel/sharding.py``):

    torchrun --nproc_per_node 8 -m ppr_diffphys_torch.main --num_envs 512 ...

Each rank runs on ``cuda:<LOCAL_RANK>``; ``--ngpu`` budgets the ranks (-1:
all) and ``--mesh_shape`` shapes the mesh (``dp=4,tp=2``; empty: dp over
the budget). Every rank runs every iteration and the eval; rank 0 alone
writes the checkpoints, ``ckpt_phys_best.pth``, videos, OBJ strips,
tensorboard, the JSON lines and the ``--profile_dir`` trace.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

NOISE_STD_DEFAULT = 2e-3


def parse_args(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add = p.add_argument
    add("--local_rank", type=int, default=0,
        help="for distributed training (LOCAL_RANK, as torchrun sets it, wins)")
    add("--ngpu", type=int, default=-1,
        help="rank budget: -1 = all ranks of the world (envs dp-shard over the mesh)")
    add("--mesh_shape", default="",
        help="device mesh, e.g. 'dp=4,tp=2'; empty = auto dp over all ranks")
    add("--dist_url", default="",
        help="torch.distributed init method (empty: env://, as torchrun sets it)")
    add("--accu_steps", type=int, default=1, help="gradient accumulation steps")
    add("--seqname", default="mi-pace", help="name of the sequence")
    add("--logroot", default="logdir/", help="root directory for output")
    add("--logname", default="dynamics", help="experiment name")
    add("--phys_learning_rate", type=float, default=1e-4, help="learning rate")
    add("--num_rounds", type=int, default=5, help="total update rounds")
    add("--warmup_iters", type=int, default=0, help="warmup iterations (DR+DP only)")
    add("--urdf_template", default="laikago", help="robot template")
    add("--num_freq", type=int, default=10, help="fourier frequencies")
    add("--t_embed_dim", type=int, default=128, help="pose code dim")
    add("--iters_per_round", type=int, default=20, help="iters per round")
    add("--ratio_phys_cycle", type=float, default=1.0, help="fraction of iters for physics")
    add("--noise_std", type=float, default=None,
        help="init-state noise std (default 2e-3; 6e-3 on 24 Hz sequences)")
    add("--traj_wt", type=float, default=0.01, help="traj matching weight")
    add("--pos_state_wt", type=float, default=0.01, help="position matching weight")
    add("--vel_state_wt", type=float, default=1e-4, help="velocity matching weight")
    add("--pos_distill_wt", type=float, default=0.0, help="kinematics distillation weight")
    add("--reg_torque_wt", type=float, default=0.0, help="torque regularization")
    add("--reg_res_f_wt", type=float, default=0.0, help="residual force regularization")
    add("--reg_foot_wt", type=float, default=0.0, help="foot contact regularization")
    add("--reg_root_wt", type=float, default=0.0, help="root pose regularization")
    add("--datadir", default="data/motion_sequences", help="mocap dir")
    add("--urdf_dir", default="data/urdf_templates", help="urdf dir")
    add("--num_envs", type=int, default=10, help="training envs per step")
    add("--frames_per_wdw", type=int, default=24, help="frames per training window")
    add("--ref_quirks", action=argparse.BooleanOptionalAction, default=False,
        help="reproduce the reference's upper-only rollout adjoint clamp and "
             "env-0 sticky divergence threshold")
    add("--wdw_schedule", action=argparse.BooleanOptionalAction, default=False,
        help="window-length curriculum: grow frames_per_wdw over training with "
             "num_envs=max(1,100/frames)")
    add("--render_vis", action=argparse.BooleanOptionalAction, default=True,
        help="render per-round videos (needs cv2)")
    add("--seed", type=int, default=0, help="rng seed")
    add("--contact_mode", default="hull", help="hull | all | hull:<margin>")
    add("--soa_with_res", action=argparse.BooleanOptionalAction, default=False,
        help="give the interval kernels residual forces (zero in the reference)")
    add("--soa_with_act", action=argparse.BooleanOptionalAction, default=False,
        help="give the interval kernels joint activations (zero in the reference)")
    add("--hull_fallback_margin", type=float, default=3e-3,
        help="interior-vertex penetration (m) that triggers the 'all' fallback")
    add("--contact_fallback", action=argparse.BooleanOptionalAction, default=True,
        help="enable the hull->all auto-fallback")
    add("--eval_selection", action=argparse.BooleanOptionalAction, default=True,
        help="copy the best round's checkpoint by full-sequence eval to "
             "ckpt_phys_best.pth")
    add("--num_seeds", type=int, default=1,
        help="train num_seeds runs (seed, seed+1, ...) and keep the best by eval")
    add("--profile_dir", default="",
        help="trace training iterations 2-4 with torch.profiler into this directory")
    add("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    return vars(p.parse_args(argv))


def _rank0() -> bool:
    from .parallel import sharding

    return sharding.rank() == 0


def log(record: dict):
    if _rank0():
        print(json.dumps(record), flush=True)


class _Silent:
    """The visualizer of a rank other than 0: it writes nothing (rank 0
    alone calls ``show``)."""

    def write_log(self, log_data, step):
        pass

    def close(self):
        pass


def train_one(opts):
    """One training run; returns (best_eval_score, best_ckpt_path). In a
    torch.distributed world every rank calls it; rank 0 writes."""
    from .utils.config import build_opts
    from .utils.vis import PhysVisualizer

    opts = build_opts(**opts)
    logname = "%s-%s" % (opts["seqname"], opts["logname"])
    save_dir = os.path.join(opts["logroot"], logname)
    vis = PhysVisualizer(save_dir, render_video=opts["render_vis"]) if _rank0() else _Silent()
    try:
        return _train(opts, save_dir, vis)
    finally:
        vis.close()


def _train(opts, save_dir, vis):
    from .data.amp_loader import DataLoader
    from .models.phys_model import phys_model

    dataloader = DataLoader(opts)
    if opts["noise_std"] is None:
        opts["noise_std"] = NOISE_STD_DEFAULT
        # 24 Hz sequences: 3x init noise when the flag was left at its default
        if int(round(dataloader.frame_interval / 5e-4)) > 60:
            opts["noise_std"] = 6e-3
            print("24 Hz sequence: defaulting --noise_std to 6e-3")

    model = phys_model(opts, dataloader, device=opts["device"])
    profiler = None
    best_score, best_it = None, None
    for it in range(model.total_iters):
        model.progress = it / (opts["num_rounds"] * opts["iters_per_round"])

        if it % opts["iters_per_round"] == 0:
            model.save_checkpoint(it)
            # full-sequence eval and its videos (reference main.py:78-81)
            model.reinit_envs(1, frames_per_wdw=model.total_frames, is_eval=True)
            eval_score = float(model.forward()["loss_traj"])
            vis.write_log({"eval/traj": eval_score}, it)
            if opts["eval_selection"] and (best_score is None or eval_score < best_score):
                best_score, best_it = eval_score, it
            t = time.perf_counter()
            if _rank0():
                data = model.query()
                data["model"] = model.env
                vis.show(it, data, fps=1.0 / model.frame_interval,
                         render_video=opts["render_vis"])
            log({"it": it, "eval/traj": eval_score, "vis_time": time.perf_counter() - t})
            if opts["wdw_schedule"]:
                fpw = int(0.5 * (model.total_frames - 1) / model.total_iters * it + 1)
                fpw = max(2, min(fpw, model.total_frames))
                n_env = max(1, int(100 / fpw))
                print("wdw/envs: %d/%d" % (fpw, n_env))
                model.reinit_envs(n_env, frames_per_wdw=fpw, is_eval=False)
            else:
                model.reinit_envs(opts["num_envs"], frames_per_wdw=opts["frames_per_wdw"],
                                  is_eval=False)

        if opts["profile_dir"] and _rank0():
            if it == 2:
                profiler = _start_profile(model.device)
            elif it == 5:
                _stop_profile(profiler, opts["profile_dir"])
                profiler = None

        t = time.perf_counter()
        accu = []
        for _ in range(opts["accu_steps"]):
            loss_dict = model.forward()
            accu.append(loss_dict["total_loss"])
        model.backward(None)
        grad_dict = model.update()
        record = {k: float(v) for k, v in loss_dict.items()}
        record["loss"] = float(sum(float(a) for a in accu)) / float(opts["accu_steps"])
        record.update(grad_dict)
        record["iter_time"] = time.perf_counter() - t
        vis.write_log(record, it)
        record["it"] = it
        log(record)
    if profiler is not None:  # fewer than 5 iterations: the window ends with the run
        _stop_profile(profiler, opts["profile_dir"])

    best_path = None
    if best_it is not None and _rank0():
        src = os.path.join(save_dir, "ckpt_phys_%04d.pth" % best_it)
        best_path = os.path.join(save_dir, "ckpt_phys_best.pth")
        if os.path.exists(src):
            shutil.copy(src, best_path)
        print("best checkpoint by full-sequence eval: iter %d (traj %.4f) -> %s"
              % (best_it, best_score, best_path))
    return best_score, best_path


def _start_profile(device):
    import torch

    from .utils import spans

    spans.reset()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir):
    """End the trace and write it as a Chrome trace, profile_dir/trace.json,
    and the summary of the program's spans and counters over the same
    iterations, profile_dir/spans.json."""
    from .utils import spans

    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print("profiler trace of iterations 2-4: %s" % path)
    path = os.path.join(profile_dir, "spans.json")
    with open(path, "w") as f:
        json.dump(spans.summary(), f, indent=1, sort_keys=True)
    print("spans and counters of iterations 2-4: %s" % path)


def main(argv=None):
    opts = parse_args(argv)
    from .parallel import sharding

    _, world, dev = sharding.init_distributed(
        opts["device"], init_method=opts["dist_url"] or None, local_rank=opts["local_rank"])
    opts["device"] = str(dev)
    try:
        _main(opts)
    finally:
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()


def _main(opts):
    n_seeds = max(1, int(opts["num_seeds"]))
    if n_seeds == 1:
        train_one(opts)
        return
    if not opts["eval_selection"]:
        raise SystemExit("--num_seeds>1 requires --eval_selection: without per-round "
                         "eval scores there is nothing to select the best seed by")
    results = []
    for k in range(n_seeds):
        o = dict(opts, seed=opts["seed"] + k, logname="%s-s%d" % (opts["logname"], k))
        score, path = train_one(o)
        results.append((score, o["seed"], path))
        print("seed %d: eval traj %s" % (o["seed"], "%.4f" % score if score is not None else "n/a"))
    results.sort(key=lambda r: (r[0] is None, r[0] if r[0] is not None else 0.0))
    score, seed, path = results[0]
    print("multi-seed selection: best seed %d (eval traj %s), checkpoint %s"
          % (seed, "%.4f" % score if score is not None else "n/a", path))


if __name__ == "__main__":
    main()
