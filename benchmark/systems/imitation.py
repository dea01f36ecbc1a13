"""The imitation model (``phys_model``: five time-MLPs, the a1 robot, the
mocap clip) built on either side from a configuration and a run's seed.

``build(side, run, device)`` gives the program's model (``"program"``:
``ppr_diffphys_torch``) or the plain reference's (``"reference"``: the
frozen copy in ``benchmark/reference``), both from the same inputs: the
configuration's options, the committed URDF and clip under
``benchmark/data``, the weights the benchmark draws on the device, and the
seed of the initial-state noise. Everything else (the mocap table, the
global SE(3) from the feet, the optimizer) each side works out itself.
"""

from __future__ import annotations

import numpy as np

from ..work import counts
from . import common


def modules(side):
    if side == "program":
        from ppr_diffphys_torch.data.amp_loader import DataLoader
        from ppr_diffphys_torch.models.phys_model import phys_model
        from ppr_diffphys_torch.utils.config import build_opts
    else:
        from ..reference.data.amp_loader import DataLoader
        from ..reference.models.phys_model import phys_model
        from ..reference.utils.config import build_opts
    return DataLoader, phys_model, build_opts


def make_model(side, config, device):
    DataLoader, phys_model, build_opts = modules(side)
    opts = common.opts_from(config, build_opts, logname="bench-" + side)
    model = phys_model(opts, DataLoader(opts), device=device)
    common.check_widths(dict(model.modules.items()), config)
    return model


def prepare(model, config, seed, device):
    """The benchmark's weights, then the global SE(3) that the model works
    out from them (``init_global_q``) and the noise generator's seed."""
    common.seed_weights(model.named_tensors(), config["weights"],
                        common.sub_seed(seed, "weights"), device)
    model.init_global_q()
    model.generator.manual_seed(common.sub_seed(seed, "noise"))


def inputs(run, device):
    """Nothing beyond the configuration's files and the seed."""
    return None


def build(side, run, device, inputs=None):
    """A training model at the traffic's envs and frames."""
    model = make_model(side, run.config, device)
    prepare(model, run.config, run.seed, device)
    model.reinit_envs(int(run.traffic["num_envs"]), int(run.traffic["frames_per_wdw"]),
                      is_eval=False)
    return model


def draw_starts(rng, model, E, F):
    """Window starts as the CLI draws them (``compute_frame_start``): whole
    frames, uniform over the clip."""
    return np.round(rng.random(E) * (model.total_frames - F)).astype(np.float32)


def shapes(run):
    """The reference's model, for the counts: bodies, contacts, joints."""
    return make_model("reference", run.config, "cpu")


def train_work(run) -> dict:
    """Counted work of one training step: the five MLPs forward and
    backward at E x S rows, and the interval kernels' bounds per launch."""
    m = shapes(run)
    E, F = int(run.traffic["num_envs"]), int(run.traffic["frames_per_wdw"])
    sub = m.steps_per_fr_interval
    rows = E * (sub * (F - 1) + 1)
    mlp = sum(counts.mlp_ops(mod, rows, backward=True) for mod in m.modules.values())
    iw = counts.interval_work(m.env, E, sub)
    return dict(mlp_ops=mlp, intervals=F - 1,
                k2=dict(bytes=iw["fwd_bytes"], ops=iw["fwd_ops"]),
                k3=dict(bytes=iw["bwd_bytes"], ops=iw["bwd_ops"]))


def serve_work(run) -> dict:
    """Counted work of one served request: the five MLPs forward on the
    clip's substep grid (the grid prologue) and K1's bound."""
    m = shapes(run)
    E, F = int(run.traffic["num_envs"]), int(run.traffic["frames"])
    sub = m.steps_per_fr_interval
    K = (m.total_frames - 1) * sub + 1
    mlp = sum(counts.mlp_ops(mod, K, backward=False) for mod in m.modules.values())
    ww = counts.window_work(m.env, E, sub, F)
    return dict(mlp_ops=mlp, k1=dict(bytes=ww["bytes"], ops=ww["ops"]))
