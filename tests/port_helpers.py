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
