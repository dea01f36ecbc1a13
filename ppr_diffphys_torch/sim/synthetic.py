"""Small synthetic articulations that reach the joint branches the robot
templates do not: a1 is all-REVOLUTE and every template imports with
``limit_ke=0``, so only a synthetic model drives the FIXED and COMPOUND
joint laws and the joint-limit law.

``add_chain`` works on any builder with the ``ModelBuilder`` interface, so
the tests build the same chain with the JAX package's builder too.

The numpy generators below make seeded window inputs (joint states,
penetrating ground placement, targets, gains and masses) that the tests
hand to both packages and chip_smoke.py hands to the kernel and its plain
version.
"""

from __future__ import annotations

import numpy as np

from .builder import JOINT_COMPOUND, JOINT_FIXED, JOINT_FREE, JOINT_REVOLUTE, ModelBuilder


def add_chain(b, extra_boxes: bool = False):
    """FREE box root -> COMPOUND link (finite limits, active limit springs)
    -> FIXED link -> REVOLUTE link (finite limits). With ``extra_boxes``
    every body also carries a massless box below it: 8 more ground contacts
    each, 45 in all. Returns the builder."""

    def extra(body):
        if extra_boxes:
            b.add_shape_box(body, (0.0, -0.03, 0.02), (0, 0, 0, 1), 0.03, 0.02, 0.03,
                            density=0.0, ke=1e4, kd=0.0, kf=1e2, mu=1.0)

    b.add_body(parent=-1, joint_type=JOINT_FREE, joint_armature=0.01, name="root")
    b.add_shape_box(0, (0, 0, 0), (0, 0, 0, 1), 0.12, 0.05, 0.08, density=1000,
                    ke=1e4, kd=0.0, kf=1e2, mu=1.0)
    extra(0)
    b.add_body(
        parent=0, joint_type=JOINT_COMPOUND,
        joint_xform=np.array([0.15, -0.02, 0.0, 0.0, 0.0, 0.0, 1.0]),
        joint_xform_child=np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]),
        joint_limit_lower=[-0.3, -0.4, -0.5], joint_limit_upper=[0.3, 0.4, 0.5],
        joint_limit_ke=50.0, joint_limit_kd=1.0,
        joint_target_ke=220.0, joint_target_kd=2.0, joint_armature=0.01,
        name="ball",
    )
    b.add_shape_capsule(1, (0.08, 0, 0), (0, 0, 0, 1), 0.02, 0.08, density=1000,
                        ke=1e4, kd=0.0, kf=1e2, mu=1.0)
    extra(1)
    b.add_body(
        parent=1, joint_type=JOINT_FIXED,
        joint_xform=np.array([0.16, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]),
        joint_armature=0.01, name="fixed",
    )
    b.add_shape_sphere(2, (0, 0, 0), (0, 0, 0, 1), 0.05, density=1000,
                       ke=1e4, kd=0.0, kf=1e2, mu=1.0)
    extra(2)
    b.add_body(
        parent=2, joint_type=JOINT_REVOLUTE,
        joint_xform=np.array([0.05, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]),
        joint_axis=(0.0, 0.0, 1.0),
        joint_limit_lower=-0.5, joint_limit_upper=0.5,
        joint_limit_ke=50.0, joint_limit_kd=1.0,
        joint_target_ke=220.0, joint_target_kd=2.0, joint_armature=0.01,
        name="hinge",
    )
    b.add_shape_capsule(3, (0.06, 0, 0), (0, 0, 0, 1), 0.025, 0.06, density=1000,
                        ke=1e4, kd=0.0, kf=1e2, mu=1.0)
    extra(3)
    return b


def chain_model(builder_cls=ModelBuilder, extra_boxes: bool = False):
    """The finalized chain with ground contacts and the robot templates'
    attach gains (ke=16000, kd=200). ``extra_boxes`` gives 45 contacts:
    more than one chunk of 32 for the warp-per-env kernels, with the FIXED
    link's contacts (26-34) across the chunk boundary."""
    model = add_chain(builder_cls(), extra_boxes).finalize().make_ground_contacts()
    model.joint_attach_ke, model.joint_attach_kd = 16000.0, 200.0
    return model


def _qrot_np(q, v):
    u, w = q[..., :3], q[..., 3:4]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def random_joint_state(model, E, seed):
    """(joint_q (E,n_q), joint_qd (E,n_qd)) around the model's initial pose:
    joint angles perturbed by up to 0.3 rad (past the chain's compound
    limits for some envs) and small random joint rates."""
    rng = np.random.RandomState(seed)
    q = np.tile(np.asarray(model.joint_q_init, np.float32)[None], (E, 1))
    n_q = model.n_q
    q[:, 7:] += rng.uniform(-0.3, 0.3, (E, n_q - 7)).astype(np.float32)
    qd = (rng.randn(E, model.n_qd) * 0.3).astype(np.float32)
    return q, qd


def grounded(model, body_q, seed, lo=-0.02, hi=0.004):
    """Shift each env vertically so its lowest contact point sits at a
    random height in [lo, hi]: most envs penetrate the ground, so the
    contact law is active."""
    rng = np.random.RandomState(seed + 1)
    bq = np.array(body_q, np.float32)
    pts = bq[:, model.contact_body, 0:3] + _qrot_np(
        bq[:, model.contact_body, 3:7], model.contact_point[None]
    )
    low = (pts[..., 1] - model.contact_dist[None]).min(-1)  # (E,)
    shift = rng.uniform(lo, hi, bq.shape[0]) - low
    bq[:, :, 1] += shift[:, None].astype(np.float32)
    return bq


def window_problem(model, E, sub, F, seed):
    """Seeded numpy inputs of a window: joint_q/qd for FK and joint targets
    (S, E, n_qd) and acts (S, E, n_qd)."""
    S = sub * (F - 1) + 1
    q, qd = random_joint_state(model, E, seed)
    rng = np.random.RandomState(seed + 2)
    tgt = (rng.randn(S, E, model.n_qd) * 0.2).astype(np.float32)
    act = (rng.randn(S, E, model.n_qd) * 0.05).astype(np.float32)
    return q, qd, tgt, act


def sim_params_np(model, E=None, seed=0):
    """Shared (E=None) or per-env PD gains and masses, numpy: (ke, kd, mass,
    norm_inertia)."""
    norm_I = model.body_inertia / model.body_mass[:, None, None]
    n_dof = model.n_qd - 6
    ke = np.concatenate([np.zeros(6), 220.0 * np.ones(n_dof)]).astype(np.float32)
    kd = np.concatenate([np.zeros(6), 2.0 * np.ones(n_dof)]).astype(np.float32)
    mass = np.asarray(model.body_mass, np.float32)
    if E is not None:
        rng = np.random.RandomState(seed)
        ke = (ke[None] * (1 + 0.2 * rng.rand(E, model.n_qd))).astype(np.float32)
        kd = (kd[None] * (1 + 0.2 * rng.rand(E, model.n_qd))).astype(np.float32)
        mass = (mass[None] * (1 + 0.2 * rng.rand(E, model.n_links))).astype(np.float32)
    return ke, kd, mass, norm_I.astype(np.float32)


def perturbed_anchors(model, E=None, seed=0, shift=1e-2, angle=0.05):
    """Joint parent anchors near the model's, as a live ``joint_X_p``:
    (B,7) shared (E None) or (E,B,7) per env. Each translation moves by up
    to ``shift`` (m) per axis, each rotation by a random axis and an angle
    up to ``angle`` (rad), seeded; float32."""
    rng = np.random.RandomState(seed)
    xp = np.asarray(model.joint_X_p, np.float64)
    shape = (model.n_links,) if E is None else (E, model.n_links)
    t = xp[..., 0:3] + rng.uniform(-shift, shift, shape + (3,))
    axis = rng.randn(*shape, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    half = 0.5 * rng.uniform(-angle, angle, shape)[..., None]
    dq = np.concatenate([axis * np.sin(half), np.cos(half)], -1)  # xyzw
    q = np.broadcast_to(xp[..., 3:7], dq.shape)
    # Hamilton product dq * q, xyzw
    v1, w1, v2, w2 = dq[..., :3], dq[..., 3:], q[..., :3], q[..., 3:]
    qn = np.concatenate([w1 * v2 + w2 * v1 + np.cross(v1, v2),
                         w1 * w2 - np.sum(v1 * v2, -1, keepdims=True)], -1)
    return np.concatenate([t, qn], -1).astype(np.float32)
