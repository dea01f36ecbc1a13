"""Port math (ppr_diffphys_torch/ops) against the JAX package on seeded
random inputs, including the singular neighbourhoods: quaternions near
identity and near w=0 (180-degree rotations), rotation vectors near zero,
and atan2 in all four quadrants and on the axes.

Tolerance: both sides compute in fp32 on the CPU with the same formulas,
so they agree to a few ulp of the values involved: atol 2e-6 for unit-scale
outputs (quaternions, rotations, angles), 1e-5 where the output is a
composition of several transforms (se3 round trips, frame rotations), 1e-6
for the reference-surface helpers (quat_rpy, quat_twist, transform_inverse,
...), and equality where the op only moves values.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ppr_diffphys_tpu.ops as J
import ppr_diffphys_tpu.ops.kernel_math as JK
import ppr_diffphys_torch.ops as T
import ppr_diffphys_torch.ops.kernel_math as TK

RNG = np.random.RandomState(7)
N = 64


def _unit_quats():
    q = RNG.randn(N, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    near_id = np.concatenate([RNG.randn(8, 3) * 1e-5, np.ones((8, 1))], -1)
    near_w0 = np.concatenate([RNG.randn(8, 3), RNG.randn(8, 1) * 1e-5], -1)
    extra = np.concatenate([near_id, near_w0], 0).astype(np.float32)
    extra /= np.linalg.norm(extra, axis=-1, keepdims=True)
    return np.concatenate([q, extra], 0)


Q = _unit_quats()
Q2 = _unit_quats()
V = RNG.randn(len(Q), 3).astype(np.float32)
ROTVEC = np.concatenate([
    RNG.randn(N, 3) * 1.0, RNG.randn(8, 3) * 1e-7, RNG.randn(8, 3) * 1e-4,
]).astype(np.float32)
ANGLES = RNG.uniform(-1.4, 1.4, (len(Q), 3)).astype(np.float32)
T7 = np.concatenate([RNG.randn(len(Q), 3).astype(np.float32), Q], -1)
T7b = np.concatenate([RNG.randn(len(Q), 3).astype(np.float32), Q2], -1)
D6 = np.concatenate([RNG.randn(len(Q), 3) * 0.1, ROTVEC[: len(Q)]], -1).astype(np.float32)
QD6 = RNG.randn(len(Q), 6).astype(np.float32)
AXIS = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (len(Q), 1))
AXIS_RAND = RNG.randn(len(Q), 3).astype(np.float32)
AXIS_RAND /= np.linalg.norm(AXIS_RAND, axis=-1, keepdims=True)


def _mats(q):
    return np.asarray(J.quat_to_matrix(jnp.asarray(q)))


CASES = {
    "quat_mul": (lambda m, x, y: m.quat_mul(x, y), (Q, Q2), 2e-6),
    "quat_conjugate": (lambda m, x: m.quat_conjugate(x), (Q,), 0),
    "quat_normalize": (lambda m, x: m.quat_normalize(x),
                       (np.concatenate([Q * 3.0, np.zeros((2, 4), np.float32)]),), 2e-6),
    "quat_rotate": (lambda m, x, v: m.quat_rotate(x, v), (Q, V), 2e-6),
    "quat_rotate_inv": (lambda m, x, v: m.quat_rotate_inv(x, v), (Q, V), 2e-6),
    "quat_from_axis_angle": (lambda m, a, t: m.quat_from_axis_angle(a, t),
                             (AXIS, ANGLES[:, 0]), 2e-6),
    "axis_angle_to_quat": (lambda m, r: m.axis_angle_to_quat(r), (ROTVEC,), 2e-6),
    "quat_to_axis_angle": (lambda m, x: m.quat_to_axis_angle(x), (Q,), 2e-5),
    "quat_to_matrix": (lambda m, x: m.quat_to_matrix(x), (Q,), 2e-6),
    "matrix_to_quat": (lambda m, x: m.matrix_to_quat(x), (_mats(Q),), 2e-6),
    "compound_to_quat": (lambda m, a: m.compound_to_quat(a), (ANGLES,), 2e-6),
    "quat_to_compound": (lambda m, x: m.quat_to_compound(x), (Q,), 2e-5),
    "transform_mul": (lambda m, a, b: m.transform_mul(a, b), (T7, T7b), 1e-5),
    "transform_point": (lambda m, a, p: m.transform_point(a, p), (T7, V), 1e-5),
    "se3_vec2mat_7": (lambda m, a: m.se3_vec2mat(a), (T7,), 2e-6),
    "se3_vec2mat_6": (lambda m, a: m.se3_vec2mat(a), (D6,), 2e-6),
    "se3_mat2vec_6": (lambda m, a: m.se3_mat2vec(a, outdim=6),
                      (np.asarray(J.se3_vec2mat(jnp.asarray(T7))),), 2e-5),
    "compose_delta": (lambda m, a, d: m.compose_delta(a, d), (T7, D6), 1e-5),
    "rotate_frame": (lambda m, g, a: m.rotate_frame(g, a), (T7[0], T7), 1e-5),
    "rotate_frame_vel": (lambda m, g, v: m.rotate_frame_vel(g, v), (T7[0], QD6), 1e-5),
    "swap_lin_ang": (lambda m, v: m.swap_lin_ang(v), (np.concatenate([QD6, V], -1),), 0),
    # the reference-surface helpers, within 1e-6
    "quat_rpy": (lambda m, r, p, y: m.quat_rpy(r, p, y), tuple(ANGLES.T), 1e-6),
    "quat_rpy_scalar": (lambda m, r, p, y: m.quat_rpy(r, p, y), tuple(ANGLES[0]), 1e-6),
    "quat_twist": (lambda m, a, x: m.quat_twist(a, x), (AXIS_RAND, Q), 1e-6),
    "quat_twist_angle": (lambda m, a, x: m.quat_twist_angle(a, x), (AXIS_RAND, Q), 1e-6),
    "transform_identity": (lambda m: m.transform_identity((3, 2)), (), 0),
    "make_transform": (lambda m, p, q: m.make_transform(p, q), (V, Q), 0),
    "transform_inverse": (lambda m, a: m.transform_inverse(a), (T7,), 1e-6),
    "transform_vector": (lambda m, a, v: m.transform_vector(a, v), (T7, V), 1e-6),
    "spatial_top": (lambda m, v: m.spatial_top(v), (QD6,), 0),
    "spatial_bottom": (lambda m, v: m.spatial_bottom(v), (QD6,), 0),
    "make_spatial": (lambda m, a, b: m.make_spatial(a, b), (V, V[::-1]), 0),
    "acos": (lambda m, x: m.kernel_math.acos(x), (np.linspace(-1.2, 1.2, 49, dtype=np.float32),),
             1e-6),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    fn, args, tol = CASES[name]
    want = np.asarray(fn(J, *[jnp.asarray(a) for a in args]))
    got = fn(T, *[torch.as_tensor(np.array(a)) for a in args]).numpy()
    assert got.shape == want.shape
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _atan2_points():
    ang = np.linspace(-np.pi, np.pi, 73)[:-1]
    r = RNG.uniform(0.1, 10.0, ang.shape)
    y, x = r * np.sin(ang), r * np.cos(ang)
    axes_y = np.array([0.0, 1.0, 0.0, -1.0, 0.0, 1e-30, -1e-30, 3.0])
    axes_x = np.array([1.0, 0.0, -1.0, 0.0, 0.0, -1.0, -1.0, 3.0])
    return (np.concatenate([y, axes_y]).astype(np.float32),
            np.concatenate([x, axes_x]).astype(np.float32))


@pytest.mark.parametrize("fn", ["atan2", "asin"])
def test_kernel_math_matches_jax(fn):
    """Same polynomial and coefficients: agreement to ~1 ulp of pi; and
    within the polynomial's ~1e-5 rad of the exact function."""
    if fn == "atan2":
        y, x = _atan2_points()
        want = np.asarray(JK.atan2(jnp.asarray(y), jnp.asarray(x)))
        got = TK.atan2(torch.as_tensor(y), torch.as_tensor(x)).numpy()
        exact = np.arctan2(y.astype(np.float64), x.astype(np.float64))
        # quadrant sanity: every quadrant is represented
        assert {(s1, s2) for s1, s2 in zip(y[:72] > 0, x[:72] > 0)} == {
            (True, True), (True, False), (False, True), (False, False)}
    else:
        x = np.concatenate([np.linspace(-1, 1, 41), [-1.5, 1.5]]).astype(np.float32)
        want = np.asarray(getattr(JK, fn)(jnp.asarray(x)))
        got = getattr(TK, fn)(torch.as_tensor(x)).numpy()
        exact = np.arcsin(np.clip(x, -1, 1).astype(np.float64))
    np.testing.assert_allclose(got, want, atol=5e-7, rtol=0)
    np.testing.assert_allclose(got, exact, atol=3e-5, rtol=0)


def test_ops_names_are_jax_counterparts():
    """The port exports every op of the JAX package's ``ops``, and each op it
    exports has a JAX counterpart of the same name; ``cross`` is the port's
    own helper."""
    names = [n for n in dir(T) if not n.startswith("_") and n != "cross"]
    for name in names:
        assert hasattr(J, name), name
    for name in (n for n in dir(J) if not n.startswith("_")):
        assert hasattr(T, name), name
