// The substep's device code, shared by every kernel of the port:
// vector/quaternion helpers, the polynomial atan2/asin, the packed constant
// layout, and the substep's units (ppr_diffphys_tpu/sim/pallas_soa.py:
// 201-227, :736-944): one contact's penalty wrench, one joint's
// FIXED/REVOLUTE/COMPOUND law with attachment springs and its PD + limit
// law, one body's symplectic Euler step.
//
// substep_warp.cuh runs these units one warp per env, with lanes over
// bodies, contacts and joints, for all four kernels (K1-K4).

#pragma once

#include <cuda_runtime.h>

#define MAX_BODIES 32
#define BODY_I 5       // parent, joint type, dof0, dof1, dof2
#define BODY_F 32      // axis3 xp_t3 xp_q4 xc_q4 com3 rp_local3 lo3 hi3 lke3 lkd3
#define CONTACT_F 8    // point3 dist ke kd kf mu

#define JOINT_REVOLUTE 1
#define JOINT_FIXED 3
#define JOINT_COMPOUND 4

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kAngDamp = 0.01f;
constexpr float kSinLimit = 0.99999988f;  // f32(1 - 1e-7)

struct V3 { float x, y, z; };
struct Q4 { float x, y, z, w; };

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ V3 clamp3(V3 a, float lim) {
  return {clampf(a.x, -lim, lim), clampf(a.y, -lim, lim), clampf(a.z, -lim, lim)};
}

__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  return {a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
          a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z};
}
__device__ __forceinline__ Q4 qinv(Q4 q) { return {-q.x, -q.y, -q.z, q.w}; }
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  V3 u = {q.x, q.y, q.z};
  V3 uv = cross(u, v);
  V3 uuv = cross(u, uv);
  return {v.x + 2.0f * (q.w * uv.x + uuv.x),
          v.y + 2.0f * (q.w * uv.y + uuv.y),
          v.z + 2.0f * (q.w * uv.z + uuv.z)};
}
__device__ __forceinline__ V3 qrot_inv(Q4 q, V3 v) { return qrot(qinv(q), v); }

// Polynomial atan2/asin of ppr_diffphys_tpu/ops/kernel_math.py (same
// coefficients), shared with the plain PyTorch version.
__device__ __forceinline__ float katan2(float y, float x) {
  float ax = fabsf(x), ay = fabsf(y);
  float big = fmaxf(ax, ay), small = fminf(ax, ay);
  float t = small / fmaxf(big, 1e-30f);
  float s = t * t;
  float a = t * (0.99997726f + s * (-0.33262347f + s * (0.19354346f +
                 s * (-0.11643287f + s * (0.05265332f + s * -0.01172120f)))));
  if (ay > ax) a = kHalfPi - a;
  if (x < 0.0f) a = kPi - a;
  if (y < 0.0f) a = -a;
  return a;
}
__device__ __forceinline__ float kasin(float x) {
  x = clampf(x, -1.0f, 1.0f);
  return katan2(x, sqrtf(fmaxf(1.0f - x * x, 1e-30f)));
}

// A launch's inputs and outputs. The state and the targets come in two
// layouts: the caller's, env outermost (the window K1 and the bench
// rollout K4), and env innermost (the interval kernels K2 and K3).
struct Args {
  const float* __restrict__ bq0;     // (E, B, 7) K1/K4, (7, B, E) K2
  const float* __restrict__ bqd0;    // (E, B, 6) K1/K4, (6, B, E) K2
  const float* __restrict__ tgt;     // (S, E, n_qd) K1/K4, (S, n_qd, E) K2/K3
  const float* __restrict__ act;     // as tgt, or null (zero)
  const float* __restrict__ res;     // (S, 6, B, E) torque,force rows (K2/K3), or null (zero)
  const int* __restrict__ body_i;    // (B, BODY_I)
  const float* __restrict__ body_f;  // (B, BODY_F)
  const int* __restrict__ cbody;     // (C,) body-sorted
  const float* __restrict__ cf;      // (C, CONTACT_F)
  // parameter planes, env-innermost: (rows, B, L) with L = E when the
  // matching *_pe flag is set (per-env params) else 1 (shared)
  const float* __restrict__ gains;        // (2*3, B, L) ke rows 0-2, kd rows 3-5
  const float* __restrict__ inv_m;        // (1, B, L)
  const float* __restrict__ inertia;      // (9, B, L)
  const float* __restrict__ inv_inertia;  // (9, B, L)
  int gains_pe, inv_m_pe, inertia_pe, inv_inertia_pe;
  // live joint anchors (K2/K3 with_xp; null: body_f's columns): the joint
  // whose child is body b has its parent anchor xp_t (3, B, L), xp_q
  // (4, B, L) and rp_local = xp_t - com_parent (3, B, L); L = E when xp_pe
  const float* __restrict__ xp_t;
  const float* __restrict__ xp_q;
  const float* __restrict__ rp_local;
  int xp_pe;
  float* __restrict__ out_q;    // (F, E, B, 7) K1, (E, B, 7) K4, (7, B, E) K2
  float* __restrict__ out_qd;   // (F, E, B, 6) K1, (E, B, 6) K4, (6, B, E) K2
  float* __restrict__ out_grf;  // (F, E, B, 6) K1
  float* __restrict__ out_jaf;  // (F, E, B, 6) K1
  int E, B, n_qd, C, F, sub;    // F frames of sub substeps: K1
  float dt, ang_decay, gx, gy, gz, attach_ke, attach_kd;
};

__device__ __forceinline__ float plane(const float* p, int pe, int row, int b,
                                       int e, int B, int E) {
  return pe ? p[((size_t)row * B + b) * E + e] : p[(size_t)row * B + b];
}

// One body's state: orientation, origin, angular and linear velocity.
struct Body {
  Q4 q;
  V3 t, w, v;
};

// A joint's parent anchor: translation and rotation in the parent's frame,
// and the arm from the parent's centre of mass (xp_t - com_parent).
struct Anchor {
  V3 xpt;
  Q4 xpq;
  V3 rpl;
};

__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ Q4 ld4(const float* p) { return {p[0], p[1], p[2], p[3]}; }

// ---- the substep's units ----------------------------------------------------
// One contact, one joint, one body's integration; the warp substep
// (substep_warp.cuh) calls them per lane and sums their results per body in
// a fixed order.

// PD + limit law of one dof (pallas_soa.py:795-806), with the dof's gains
// ke/kd, target tg and activation ac.
__device__ __forceinline__ float joint_force(const float* bf, int k, float ke, float kd,
                                             float tg, float ac, float q, float qd) {
  float lo = bf[20 + k], hi = bf[23 + k], lke = bf[26 + k], lkd = bf[29 + k];
  float limit_f = 0.0f;
  if (q < lo) limit_f = lke * (lo - q) - lkd * fminf(qd, 0.0f);
  if (q > hi) limit_f = lke * (hi - q) - lkd * fmaxf(qd, 0.0f);
  return ke * (q - tg) + kd * qd + ac - limit_f;
}

// Penalty ground contact (pallas_soa.py:201-227) of a point (cf) on a body
// with state bd and centre of mass com: its body's torque and force totals
// take -= t and -= f (the sign of warp's atomic_sub).
__device__ __forceinline__ void contact_wrench(const Body& bd, V3 com, const float* cf, V3& t,
                                               V3& f) {
  V3 com_w = add(bd.t, qrot(bd.q, com));
  V3 cp = add(qrot(bd.q, ld3(cf)), bd.t);
  cp.y = cp.y - cf[3];
  V3 r = sub(cp, com_w);
  V3 dpdt = add(bd.v, cross(bd.w, r));
  float cy = cp.y;
  float active = cy < 0.0f ? 1.0f : 0.0f;
  float vn = dpdt.y;
  V3 vt = {dpdt.x, dpdt.y - vn, dpdt.z};
  float fn = cy * cf[4];
  float fd = fminf(vn, 0.0f) * cf[5];
  float vt_len = sqrtf(dot(vt, vt) + 1e-12f);
  float ft_mag = fminf(cf[6] * vt_len, -cf[7] * (fn + fd));
  V3 ftan = scale(vt, ft_mag / vt_len);
  f = {ftan.x, (fn + fd) + ftan.y, ftan.z};
  f = {clampf(f.x * active, -500.0f, 500.0f), clampf(f.y * active, -500.0f, 500.0f),
       clampf(f.z * active, -500.0f, 500.0f)};
  t = cross(r, f);
}

// The joint law (pallas_soa.py:760-903) of a body's joint of type jt, with
// the child's state c, the parent's state pb (read only when hp), the
// joint's parent anchor `an` and the body's packed constants bf. `d` gives
// dof k's gains, target and activation: d.ke(k), d.kd(k), d.tg(k), d.ac(k). The child's totals take
// -= (child_t, fj), the parent's += (parent_t, fj) (parent_t set when hp).
template <class Drive>
__device__ __forceinline__ void joint_wrench(const Args& a, int jt, bool hp, const Body& c,
                                             const Body& pb, const Anchor& an, const float* bf,
                                             const Drive& d, V3& child_t, V3& parent_t, V3& fj) {
  Q4 q_c = c.q;
  V3 t_c = c.t, w_c = c.w, v_c = c.v;
  Q4 xpq = an.xpq;
  V3 xpt = an.xpt;
  Q4 X_wp_q = xpq;
  V3 X_wp_t = xpt, w_p = {0.f, 0.f, 0.f}, v_p = {0.f, 0.f, 0.f}, r_p = {0.f, 0.f, 0.f};
  if (hp) {
    Q4 pq = pb.q;
    X_wp_q = qmul(pq, xpq);
    X_wp_t = add(pb.t, qrot(pq, xpt));
    w_p = pb.w;
    v_p = pb.v;
    r_p = qrot(pq, an.rpl);
  }
  V3 r_c = scale(qrot(q_c, ld3(bf + 14)), -1.0f);
  V3 x_err = sub(t_c, X_wp_t);
  Q4 r_err = qmul(qinv(X_wp_q), q_c);
  V3 v_err = sub(v_c, v_p);
  V3 w_err = sub(w_c, w_p);
  const float ke_a = a.attach_ke, kd_a = a.attach_kd;

  V3 tt;
  V3 attach = add(scale(x_err, ke_a), scale(v_err, kd_a));
  if (jt == JOINT_FIXED) {
    // Taylor-safe axis-angle of r_err
    V3 rv = {r_err.x, r_err.y, r_err.z};
    float sq = dot(rv, rv);
    bool is_zero = sq < 1e-12f;
    float norms = is_zero ? 0.0f : sqrtf(sq);
    float half = katan2(norms, r_err.w);
    float ang = 2.0f * half;
    bool small = fabsf(ang) < 1e-6f;
    float sho = small ? 0.5f - ang * ang / 48.0f : sinf(half) / ang;
    V3 ang_err = {rv.x / sho, rv.y / sho, rv.z / sho};
    V3 tf = qrot(X_wp_q, ang_err);
    fj = attach;
    tt = {tf.x * ke_a + w_err.x * kd_a * kAngDamp,
          tf.y * ke_a + w_err.y * kd_a * kAngDamp,
          tf.z * ke_a + w_err.z * kd_a * kAngDamp};
  } else if (jt == JOINT_REVOLUTE) {
    V3 axis = ld3(bf);
    V3 axis_p = qrot(X_wp_q, axis);
    V3 axis_cw = qrot(q_c, axis);
    float s_tw = r_err.x * axis.x + r_err.y * axis.y + r_err.z * axis.z;
    float q_ang = 2.0f * katan2(s_tw, r_err.w);
    float qd_ang = dot(w_err, axis_p);
    float fmag = joint_force(bf, 0, d.ke(0), d.kd(0), d.tg(0), d.ac(0), q_ang, qd_ang);
    V3 swing = cross(axis_p, axis_cw);
    fj = attach;
    tt = {axis_p.x * fmag + swing.x * ke_a + (w_err.x - qd_ang * axis_p.x) * kd_a * kAngDamp,
          axis_p.y * fmag + swing.y * ke_a + (w_err.y - qd_ang * axis_p.y) * kd_a * kAngDamp,
          axis_p.z * fmag + swing.z * ke_a + (w_err.z - qd_ang * axis_p.z) * kd_a * kAngDamp};
  } else {  // JOINT_COMPOUND: intrinsic-XYZ split
    Q4 qoff = ld4(bf + 10);
    Q4 q_pc = qmul(qmul(qinv(qoff), r_err), qoff);
    float x = q_pc.x, y = q_pc.y, z = q_pc.z, w = q_pc.w;
    float m12 = 2.0f * (y * z - w * x);
    float m22 = 1.0f - 2.0f * (x * x + y * y);
    float m02 = 2.0f * (x * z + w * y);
    float m01 = 2.0f * (x * y - w * z);
    float m00 = 1.0f - 2.0f * (y * y + z * z);
    float ang[3];
    ang[0] = katan2(-m12, m22);
    ang[1] = kasin(clampf(m02, -kSinLimit, kSinLimit));
    ang[2] = katan2(-m01, m00);
    Q4 q0 = {sinf(0.5f * ang[0]), 0.0f, 0.0f, cosf(0.5f * ang[0])};
    V3 ax[3];
    ax[0] = {1.0f, 0.0f, 0.0f};
    ax[1] = qrot(q0, {0.0f, 1.0f, 0.0f});
    float sb = sinf(0.5f * ang[1]), cb = cosf(0.5f * ang[1]);
    Q4 q1 = {ax[1].x * sb, ax[1].y * sb, ax[1].z * sb, cb};
    ax[2] = qrot(qmul(q1, q0), {0.0f, 0.0f, 1.0f});
    Q4 q_w = qmul(X_wp_q, qoff);
    V3 tc = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < 3; ++k) {
      V3 ax_w = qrot(q_w, ax[k]);
      float fmag = joint_force(bf, k, d.ke(k), d.kd(k), d.tg(k), d.ac(k), ang[k],
                               dot(ax_w, w_err));
      tc = add(tc, scale(ax_w, fmag));
    }
    tt = clamp3(tc, 10000.0f);
    fj = clamp3(attach, 10000.0f);
  }

  // scatter: child -= (t + r_c x f, f); parent += (t + r_p x f, f)
  child_t = add(tt, cross(r_c, fj));
  if (hp) parent_t = add(tt, cross(r_p, fj));
}

// Symplectic Euler (pallas_soa.py:909-944) of a body with state s (updated
// in place), torque and force totals tq and fo, centre of mass comc and
// parameters inv_m, I, Ii (row-major 3x3).
__device__ __forceinline__ void integrate_body(const Args& a, Body& s, V3 tq, V3 fo, V3 comc,
                                               float inv_m, const float* I, const float* Ii) {
  Q4 q_c = s.q;
  V3 t_c = s.t, w_c = s.w, v_c = s.v;
  V3 x_com = add(t_c, qrot(q_c, comc));
  V3 v1 = {v_c.x + (fo.x * inv_m + a.gx) * a.dt,
           v_c.y + (fo.y * inv_m + a.gy) * a.dt,
           v_c.z + (fo.z * inv_m + a.gz) * a.dt};
  V3 x1 = add(x_com, scale(v1, a.dt));

  V3 wb = qrot_inv(q_c, w_c);
  V3 tb = qrot_inv(q_c, tq);
  V3 Iw = {I[0] * wb.x + I[1] * wb.y + I[2] * wb.z,
           I[3] * wb.x + I[4] * wb.y + I[5] * wb.z,
           I[6] * wb.x + I[7] * wb.y + I[8] * wb.z};
  tb = sub(tb, cross(wb, Iw));
  V3 It = {Ii[0] * tb.x + Ii[1] * tb.y + Ii[2] * tb.z,
           Ii[3] * tb.x + Ii[4] * tb.y + Ii[5] * tb.z,
           Ii[6] * tb.x + Ii[7] * tb.y + Ii[8] * tb.z};
  V3 w1 = qrot(q_c, add(wb, scale(It, a.dt)));
  // dr = 0.5*dt*quat(w1,0)*r0 with the pre-damping w1
  Q4 dq = qmul({w1.x, w1.y, w1.z, 0.0f}, q_c);
  const float hdt = 0.5f * a.dt;
  Q4 r1 = {q_c.x + hdt * dq.x, q_c.y + hdt * dq.y, q_c.z + hdt * dq.z,
           q_c.w + hdt * dq.w};
  float n2 = r1.x * r1.x + r1.y * r1.y + r1.z * r1.z + r1.w * r1.w;
  float inv = 1.0f / sqrtf(fmaxf(n2, 1e-18f));
  r1 = {r1.x * inv, r1.y * inv, r1.z * inv, r1.w * inv};
  w1 = clamp3(scale(w1, a.ang_decay), 10.0f);
  v1 = clamp3(v1, 10.0f);
  s.t = sub(x1, qrot(r1, comc));
  s.q = r1;
  s.w = w1;
  s.v = v1;
}

}  // namespace
