// The substep's device code, shared by the serving window
// (soa_window.cu) and the training interval kernels (soa_interval.cu):
// vector/quaternion helpers, the polynomial atan2/asin, the packed constant
// layout, the PD + limit law and one substep (penalty contacts, the
// FIXED/REVOLUTE/COMPOUND joint law with attachment springs, symplectic
// Euler; ppr_diffphys_tpu/sim/pallas_soa.py:201-227, :736-944).
//
// One thread runs one env; every per-body quantity lives in that thread's
// EnvState. Env is the innermost dimension of every global array.

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

struct Args {
  const float* __restrict__ bq0;     // (7, B, E)
  const float* __restrict__ bqd0;    // (6, B, E)
  const float* __restrict__ tgt;     // (S, n_qd, E)
  const float* __restrict__ act;     // (S, n_qd, E) or null (zero)
  const float* __restrict__ res;     // (S, 6, B, E) torque,force rows, or null (zero)
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
  float* __restrict__ out_q;    // (F, 7, B, E)
  float* __restrict__ out_qd;   // (F, 6, B, E)
  float* __restrict__ out_grf;  // (F, 6, B, E)
  float* __restrict__ out_jaf;  // (F, 6, B, E)
  int E, B, n_qd, C, F, sub;
  float dt, ang_decay, gx, gy, gz, attach_ke, attach_kd;
};

__device__ __forceinline__ float plane(const float* p, int pe, int row, int b,
                                       int e, int B, int E) {
  return pe ? p[((size_t)row * B + b) * E + e] : p[(size_t)row * B + b];
}

struct EnvState {
  float q[MAX_BODIES][7];
  float qd[MAX_BODIES][6];
  float ft[MAX_BODIES][3];   // torque accumulator
  float ff[MAX_BODIES][3];   // force accumulator
  float grf[MAX_BODIES][6];  // post-contact snapshot (observable substeps)
};

__device__ __forceinline__ Q4 getq(const EnvState& s, int b) {
  return {s.q[b][3], s.q[b][4], s.q[b][5], s.q[b][6]};
}
__device__ __forceinline__ V3 gett(const EnvState& s, int b) {
  return {s.q[b][0], s.q[b][1], s.q[b][2]};
}
__device__ __forceinline__ V3 getw(const EnvState& s, int b) {
  return {s.qd[b][0], s.qd[b][1], s.qd[b][2]};
}
__device__ __forceinline__ V3 getv(const EnvState& s, int b) {
  return {s.qd[b][3], s.qd[b][4], s.qd[b][5]};
}
__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ Q4 ld4(const float* p) { return {p[0], p[1], p[2], p[3]}; }

// PD + limit law of one dof (pallas_soa.py:795-806).
__device__ __forceinline__ float joint_force(const Args& a, const float* bf,
                                             const int* bi, int k, int b, int e,
                                             size_t srow, float q, float qd) {
  float lo = bf[20 + k], hi = bf[23 + k], lke = bf[26 + k], lkd = bf[29 + k];
  float ke = plane(a.gains, a.gains_pe, k, b, e, a.B, a.E);
  float kd = plane(a.gains, a.gains_pe, 3 + k, b, e, a.B, a.E);
  int dof = bi[2 + k];
  float tg = a.tgt[(srow + dof) * a.E + e];
  float ac = a.act ? a.act[(srow + dof) * a.E + e] : 0.0f;
  float limit_f = 0.0f;
  if (q < lo) limit_f = lke * (lo - q) - lkd * fminf(qd, 0.0f);
  if (q > hi) limit_f = lke * (hi - q) - lkd * fmaxf(qd, 0.0f);
  return ke * (q - tg) + kd * qd + ac - limit_f;
}

// One substep of env e using input row s. With `obs`, writes the grf/jaf
// observables into frame row `frame`. With `integrate` false, only the
// forces are evaluated into st.ft/st.ff (the final-row observables, and the
// backward's recompute).
__device__ void substep(const Args& a, EnvState& st, int e, int s, bool obs,
                        int frame, bool integrate) {
  const int B = a.B, E = a.E;
  // accumulators start at the residual body forces (zero without them)
  for (int b = 0; b < B; ++b) {
    for (int k = 0; k < 3; ++k) {
      st.ft[b][k] = a.res ? a.res[(((size_t)s * 6 + k) * B + b) * E + e] : 0.0f;
      st.ff[b][k] = a.res ? a.res[(((size_t)s * 6 + 3 + k) * B + b) * E + e] : 0.0f;
    }
  }

  // ---- penalty ground contacts (pallas_soa.py:201-227), summed per body
  // in contact order with the sign of warp's atomic_sub
  for (int c = 0; c < a.C; ++c) {
    const int b = a.cbody[c];
    const float* cf = a.cf + (size_t)c * CONTACT_F;
    const float* bf = a.body_f + (size_t)b * BODY_F;
    Q4 qb = getq(st, b);
    V3 tb = gett(st, b), wb = getw(st, b), vb = getv(st, b);
    V3 com_w = add(tb, qrot(qb, ld3(bf + 14)));
    V3 cp = add(qrot(qb, ld3(cf)), tb);
    cp.y = cp.y - cf[3];
    V3 r = sub(cp, com_w);
    V3 dpdt = add(vb, cross(wb, r));
    float cy = cp.y;
    float active = cy < 0.0f ? 1.0f : 0.0f;
    float vn = dpdt.y;
    V3 vt = {dpdt.x, dpdt.y - vn, dpdt.z};
    float fn = cy * cf[4];
    float fd = fminf(vn, 0.0f) * cf[5];
    float vt_len = sqrtf(dot(vt, vt) + 1e-12f);
    float ft_mag = fminf(cf[6] * vt_len, -cf[7] * (fn + fd));
    V3 ftan = scale(vt, ft_mag / vt_len);
    V3 f = {ftan.x, (fn + fd) + ftan.y, ftan.z};
    f = {clampf(f.x * active, -500.0f, 500.0f), clampf(f.y * active, -500.0f, 500.0f),
         clampf(f.z * active, -500.0f, 500.0f)};
    V3 t = cross(r, f);
    st.ft[b][0] -= t.x; st.ft[b][1] -= t.y; st.ft[b][2] -= t.z;
    st.ff[b][0] -= f.x; st.ff[b][1] -= f.y; st.ff[b][2] -= f.z;
  }
  if (obs) {
    for (int b = 0; b < B; ++b) {
      for (int k = 0; k < 3; ++k) {
        st.grf[b][k] = st.ft[b][k];
        st.grf[b][3 + k] = st.ff[b][k];
      }
    }
  }

  // ---- joints (pallas_soa.py:760-903)
  const size_t srow = (size_t)s * a.n_qd;
  for (int b = 0; b < B; ++b) {
    const int* bi = a.body_i + (size_t)b * BODY_I;
    const float* bf = a.body_f + (size_t)b * BODY_F;
    const int jt = bi[1];
    if (jt != JOINT_FIXED && jt != JOINT_REVOLUTE && jt != JOINT_COMPOUND) continue;
    const int p = bi[0];
    const bool hp = p >= 0;

    Q4 q_c = getq(st, b);
    V3 t_c = gett(st, b), w_c = getw(st, b), v_c = getv(st, b);
    Q4 xpq = ld4(bf + 6);
    V3 xpt = ld3(bf + 3);
    Q4 X_wp_q = xpq;
    V3 X_wp_t = xpt, w_p = {0.f, 0.f, 0.f}, v_p = {0.f, 0.f, 0.f}, r_p = {0.f, 0.f, 0.f};
    if (hp) {
      Q4 pq = getq(st, p);
      X_wp_q = qmul(pq, xpq);
      X_wp_t = add(gett(st, p), qrot(pq, xpt));
      w_p = getw(st, p);
      v_p = getv(st, p);
      r_p = qrot(pq, ld3(bf + 17));
    }
    V3 r_c = scale(qrot(q_c, ld3(bf + 14)), -1.0f);
    V3 x_err = sub(t_c, X_wp_t);
    Q4 r_err = qmul(qinv(X_wp_q), q_c);
    V3 v_err = sub(v_c, v_p);
    V3 w_err = sub(w_c, w_p);
    const float ke_a = a.attach_ke, kd_a = a.attach_kd;

    V3 tt, fj;
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
      float fmag = joint_force(a, bf, bi, 0, b, e, srow, q_ang, qd_ang);
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
        float fmag = joint_force(a, bf, bi, k, b, e, srow, ang[k], dot(ax_w, w_err));
        tc = add(tc, scale(ax_w, fmag));
      }
      tt = clamp3(tc, 10000.0f);
      fj = clamp3(attach, 10000.0f);
    }

    // scatter: child -= (t + r_c x f, f); parent += (t + r_p x f, f)
    V3 child_t = add(tt, cross(r_c, fj));
    st.ft[b][0] -= child_t.x; st.ft[b][1] -= child_t.y; st.ft[b][2] -= child_t.z;
    st.ff[b][0] -= fj.x; st.ff[b][1] -= fj.y; st.ff[b][2] -= fj.z;
    if (hp) {
      V3 parent_t = add(tt, cross(r_p, fj));
      st.ft[p][0] += parent_t.x; st.ft[p][1] += parent_t.y; st.ft[p][2] += parent_t.z;
      st.ff[p][0] += fj.x; st.ff[p][1] += fj.y; st.ff[p][2] += fj.z;
    }
  }

  if (obs) {
    const size_t fo = (size_t)frame * 6;
    for (int b = 0; b < B; ++b) {
      for (int k = 0; k < 3; ++k) {
        a.out_grf[((fo + k) * B + b) * E + e] = st.grf[b][k];
        a.out_grf[((fo + 3 + k) * B + b) * E + e] = st.grf[b][3 + k];
        a.out_jaf[((fo + k) * B + b) * E + e] = st.ft[b][k] - st.grf[b][k];
        a.out_jaf[((fo + 3 + k) * B + b) * E + e] = st.ff[b][k] - st.grf[b][3 + k];
      }
    }
  }
  if (!integrate) return;

  // ---- symplectic Euler (pallas_soa.py:909-944)
  for (int b = 0; b < B; ++b) {
    const float* bf = a.body_f + (size_t)b * BODY_F;
    Q4 q_c = getq(st, b);
    V3 t_c = gett(st, b), w_c = getw(st, b), v_c = getv(st, b);
    V3 comc = ld3(bf + 14);
    V3 tq = {st.ft[b][0], st.ft[b][1], st.ft[b][2]};
    V3 fo = {st.ff[b][0], st.ff[b][1], st.ff[b][2]};
    float inv_m = plane(a.inv_m, a.inv_m_pe, 0, b, e, B, E);
    float I[9], Ii[9];
    for (int k = 0; k < 9; ++k) {
      I[k] = plane(a.inertia, a.inertia_pe, k, b, e, B, E);
      Ii[k] = plane(a.inv_inertia, a.inv_inertia_pe, k, b, e, B, E);
    }
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
    V3 new_t = sub(x1, qrot(r1, comc));

    st.q[b][0] = new_t.x; st.q[b][1] = new_t.y; st.q[b][2] = new_t.z;
    st.q[b][3] = r1.x; st.q[b][4] = r1.y; st.q[b][5] = r1.z; st.q[b][6] = r1.w;
    st.qd[b][0] = w1.x; st.qd[b][1] = w1.y; st.qd[b][2] = w1.z;
    st.qd[b][3] = v1.x; st.qd[b][4] = v1.y; st.qd[b][5] = v1.z;
  }
}

}  // namespace
