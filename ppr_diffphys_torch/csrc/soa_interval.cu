// Training interval kernels: one frame interval of S substeps per env,
// forward (K2) and backward (K3), for the differentiable rollout.
//
// Replaces the TPU kernels of ppr_diffphys_tpu/sim/pallas_soa_grad.py:
// make_diff_interval, forward `fwd_call` (:453-481, kernel :211-252,
// pallas_call :473) and backward `bwd_call` (:483-535, kernel :255-407,
// pallas_call :526), the pair under its custom_vjp (:537-565).
//
// - K2 `soa_interval_fwd` runs the S substeps on (bq, bqd), with optional
//   acts and residual forces and shared or per-env planes. When the caller
//   needs gradients it also writes the state entering each substep to an
//   (S, E, 13, B) buffer (the TPU kernel's `with_sr` export, there
//   (S, 19, B, E)); a primal-only call passes no buffer and writes nothing
//   there.
// - K3 `soa_interval_bwd` sweeps j = S-1 .. 0: it reads the state entering
//   substep j, recomputes that substep's contact and joint forces, and
//   applies the hand-derived adjoint of integrate -> joints -> contacts (the
//   TPU kernel gets it from an in-kernel jax.vjp). It writes d(state0),
//   dtgt[j] (+ dact[j], dres[j]) and per-env partial gradients of the 25
//   parameter-plane rows per body (35 with live joint anchors).
// - `with_xp` (pallas_soa_grad.py:90-161, `tr_names = TRACED_NAMES +
//   XP_NAMES`): both kernels take each joint's parent anchor as three more
//   planes, xp_t (3 rows), xp_q (4) and rp_local (3), lane 1 or lane E, in
//   place of body_f's constant columns: the lab4d coupling's per-env
//   anchors. The warp copies them into its shared plane rows once per
//   launch with the other planes; the joint sweep reads them there. K3 adds
//   their cotangents (of the parent transform X_wp = X_p * X_pj and of the
//   arm r_p = R_p rp_local) into the same shared gradient rows and writes
//   them out as per-env partials beside the other 25 rows; shared anchors
//   go through the env reduction. Without anchors (a null xp_t) the
//   kernels read body_f and compute exactly what they did before.
// - `soa_interval_reduce` sums those partials over envs for the shared
//   (lane-1) planes in a fixed order: deterministic, no atomics. The TPU
//   kernel does this sum in its own body (pallas_soa_grad.py:399-407).
//
// Ties at kinks (min/max/clamp at equality, |x| at 0) are measure-zero:
// clamps pass the gradient on the closed range, fminf(a, b) sends it to a
// when a < b and to b otherwise, |x| has derivative sign(x) with sign(0)=0.
//
// What bounds them on an H100: operations (~10^4 fp32 operations per
// env-substep forward, ~3x that backward, on ~10^2 bytes per substep of
// targets and exported state). Both run one warp per env on the warp
// substep of substep_warp.cuh, 1-8 consecutive envs per CTA
// (sim/soa.py:envs_per_cta): 128 CTAs of 4 warps at 512 envs, 512 of 8 at
// 4096.
// - K2 is the bench rollout K4's loop on env-innermost arrays: lane l
//   integrates body l, evaluates the joint whose child is body l and
//   contacts l, l+32, ... Each body's lane starts its totals at its
//   residual forces of the substep, which come with the targets/acts
//   through a cp.async double buffer. At each substep's start the warp
//   copies its shared mirror of the body states, whose [k][b] order is the
//   export's, into the export as one contiguous run of 13 x B floats (env
//   innermost there cost K2 +62 % of device time at 4096 envs, scattered
//   4-byte stores; this layout +9 %). Without residual forces its final
//   state equals K4's bit for bit.
// - K3 recomputes body l's forces with the same warp force pass, then runs
//   the adjoint of body l's integration, of the joint whose child is body l
//   and of contacts l, l+32, ... Each writes its cotangent contributions
//   into shared-memory slots; body l's lane sums its d(state) in a fixed
//   order: integration, then the joints j = 0..B-1 that touch it, then its
//   contacts in contact order.
// - K3 fetches the state entering substep j-1 (one contiguous run of the
//   export) and its targets/acts with cp.async into a shared double buffer
//   while substep j is computed.
// - The reduction takes one warp per plane row: lane l sums envs l, l+32,
//   ... in ascending order and a fixed butterfly of shuffles combines the
//   32 partials.

#include "substep_warp.cuh"

namespace {

struct BwdArgs {
  const float* __restrict__ sstate;  // (S, E, 13, B) state entering each substep
  const float* __restrict__ dq;      // (7, B, E) cotangent of the final bq
  const float* __restrict__ dqd;     // (6, B, E)
  float* __restrict__ dbq0;          // (7, B, E)
  float* __restrict__ dbqd0;         // (6, B, E)
  float* __restrict__ dtgt;          // (S, n_qd, E)
  float* __restrict__ dact;          // (S, n_qd, E) or null
  float* __restrict__ dres;          // (S, 6, B, E) or null
  float* __restrict__ dplanes;       // (N_PLANE_ROWS[_XP], B, E) per-env partials
  int S;
};

// ---- adjoint helpers: each adds the cotangents of its inputs ------------
__device__ __forceinline__ void acc(V3& a, V3 b) { a.x += b.x; a.y += b.y; a.z += b.z; }
__device__ __forceinline__ void acc(Q4& a, Q4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot4(Q4 a, Q4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float sgnf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
// cotangent through clampf(x, -lim, lim), per component
__device__ __forceinline__ V3 gate3(V3 g, V3 x, float lim) {
  return {(x.x >= -lim && x.x <= lim) ? g.x : 0.0f,
          (x.y >= -lim && x.y <= lim) ? g.y : 0.0f,
          (x.z >= -lim && x.z <= lim) ? g.z : 0.0f};
}

// c = cross(a, b): da += b x g, db += g x a
__device__ __forceinline__ void cross_adj(V3 a, V3 b, V3 g, V3& da, V3& db) {
  acc(da, cross(b, g));
  acc(db, cross(g, a));
}

// out = a * b (Hamilton)
__device__ __forceinline__ void qmul_adj(Q4 a, Q4 b, Q4 g, Q4& da, Q4& db) {
  da.x += g.x * b.w - g.y * b.z + g.z * b.y - g.w * b.x;
  da.y += g.x * b.z + g.y * b.w - g.z * b.x - g.w * b.y;
  da.z += -g.x * b.y + g.y * b.x + g.z * b.w - g.w * b.z;
  da.w += g.x * b.x + g.y * b.y + g.z * b.z + g.w * b.w;
  db.x += g.x * a.w + g.y * a.z - g.z * a.y - g.w * a.x;
  db.y += -g.x * a.z + g.y * a.w + g.z * a.x - g.w * a.y;
  db.z += g.x * a.y - g.y * a.x + g.z * a.w - g.w * a.z;
  db.w += g.x * a.x + g.y * a.y + g.z * a.z + g.w * a.w;
}

// out = qrot(q, v) = v + 2 (w uv + u x uv), uv = u x v
__device__ __forceinline__ void qrot_adj(Q4 q, V3 v, V3 g, Q4& dq, V3& dv) {
  V3 u = {q.x, q.y, q.z};
  V3 uv = cross(u, v);
  acc(dv, g);
  dq.w += 2.0f * dot(g, uv);
  V3 g_uv = scale(g, 2.0f * q.w);
  V3 du = {0.0f, 0.0f, 0.0f};
  cross_adj(u, uv, scale(g, 2.0f), du, g_uv);
  cross_adj(u, v, g_uv, du, dv);
  dq.x += du.x; dq.y += du.y; dq.z += du.z;
}

__device__ __forceinline__ void qrot_inv_adj(Q4 q, V3 v, V3 g, Q4& dq, V3& dv) {
  Q4 dqi = {0.0f, 0.0f, 0.0f, 0.0f};
  qrot_adj(qinv(q), v, g, dqi, dv);
  dq.x -= dqi.x; dq.y -= dqi.y; dq.z -= dqi.z; dq.w += dqi.w;
}

// a = katan2(y, x)
__device__ __forceinline__ void katan2_adj(float y, float x, float g, float& dy, float& dx) {
  float ax = fabsf(x), ay = fabsf(y);
  float big = fmaxf(ax, ay), small = fminf(ax, ay);
  float bigc = fmaxf(big, 1e-30f);
  float t = small / bigc;
  float s = t * t;
  float P = 0.99997726f + s * (-0.33262347f + s * (0.19354346f +
            s * (-0.11643287f + s * (0.05265332f + s * -0.01172120f))));
  float dP = -0.33262347f + s * (2.0f * 0.19354346f + s * (3.0f * -0.11643287f +
             s * (4.0f * 0.05265332f + s * (5.0f * -0.01172120f))));
  float sg = g;
  if (ay > ax) sg = -sg;
  if (x < 0.0f) sg = -sg;
  if (y < 0.0f) sg = -sg;
  float gt = sg * (P + 2.0f * s * dP);
  float g_small = gt / bigc;
  float g_big = big > 1e-30f ? -gt * t / bigc : 0.0f;
  float gax, gay;
  if (ay > ax) { gay = g_big; gax = g_small; } else { gax = g_big; gay = g_small; }
  dx += gax * sgnf(x);
  dy += gay * sgnf(y);
}

// a = kasin(x)
__device__ __forceinline__ void kasin_adj(float x, float g, float& dx) {
  float xc = clampf(x, -1.0f, 1.0f);
  float r = 1.0f - xc * xc;
  float sr = sqrtf(fmaxf(r, 1e-30f));
  float gy = 0.0f, gs = 0.0f;
  katan2_adj(xc, sr, g, gy, gs);
  if (r > 1e-30f) gy += gs * (-xc) / sr;
  if (x >= -1.0f && x <= 1.0f) dx += gy;
}


// ---- the adjoint of one substep's units ------------------------------------

// d[k * stride] = (t, q, w, v)[k], k < 13
__device__ __forceinline__ void put_state(float* d, int stride, V3 t, Q4 q, V3 w, V3 v) {
  d[0] = t.x; d[stride] = t.y; d[2 * stride] = t.z;
  d[3 * stride] = q.x; d[4 * stride] = q.y; d[5 * stride] = q.z; d[6 * stride] = q.w;
  d[7 * stride] = w.x; d[8 * stride] = w.y; d[9 * stride] = w.z;
  d[10 * stride] = v.x; d[11 * stride] = v.y; d[12 * stride] = v.z;
}

__device__ __forceinline__ void add_state(float* d, V3 t, Q4 q, V3 w, V3 v) {
  d[0] += t.x; d[1] += t.y; d[2] += t.z;
  d[3] += q.x; d[4] += q.y; d[5] += q.z; d[6] += q.w;
  d[7] += w.x; d[8] += w.y; d[9] += w.z;
  d[10] += v.x; d[11] += v.y; d[12] += v.z;
}

// Where a joint's dof cotangents go: dtgt/dact of substep j and env e,
// dof d at [d * E] (dact null without acts).
struct DofOut {
  float* dtgt;
  float* dact;
  int E;
};

// joint_force (substep.cuh) of dof k, reversed: cotangent g of the dof
// force -> dq, dqd, the gains rows k and 3+k of dpl (row stride rs), and
// dtgt/dact of the dof.
__device__ __forceinline__ void joint_force_adj(const float* bf, const WarpDrive& d, int k,
                                                float q, float qd, float g, float& dq,
                                                float& dqd, float* dpl, int rs,
                                                const DofOut& o) {
  float lo = bf[20 + k], hi = bf[23 + k], lke = bf[26 + k], lkd = bf[29 + k];
  float ke = d.ke(k), kd = d.kd(k), tg = d.tg(k);
  int dof = d.bi[2 + k];
  dq += g * ke;
  dqd += g * kd;
  dpl[k * rs] += g * (q - tg);
  dpl[(3 + k) * rs] += g * qd;
  o.dtgt[(size_t)dof * o.E] -= g * ke;
  if (o.dact) o.dact[(size_t)dof * o.E] += g;
  // out = ... - limit_f; the `above` branch overrides `below`
  if (q > hi) {
    dq += g * lke;
    if (qd > 0.0f) dqd += g * lkd;
  } else if (q < lo) {
    dq += g * lke;
    if (qd < 0.0f) dqd += g * lkd;
  }
}

// Symplectic Euler of one body (state s, totals tq/fo), reversed: dn =
// cotangent of its new state -> dS (its entering state, added), dF (its
// torque/force totals) and its plane rows dpl[r * rs].
__device__ __forceinline__ void integrate_adj(const Args& a, const Body& s, V3 tq, V3 fo,
                                              V3 comc, float inv_m, const float* I,
                                              const float* Ii, const float* dn, float* dS,
                                              float* dF, float* dpl, int rs) {
  Q4 q_c = s.q;
  V3 w_c = s.w, v_c = s.v;
  // forward recompute
  V3 v1 = {v_c.x + (fo.x * inv_m + a.gx) * a.dt,
           v_c.y + (fo.y * inv_m + a.gy) * a.dt,
           v_c.z + (fo.z * inv_m + a.gz) * a.dt};
  V3 wb = qrot_inv(q_c, w_c);
  V3 tb0 = qrot_inv(q_c, tq);
  V3 Iw = {I[0] * wb.x + I[1] * wb.y + I[2] * wb.z,
           I[3] * wb.x + I[4] * wb.y + I[5] * wb.z,
           I[6] * wb.x + I[7] * wb.y + I[8] * wb.z};
  V3 tb = sub(tb0, cross(wb, Iw));
  V3 It = {Ii[0] * tb.x + Ii[1] * tb.y + Ii[2] * tb.z,
           Ii[3] * tb.x + Ii[4] * tb.y + Ii[5] * tb.z,
           Ii[6] * tb.x + Ii[7] * tb.y + Ii[8] * tb.z};
  V3 y = add(wb, scale(It, a.dt));
  V3 w1 = qrot(q_c, y);
  Q4 w1q = {w1.x, w1.y, w1.z, 0.0f};
  Q4 dq = qmul(w1q, q_c);
  const float hdt = 0.5f * a.dt;
  Q4 r1 = {q_c.x + hdt * dq.x, q_c.y + hdt * dq.y, q_c.z + hdt * dq.z, q_c.w + hdt * dq.w};
  float n2 = dot4(r1, r1);
  float inv = 1.0f / sqrtf(fmaxf(n2, 1e-18f));
  r1 = {r1.x * inv, r1.y * inv, r1.z * inv, r1.w * inv};
  V3 w1d = scale(w1, a.ang_decay);

  // reverse
  V3 g_t = {dn[0], dn[1], dn[2]};
  Q4 g_r1 = {dn[3], dn[4], dn[5], dn[6]};
  V3 g_w = {dn[7], dn[8], dn[9]};
  V3 g_v = {dn[10], dn[11], dn[12]};
  V3 dv = {0.0f, 0.0f, 0.0f};
  // new_t = x1 - qrot(r1, comc)
  V3 g_x1 = g_t;
  qrot_adj(r1, comc, neg(g_t), g_r1, dv);
  V3 g_v1 = gate3(g_v, v1, 10.0f);
  V3 g_w1 = scale(gate3(g_w, w1d, 10.0f), a.ang_decay);
  // r1 = r1u / |r1u|
  Q4 g_u;
  if (n2 > 1e-18f) {
    float d = dot4(g_r1, r1);
    g_u = {(g_r1.x - r1.x * d) * inv, (g_r1.y - r1.y * d) * inv,
           (g_r1.z - r1.z * d) * inv, (g_r1.w - r1.w * d) * inv};
  } else {
    g_u = {g_r1.x * inv, g_r1.y * inv, g_r1.z * inv, g_r1.w * inv};
  }
  // r1u = q_c + hdt * qmul(w1q, q_c)
  Q4 g_qc = g_u;
  Q4 g_dq = {g_u.x * hdt, g_u.y * hdt, g_u.z * hdt, g_u.w * hdt};
  Q4 g_w1q = {0.0f, 0.0f, 0.0f, 0.0f};
  qmul_adj(w1q, q_c, g_dq, g_w1q, g_qc);
  g_w1.x += g_w1q.x; g_w1.y += g_w1q.y; g_w1.z += g_w1q.z;
  // w1 = qrot(q_c, wb + It * dt)
  V3 g_y = {0.0f, 0.0f, 0.0f};
  qrot_adj(q_c, y, g_w1, g_qc, g_y);
  V3 g_wb = g_y;
  V3 g_It = scale(g_y, a.dt);
  // It = Ii tb
  float gIt[3] = {g_It.x, g_It.y, g_It.z}, tbv[3] = {tb.x, tb.y, tb.z};
  float gtb[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < 3; ++i) {
    for (int k = 0; k < 3; ++k) {
      dpl[(PR_INV_INERTIA + 3 * i + k) * rs] += gIt[i] * tbv[k];
      gtb[k] += Ii[3 * i + k] * gIt[i];
    }
  }
  V3 g_tb = {gtb[0], gtb[1], gtb[2]};
  // tb = tb0 - cross(wb, Iw)
  V3 g_Iw = {0.0f, 0.0f, 0.0f};
  cross_adj(wb, Iw, neg(g_tb), g_wb, g_Iw);
  // Iw = I wb
  float gIw[3] = {g_Iw.x, g_Iw.y, g_Iw.z}, wbv[3] = {wb.x, wb.y, wb.z};
  float gwb[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < 3; ++i) {
    for (int k = 0; k < 3; ++k) {
      dpl[(PR_INERTIA + 3 * i + k) * rs] += gIw[i] * wbv[k];
      gwb[k] += I[3 * i + k] * gIw[i];
    }
  }
  g_wb.x += gwb[0]; g_wb.y += gwb[1]; g_wb.z += gwb[2];
  // tb0 = qrot_inv(q_c, tq); wb = qrot_inv(q_c, w_c)
  V3 g_tq = {0.0f, 0.0f, 0.0f}, g_wc = {0.0f, 0.0f, 0.0f};
  qrot_inv_adj(q_c, tq, g_tb, g_qc, g_tq);
  qrot_inv_adj(q_c, w_c, g_wb, g_qc, g_wc);
  // x1 = x_com + v1 dt; v1 = v_c + (fo inv_m + g) dt
  V3 g_xcom = g_x1;
  acc(g_v1, scale(g_x1, a.dt));
  V3 g_fo = scale(g_v1, inv_m * a.dt);
  dpl[PR_INV_M * rs] += dot(g_v1, fo) * a.dt;
  // x_com = t_c + qrot(q_c, comc)
  qrot_adj(q_c, comc, g_xcom, g_qc, dv);
  add_state(dS, g_xcom, g_qc, g_wc, g_v1);
  dF[0] = g_tq.x; dF[1] = g_tq.y; dF[2] = g_tq.z;
  dF[3] = g_fo.x; dF[4] = g_fo.y; dF[5] = g_fo.z;
}

// Lanes fetch substep j's targets (and acts) of env e from (S,n_qd,E) into
// a row: tgt (n_qd), act. Not committed.
__device__ __forceinline__ void fetch_targets(Lane& L, const Args& a, int e, int j,
                                              float* row) {
  for (int d = L.lane; d < a.n_qd; d += 32) {
    const size_t g = ((size_t)j * a.n_qd + d) * a.E + e;
    cp_async4(row + d, a.tgt + g);
    if (a.act) cp_async4(row + a.n_qd + d, a.act + g);
  }
}

// ---- K2's per-lane phases ----------------------------------------------------

// Lanes fetch substep s's targets/acts into row and, with residual forces,
// body lane's six rows of them into rs [k][b] (each lane reads back only
// what it fetched itself).
__device__ __forceinline__ void fetch_fwd(Lane& L, const Args& a, int e, int s, float* row,
                                          float* rs) {
  fetch_targets(L, a, e, s, row);
  const int b = L.lane, B = a.B;
  if (a.res && b < B)
    for (int k = 0; k < 6; ++k)
      cp_async4(rs + k * B + b, a.res + (((size_t)s * 6 + k) * B + b) * a.E + e);
  cp_async_commit();
}

// Body lane's state of env e from (7,B,E)/(6,B,E) into its registers and
// the mirror.
__device__ __forceinline__ void load_state_inner(Lane& L, const Args& a, int e, float* mir) {
  const int b = L.lane, B = a.B;
  if (b >= B) return;
  const size_t r = (size_t)B * a.E;
  const float* q = a.bq0 + (size_t)b * a.E + e;
  const float* qd = a.bqd0 + (size_t)b * a.E + e;
  L.s = {{q[3 * r], q[4 * r], q[5 * r], q[6 * r]}, {q[0], q[r], q[2 * r]},
         {qd[0], qd[r], qd[2 * r]}, {qd[3 * r], qd[4 * r], qd[5 * r]}};
  mirror_put(mir, b, B, L.s);
}

// Entering substep s of S: export the state entering it (the mirror, whose
// [k][b] order is the export's), fetch substep s+1, wait for s;
// the totals start at the residual forces (zero without them).
__device__ __forceinline__ void enter_fwd(Lane& L, const Args& a, float* sstate, int e, int s,
                                          int S, const WarpMem& m) {
  const int B = a.B, RW = 2 * a.n_qd, RS = 6 * B;
  if (sstate)
    for (int i = L.lane; i < 13 * B; i += 32)
      sstate[((size_t)s * a.E + e) * 13 * B + i] = m.mir[i];
  if (s + 1 < S) fetch_fwd(L, a, e, s + 1, m.seq + ((s + 1) & 1) * RW, m.rs + ((s + 1) & 1) * RS);
  cp_async_wait(s + 1 < S ? 1 : 0);
  L.ft = {0.0f, 0.0f, 0.0f};
  L.ff = {0.0f, 0.0f, 0.0f};
  if (a.res && L.lane < B) {
    const float* r = m.rs + (s & 1) * RS + L.lane;
    L.ft = {r[0], r[B], r[2 * B]};
    L.ff = {r[3 * B], r[4 * B], r[5 * B]};
  }
}

// Body lane's final state into (7,B,E)/(6,B,E).
__device__ __forceinline__ void store_state_inner(const Lane& L, const Args& a, int e) {
  const int b = L.lane, B = a.B;
  if (b >= B) return;
  const size_t r = (size_t)B * a.E;
  float* q = a.out_q + (size_t)b * a.E + e;
  float* qd = a.out_qd + (size_t)b * a.E + e;
  q[0] = L.s.t.x; q[r] = L.s.t.y; q[2 * r] = L.s.t.z;
  q[3 * r] = L.s.q.x; q[4 * r] = L.s.q.y; q[5 * r] = L.s.q.z; q[6 * r] = L.s.q.w;
  qd[0] = L.s.w.x; qd[r] = L.s.w.y; qd[2 * r] = L.s.w.z;
  qd[3 * r] = L.s.v.x; qd[4 * r] = L.s.v.y; qd[5 * r] = L.s.v.z;
}

// ---- K3's per-lane phases ----------------------------------------------------

// Lanes fetch the state entering substep j (13 rows of the export) into a
// mirror [k][b] and its targets (and acts) into a row.
__device__ __forceinline__ void fetch_substep(Lane& L, const Args& a, const BwdArgs& w, int e,
                                              int j, float* mir, float* row) {
  const int B = a.B, E = a.E;
  for (int i = L.lane; i < 13 * B; i += 32)  // i = k * B + b: export (j, e, k, b)
    cp_async4(mir + i, w.sstate + ((size_t)j * E + e) * 13 * B + i);
  fetch_targets(L, a, e, j, row);
  cp_async_commit();
}

// Body lane's cotangent dn from (dq, dqd); its plane gradients start at 0.
__device__ __forceinline__ void start_lane(Lane& L, const Args& a, const BwdArgs& w, int e,
                                           float* dpl) {
  const int b = L.lane, B = a.B;
  if (b >= B) return;
  for (int q = 0; q < 7; ++q) L.dn[q] = w.dq[((size_t)q * B + b) * a.E + e];
  for (int q = 0; q < 6; ++q) L.dn[7 + q] = w.dqd[((size_t)q * B + b) * a.E + e];
  for (int r = 0; r < plane_rows(a); ++r) dpl[r * B + b] = 0.0f;
}

// Entering substep j: fetch substep j-1, wait for j, zero dtgt/dact row j
// (the joints' dofs are filled in below).
__device__ __forceinline__ void enter_substep(Lane& L, const Args& a, const BwdArgs& w, int e,
                                              int j, const WarpMem& m) {
  if (j > 0) {
    const int o = (j - 1) & 1;
    fetch_substep(L, a, w, e, j - 1, m.mir + o * 13 * a.B, m.seq + o * 2 * a.n_qd);
  }
  cp_async_wait(j > 0 ? 1 : 0);
  for (int d = L.lane; d < a.n_qd; d += 32) {
    const size_t g = ((size_t)j * a.n_qd + d) * a.E + e;
    w.dtgt[g] = 0.0f;
    if (w.dact) w.dact[g] = 0.0f;
  }
}

// Body lane's entering state into its registers; its totals start at its
// residual forces (zero without them).
__device__ __forceinline__ void load_lane(Lane& L, const Args& a, int e, int j,
                                          const float* mir) {
  const int b = L.lane, B = a.B;
  if (b >= B) return;
  L.s = mirror_get(mir, b, B);
  L.ft = {0.0f, 0.0f, 0.0f};
  L.ff = {0.0f, 0.0f, 0.0f};
  if (a.res) {
    const float* r = a.res + ((size_t)j * 6 * B + b) * a.E + e;
    const size_t rs = (size_t)B * a.E;
    L.ft = {r[0], r[rs], r[2 * rs]};
    L.ff = {r[3 * rs], r[4 * rs], r[5 * rs]};
  }
}

// Body lane's integration, reversed: L.dS starts at its share, dF goes to
// the warp's [k][b] rows (and dres).
__device__ __forceinline__ void integrate_adj_lane(Lane& L, const Args& a, const BwdArgs& w,
                                                   const Consts& k, const WarpMem& m, int e,
                                                   int j) {
  const int b = L.lane, B = a.B;
  if (b >= B) return;
  float I[9], Ii[9], dF[6];
  const float inv_m = body_inertia(m.pl, b, B, I, Ii);
  for (int q = 0; q < 13; ++q) L.dS[q] = 0.0f;
  integrate_adj(a, L.s, L.ft, L.ff, ld3(k.bf + b * BF_STRIDE + 14), inv_m, I, Ii, L.dn, L.dS,
                dF, m.dpl + b, B);
  for (int q = 0; q < 6; ++q) m.dF[q * B + b] = dF[q];
  if (w.dres)
    for (int q = 0; q < 6; ++q) w.dres[(((size_t)j * 6 + q) * B + b) * a.E + e] = dF[q];
}

// The joint of body lane (child b, parent p), reversed: dF of b and p ->
// the child's d(state) share into slot rows 0-12 [k][b], the parent's into
// rows 13-25; dtgt/dact of its dofs; body b's gains rows and, with live
// anchors, its anchor rows.
__device__ __forceinline__ void joint_adj_lane(Lane& L, const Args& a, const BwdArgs& w,
                                               const Consts& k, const WarpMem& m,
                                               const float* mir, const float* row, int e,
                                               int j) {
  const int b = L.lane, B = a.B;
  if (b >= B) return;
  const int* bi = k.bi + b * BODY_I;
  const float* bf = k.bf + b * BF_STRIDE;
  const int jt = bi[1];
  if (!has_joint(jt)) return;
  const int p = bi[0];
  const bool hp = p >= 0;
  const float ke_a = a.attach_ke, kd_a = a.attach_kd;
  const WarpDrive d{m.pl, bi, row, a.act ? row + a.n_qd : nullptr, b, B};
  const size_t srow = (size_t)j * a.n_qd * a.E + e;
  const DofOut o{w.dtgt + srow, w.dact ? w.dact + srow : nullptr, a.E};
  float* dplb = m.dpl + b;  // body b's plane gradient rows, stride B
  const float* dF = m.dF;

  // forward recompute (substep.cuh:joint_wrench)
  Q4 q_c = L.s.q;
  V3 t_c = L.s.t, w_c = L.s.w, v_c = L.s.v;
  const Anchor an = anchor_of(a, m.pl, bf, b, B);
  Q4 xpq = an.xpq;
  V3 xpt = an.xpt, rpl = an.rpl, comb = ld3(bf + 14);
  Q4 pq = {0.f, 0.f, 0.f, 1.f};
  Q4 X_wp_q = xpq;
  V3 X_wp_t = xpt, w_p = {0.f, 0.f, 0.f}, v_p = {0.f, 0.f, 0.f}, r_p = {0.f, 0.f, 0.f};
  if (hp) {
    const Body pb = mirror_get(mir, p, B);
    pq = pb.q;
    X_wp_q = qmul(pq, xpq);
    X_wp_t = add(pb.t, qrot(pq, xpt));
    w_p = pb.w;
    v_p = pb.v;
    r_p = qrot(pq, rpl);
  }
  V3 r_c = scale(qrot(q_c, comb), -1.0f);
  V3 x_err = sub(t_c, X_wp_t);
  Q4 r_err = qmul(qinv(X_wp_q), q_c);
  V3 v_err = sub(v_c, v_p);
  V3 w_err = sub(w_c, w_p);
  V3 attach = add(scale(x_err, ke_a), scale(v_err, kd_a));
  V3 fj = jt == JOINT_COMPOUND ? clamp3(attach, 10000.0f) : attach;

  // scatter: child -= (t + r_c x f, f); parent += (t + r_p x f, f)
  V3 g_childt = {-dF[b], -dF[B + b], -dF[2 * B + b]};
  V3 g_fj = {-dF[3 * B + b], -dF[4 * B + b], -dF[5 * B + b]};
  V3 g_tt = g_childt;
  V3 g_rc = {0.f, 0.f, 0.f}, g_rp = {0.f, 0.f, 0.f};
  cross_adj(r_c, fj, g_childt, g_rc, g_fj);
  if (hp) {
    V3 g_pt = {dF[p], dF[B + p], dF[2 * B + p]};
    g_fj.x += dF[3 * B + p]; g_fj.y += dF[4 * B + p]; g_fj.z += dF[5 * B + p];
    acc(g_tt, g_pt);
    cross_adj(r_p, fj, g_pt, g_rp, g_fj);
  }

  V3 g_attach = {0.f, 0.f, 0.f}, g_werr = {0.f, 0.f, 0.f}, dv = {0.f, 0.f, 0.f};
  Q4 g_rerr = {0.f, 0.f, 0.f, 0.f}, g_Xwpq = {0.f, 0.f, 0.f, 0.f}, g_qc = {0.f, 0.f, 0.f, 0.f};
  Q4 dq_unused = {0.f, 0.f, 0.f, 0.f};

  if (jt == JOINT_FIXED) {
    V3 rv = {r_err.x, r_err.y, r_err.z};
    float sq = dot(rv, rv);
    bool is_zero = sq < 1e-12f;
    float norms = is_zero ? 0.0f : sqrtf(sq);
    float half = katan2(norms, r_err.w);
    float ang = 2.0f * half;
    bool small = fabsf(ang) < 1e-6f;
    float sho = small ? 0.5f - ang * ang / 48.0f : sinf(half) / ang;
    V3 ang_err = {rv.x / sho, rv.y / sho, rv.z / sho};
    // fj = attach; tt = qrot(X_wp_q, ang_err) ke_a + w_err kd_a kAngDamp
    acc(g_attach, g_fj);
    acc(g_werr, scale(g_tt, kd_a * kAngDamp));
    V3 g_ae = {0.f, 0.f, 0.f};
    qrot_adj(X_wp_q, ang_err, scale(g_tt, ke_a), g_Xwpq, g_ae);
    V3 g_rv = scale(g_ae, 1.0f / sho);
    float g_sho = -dot(g_ae, rv) / (sho * sho);
    float g_half = 0.0f, g_ang = 0.0f;
    if (small) {
      g_ang += g_sho * (-ang / 24.0f);
    } else {
      g_half += g_sho * cosf(half) / ang;
      g_ang -= g_sho * sinf(half) / (ang * ang);
    }
    g_half += 2.0f * g_ang;
    float g_norms = 0.0f, g_w = 0.0f;
    katan2_adj(norms, r_err.w, g_half, g_norms, g_w);
    if (!is_zero) acc(g_rv, scale(rv, g_norms / norms));
    acc(g_rerr, Q4{g_rv.x, g_rv.y, g_rv.z, g_w});
  } else if (jt == JOINT_REVOLUTE) {
    V3 axis = ld3(bf);
    V3 axis_p = qrot(X_wp_q, axis);
    V3 axis_cw = qrot(q_c, axis);
    float s_tw = r_err.x * axis.x + r_err.y * axis.y + r_err.z * axis.z;
    float q_ang = 2.0f * katan2(s_tw, r_err.w);
    float qd_ang = dot(w_err, axis_p);
    float fmag = joint_force(bf, 0, d.ke(0), d.kd(0), d.tg(0), d.ac(0), q_ang, qd_ang);
    // tt = axis_p fmag + swing ke_a + (w_err - qd_ang axis_p) kd_a kAngDamp
    acc(g_attach, g_fj);
    const float c = kd_a * kAngDamp;
    V3 g_axp = scale(g_tt, fmag - qd_ang * c);
    float g_fmag = dot(g_tt, axis_p);
    acc(g_werr, scale(g_tt, c));
    float g_qd = -dot(g_tt, axis_p) * c;
    V3 g_axcw = {0.f, 0.f, 0.f};
    cross_adj(axis_p, axis_cw, scale(g_tt, ke_a), g_axp, g_axcw);
    float g_q = 0.0f;
    joint_force_adj(bf, d, 0, q_ang, qd_ang, g_fmag, g_q, g_qd, dplb, B, o);
    acc(g_werr, scale(axis_p, g_qd));
    acc(g_axp, scale(w_err, g_qd));
    float g_s = 0.0f, g_w = 0.0f;
    katan2_adj(s_tw, r_err.w, 2.0f * g_q, g_s, g_w);
    acc(g_rerr, Q4{axis.x * g_s, axis.y * g_s, axis.z * g_s, g_w});
    qrot_adj(q_c, axis, g_axcw, g_qc, dv);
    qrot_adj(X_wp_q, axis, g_axp, g_Xwpq, dv);
  } else {  // JOINT_COMPOUND
    Q4 qoff = ld4(bf + 10);
    Q4 A = qmul(qinv(qoff), r_err);
    Q4 q_pc = qmul(A, qoff);
    float x = q_pc.x, y = q_pc.y, z = q_pc.z, ww = q_pc.w;
    float m12 = 2.0f * (y * z - ww * x);
    float m22 = 1.0f - 2.0f * (x * x + y * y);
    float m02 = 2.0f * (x * z + ww * y);
    float m01 = 2.0f * (x * y - ww * z);
    float m00 = 1.0f - 2.0f * (y * y + z * z);
    float m02c = clampf(m02, -kSinLimit, kSinLimit);
    float ang[3];
    ang[0] = katan2(-m12, m22);
    ang[1] = kasin(m02c);
    ang[2] = katan2(-m01, m00);
    float sa = sinf(0.5f * ang[0]), ca = cosf(0.5f * ang[0]);
    Q4 q0 = {sa, 0.0f, 0.0f, ca};
    const V3 ey = {0.0f, 1.0f, 0.0f}, ez = {0.0f, 0.0f, 1.0f};
    V3 ax[3];
    ax[0] = {1.0f, 0.0f, 0.0f};
    ax[1] = qrot(q0, ey);
    float sb = sinf(0.5f * ang[1]), cb = cosf(0.5f * ang[1]);
    Q4 q1 = {ax[1].x * sb, ax[1].y * sb, ax[1].z * sb, cb};
    Q4 q10 = qmul(q1, q0);
    ax[2] = qrot(q10, ez);
    Q4 q_w = qmul(X_wp_q, qoff);
    V3 axw[3];
    float qdk[3], fm[3];
    V3 tc = {0.0f, 0.0f, 0.0f};
    for (int kk = 0; kk < 3; ++kk) {
      axw[kk] = qrot(q_w, ax[kk]);
      qdk[kk] = dot(axw[kk], w_err);
      fm[kk] = joint_force(bf, kk, d.ke(kk), d.kd(kk), d.tg(kk), d.ac(kk), ang[kk], qdk[kk]);
      tc = add(tc, scale(axw[kk], fm[kk]));
    }
    // tt = clamp3(tc), fj = clamp3(attach)
    V3 g_tc = gate3(g_tt, tc, 10000.0f);
    acc(g_attach, gate3(g_fj, attach, 10000.0f));
    Q4 g_qw = {0.f, 0.f, 0.f, 0.f};
    V3 g_ax[3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    float g_ang[3] = {0.0f, 0.0f, 0.0f};
    for (int kk = 0; kk < 3; ++kk) {
      V3 g_axw = scale(g_tc, fm[kk]);
      float g_fm = dot(g_tc, axw[kk]);
      float g_qk = 0.0f, g_qdk = 0.0f;
      joint_force_adj(bf, d, kk, ang[kk], qdk[kk], g_fm, g_qk, g_qdk, dplb, B, o);
      g_ang[kk] += g_qk;
      acc(g_axw, scale(w_err, g_qdk));
      acc(g_werr, scale(axw[kk], g_qdk));
      qrot_adj(q_w, ax[kk], g_axw, g_qw, g_ax[kk]);
    }
    qmul_adj(X_wp_q, qoff, g_qw, g_Xwpq, dq_unused);
    Q4 g_q10 = {0.f, 0.f, 0.f, 0.f}, g_q1 = {0.f, 0.f, 0.f, 0.f}, g_q0 = {0.f, 0.f, 0.f, 0.f};
    qrot_adj(q10, ez, g_ax[2], g_q10, dv);
    qmul_adj(q1, q0, g_q10, g_q1, g_q0);
    acc(g_ax[1], V3{g_q1.x * sb, g_q1.y * sb, g_q1.z * sb});
    float g_sb = g_q1.x * ax[1].x + g_q1.y * ax[1].y + g_q1.z * ax[1].z;
    g_ang[1] += 0.5f * (g_sb * cb - g_q1.w * sb);
    qrot_adj(q0, ey, g_ax[1], g_q0, dv);
    g_ang[0] += 0.5f * (g_q0.x * ca - g_q0.w * sa);
    float g12 = 0.f, g22 = 0.f, g02 = 0.f, g01 = 0.f, g00 = 0.f, gy = 0.f, gx = 0.f;
    katan2_adj(-m12, m22, g_ang[0], gy, gx);
    g12 -= gy; g22 += gx;
    float g02c = 0.0f;
    kasin_adj(m02c, g_ang[1], g02c);
    if (m02 >= -kSinLimit && m02 <= kSinLimit) g02 += g02c;
    gy = 0.f; gx = 0.f;
    katan2_adj(-m01, m00, g_ang[2], gy, gx);
    g01 -= gy; g00 += gx;
    Q4 g_pc = {-2.0f * ww * g12 - 4.0f * x * g22 + 2.0f * z * g02 + 2.0f * y * g01,
               2.0f * z * g12 - 4.0f * y * g22 + 2.0f * ww * g02 + 2.0f * x * g01 - 4.0f * y * g00,
               2.0f * y * g12 + 2.0f * x * g02 - 2.0f * ww * g01 - 4.0f * z * g00,
               -2.0f * x * g12 + 2.0f * y * g02 - 2.0f * z * g01};
    Q4 g_A = {0.f, 0.f, 0.f, 0.f};
    qmul_adj(A, qoff, g_pc, g_A, dq_unused);
    qmul_adj(qinv(qoff), r_err, g_A, dq_unused, g_rerr);
  }

  // common frame: attach, errors, parent transform
  V3 g_xerr = scale(g_attach, ke_a);
  V3 g_verr = scale(g_attach, kd_a);
  Q4 g_qiX = {0.f, 0.f, 0.f, 0.f};
  qmul_adj(qinv(X_wp_q), q_c, g_rerr, g_qiX, g_qc);
  g_Xwpq.x -= g_qiX.x; g_Xwpq.y -= g_qiX.y; g_Xwpq.z -= g_qiX.z; g_Xwpq.w += g_qiX.w;
  qrot_adj(q_c, comb, neg(g_rc), g_qc, dv);
  put_state(m.jw + b, B, g_xerr, g_qc, g_werr, g_verr);
  // the anchor: X_wp = (p.t + qrot(pq, xpt), pq * xpq), r_p = qrot(pq, rpl);
  // without a parent X_wp = (xpt, xpq)
  V3 g_xpt = neg(g_xerr), g_rpl = {0.f, 0.f, 0.f};
  Q4 g_xpq = g_Xwpq;
  if (hp) {
    Q4 g_pq = {0.f, 0.f, 0.f, 0.f};
    const V3 g_Xwpt = g_xpt;
    g_xpq = {0.f, 0.f, 0.f, 0.f};
    g_xpt = {0.f, 0.f, 0.f};
    qmul_adj(pq, xpq, g_Xwpq, g_pq, g_xpq);
    qrot_adj(pq, xpt, g_Xwpt, g_pq, g_xpt);
    qrot_adj(pq, rpl, g_rp, g_pq, g_rpl);
    put_state(m.jw + 13 * B + b, B, g_Xwpt, g_pq, neg(g_werr), neg(g_verr));
  }
  if (a.xp_t) {
    dplb[PR_XP_T * B] += g_xpt.x;
    dplb[(PR_XP_T + 1) * B] += g_xpt.y;
    dplb[(PR_XP_T + 2) * B] += g_xpt.z;
    dplb[PR_XP_Q * B] += g_xpq.x;
    dplb[(PR_XP_Q + 1) * B] += g_xpq.y;
    dplb[(PR_XP_Q + 2) * B] += g_xpq.z;
    dplb[(PR_XP_Q + 3) * B] += g_xpq.w;
    dplb[PR_RP_LOCAL * B] += g_rpl.x;
    dplb[(PR_RP_LOCAL + 1) * B] += g_rpl.y;
    dplb[(PR_RP_LOCAL + 2) * B] += g_rpl.z;
  }
}

// Body lane's d(state) shares of the joints that touch it, joints in body
// order.
__device__ __forceinline__ void joint_adj_sum(Lane& L, const Args& a, const Consts& k,
                                              const float* jw) {
  const int b = L.lane, B = a.B;
  if (b >= B) return;
  for (int i = k.adj_off[b]; i < k.adj_off[b + 1]; ++i) {
    const float* s = jw + (k.adj[i] & 1) * 13 * B + (k.adj[i] >> 1);
    for (int q = 0; q < 13; ++q) L.dS[q] += s[q * B];
  }
}

// Contact c0 + lane, reversed: dF of its body -> its body's d(state) share
// into slot rows 0-12 [k][lane]; row 13 flags it active. Inactive contacts
// carry no force and no cotangent.
__device__ __forceinline__ void contact_adj_slot(Lane& L, const Args& a, const Consts& k,
                                                 const WarpMem& m, const float* mir, int c0) {
  const int c = c0 + L.lane;
  if (c >= a.C) return;
  float* slot = m.cw + L.lane;
  const int B = a.B;
  const int b = k.cbody[c];
  const float* cf = k.cf + (size_t)c * k.cfs;
  const Body bd = mirror_get(mir, b, B);
  Q4 qb = bd.q;
  V3 tb = bd.t, wb = bd.w, vb = bd.v;
  V3 comb = ld3(k.bf + b * BF_STRIDE + 14), pt = ld3(cf);
  V3 com_w = add(tb, qrot(qb, comb));
  V3 cp = add(qrot(qb, pt), tb);
  cp.y = cp.y - cf[3];
  if (!(cp.y < 0.0f)) {
    slot[13 * CHUNK] = 0.0f;
    return;
  }
  V3 r = sub(cp, com_w);
  V3 dpdt = add(vb, cross(wb, r));
  float vn = dpdt.y;
  V3 vt = {dpdt.x, dpdt.y - vn, dpdt.z};
  float fn = cp.y * cf[4];
  float fd = fminf(vn, 0.0f) * cf[5];
  float vt_len = sqrtf(dot(vt, vt) + 1e-12f);
  float fa = cf[6] * vt_len, fb = -cf[7] * (fn + fd);
  float ft_mag = fminf(fa, fb);
  float ratio = ft_mag / vt_len;
  V3 ftan = scale(vt, ratio);
  V3 fraw = {ftan.x, (fn + fd) + ftan.y, ftan.z};
  V3 f = clamp3(fraw, 500.0f);

  // body forces -= (r x f, f)
  const float* dF = m.dF;
  V3 g_t = {-dF[b], -dF[B + b], -dF[2 * B + b]};
  V3 g_f = {-dF[3 * B + b], -dF[4 * B + b], -dF[5 * B + b]};
  V3 g_r = {0.f, 0.f, 0.f};
  cross_adj(r, f, g_t, g_r, g_f);
  V3 g_ftan = gate3(g_f, fraw, 500.0f);
  float g_fnfd = g_ftan.y;
  V3 g_vt = scale(g_ftan, ratio);
  float g_ratio = dot(g_ftan, vt);
  float g_ftmag = g_ratio / vt_len;
  float g_vtlen = -g_ratio * ft_mag / (vt_len * vt_len);
  if (fa < fb) g_vtlen += g_ftmag * cf[6];
  else g_fnfd -= cf[7] * g_ftmag;
  acc(g_vt, scale(vt, g_vtlen / vt_len));
  float g_vn = vn < 0.0f ? g_fnfd * cf[5] : 0.0f;
  float g_cy = g_fnfd * cf[4];
  V3 g_dpdt = g_vt;
  g_vn -= g_vt.y;
  g_dpdt.y += g_vn;
  V3 g_wb = {0.f, 0.f, 0.f};
  cross_adj(wb, r, g_dpdt, g_wb, g_r);
  V3 g_cp = g_r;
  g_cp.y += g_cy;
  V3 g_comw = neg(g_r);
  Q4 g_qb = {0.f, 0.f, 0.f, 0.f};
  V3 dv = {0.f, 0.f, 0.f};
  qrot_adj(qb, pt, g_cp, g_qb, dv);
  qrot_adj(qb, comb, g_comw, g_qb, dv);
  put_state(slot, CHUNK, add(g_cp, g_comw), g_qb, g_wb, g_dpdt);
  slot[13 * CHUNK] = 1.0f;
}

// Body lane's d(state) shares of its active contacts in the chunk, in
// contact order.
__device__ __forceinline__ void contact_adj_sum(Lane& L, const Args& a, const Consts& k,
                                                const float* cw, int c0) {
  const int b = L.lane;
  if (b >= a.B) return;
  const int hi = imin(k.c_off[b + 1], c0 + CHUNK);
  for (int c = imax(k.c_off[b], c0); c < hi; ++c) {
    const float* s = cw + (c - c0);
    if (s[13 * CHUNK] == 0.0f) continue;
    for (int q = 0; q < 13; ++q) L.dS[q] += s[q * CHUNK];
  }
}

__device__ __forceinline__ void next_substep(Lane& L) {
  for (int q = 0; q < 13; ++q) L.dn[q] = L.dS[q];
}

// Body lane's d(state0) and plane gradients out.
__device__ __forceinline__ void finish_lane(const Lane& L, const Args& a, const BwdArgs& w,
                                            int e, const float* dpl) {
  const int b = L.lane, B = a.B;
  if (b >= B) return;
  for (int q = 0; q < 7; ++q) w.dbq0[((size_t)q * B + b) * a.E + e] = L.dn[q];
  for (int q = 0; q < 6; ++q) w.dbqd0[((size_t)q * B + b) * a.E + e] = L.dn[7 + q];
  for (int r = 0; r < plane_rows(a); ++r)
    w.dplanes[((size_t)r * B + b) * a.E + e] = dpl[r * B + b];
}

// Lane's partial sum of a row of E floats: envs lane, lane + 32, ...
__device__ __forceinline__ void row_partial(Lane& L, const float* x, int E) {
  float s = 0.0f;
  for (int e = L.lane; e < E; e += 32) s += x[e];
  L.acc = s;
}

// ---- kernels -------------------------------------------------------------

__global__ void __launch_bounds__(32 * MAX_ENVS_PER_CTA, 2)
soa_interval_fwd_kernel(Args a, Lists li, float* __restrict__ sstate, int S, int epc, Plan p) {
  DYN_SHARED(sm);
  const Consts k = stage_consts(a, li, sm, p);
  __syncthreads();
  const int warp = (int)(threadIdx.x >> 5);
  const int e = (int)blockIdx.x * epc + warp;
  if (e >= a.E) return;  // the last CTA's missing envs
  const WarpMem m = warp_mem(sm, p, warp);
  WARP_LANES;
  PHASE(load_planes(L, a, e, m.pl); load_state_inner(L, a, e, m.mir);
        fetch_fwd(L, a, e, 0, m.seq, m.rs));
  for (int s = 0; s < S; ++s) {
    PHASE(enter_fwd(L, a, sstate, e, s, S, m));
    warp_forces(LANES_ARG, a, k, m, m.mir, m.seq + (s & 1) * 2 * a.n_qd);
    PHASE(integrate_lane(L, a, k, m.pl, m.mir));
  }
  PHASE(store_state_inner(L, a, e));
}

__global__ void __launch_bounds__(32 * MAX_ENVS_PER_CTA, 2)
soa_interval_bwd_kernel(Args a, BwdArgs w, Lists li, int epc, Plan p) {
  DYN_SHARED(sm);
  const Consts k = stage_consts(a, li, sm, p);
  __syncthreads();
  const int warp = (int)(threadIdx.x >> 5);
  const int e = (int)blockIdx.x * epc + warp;
  if (e >= a.E) return;  // the last CTA's missing envs
  const WarpMem m = warp_mem(sm, p, warp);
  const int MB = 13 * a.B, RW = 2 * a.n_qd, S = w.S;
  WARP_LANES;
  PHASE(load_planes(L, a, e, m.pl); start_lane(L, a, w, e, m.dpl);
        fetch_substep(L, a, w, e, S - 1, m.mir + ((S - 1) & 1) * MB, m.seq + ((S - 1) & 1) * RW));
  for (int j = S - 1; j >= 0; --j) {
    const float* mir = m.mir + (j & 1) * MB;
    const float* row = m.seq + (j & 1) * RW;
    PHASE(enter_substep(L, a, w, e, j, m));
    PHASE(load_lane(L, a, e, j, mir));
    warp_forces(LANES_ARG, a, k, m, mir, row);  // this substep's force totals
    PHASE(integrate_adj_lane(L, a, w, k, m, e, j));
    PHASE(joint_adj_lane(L, a, w, k, m, mir, row, e, j));
    PHASE(joint_adj_sum(L, a, k, m.jw));
    for (int c0 = 0; c0 < a.C; c0 += CHUNK) {
      PHASE(contact_adj_slot(L, a, k, m, mir, c0));
      PHASE(contact_adj_sum(L, a, k, m.cw, c0));
    }
    PHASE(next_substep(L));
  }
  PHASE(finish_lane(L, a, w, e, m.dpl));
}

// out[r] = sum over e of in[r][e], one warp per row: lane l sums envs l,
// l + 32, ... in ascending order, then a fixed butterfly combines the 32
// partials (every lane ends with the same sum).
__global__ void soa_interval_reduce_kernel(const float* __restrict__ in,
                                           float* __restrict__ out, int rows, int E) {
  const int r = (int)(blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5));
  if (r >= rows) return;
  WARP_LANES;
  PHASE(row_partial(L, in + (size_t)r * E, E));
  for (int off = 16; off > 0; off >>= 1) WARP_XOR_ADD(acc, off);
  PHASE(if (L.lane == 0) out[r] = L.acc);
}

Args make_args(const float* tgt, const float* act, const float* res, const int* body_i,
               const float* body_f, const int* cbody, const float* cf,
               const float* gains, int gains_pe, const float* inv_m, int inv_m_pe,
               const float* inertia, int inertia_pe, const float* inv_inertia,
               int inv_inertia_pe, const float* xp_t, const float* xp_q,
               const float* rp_local, int xp_pe, int E, int B, int n_qd, int C, float dt,
               float ang_decay, float gx, float gy, float gz, float attach_ke,
               float attach_kd) {
  Args a = {};
  a.xp_t = xp_t; a.xp_q = xp_q; a.rp_local = rp_local; a.xp_pe = xp_pe;
  a.tgt = tgt; a.act = act; a.res = res;
  a.body_i = body_i; a.body_f = body_f; a.cbody = cbody; a.cf = cf;
  a.gains = gains; a.inv_m = inv_m; a.inertia = inertia; a.inv_inertia = inv_inertia;
  a.gains_pe = gains_pe; a.inv_m_pe = inv_m_pe;
  a.inertia_pe = inertia_pe; a.inv_inertia_pe = inv_inertia_pe;
  a.E = E; a.B = B; a.n_qd = n_qd; a.C = C;
  a.dt = dt; a.ang_decay = ang_decay; a.gx = gx; a.gy = gy; a.gz = gz;
  a.attach_ke = attach_ke; a.attach_kd = attach_kd;
  return a;
}

bool bad_dims(int E, int B, int C, int S) {
  return B < 1 || B > MAX_BODIES || E < 1 || S < 1 || C < 0;
}

// The anchor planes come all three or not at all.
bool bad_anchors(const float* xp_t, const float* xp_q, const float* rp_local) {
  return !((xp_t && xp_q && rp_local) || (!xp_t && !xp_q && !rp_local));
}

}  // namespace

// plane rows of K3's gradient output: 25, or 35 with live anchors (xp != 0)
extern "C" int soa_interval_plane_rows(int xp) { return xp ? N_PLANE_ROWS_XP : N_PLANE_ROWS; }
extern "C" int soa_interval_max_bodies() { return MAX_BODIES; }

// bq0 (7,B,E), bqd0 (6,B,E), tgt/act (S,n_qd,E), res (S,6,B,E) (act, res
// may be null), planes of lane 1 or E (*_pe), anchor planes xp_t (3,B,L),
// xp_q (4,B,L), rp_local (3,B,L) or all three null (body_f's anchors);
// out_q (7,B,E), out_qd (6,B,E), sstate (S,E,13,B) or null (no export).
extern "C" int soa_interval_fwd_launch(
    const float* bq0, const float* bqd0, const float* tgt, const float* act,
    const float* res, const int* body_i, const float* body_f, const int* cbody,
    const float* cf, const int* adj_off, const int* adj, const int* c_off, int n_adj,
    const float* gains, int gains_pe, const float* inv_m, int inv_m_pe,
    const float* inertia, int inertia_pe, const float* inv_inertia, int inv_inertia_pe,
    const float* xp_t, const float* xp_q, const float* rp_local, int xp_pe,
    float* out_q, float* out_qd, float* sstate, int E, int B, int n_qd, int C, int S,
    float dt, float ang_decay, float gx, float gy, float gz, float attach_ke,
    float attach_kd, int envs_per_cta, void* stream) {
  if (bad_dims(E, B, C, S) || n_adj < 0 || envs_per_cta < 1 ||
      envs_per_cta > MAX_ENVS_PER_CTA || bad_anchors(xp_t, xp_q, rp_local))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(tgt, act, res, body_i, body_f, cbody, cf, gains, gains_pe, inv_m,
                     inv_m_pe, inertia, inertia_pe, inv_inertia, inv_inertia_pe, xp_t, xp_q,
                     rp_local, xp_pe, E, B, n_qd, C, dt, ang_decay, gx, gy, gz, attach_ke,
                     attach_kd);
  a.bq0 = bq0; a.bqd0 = bqd0; a.out_q = out_q; a.out_qd = out_qd;
  const Lists li = {adj_off, adj, c_off, n_adj};
  const Plan p = make_plan(B, C, n_qd, n_adj, false, res != nullptr, xp_t != nullptr);
  const int bytes = 4 * (p.cta + envs_per_cta * p.warp);
  static bool smem_cap_set[MAX_DEVICES];
  const int st = allow_dyn_smem(soa_interval_fwd_kernel, smem_cap_set);
  if (st != 0) return st;
  const int blocks = (E + envs_per_cta - 1) / envs_per_cta;
  LAUNCH_WARPS(soa_interval_fwd_kernel, blocks, envs_per_cta, bytes, stream)(
      a, li, sstate, S, envs_per_cta, p);
  return (int)cudaGetLastError();
}

extern "C" int soa_interval_bwd_launch(
    const float* sstate, const float* tgt, const float* act, const float* res,
    const int* body_i, const float* body_f, const int* cbody, const float* cf,
    const int* adj_off, const int* adj, const int* c_off, int n_adj,
    const float* gains, int gains_pe, const float* inv_m, int inv_m_pe,
    const float* inertia, int inertia_pe, const float* inv_inertia, int inv_inertia_pe,
    const float* xp_t, const float* xp_q, const float* rp_local, int xp_pe,
    const float* dq, const float* dqd, float* dbq0, float* dbqd0, float* dtgt,
    float* dact, float* dres, float* dplanes, int E, int B, int n_qd, int C, int S,
    float dt, float ang_decay, float gx, float gy, float gz, float attach_ke,
    float attach_kd, int envs_per_cta, void* stream) {
  if (bad_dims(E, B, C, S) || n_adj < 0 || envs_per_cta < 1 ||
      envs_per_cta > MAX_ENVS_PER_CTA || bad_anchors(xp_t, xp_q, rp_local))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(tgt, act, res, body_i, body_f, cbody, cf, gains, gains_pe, inv_m,
                     inv_m_pe, inertia, inertia_pe, inv_inertia, inv_inertia_pe, xp_t, xp_q,
                     rp_local, xp_pe, E, B, n_qd, C, dt, ang_decay, gx, gy, gz, attach_ke,
                     attach_kd);
  BwdArgs w;
  w.sstate = sstate; w.dq = dq; w.dqd = dqd; w.dbq0 = dbq0; w.dbqd0 = dbqd0;
  w.dtgt = dtgt; w.dact = dact; w.dres = dres; w.dplanes = dplanes; w.S = S;
  const Lists li = {adj_off, adj, c_off, n_adj};
  const Plan p = make_plan(B, C, n_qd, n_adj, true, false, xp_t != nullptr);
  const int bytes = 4 * (p.cta + envs_per_cta * p.warp);
  static bool smem_cap_set[MAX_DEVICES];
  const int st = allow_dyn_smem(soa_interval_bwd_kernel, smem_cap_set);
  if (st != 0) return st;
  const int blocks = (E + envs_per_cta - 1) / envs_per_cta;
  LAUNCH_WARPS(soa_interval_bwd_kernel, blocks, envs_per_cta, bytes, stream)(a, w, li,
                                                                             envs_per_cta, p);
  return (int)cudaGetLastError();
}

// rows warps, warps_per_cta of them per CTA
extern "C" int soa_interval_reduce_launch(const float* in, float* out, int rows, int E,
                                          int warps_per_cta, void* stream) {
  if (rows < 1 || E < 1 || warps_per_cta < 1 || warps_per_cta > 32)
    return (int)cudaErrorInvalidValue;
  const int blocks = (rows + warps_per_cta - 1) / warps_per_cta;
  LAUNCH_WARPS(soa_interval_reduce_kernel, blocks, warps_per_cta, 0, stream)(in, out, rows, E);
  return (int)cudaGetLastError();
}
