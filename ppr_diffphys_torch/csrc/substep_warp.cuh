// One warp per env: substep.cuh's units with lanes over bodies, contacts and
// joints, for every kernel of the port: the serving window K1
// (soa_window.cu), the interval forward K2 and backward K3
// (soa_interval.cu) and the bench rollout K4 (soa_rollout.cu).
//
// - Lane l owns body l: its state and its torque/force totals in registers
//   (struct Lane). It also owns the joint whose child is body l, and contact
//   c0 + l of each chunk of 32 contacts starting at c0 (any C works).
// - A CTA holds several consecutive envs, one per warp. Once per CTA the
//   packed constants (body_i, body_f with rows padded against bank
//   conflicts, cbody/cf while C <= CF_SMEM_MAX, and the per-body lists
//   below) are staged into shared memory. Each warp copies its env's
//   parameter planes (shared lane-1 or per-env; K2/K3 with live joint
//   anchors also the anchor planes) into its own shared rows.
// - What lanes exchange goes through the warp's shared memory, with
//   __syncwarp() between phases: a mirror of the body states, one slot per
//   contact of the current chunk and one per joint for the wrench it
//   produces. Each body's lane then sums its slots in one fixed order:
//   residual, its contacts in contact order (cbody is body-sorted, so a
//   contiguous range c_off[b] .. c_off[b+1]), then the joints j = 0..B-1
//   that touch it (the list adj[adj_off[b] .. adj_off[b+1]], entry 2j for
//   the child part, taken with minus, 2j+1 for the parent part, with plus;
//   built on the host by sim/soa.py:pack_static). No atomics: the results
//   are deterministic, and the forward kernels K1, K2 and K4 give the same
//   states bit for bit on the same inputs.
// - The caller's layouts are read and written as they are: env outermost
//   for K1 and K4 (a warp's env is a contiguous run), env innermost for K2
//   and K3's state, targets and residual forces (a CTA of consecutive envs
//   reads whole 32-byte sectors); K2's per-substep export, which K3 reads,
//   is env outermost. The next substep's targets/acts (K2: and residual
//   forces) are fetched with cp.async into a shared double buffer while the
//   current one is computed.
//
// A warp program is written as phases: PHASE(stmts) runs stmts on every
// lane (`L` is the lane's struct) and ends in __syncwarp(). Each phase calls
// per-lane functions of a Lane, so the same source also runs on the host,
// one lane after another, phase by phase, where tests/test_torch_warp_host.py
// defines SOA_HOST_WARP and these macros, cp_async4 and friends for g++.

#pragma once

#include "substep.cuh"

#define CHUNK 32          // contacts per chunk: one per lane
#define MAX_ENVS_PER_CTA 8
#define BF_STRIDE 33      // shared-memory row of body_f (BODY_F + 1: no bank conflicts)
#define CF_STRIDE 9       // shared-memory row of cf (CONTACT_F + 1)
#define CF_SMEM_MAX 128   // contacts whose constants are staged in shared memory
#define N_PLANE_ROWS 25   // gains: ke 0-2, kd 3-5; inv_m 6; inertia 7-15; inv_inertia 16-24
#define PR_INV_M 6
#define PR_INERTIA 7
#define PR_INV_INERTIA 16
// with live joint anchors (K2/K3 with_xp) the planes have 10 more rows:
// xp_t 25-27, xp_q 28-31, rp_local 32-34
#define N_PLANE_ROWS_XP 35
#define PR_XP_T 25
#define PR_XP_Q 28
#define PR_RP_LOCAL 32

#ifndef SOA_HOST_WARP
#define LANES Lane& L  // a warp function's parameter: the calling lane
#define LANES_ARG L
#define WARP_LANES \
  Lane L;          \
  L.lane = (int)(threadIdx.x & 31)
#define PHASE(...) \
  do {             \
    __VA_ARGS__;   \
    __syncwarp();  \
  } while (0)
// every lane's `field` becomes the sum of its own and lane (lane ^ off)'s
#define WARP_XOR_ADD(field, off) L.field += __shfl_xor_sync(0xffffffffu, L.field, off)
#define CTA_FOR(i, n) for (int i = (int)threadIdx.x; i < (n); i += (int)blockDim.x)
#define DYN_SHARED(name) extern __shared__ __align__(16) float name[]
#define LAUNCH_WARPS(kernel, grid, warps, smem, stream) \
  kernel<<<(grid), 32 * (warps), (smem), (cudaStream_t)(stream)>>>
#endif

namespace {

// The registers of lane `lane`: body `lane`'s state and force totals; K1
// adds their post-contact snapshot (gt, gf: the ground reaction), K3 the
// cotangents of the state after (dn) and entering (dS) a substep, the
// reduction a partial sum.
struct Lane {
  int lane;
  Body s;
  V3 ft, ff;
  V3 gt, gf;
  float dn[13], dS[13];
  float acc;
};

#ifndef SOA_HOST_WARP
// 4-byte asynchronous copy global -> shared (sm_80+), cached in L1
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most `pending` (0 or 1) of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending) asm volatile("cp.async.wait_group 1;\n" ::);
  else asm volatile("cp.async.wait_group 0;\n" ::);
}
#endif

__device__ __forceinline__ int imin(int x, int y) { return x < y ? x : y; }
__device__ __forceinline__ int imax(int x, int y) { return x > y ? x : y; }

// The per-body lists of sim/soa.py:pack_static.
struct Lists {
  const int* adj_off;  // (B+1,)
  const int* adj;      // (n_adj,)
  const int* c_off;    // (B+1,)
  int n_adj;
};

// Dynamic shared memory, in 4-byte words: the CTA's constants, then one
// part per warp. The same function sizes it at launch.
struct Plan {
  int bi, bf, cbody, cf, adj_off, adj, c_off, cta;  // per CTA; cta = its words
  int pl, mir, seq, rs, cw, jw, dpl, dF, warp;      // per warp; warp = its words
  int cf_smem;
};

// `adjoint`: K3's parts; `res`: K2's double buffer of residual forces;
// `xp`: the anchor rows of the planes (and of their gradients).
__host__ __device__ inline Plan make_plan(int B, int C, int n_qd, int n_adj, bool adjoint,
                                          bool res, bool xp = false) {
  const int rows = xp ? N_PLANE_ROWS_XP : N_PLANE_ROWS;
  Plan p;
  int o = 0;
  p.cf_smem = C <= CF_SMEM_MAX;
  p.bi = o; o += B * BODY_I;
  p.bf = o; o += B * BF_STRIDE;
  p.cbody = o; o += p.cf_smem ? C : 0;
  p.cf = o; o += p.cf_smem ? C * CF_STRIDE : 0;
  p.adj_off = o; o += B + 1;
  p.adj = o; o += n_adj;
  p.c_off = o; o += B + 1;
  p.cta = (o + 3) & ~3;
  int w = 0;
  p.pl = w; w += rows * B;                      // planes [row][b]
  p.mir = w; w += (adjoint ? 2 : 1) * 13 * B;   // body states [k][b] (K3: double buffer)
  p.seq = w; w += 2 * 2 * n_qd;                 // double buffer of (targets, acts) rows
  p.rs = w; w += res ? 2 * 6 * B : 0;           // double buffer of residual rows [k][b]
  p.cw = w; w += (adjoint ? 14 : 6) * CHUNK;    // contact slots [k][c - c0]
  p.jw = w; w += (adjoint ? 26 : 9) * B;        // joint slots [k][b]
  p.dpl = w; w += adjoint ? rows * B : 0;       // plane gradients [row][b]
  p.dF = w; w += adjoint ? 6 * B : 0;           // torque/force cotangents [k][b]
  p.warp = (w + 3) & ~3;
  return p;
}

#define MAX_DEVICES 64

// Lets `kernel` take up to the device's opt-in maximum of dynamic shared
// memory (the warp kernels have no static shared memory); a launch that
// needs more still fails. The attribute is only a cap, so it is set once
// per device (`done[device]`) instead of on every launch, where it would
// cost host time on short launches. Every caller sets the same value, so
// threads racing here do no harm.
template <class K>
__host__ inline int allow_dyn_smem(K kernel, bool* done) {
  int dev = 0;
  int st = (int)cudaGetDevice(&dev);
  if (st != 0) return st;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidValue;
  if (done[dev]) return 0;
  int optin = 0;
  st = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (st == 0)
    st = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (st == 0) done[dev] = true;
  return st;
}

// The CTA's constants in shared memory (cbody/cf stay in device memory for
// large C).
struct Consts {
  const int* bi;     // [b][BODY_I]
  const float* bf;   // [b][BF_STRIDE]
  const int* cbody;  // [c]
  const float* cf;   // [c][cfs]
  int cfs;
  const int* adj_off;
  const int* adj;
  const int* c_off;
};

// Every thread of the CTA takes part; a __syncthreads() must follow.
__device__ __forceinline__ Consts stage_consts(const Args& a, const Lists& li, float* sm,
                                               const Plan& p) {
  int* bi = reinterpret_cast<int*>(sm + p.bi);
  float* bf = sm + p.bf;
  int* ao = reinterpret_cast<int*>(sm + p.adj_off);
  int* ad = reinterpret_cast<int*>(sm + p.adj);
  int* co = reinterpret_cast<int*>(sm + p.c_off);
  CTA_FOR(i, a.B * BODY_I) bi[i] = a.body_i[i];
  CTA_FOR(i, a.B * BODY_F) bf[(i / BODY_F) * BF_STRIDE + i % BODY_F] = a.body_f[i];
  CTA_FOR(i, a.B + 1) {
    ao[i] = li.adj_off[i];
    co[i] = li.c_off[i];
  }
  CTA_FOR(i, li.n_adj) ad[i] = li.adj[i];
  Consts k = {bi, bf, a.cbody, a.cf, CONTACT_F, ao, ad, co};
  if (p.cf_smem) {
    int* cb = reinterpret_cast<int*>(sm + p.cbody);
    float* cf = sm + p.cf;
    CTA_FOR(i, a.C) cb[i] = a.cbody[i];
    CTA_FOR(i, a.C * CONTACT_F) cf[(i / CONTACT_F) * CF_STRIDE + i % CONTACT_F] = a.cf[i];
    k.cbody = cb;
    k.cf = cf;
    k.cfs = CF_STRIDE;
  }
  return k;
}

// A warp's part of the shared memory.
struct WarpMem {
  float *pl, *mir, *seq, *rs, *cw, *jw, *dpl, *dF;
};

__device__ __forceinline__ WarpMem warp_mem(float* sm, const Plan& p, int warp) {
  float* w = sm + p.cta + warp * p.warp;
  return {w + p.pl, w + p.mir, w + p.seq, w + p.rs, w + p.cw, w + p.jw, w + p.dpl, w + p.dF};
}

// Body b of a mirror [k][b] (k: origin 0-2, orientation 3-6, angular 7-9,
// linear 10-12 velocity).
__device__ __forceinline__ Body mirror_get(const float* m, int b, int B) {
  return {{m[3 * B + b], m[4 * B + b], m[5 * B + b], m[6 * B + b]},
          {m[b], m[B + b], m[2 * B + b]},
          {m[7 * B + b], m[8 * B + b], m[9 * B + b]},
          {m[10 * B + b], m[11 * B + b], m[12 * B + b]}};
}
__device__ __forceinline__ void mirror_put(float* m, int b, int B, const Body& s) {
  m[b] = s.t.x; m[B + b] = s.t.y; m[2 * B + b] = s.t.z;
  m[3 * B + b] = s.q.x; m[4 * B + b] = s.q.y; m[5 * B + b] = s.q.z; m[6 * B + b] = s.q.w;
  m[7 * B + b] = s.w.x; m[8 * B + b] = s.w.y; m[9 * B + b] = s.w.z;
  m[10 * B + b] = s.v.x; m[11 * B + b] = s.v.y; m[12 * B + b] = s.v.z;
}

__device__ __forceinline__ bool has_joint(int jt) {
  return jt == JOINT_FIXED || jt == JOINT_REVOLUTE || jt == JOINT_COMPOUND;
}

// Body b's gains from the warp's planes, dof targets/acts from its staged
// row (acts null: zero).
struct WarpDrive {
  const float* pl;
  const int* bi;
  const float* tgt;
  const float* act;
  int b, B;
  __device__ __forceinline__ float ke(int k) const { return pl[k * B + b]; }
  __device__ __forceinline__ float kd(int k) const { return pl[(3 + k) * B + b]; }
  __device__ __forceinline__ float tg(int k) const { return tgt[bi[2 + k]]; }
  __device__ __forceinline__ float ac(int k) const { return act ? act[bi[2 + k]] : 0.0f; }
};

// ---- per-lane phases ----------------------------------------------------

// Rows of the planes: 25, or 35 with live joint anchors.
__device__ __forceinline__ int plane_rows(const Args& a) {
  return a.xp_t ? N_PLANE_ROWS_XP : N_PLANE_ROWS;
}

// The warp's planes [row][b] for env e, from lane-1 or per-env planes: once
// per launch, so a joint's live anchor is read from device memory once per
// interval and from the warp's shared rows at every substep.
__device__ __forceinline__ void load_planes(Lane& L, const Args& a, int e, float* pl) {
  for (int i = L.lane; i < plane_rows(a) * a.B; i += 32) {
    const int r = i / a.B, b = i - r * a.B;
    float v;
    if (r < PR_INV_M) v = plane(a.gains, a.gains_pe, r, b, e, a.B, a.E);
    else if (r == PR_INV_M) v = plane(a.inv_m, a.inv_m_pe, 0, b, e, a.B, a.E);
    else if (r < PR_INV_INERTIA) v = plane(a.inertia, a.inertia_pe, r - PR_INERTIA, b, e, a.B, a.E);
    else if (r < PR_XP_T) v = plane(a.inv_inertia, a.inv_inertia_pe, r - PR_INV_INERTIA, b, e, a.B, a.E);
    else if (r < PR_XP_Q) v = plane(a.xp_t, a.xp_pe, r - PR_XP_T, b, e, a.B, a.E);
    else if (r < PR_RP_LOCAL) v = plane(a.xp_q, a.xp_pe, r - PR_XP_Q, b, e, a.B, a.E);
    else v = plane(a.rp_local, a.xp_pe, r - PR_RP_LOCAL, b, e, a.B, a.E);
    pl[i] = v;
  }
}

// The parent anchor of body b's joint: the warp's anchor rows when the
// anchors are live, else body_f's columns (xp_t 3-5, xp_q 6-9, rp_local
// 17-19).
__device__ __forceinline__ Anchor anchor_of(const Args& a, const float* pl, const float* bf,
                                            int b, int B) {
  if (!a.xp_t) return {ld3(bf + 3), ld4(bf + 6), ld3(bf + 17)};
  const float* r = pl + b;
  return {{r[PR_XP_T * B], r[(PR_XP_T + 1) * B], r[(PR_XP_T + 2) * B]},
          {r[PR_XP_Q * B], r[(PR_XP_Q + 1) * B], r[(PR_XP_Q + 2) * B], r[(PR_XP_Q + 3) * B]},
          {r[PR_RP_LOCAL * B], r[(PR_RP_LOCAL + 1) * B], r[(PR_RP_LOCAL + 2) * B]}};
}

// ---- the caller's layout: state (E,B,7)/(E,B,6), targets (S,E,n_qd) (K1, K4)

// Lanes fetch row s of env e's targets (and acts) into buf: tgt (n_qd), act.
__device__ __forceinline__ void fetch_row(Lane& L, const Args& a, int e, int s, float* buf) {
  const size_t off = ((size_t)s * a.E + e) * a.n_qd;
  for (int d = L.lane; d < a.n_qd; d += 32) {
    cp_async4(buf + d, a.tgt + off + d);
    if (a.act) cp_async4(buf + a.n_qd + d, a.act + off + d);
  }
  cp_async_commit();
}

// Entering substep s of S: fetch row s+1, wait for row s, zero the totals.
__device__ __forceinline__ void enter(Lane& L, const Args& a, int e, int s, int S, float* seq) {
  if (s + 1 < S) fetch_row(L, a, e, s + 1, seq + ((s + 1) & 1) * 2 * a.n_qd);
  cp_async_wait(s + 1 < S ? 1 : 0);
  L.ft = {0.0f, 0.0f, 0.0f};
  L.ff = {0.0f, 0.0f, 0.0f};
}

// Body lane's state of env e from (E,B,7)/(E,B,6) into its registers and the mirror.
__device__ __forceinline__ void load_state(Lane& L, const Args& a, int e, float* mir) {
  if (L.lane >= a.B) return;
  const float* q = a.bq0 + ((size_t)e * a.B + L.lane) * 7;
  const float* qd = a.bqd0 + ((size_t)e * a.B + L.lane) * 6;
  L.s = {ld4(q + 3), ld3(q), ld3(qd), ld3(qd + 3)};
  mirror_put(mir, L.lane, a.B, L.s);
}

// Contact c0 + lane's wrench into its slot [k][lane]: torque 0-2, force 3-5.
__device__ __forceinline__ void contact_slot(Lane& L, const Args& a, const Consts& k,
                                             const float* mir, float* cw, int c0) {
  const int c = c0 + L.lane;
  if (c >= a.C) return;
  const int b = k.cbody[c];
  V3 t, f;
  contact_wrench(mirror_get(mir, b, a.B), ld3(k.bf + b * BF_STRIDE + 14),
                 k.cf + (size_t)c * k.cfs, t, f);
  float* s = cw + L.lane;
  s[0] = t.x; s[CHUNK] = t.y; s[2 * CHUNK] = t.z;
  s[3 * CHUNK] = f.x; s[4 * CHUNK] = f.y; s[5 * CHUNK] = f.z;
}

// Body lane's contacts of the chunk, in contact order, off its totals.
__device__ __forceinline__ void contact_sum(Lane& L, const Args& a, const Consts& k,
                                            const float* cw, int c0) {
  const int b = L.lane;
  if (b >= a.B) return;
  const int hi = imin(k.c_off[b + 1], c0 + CHUNK);
  for (int c = imax(k.c_off[b], c0); c < hi; ++c) {
    const float* s = cw + (c - c0);
    L.ft.x -= s[0]; L.ft.y -= s[CHUNK]; L.ft.z -= s[2 * CHUNK];
    L.ff.x -= s[3 * CHUNK]; L.ff.y -= s[4 * CHUNK]; L.ff.z -= s[5 * CHUNK];
  }
}

// The joint of body lane into its slot [k][b]: child torque 0-2, parent
// torque 3-5, force 6-8. `row` is the staged (targets, acts) row.
__device__ __forceinline__ void joint_slot(Lane& L, const Args& a, const Consts& k,
                                           const float* pl, const float* mir,
                                           const float* row, float* jw) {
  const int b = L.lane, B = a.B;
  if (b >= B) return;
  const int* bi = k.bi + b * BODY_I;
  const int jt = bi[1];
  if (!has_joint(jt)) return;
  const int p = bi[0];
  const bool hp = p >= 0;
  V3 ct, pt, fj;
  const float* bf = k.bf + b * BF_STRIDE;
  joint_wrench(a, jt, hp, L.s, hp ? mirror_get(mir, p, B) : L.s, anchor_of(a, pl, bf, b, B),
               bf, WarpDrive{pl, bi, row, a.act ? row + a.n_qd : nullptr, b, B}, ct, pt, fj);
  jw[b] = ct.x; jw[B + b] = ct.y; jw[2 * B + b] = ct.z;
  if (hp) {
    jw[3 * B + b] = pt.x; jw[4 * B + b] = pt.y; jw[5 * B + b] = pt.z;
  }
  jw[6 * B + b] = fj.x; jw[7 * B + b] = fj.y; jw[8 * B + b] = fj.z;
}

// Body lane's joint wrenches, joints in body order: child part off, parent
// part onto its totals.
__device__ __forceinline__ void joint_sum(Lane& L, const Args& a, const Consts& k,
                                          const float* jw) {
  const int b = L.lane, B = a.B;
  if (b >= B) return;
  for (int i = k.adj_off[b]; i < k.adj_off[b + 1]; ++i) {
    const int j = k.adj[i] >> 1;
    if (k.adj[i] & 1) {
      L.ft.x += jw[3 * B + j]; L.ft.y += jw[4 * B + j]; L.ft.z += jw[5 * B + j];
      L.ff.x += jw[6 * B + j]; L.ff.y += jw[7 * B + j]; L.ff.z += jw[8 * B + j];
    } else {
      L.ft.x -= jw[j]; L.ft.y -= jw[B + j]; L.ft.z -= jw[2 * B + j];
      L.ff.x -= jw[6 * B + j]; L.ff.y -= jw[7 * B + j]; L.ff.z -= jw[8 * B + j];
    }
  }
}

// Body lane's inertia, inverse inertia and inverse mass from the planes.
__device__ __forceinline__ float body_inertia(const float* pl, int b, int B, float* I,
                                              float* Ii) {
  for (int q = 0; q < 9; ++q) {
    I[q] = pl[(PR_INERTIA + q) * B + b];
    Ii[q] = pl[(PR_INV_INERTIA + q) * B + b];
  }
  return pl[PR_INV_M * B + b];
}

// Body lane's symplectic Euler step; the mirror gets its new state.
__device__ __forceinline__ void integrate_lane(Lane& L, const Args& a, const Consts& k,
                                               const float* pl, float* mir) {
  const int b = L.lane, B = a.B;
  if (b >= B) return;
  float I[9], Ii[9];
  const float inv_m = body_inertia(pl, b, B, I, Ii);
  integrate_body(a, L.s, L.ft, L.ff, ld3(k.bf + b * BF_STRIDE + 14), inv_m, I, Ii);
  mirror_put(mir, b, B, L.s);
}

// ---- warp functions ---------------------------------------------------------

// One substep's contact forces onto each lane's totals (which hold the
// residual forces or zero), chunk by chunk, reading the bodies from `mir`.
__device__ __forceinline__ void warp_contacts(LANES, const Args& a, const Consts& k,
                                              const WarpMem& w, const float* mir) {
  for (int c0 = 0; c0 < a.C; c0 += CHUNK) {
    PHASE(contact_slot(L, a, k, mir, w.cw, c0));
    PHASE(contact_sum(L, a, k, w.cw, c0));
  }
}

// Then its joint forces, with the targets/acts of `row`.
__device__ __forceinline__ void warp_joints(LANES, const Args& a, const Consts& k,
                                            const WarpMem& w, const float* mir,
                                            const float* row) {
  PHASE(joint_slot(L, a, k, w.pl, mir, row, w.jw));
  PHASE(joint_sum(L, a, k, w.jw));
}

// One substep's forces: contacts, then joints.
__device__ __forceinline__ void warp_forces(LANES, const Args& a, const Consts& k,
                                            const WarpMem& w, const float* mir,
                                            const float* row) {
  warp_contacts(LANES_ARG, a, k, w, mir);
  warp_joints(LANES_ARG, a, k, w, mir, row);
}

}  // namespace
