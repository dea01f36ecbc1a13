// Bench rollout K4: S forward substeps per env in one launch, final state only.
//
// Replaces the TPU kernel ppr_diffphys_tpu/sim/pallas_soa.py:build_soa_rollout
// (kernel body :1288-1302, pallas_call :1329). Computes exactly what it does:
// per env, S substeps of the penalty contact law, the FIXED/REVOLUTE/COMPOUND
// joint law with attachment springs and symplectic Euler, reading the joint
// targets and activations of substep i (no activations = zero) with zero
// residual forces, and writes only the final state. The parameters are
// baked in by the wrapper as shared (lane-1) planes, as the TPU kernel bakes
// them in as constants. It runs the warp substep of K1 and K2
// (substep_warp.cuh), so its final state equals soa_interval_fwd's (K2) on
// the same inputs, bit for bit.
//
// What bounds it on an H100: operations, not bytes. One env-substep is
// ~1.1e4 fp32 operations (sim/soa.py:window_work) on the 2 x 18 floats of
// targets and activations it reads; the state goes in and out once per
// launch. At the bench's 4096 envs x 33 substeps a launch needs ~1.5e9
// operations (~23 us at the 67 TFLOP/s non-tensor fp32 peak) against ~25 MB
// of traffic (~7.5 us at 3.35 TB/s).
//
// What the design does about it (substep_warp.cuh):
// - One warp per env, 1-8 consecutive envs per CTA (sim/soa.py:
//   envs_per_cta): at 4096 envs, 512 CTAs of 8 warps instead of one warp
//   per SM. Lane l integrates body l, evaluates the joint whose child is
//   body l and contacts l, l+32, ...; the 28 contacts, 12 joints and 13
//   bodies of a1 each take one lane-parallel phase instead of one serial
//   loop.
// - The body states live in registers (one body per lane) with a mirror in
//   shared memory for the lanes that read another body; the packed
//   constants and the planes are read from shared memory, staged once per
//   CTA and per warp.
// - The caller's (E,B,7)/(E,B,6) state and (S,E,n_qd) targets/acts are read
//   as they are (a warp's env is a contiguous run there) and the final
//   state written as (E,B,7)/(E,B,6): the wrapper copies nothing. The next
//   substep's targets/acts row is fetched with cp.async into a shared
//   double buffer while the current one is computed.
// - Lanes beyond the 13 bodies, 12 joints or 28 contacts idle in their
//   phase; no tensor cores (fp32 physics, no product to map onto them).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: division, sqrt and denormals stay
// IEEE so results track the plain PyTorch version).

#include "substep_warp.cuh"

namespace {

__device__ __forceinline__ void store_state(const Lane& L, const Args& a, int e) {
  if (L.lane >= a.B) return;
  float* q = a.out_q + ((size_t)e * a.B + L.lane) * 7;
  float* qd = a.out_qd + ((size_t)e * a.B + L.lane) * 6;
  q[0] = L.s.t.x; q[1] = L.s.t.y; q[2] = L.s.t.z;
  q[3] = L.s.q.x; q[4] = L.s.q.y; q[5] = L.s.q.z; q[6] = L.s.q.w;
  qd[0] = L.s.w.x; qd[1] = L.s.w.y; qd[2] = L.s.w.z;
  qd[3] = L.s.v.x; qd[4] = L.s.v.y; qd[5] = L.s.v.z;
}

__global__ void __launch_bounds__(32 * MAX_ENVS_PER_CTA, 2)
soa_rollout_kernel(Args a, Lists li, int S, int epc, Plan p) {
  DYN_SHARED(sm);
  const Consts k = stage_consts(a, li, sm, p);
  __syncthreads();
  const int warp = (int)(threadIdx.x >> 5);
  const int e = (int)blockIdx.x * epc + warp;
  if (e >= a.E) return;  // the last CTA's missing envs
  const WarpMem w = warp_mem(sm, p, warp);
  WARP_LANES;
  PHASE(load_planes(L, a, e, w.pl); load_state(L, a, e, w.mir); fetch_row(L, a, e, 0, w.seq));
  for (int s = 0; s < S; ++s) {
    PHASE(enter(L, a, e, s, S, w.seq));
    warp_forces(LANES_ARG, a, k, w, w.mir, w.seq + (s & 1) * 2 * a.n_qd);
    PHASE(integrate_lane(L, a, k, w.pl, w.mir));
  }
  PHASE(store_state(L, a, e));
}

}  // namespace

extern "C" int soa_rollout_max_bodies() { return MAX_BODIES; }

// bq0 (E,B,7), bqd0 (E,B,6), tgt/act (S,E,n_qd) (act may be null), planes
// lane 1; out_q (E,B,7), out_qd (E,B,6).
extern "C" int soa_rollout_launch(
    const float* bq0, const float* bqd0, const float* tgt, const float* act,
    const int* body_i, const float* body_f, const int* cbody, const float* cf,
    const int* adj_off, const int* adj, const int* c_off, int n_adj,
    const float* gains, const float* inv_m, const float* inertia,
    const float* inv_inertia, float* out_q, float* out_qd, int E, int B, int n_qd,
    int C, int S, float dt, float ang_decay, float gx, float gy, float gz,
    float attach_ke, float attach_kd, int envs_per_cta, void* stream) {
  if (B < 1 || B > MAX_BODIES || E < 1 || S < 1 || C < 0 || n_adj < 0 ||
      envs_per_cta < 1 || envs_per_cta > MAX_ENVS_PER_CTA)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.bq0 = bq0; a.bqd0 = bqd0; a.tgt = tgt; a.act = act; a.res = nullptr;
  a.body_i = body_i; a.body_f = body_f; a.cbody = cbody; a.cf = cf;
  // shared planes only (lane 1): the per-env flags stay 0
  a.gains = gains; a.inv_m = inv_m; a.inertia = inertia; a.inv_inertia = inv_inertia;
  a.out_q = out_q; a.out_qd = out_qd;
  a.E = E; a.B = B; a.n_qd = n_qd; a.C = C;
  a.dt = dt; a.ang_decay = ang_decay; a.gx = gx; a.gy = gy; a.gz = gz;
  a.attach_ke = attach_ke; a.attach_kd = attach_kd;
  const Lists li = {adj_off, adj, c_off, n_adj};
  const Plan p = make_plan(B, C, n_qd, n_adj, false, false);
  const int bytes = 4 * (p.cta + envs_per_cta * p.warp);
  static bool smem_cap_set[MAX_DEVICES];
  const int st = allow_dyn_smem(soa_rollout_kernel, smem_cap_set);
  if (st != 0) return st;
  const int blocks = (E + envs_per_cta - 1) / envs_per_cta;
  LAUNCH_WARPS(soa_rollout_kernel, blocks, envs_per_cta, bytes, stream)(a, li, S, envs_per_cta, p);
  return (int)cudaGetLastError();
}
