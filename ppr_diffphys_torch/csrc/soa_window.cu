// Serving window rollout K1: the whole forward window of F-1 frame intervals
// of `sub` substeps each, for every env, in one launch.
//
// Replaces the TPU kernel ppr_diffphys_tpu/sim/pallas_soa.py:build_soa_window
// (kernel body :1135-1180, pallas_call :1244). Computes exactly what it
// does: per env, the state entering each interval plus the grf/jaf of that
// interval's first substep, and a final row that applies the last substep's
// inputs to the final state (which is kept). The substep is the penalty
// contact law, the FIXED/REVOLUTE/COMPOUND joint law with attachment
// springs, and symplectic Euler (pallas_soa.py:201-227, :736-944), with
// shared or per-env parameter planes, zero acts when none are given and no
// residual forces.
//
// What bounds it on an H100: operations, not bytes. One env-substep is
// ~1.1e4 fp32 operations (sim/soa.py:window_work) on the 2 x 18 floats of
// targets and activations it reads; the serving window (4096 envs, 24
// frames, 759 substeps) needs ~3.5e10 operations (~0.53 ms at the 67
// TFLOP/s non-tensor fp32 peak) against ~0.35 GB of traffic (~0.11 ms).
//
// What the design does about it: the warp substep of K2 and K4
// (substep_warp.cuh), one warp per env, 1-8 consecutive envs per CTA
// (sim/soa.py:envs_per_cta; 512 CTAs of 8 warps at 4096 envs, one warp for
// the training loop's 1-env eval):
// - Lane l integrates body l, evaluates the joint whose child is body l and
//   contacts l, l+32, ...; the body states stay in registers (with a shared
//   mirror) for the whole window, the constants and planes in shared memory.
// - The TPU kernel iterated frames as a sequential grid axis carrying the
//   state in VMEM scratch. Here each warp loops over the window's substeps
//   itself; the state never goes back to device memory between substeps.
// - At each interval's first substep, each body's lane snapshots its totals
//   after the contact phases (grf) and, after the joint phases, writes grf
//   and jaf = total - grf for its body. The final row evaluates the forces
//   on the final state and skips the integration.
// - The caller's (E,B,7)/(E,B,6) state and (S,E,n_qd) targets/acts are read
//   as they are, and the frame rows written as (F,E,B,7), (F,E,B,6) x 3: a
//   warp writes its env's row of a frame as one contiguous run. The wrapper
//   copies nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: division, sqrt and denormals stay
// IEEE so results track the plain PyTorch version).

#include "substep_warp.cuh"

namespace {

// Row f of the (F,E,B,7)/(F,E,B,6) state outputs for env e, from the mirror.
__device__ __forceinline__ void write_frame(Lane& L, const Args& a, int e, int f,
                                            const float* mir) {
  const int B = a.B;
  float* q = a.out_q + ((size_t)f * a.E + e) * B * 7;
  for (int i = L.lane; i < 7 * B; i += 32) {
    const int b = i / 7;
    q[i] = mir[(i - 7 * b) * B + b];
  }
  float* qd = a.out_qd + ((size_t)f * a.E + e) * B * 6;
  for (int i = L.lane; i < 6 * B; i += 32) {
    const int b = i / 6;
    qd[i] = mir[(7 + i - 6 * b) * B + b];
  }
}

// Body lane's totals after the contacts: its ground reaction.
__device__ __forceinline__ void snapshot(Lane& L, const Args& a) {
  if (L.lane >= a.B) return;
  L.gt = L.ft;
  L.gf = L.ff;
}

// Body lane's grf and jaf (total - grf) into row f.
__device__ __forceinline__ void write_obs(const Lane& L, const Args& a, int e, int f) {
  if (L.lane >= a.B) return;
  const size_t o = (((size_t)f * a.E + e) * a.B + L.lane) * 6;
  float* g = a.out_grf + o;
  float* j = a.out_jaf + o;
  g[0] = L.gt.x; g[1] = L.gt.y; g[2] = L.gt.z;
  g[3] = L.gf.x; g[4] = L.gf.y; g[5] = L.gf.z;
  j[0] = L.ft.x - L.gt.x; j[1] = L.ft.y - L.gt.y; j[2] = L.ft.z - L.gt.z;
  j[3] = L.ff.x - L.gf.x; j[4] = L.ff.y - L.gf.y; j[5] = L.ff.z - L.gf.z;
}

__global__ void __launch_bounds__(32 * MAX_ENVS_PER_CTA, 2)
soa_window_kernel(Args a, Lists li, int epc, Plan p) {
  DYN_SHARED(sm);
  const Consts k = stage_consts(a, li, sm, p);
  __syncthreads();
  const int warp = (int)(threadIdx.x >> 5);
  const int e = (int)blockIdx.x * epc + warp;
  if (e >= a.E) return;  // the last CTA's missing envs
  const WarpMem w = warp_mem(sm, p, warp);
  const int S = a.sub * (a.F - 1) + 1;
  WARP_LANES;
  PHASE(load_planes(L, a, e, w.pl); load_state(L, a, e, w.mir); fetch_row(L, a, e, 0, w.seq));
  // substep s: frame row f = s / sub at each interval's first substep; the
  // last (s = S-1, row F-1) evaluates the forces only
  for (int s = 0; s < S; ++s) {
    const bool obs = s % a.sub == 0;
    const int f = s / a.sub;
    PHASE(if (obs) write_frame(L, a, e, f, w.mir); enter(L, a, e, s, S, w.seq));
    warp_contacts(LANES_ARG, a, k, w, w.mir);
    if (obs) PHASE(snapshot(L, a));
    warp_joints(LANES_ARG, a, k, w, w.mir, w.seq + (s & 1) * 2 * a.n_qd);
    PHASE(if (obs) write_obs(L, a, e, f); if (s + 1 < S) integrate_lane(L, a, k, w.pl, w.mir));
  }
}

}  // namespace

extern "C" int soa_window_max_bodies() { return MAX_BODIES; }

// bq0 (E,B,7), bqd0 (E,B,6), tgt/act (S,E,n_qd) with S = sub*(F-1)+1 (act
// may be null), planes of lane 1 or E (*_pe); out_q (F,E,B,7), out_qd,
// out_grf, out_jaf (F,E,B,6).
extern "C" int soa_window_launch(
    const float* bq0, const float* bqd0, const float* tgt, const float* act,
    const int* body_i, const float* body_f, const int* cbody, const float* cf,
    const int* adj_off, const int* adj, const int* c_off, int n_adj,
    const float* gains, int gains_pe, const float* inv_m, int inv_m_pe,
    const float* inertia, int inertia_pe, const float* inv_inertia,
    int inv_inertia_pe, float* out_q, float* out_qd, float* out_grf,
    float* out_jaf, int E, int B, int n_qd, int C, int F, int sub, float dt,
    float ang_decay, float gx, float gy, float gz, float attach_ke,
    float attach_kd, int envs_per_cta, void* stream) {
  if (B < 1 || B > MAX_BODIES || E < 1 || F < 2 || sub < 1 || C < 0 || n_adj < 0 ||
      envs_per_cta < 1 || envs_per_cta > MAX_ENVS_PER_CTA)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.bq0 = bq0; a.bqd0 = bqd0; a.tgt = tgt; a.act = act; a.res = nullptr;
  a.body_i = body_i; a.body_f = body_f; a.cbody = cbody; a.cf = cf;
  a.gains = gains; a.inv_m = inv_m; a.inertia = inertia; a.inv_inertia = inv_inertia;
  a.gains_pe = gains_pe; a.inv_m_pe = inv_m_pe;
  a.inertia_pe = inertia_pe; a.inv_inertia_pe = inv_inertia_pe;
  a.out_q = out_q; a.out_qd = out_qd; a.out_grf = out_grf; a.out_jaf = out_jaf;
  a.E = E; a.B = B; a.n_qd = n_qd; a.C = C; a.F = F; a.sub = sub;
  a.dt = dt; a.ang_decay = ang_decay; a.gx = gx; a.gy = gy; a.gz = gz;
  a.attach_ke = attach_ke; a.attach_kd = attach_kd;
  const Lists li = {adj_off, adj, c_off, n_adj};
  const Plan p = make_plan(B, C, n_qd, n_adj, false, false);
  const int bytes = 4 * (p.cta + envs_per_cta * p.warp);
  static bool smem_cap_set[MAX_DEVICES];
  const int st = allow_dyn_smem(soa_window_kernel, smem_cap_set);
  if (st != 0) return st;
  const int blocks = (E + envs_per_cta - 1) / envs_per_cta;
  LAUNCH_WARPS(soa_window_kernel, blocks, envs_per_cta, bytes, stream)(a, li, envs_per_cta, p);
  return (int)cudaGetLastError();
}
