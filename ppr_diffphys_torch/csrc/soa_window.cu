// Serving window rollout: the whole forward window of F-1 frame intervals
// of `sub` substeps each, for every env, in one launch.
//
// Replaces the TPU kernel ppr_diffphys_tpu/sim/pallas_soa.py:build_soa_window
// (kernel body :1135-1180, pallas_call :1244). Computes exactly what it
// does: per env, the state entering each interval plus the grf/jaf of that
// interval's first substep, and a final row that applies the last substep's
// inputs to the final state (which is kept). The substep is the penalty
// contact law, the FIXED/REVOLUTE/COMPOUND joint law with attachment
// springs, and symplectic Euler (pallas_soa.py:201-227, :736-944); its
// device code is substep.cuh, shared with the training interval kernels.
//
// What bounds it on an H100: operations, not bytes. One env-substep is
// ~10^4 fp32 operations on ~10^2 bytes of per-substep input (the 18 joint
// targets), so the targets and frame outputs move in well under the time
// the arithmetic needs at the 67 TFLOP/s non-tensor fp32 peak.
//
// What the design does about it, and what it does not yet do:
// - The TPU kernel iterated frames as a sequential grid axis carrying the
//   state in VMEM scratch. CUDA blocks run in no order, so here each env is
//   one thread that loops over frames and substeps itself, with the whole
//   articulation state held per thread for the entire window: state never
//   goes back to device memory between substeps.
// - The TPU kernel gathered parent states and scattered forces with one-hot
//   matmuls. Here they are plain index loops over joint_parent, the dof
//   index table and contact_body. Contacts are body-sorted and summed in
//   contact order, with no atomics, so results are deterministic.
// - Env is the innermost (fastest) dimension of every input and output, so
//   a warp's 32 threads read and write 32 consecutive floats.
// - One thread per env leaves most of the card idle at serving widths
//   (4096 envs fill ~128 warps on 132 SMs) and its per-body state lives in
//   local memory. Lanes over bodies and contacts, constants in shared
//   memory and in-kernel target gathering are left to a later change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: division, sqrt and denormals stay
// IEEE so results track the plain PyTorch version).

#include "substep.cuh"

namespace {

__device__ void write_state(const Args& a, const EnvState& st, int e, int frame) {
  const int B = a.B, E = a.E;
  for (int b = 0; b < B; ++b) {
    for (int k = 0; k < 7; ++k)
      a.out_q[(((size_t)frame * 7 + k) * B + b) * E + e] = st.q[b][k];
    for (int k = 0; k < 6; ++k)
      a.out_qd[(((size_t)frame * 6 + k) * B + b) * E + e] = st.qd[b][k];
  }
}

__global__ void soa_window_kernel(Args a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.E) return;
  EnvState st;
  for (int b = 0; b < a.B; ++b) {
    for (int k = 0; k < 7; ++k) st.q[b][k] = a.bq0[((size_t)k * a.B + b) * a.E + e];
    for (int k = 0; k < 6; ++k) st.qd[b][k] = a.bqd0[((size_t)k * a.B + b) * a.E + e];
  }
  for (int f = 0; f < a.F - 1; ++f) {
    write_state(a, st, e, f);  // state entering the interval
    for (int i = 0; i < a.sub; ++i) {
      substep(a, st, e, f * a.sub + i, i == 0, f, true);
    }
  }
  write_state(a, st, e, a.F - 1);
  // final row: the last substep's inputs on the final state, state kept
  substep(a, st, e, (a.F - 1) * a.sub, true, a.F - 1, false);
}

}  // namespace

extern "C" int soa_window_max_bodies() { return MAX_BODIES; }

extern "C" int soa_window_launch(
    const float* bq0, const float* bqd0, const float* tgt, const float* act,
    const int* body_i, const float* body_f, const int* cbody, const float* cf,
    const float* gains, int gains_pe, const float* inv_m, int inv_m_pe,
    const float* inertia, int inertia_pe, const float* inv_inertia,
    int inv_inertia_pe, float* out_q, float* out_qd, float* out_grf,
    float* out_jaf, int E, int B, int n_qd, int C, int F, int sub, float dt,
    float ang_decay, float gx, float gy, float gz, float attach_ke,
    float attach_kd, int threads, void* stream) {
  if (B < 1 || B > MAX_BODIES || E < 1 || F < 2 || sub < 1 || C < 0 ||
      threads < 1 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.bq0 = bq0; a.bqd0 = bqd0; a.tgt = tgt; a.act = act; a.res = nullptr;
  a.body_i = body_i; a.body_f = body_f; a.cbody = cbody; a.cf = cf;
  a.gains = gains; a.inv_m = inv_m; a.inertia = inertia; a.inv_inertia = inv_inertia;
  a.gains_pe = gains_pe; a.inv_m_pe = inv_m_pe;
  a.inertia_pe = inertia_pe; a.inv_inertia_pe = inv_inertia_pe;
  a.out_q = out_q; a.out_qd = out_qd; a.out_grf = out_grf; a.out_jaf = out_jaf;
  a.E = E; a.B = B; a.n_qd = n_qd; a.C = C; a.F = F; a.sub = sub;
  a.dt = dt; a.ang_decay = ang_decay; a.gx = gx; a.gy = gy; a.gz = gz;
  a.attach_ke = attach_ke; a.attach_kd = attach_kd;
  const int blocks = (E + threads - 1) / threads;
  soa_window_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
