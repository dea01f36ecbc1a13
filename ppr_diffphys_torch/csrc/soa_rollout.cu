// Bench rollout: S forward substeps per env in one launch, final state only.
//
// Replaces the TPU kernel ppr_diffphys_tpu/sim/pallas_soa.py:build_soa_rollout
// (kernel body :1288-1302, pallas_call :1329). Computes exactly what it does:
// per env, S substeps of the penalty contact law, the FIXED/REVOLUTE/COMPOUND
// joint law with attachment springs and symplectic Euler, reading the joint
// targets and activations of substep i (no activations = zero) with zero
// residual forces, and writes only the final (7,B,E) and (6,B,E) states. The
// parameters are baked in by the wrapper as shared (lane-1) planes, as the
// TPU kernel bakes them in as constants. The substep is substep.cuh, the
// device code of the serving window and the training interval kernels, so
// its final state equals soa_interval_fwd's on the same inputs bit for bit.
//
// What bounds it on an H100: operations, not bytes. One env-substep is
// ~1.1e4 fp32 operations (sim/soa.py:window_work) on the 2 x 18 floats of
// targets and activations it reads; the state goes in and out once per
// launch. At the bench's 4096 envs x 33 substeps a launch needs ~1.5e9
// operations (~23 us at the 67 TFLOP/s non-tensor fp32 peak) against ~25 MB
// of traffic (~7.5 us at 3.35 TB/s).
//
// What the design does about it, and what it does not yet do:
// - The TPU kernel ran the substeps as a fori_loop over VMEM-resident
//   planes of one env tile. Here each env is one thread that holds the
//   whole articulation state for all S substeps: state touches device
//   memory once on entry and once on exit.
// - Env is the innermost dimension of every input and output, so a warp's
//   32 threads read and write 32 consecutive floats.
// - Gathers and scatters are index loops; contacts are summed per body in
//   contact order, with no atomics: results are deterministic.
// - As with K1, one thread per env fills one warp per SM at 4096 envs and
//   keeps the per-body state in local memory, so the kernel is latency
//   bound, far above its operations bound. A redesign would spread an env
//   over a warp's lanes (bodies, contacts), keep the packed constants in
//   shared memory, and generate the tiled targets in the kernel instead of
//   reading an (S, n_qd, E) array.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: division, sqrt and denormals stay
// IEEE so results track the plain PyTorch version).

#include "substep.cuh"

namespace {

__global__ void soa_rollout_kernel(Args a, int S) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.E) return;
  const int B = a.B, E = a.E;
  EnvState st;
  for (int b = 0; b < B; ++b) {
    for (int k = 0; k < 7; ++k) st.q[b][k] = a.bq0[((size_t)k * B + b) * E + e];
    for (int k = 0; k < 6; ++k) st.qd[b][k] = a.bqd0[((size_t)k * B + b) * E + e];
  }
  for (int i = 0; i < S; ++i) substep(a, st, e, i, /*obs=*/false, 0, /*integrate=*/true);
  for (int b = 0; b < B; ++b) {
    for (int k = 0; k < 7; ++k) a.out_q[((size_t)k * B + b) * E + e] = st.q[b][k];
    for (int k = 0; k < 6; ++k) a.out_qd[((size_t)k * B + b) * E + e] = st.qd[b][k];
  }
}

}  // namespace

extern "C" int soa_rollout_max_bodies() { return MAX_BODIES; }

extern "C" int soa_rollout_launch(
    const float* bq0, const float* bqd0, const float* tgt, const float* act,
    const int* body_i, const float* body_f, const int* cbody, const float* cf,
    const float* gains, const float* inv_m, const float* inertia,
    const float* inv_inertia, float* out_q, float* out_qd, int E, int B, int n_qd,
    int C, int S, float dt, float ang_decay, float gx, float gy, float gz,
    float attach_ke, float attach_kd, int threads, void* stream) {
  if (B < 1 || B > MAX_BODIES || E < 1 || S < 1 || C < 0 || threads < 1 ||
      threads > 1024)
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
  const int blocks = (E + threads - 1) / threads;
  soa_rollout_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a, S);
  return (int)cudaGetLastError();
}
