// churn_sampler_kernel replaces graspldm_tpu/models/pallas_sampler.py:_mega_churn_kernel:
// the whole EDM stochastic churn (Heun) trajectory for R rows in one launch,
// two network evaluations per step.
//
// Per step s, with a = coefA[s] = [cinA, cskipA, coutA, s_eps, dsc, inv_sh,
// 0, 0] and c = coefB[s] = [cinB, cskipB, coutB, s_eps, hh, inv_sn, sel, 0]
// (models/cuda_sampler.py:churn_tables builds them, as
// pallas_sampler.py:fused_sample_churn does), following _churn_step_v:
//   x_hat = x + s_eps * noise[s]                      (noise a unit normal)
//   denA  = cskipA * x_hat + coutA * net_T(round_T(cinA * x_hat))   (trowsA[s])
//   d     = (x_hat - denA) * inv_sh;   x_eul = x_hat + dsc * d
//   denB  = cskipB * x_eul + coutB * net_T(round_T(cinB * x_eul))   (trowsB[s])
//   d'    = (x_eul - denB) * inv_sn
//   x     = sel * (x_hat + hh * (d + d')) + (1 - sel) * x_eul
// (den clamped to [-1, 1] with `clamp`). At the last step sigma_next = 0:
// coutB = 0, cskipB = 1, so denB = x_eul and d' = 0 exactly (x_eul, d and
// x_hat stay fp32 in shared memory), and sel = 0 keeps x_eul. That step's
// second evaluation cannot reach x_0, so the function needs 2N - 1 of the
// 2N evaluations; the kernel runs it anyway, as the TPU kernel does:
// branching around it changed how ptxas scheduled the shared step body and
// cost one of the two dtypes more than the skipped evaluation saves.
//
// What bounds it on the H100: the whole-network step of the other sampler
// kernels (net_step in sampler_body.cuh), twice per step, so the same
// design: the carry x and x_hat, x_eul, d (fp32), the conditioning
// embedding and every activation stay in shared memory across all N steps.
// noise [N, BG, L] is read from device memory, one row vector per step (the
// TPU kernel keeps the block's noise in VMEM; its 16 B per row-step are
// nothing beside the step's work).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// interface, loaded with ctypes; see graspldm_tpu_torch/cuda_build.py).
#include "sampler_body.cuh"

using namespace gl;

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
churn_sampler_kernel(const float* __restrict__ xT, const float* __restrict__ embin,
                     const float* __restrict__ trowsA, const float* __restrict__ trowsB,
                     const float* __restrict__ coefA, const float* __restrict__ coefB,
                     const float* __restrict__ noise, const T* __restrict__ Wf,
                     const long long* __restrict__ net, float* __restrict__ out, int BG, int S,
                     int L, int E, int Ce, int G, int cmax, int clamp, int R) {
  extern __shared__ __align__(16) char smem[];
  const Bufs<T> b = carve<T>(smem, sampler_plan(L, cmax, E, Ce, G, 4), R);
  const int row0 = blockIdx.x * R;
  const int CeE = Ce * E, RL = R * L;
  float* X = b.XC;
  float* XH = b.XC + RL;      // x_hat
  float* XE = b.XC + 2 * RL;  // x_eul
  float* D = b.XC + 3 * RL;   // d
  load_sampler_rows(b, xT, embin, row0, R, BG, L, CeE);
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const float* a = coefA + (size_t)s * 8;
    const float* c = coefB + (size_t)s * 8;
    for (int idx = threadIdx.x; idx < RL; idx += blockDim.x) {
      const float nz = row0 + idx / L < BG ? noise[((size_t)s * BG + row0) * L + idx] : 0.f;
      XH[idx] = X[idx] + a[3] * nz;
    }
    __syncthreads();
    // one call site of net_step for both legs keeps the kernel's code small
    for (int leg = 0; leg < 2; ++leg) {
      const float* k = leg ? c : a;
      const float* src = leg ? XE : XH;
      const float* trow = (leg ? trowsB : trowsA) + (size_t)s * CeE;
      const float* nout = net_step(b, src, k[0], trow, R, L, E, Ce, G, Wf, net);
      for (int idx = threadIdx.x; idx < RL; idx += blockDim.x) {
        const float xin = src[idx];
        float den = k[1] * xin + k[2] * nout[idx];
        if (clamp) den = fminf(fmaxf(den, -1.f), 1.f);
        const float dd = (xin - den) * k[5];
        if (leg == 0) {
          D[idx] = dd;
          XE[idx] = xin + k[4] * dd;
        } else {
          const float sel = k[6];
          X[idx] = sel * (XH[idx] + k[4] * (D[idx] + dd)) + (1.f - sel) * xin;
        }
      }
      __syncthreads();
    }
  }
  for (int idx = threadIdx.x; idx < RL; idx += blockDim.x)
    if (row0 + idx / L < BG) out[(size_t)row0 * L + idx] = X[idx];
}

template <typename T>
int launch_churn(const float* xT, const float* embin, const float* trowsA, const float* trowsB,
                 const float* coefA, const float* coefB, const float* noise, const void* w,
                 const long long* net, float* out, int BG, int S, int L, int E, int Ce, int G,
                 int cmax, int clamp, cudaStream_t st) {
  return launch_rows<T>(churn_sampler_kernel<T>, sampler_plan(L, cmax, E, Ce, G, 4), BG, st, xT,
                        embin, trowsA, trowsB, coefA, coefB, noise, (const T*)w, net, out, BG, S,
                        L, E, Ce, G, cmax, clamp);
}

}  // namespace

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int gl_churn_sample(int dtype, const float* xT, const float* embin,
                               const float* trowsA, const float* trowsB, const float* coefA,
                               const float* coefB, const float* noise, const void* w,
                               const long long* net, float* out, int BG, int S, int L, int E,
                               int Ce, int G, int cmax, int clamp, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_churn<float>(xT, embin, trowsA, trowsB, coefA, coefB, noise, w, net, out, BG,
                               S, L, E, Ce, G, cmax, clamp, st);
  return launch_churn<__nv_bfloat16>(xT, embin, trowsA, trowsB, coefA, coefB, noise, w, net, out,
                                     BG, S, L, E, Ce, G, cmax, clamp, st);
}
