// dpmpp_sampler_kernel replaces graspldm_tpu/models/pallas_sampler.py:_mega_dpmpp_kernel:
// the whole EDM DPM-Solver++(2M) trajectory for R rows in one launch.
//
// Per step s, with c = coefs[s] = [c_in, c_skip, c_out, g1, g2, ratio,
// em1, 0] (models/cuda_sampler.py:dpmpp_tables builds them, as
// pallas_sampler.py:fused_sample_dpmpp does), following _dpmpp_update_v:
//   net = net_T(round_T(c_in * x))            (time row trows[s] = c_noise(sigma_s))
//   den = c_skip * x + c_out * net            (clamped to [-1, 1] with `clamp`)
//   x   = ratio * x - em1 * (g1 * den + g2 * old);  old = den
// The rounding point is c_in * x: x itself starts at sigma_max = 80.
//
// What bounds it on the H100: the same whole-network step as
// ddim_sampler_kernel (net_step in sampler_body.cuh), so the same design:
// the carry x and old (fp32, zeros for old at the start), the conditioning
// embedding and every activation stay in shared memory across all N steps;
// weights stream through L1/L2. The only device-memory traffic is x_T,
// embin and the tables in, x_0 out, and the weights.
//
// The network (kDpmppTc in sampler_body.cuh), both dtypes at 512 threads
// (kTcThreads) and tc_rows_per_block's rows. Times and errors on the H100
// 80GB HBM3 at 700.00 W (fpc BG = 4096 / ppc BG = 1024, 32 steps), each
// against the sources with the decision undone:
//   * float32: net_step<float, true>, the float32 DDIM sampler's body (the
//     exact bf16 split on the tensor cores): 52.1 / 52.0 ms (on the CUDA
//     cores at 256 threads: 137.2 / 106.6, chip_smoke.py). 8 rows a block
//     at fpc, where the plan fits 9 (9 rows: 69.2 ms); ppc 2 rows. The
//     second carry vector (old) leaves the rows as they are. Block 0 of an
//     evaluation stages 24 of its 30 products at fpc and all 30 at ppc, none
//     short of room (--staging). Registers: 128, with 304 bytes of spill
//     stores and 844 of loads (the float32 DDIM sampler's). Its error over
//     32 steps reads 1.00x that of the same plain steps through the float32
//     stage chain (chip_smoke.py's CUDA-core control).
//   * bf16: net_step<bf16, false>, the CUDA-core body, its arithmetic
//     unchanged: 67.0 / 74.0 ms against 100.0 / 106.3 at 256 threads (128
//     registers and no spill, where 256 threads held it to 80 and spilled
//     36 bytes). On the tensor cores (ddim_sampler_kernel<bf16>'s body) it
//     reads 24.2 / 24.8 ms but fails TOL_BF16_EDM_STEP_MEAN (2^-10.5 =
//     6.9e-4 of max(1, max|x_0|), the mean over a 2-step trajectory) at ppc:
//     9.0e-4 in chip_smoke.py, where the CUDA-core kernel reads 9.7e-5
//     (fpc: 2.7e-4 against 1.6e-5), and the card tests' 2-step limit at fpc
//     and ppc. The summation order of churn's (churn_sampler.cu): bf16 stays
//     on the CUDA cores until a check holds the tensor cores' order
//     (ROADMAP.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// interface, loaded with ctypes; see graspldm_tpu_torch/cuda_build.py).
#include "sampler_body.cuh"

using namespace gl;

namespace {

template <typename T>
__global__ void __launch_bounds__(kTcThreads)
dpmpp_sampler_kernel(const float* __restrict__ xT, const float* __restrict__ embin,
                     const float* __restrict__ trows, const float* __restrict__ coefs,
                     const T* __restrict__ Wf, const long long* __restrict__ net,
                     float* __restrict__ out, int BG, int S, int L, int E, int Ce, int G,
                     int cmax, int clamp, int R) {
  extern __shared__ __align__(16) char smem[];
  const Bufs<T> b = carve<T>(smem, sampler_plan(L, cmax, E, Ce, G, 2), R);
  const int row0 = blockIdx.x * R;
  const int CeE = Ce * E;
  float* X = b.XC;
  float* OLD = b.XC + R * L;
  load_sampler_rows(b, xT, embin, row0, R, BG, L, CeE);
  for (int idx = threadIdx.x; idx < R * L; idx += blockDim.x) OLD[idx] = 0.f;
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const float* c = coefs + (size_t)s * 8;
    const float* nout =
        net_step<T, kDpmppTc<T>>(b, X, c[0], trows + (size_t)s * CeE, R, L, E, Ce, G, Wf, net);
    for (int idx = threadIdx.x; idx < R * L; idx += blockDim.x) {
      const float x = X[idx];
      float den = c[1] * x + c[2] * nout[idx];
      if (clamp) den = fminf(fmaxf(den, -1.f), 1.f);
      X[idx] = c[5] * x - c[6] * (c[3] * den + c[4] * OLD[idx]);
      OLD[idx] = den;
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < R * L; idx += blockDim.x)
    if (row0 + idx / L < BG) out[(size_t)row0 * L + idx] = X[idx];
}

template <typename T>
int launch_dpmpp(const float* xT, const float* embin, const float* trows, const float* coefs,
                 const void* w, const long long* net, float* out, int BG, int S, int L, int E,
                 int Ce, int G, int cmax, int clamp, cudaStream_t st) {
  return launch_tc_rows<T>(dpmpp_sampler_kernel<T>, sampler_plan(L, cmax, E, Ce, G, 2), L, BG,
                           st, xT, embin, trows, coefs, (const T*)w, net, out, BG, S, L, E, Ce,
                           G, cmax, clamp);
}

}  // namespace

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int gl_dpmpp_sample(int dtype, const float* xT, const float* embin,
                               const float* trows, const float* coefs, const void* w,
                               const long long* net, float* out, int BG, int S, int L, int E,
                               int Ce, int G, int cmax, int clamp, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dpmpp<float>(xT, embin, trows, coefs, w, net, out, BG, S, L, E, Ce, G, cmax,
                               clamp, st);
  return launch_dpmpp<__nv_bfloat16>(xT, embin, trows, coefs, w, net, out, BG, S, L, E, Ce, G,
                                     cmax, clamp, st);
}
