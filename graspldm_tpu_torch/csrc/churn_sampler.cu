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
// What bounds it on the H100: operations, the whole-network step of the
// other sampler kernels (net_step in sampler_body.cuh) twice per step, so
// the same design: the carry x and x_hat, x_eul, d (fp32), the conditioning
// embedding and every activation stay in shared memory across all N steps.
// noise [N, BG, L] is read from device memory, one row vector per step (the
// TPU kernel keeps the block's noise in VMEM; its 16 B per row-step are
// nothing beside the step's work).
//
// The network (kChurnTc in sampler_body.cuh), both dtypes at 512 threads
// (kTcThreads: 128 registers a thread) and tc_rows_per_block's rows. Times
// and errors on the H100 80GB HBM3 at 700.00 W (fpc BG = 4096 / ppc BG =
// 1024, 100 steps), each against the sources with the decision undone:
//   * float32: net_step<float, true>, full_kernel<float>'s body: the convs,
//     projections and wqkv / wo as the six exact bf16 products of the
//     weights' and the activations' three-part split. 351 / 359 ms (the
//     CUDA-core kernel at 256 threads: 790 / 607, chip_smoke.py). 8 rows a
//     block at fpc, where the plan fits 9 (M = 32 tokens, one warp unit):
//     9 rows read 467 ms; ppc 2 rows (M = 32). sampler_plan carves the stage
//     plan's X, OUT, H, H2, QKV and S first, so R rows have full_kernel's
//     scratch at R rows: block 0 of a fpc evaluation stages the three A
//     parts of 24 products in the dead buffers and reads 6 value by value
//     (stage 0's 4-wide convs and wqkv, off the 16-wide k-step), a ppc one
//     stages all 30, and none lacks room (--staging). Registers: 128, with
//     400 bytes of spill stores and 1088 of loads in the code (full_kernel<
//     float>: 24 and 100); an evaluation takes 1.75 ms against full_kernel<
//     float>'s 1.45 at the same 8-row blocks, which bounds what the spills,
//     the init conv, the FiLM input and the update passes cost together.
//     Making the weights' and sizes' registers opaque each leg (so nothing
//     hoists out of the step loop) moved neither the spills nor the time.
//   * bf16: net_step<bf16, false>, the CUDA-core body, its arithmetic
//     unchanged: 422 / 470 ms against 619 / 656 at 256 threads (16 warps
//     where there were 8; the step kernel at 256 threads was also held to
//     80 registers and spilled). On the tensor cores (ddim_sampler_kernel<
//     bf16>'s body) it reads 148 / 153 ms but fails two of chip_smoke.py's
//     bf16 mean limits at ppc, relative to max|state|: over a 2-step
//     trajectory 1.3e-3 against TOL_BF16_EDM_STEP_MEAN = 6.9e-4, over 3
//     chained churn_step_kernel steps 3.5e-7 against
//     TOL_BF16_STEP_MEAN["churn"] = 2.4e-7 (fpc: 5.5e-4 and 1.3e-7, under
//     both). The limits sit a few times above a kernel whose float32 sums
//     run in the plain version's order: the CUDA-core convs and products
//     add one product an FMA in k order, as the plain version's float32
//     matmuls do, and read 2.7e-4 and 5.2e-8 at ppc. An mma.sync adds a
//     k-step's 16 products at once and truncates its sum into the
//     accumulator, so a bf16 activation near a rounding boundary rounds the
//     other way from the plain version more often. A fresh accumulator a
//     k-step, added by a float32 add, removes the truncation's bias (9.7e-4
//     and 2.5e-7 at ppc) but not the order, and costs ddim_sampler_kernel<
//     bf16> 1.8 % (76.28 ms against 74.90). So bf16 stays on the CUDA cores
//     until a check holds the tensor cores' order (ROADMAP.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// interface, loaded with ctypes; see graspldm_tpu_torch/cuda_build.py).
#include "sampler_body.cuh"

using namespace gl;

namespace {

template <typename T>
__global__ void __launch_bounds__(kTcThreads)
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
      const float* nout = net_step<T, kChurnTc<T>>(b, src, k[0], trow, R, L, E, Ce, G, Wf, net);
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
  return launch_tc_rows<T>(churn_sampler_kernel<T>, sampler_plan(L, cmax, E, Ce, G, 4), L, BG,
                           st, xT, embin, trowsA, trowsB, coefA, coefB, noise, (const T*)w, net,
                           out, BG, S, L, E, Ce, G, cmax, clamp);
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
