// Per-step sampler kernels of the trajectory path (ldm_generate with
// return_trajectory): one launch computes one step of one sampler for every
// row, reading the fp32 state from device memory and writing the next state
// back, so the host can keep every intermediate state.
//
//   ddim_step_kernel   replaces graspldm_tpu/models/pallas_sampler.py:
//                      _full_step_kernel (:156) and the chain _stage0_kernel
//                      (:79) -> _mid_stage_kernel (:94) x 3 -> _final_step_kernel
//                      (:181)  (DDIM / DDPM)
//   dpmpp_step_kernel  replaces _full_dpmpp_kernel (:270) and the chain
//                      _stage0_dpmpp_kernel (:210) -> _mid_stage_kernel x 3 ->
//                      _final_dpmpp_kernel (:253)  (EDM DPM-Solver++(2M))
//   churn_step_kernel  replaces _full_churn_kernel (:441) and the two chains
//                      _stage0_churn_a_kernel (:320) -> _mid_stage_kernel x 3 ->
//                      _final_churn_a_kernel (:358), then _stage0_dpmpp_kernel ->
//                      _mid_stage_kernel x 3 -> _final_churn_b_kernel (:399)
//                      (EDM stochastic churn with the Heun correction)
//
// One kernel per sampler where the TPU has a chain: the TPU splits a step
// into n_stages + 1 launches at L = 4 and many rows only because the
// whole-network launch lost ~10 % on v5e there (pallas_sampler.py:773-780);
// the split computes the same step. Here a block's rows keep every activation
// of the whole network in shared memory, so a chain would only add device
// memory round trips of the [BG, L*C] activations between launches.
//
// What bounds them on the H100: operations, as for the whole-trajectory
// kernels. One launch is one network evaluation per row (two for churn);
// the weights (1.8 MB bf16 / 3.6 MB fp32 at fpc) are re-read once per block
// through L1/L2 in every launch, and the state in and out is 16-64 B per row.
//
// Design: the block plan, the step body and the launch of the matching
// whole-trajectory kernel (sampler_plan with the same carry count, net_step
// in sampler_body.cuh), so a block holds the same rows and computes the same
// arithmetic; only the fp32 carry goes through device memory between steps
// (exactly: it is fp32 on both sides). All but dpmpp_step_kernel, which
// runs the CUDA-core body at 256 threads (16 bf16 / 9 fp32 rows at fpc, 4 /
// 2 at ppc) where its twin dpmpp_sampler_kernel runs 512 threads,
// tc_rows_per_block's rows and, in float32, the tensor cores (kDpmppTc):
// the same function, its float32 sums in another order (the step kernel is
// next in ROADMAP.md's queue). ddim_step_kernel and churn_step_kernel run
// their network on the tensor cores in float32, through the exact bf16
// split, and on the CUDA cores in bf16 (kDdimStepTc, kChurnTc in
// sampler_body.cuh), at 512 threads and tc_rows_per_block's rows (16 bf16
// / 8 fp32 at fpc, 4 / 2 at ppc). churn_step_kernel: one launch at step
// 50 of 100 takes 3.34 / 3.32 ms in float32 and 4.31 / 4.77 in bf16 at fpc
// BG = 4096 / ppc BG = 1024
// (bf16 at 256 threads: 6.30 / 6.71); churn_sampler.cu gives the decisions.
// ddim_step_kernel, against the sources with each decision undone
// (H100 80GB HBM3, 700.00 W; step 50 of 100, the
// operands of chip_smoke.py's step-kernel phase):
//   * float32: ddim_sampler_kernel<float>'s body and rows (kernels.cu), so
//     its launches are bitwise that kernel's steps: 1.523 / 1.555 ms (on
//     the CUDA cores at 256 threads: 4.044 / 3.088, chip_smoke.py); 9 rows
//     at fpc 1.956, the tensor-core body at 256 threads 1.711 / 1.679,
//     net_step not inlined 1.747 / 1.795. 128 registers, 60 bytes of spill
//     stores. The mean error of its first 3 steps reads 8.3e-9 of
//     max(1, max|x|).
//   * bf16: the CUDA-core body, its arithmetic unchanged, 2.092 / 2.305 ms
//     against 3.075 / 3.240 at 256 threads (113 registers and no spill,
//     where 256 threads held it to 80 and spilled 64 bytes). On the tensor
//     cores (ddim_sampler_kernel<bf16>'s body, whose launches it would
//     match bitwise) it reads 0.798 / 0.794 ms but fails chip_smoke.py's
//     TOL_BF16_STEP_MEAN["ddim"] (2^-19 = 1.9e-6 of max(1, max|x|), the
//     mean over the first 3 chained steps) at ppc: 3.68e-6 at BG = 1024
//     and 3.69e-6 at 1021, where the CUDA-core kernel reads 4.2e-7 and
//     4.6e-7 (fpc: 1.26e-6 and 1.45e-6, under it; the CUDA-core kernel
//     7.8e-8 and 1.1e-7). The same summation order as churn's
//     (churn_sampler.cu): the limit sits a few times above a kernel whose
//     float32 sums run in the plain version's order. So bf16 stays on the
//     CUDA cores until a check holds the tensor cores' order (ROADMAP.md).
//
// Each update is a copy of the one in its whole-trajectory twin, named at the
// update; the twins are left as they are, because their times moved by whole
// percents with small edits near the shared step body (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// interface, loaded with ctypes; see graspldm_tpu_torch/cuda_build.py).
#include "sampler_body.cuh"

using namespace gl;

namespace {

// One DDIM / DDPM step for R rows: x [BG, L] -> out [BG, L] (fp32), with the
// step's time row trow [Ce*E] and coefficient row c [8]:
//   eps = net(x);  x0 = clip(c0*x - c1*eps)
//   ddim: out = c2*x + c3*x0;   ddpm: out = c2*x0 + c3*x + c4*noise
template <typename T>
__global__ void __launch_bounds__(kTcThreads)
ddim_step_kernel(const float* __restrict__ x, const float* __restrict__ embin,
                 const float* __restrict__ trow, const float* __restrict__ c,
                 const float* __restrict__ noise, const T* __restrict__ Wf,
                 const long long* __restrict__ net, float* __restrict__ out, int BG, int L,
                 int E, int Ce, int G, int cmax, int clip, float clip_range, int R) {
  extern __shared__ __align__(16) char smem[];
  const Bufs<T> b = carve<T>(smem, sampler_plan(L, cmax, E, Ce, G, 1), R);
  const int row0 = blockIdx.x * R;
  load_sampler_rows(b, x, embin, row0, R, BG, L, Ce * E);
  __syncthreads();
  const float* eps = net_step<T, kDdimStepTc<T>>(b, b.XC, 1.0f, trow, R, L, E, Ce, G, Wf, net);
  // the update of ddim_sampler_kernel (kernels.cu), its twin
  for (int idx = threadIdx.x; idx < R * L; idx += blockDim.x) {
    if (row0 + idx / L >= BG) continue;
    const size_t g = (size_t)row0 * L + idx;
    const float xt = b.XC[idx];
    float x0 = c[0] * xt - c[1] * eps[idx];
    if (clip) x0 = fminf(fmaxf(x0, -clip_range), clip_range);
    if (noise == nullptr) {
      out[g] = c[2] * xt + c[3] * x0;
    } else {
      out[g] = c[2] * x0 + c[3] * xt + c[4] * noise[g];
    }
  }
}

// One DPM-Solver++(2M) step for R rows, with c = [c_in, c_skip, c_out, g1,
// g2, ratio, em1, 0] at sigma_s and old the previous denoised estimate (zeros
// at the first step):
//   net = net_T(round_T(c_in * x));  den = c_skip*x + c_out*net  (clamped)
//   x_new = ratio*x - em1*(g1*den + g2*old);  den_out = den
template <typename T>
__global__ void __launch_bounds__(kThreads)
dpmpp_step_kernel(const float* __restrict__ x, const float* __restrict__ old,
                  const float* __restrict__ embin, const float* __restrict__ trow,
                  const float* __restrict__ c, const T* __restrict__ Wf,
                  const long long* __restrict__ net, float* __restrict__ x_new,
                  float* __restrict__ den_out, int BG, int L, int E, int Ce, int G, int cmax,
                  int clamp, int R) {
  extern __shared__ __align__(16) char smem[];
  const Bufs<T> b = carve<T>(smem, sampler_plan(L, cmax, E, Ce, G, 2), R);
  const int row0 = blockIdx.x * R;
  float* X = b.XC;
  load_sampler_rows(b, x, embin, row0, R, BG, L, Ce * E);
  __syncthreads();
  const float* nout = net_step(b, X, c[0], trow, R, L, E, Ce, G, Wf, net);
  // the update of dpmpp_sampler_kernel (dpmpp_sampler.cu), its twin
  for (int idx = threadIdx.x; idx < R * L; idx += blockDim.x) {
    if (row0 + idx / L >= BG) continue;
    const size_t g = (size_t)row0 * L + idx;
    const float xv = X[idx];
    float den = c[1] * xv + c[2] * nout[idx];
    if (clamp) den = fminf(fmaxf(den, -1.f), 1.f);
    x_new[g] = c[5] * xv - c[6] * (c[3] * den + c[4] * old[g]);
    den_out[g] = den;
  }
}

// One churn step (both legs) for R rows, with a = coefA row [cinA, cskipA,
// coutA, s_eps, dsc, inv_sh, 0, 0] and c = coefB row [cinB, cskipB, coutB,
// s_eps, hh, inv_sn, sel, 0] (the math of churn_sampler_kernel, whose source
// comment derives it):
//   x_hat = x + s_eps*noise;  denA from net(cinA*x_hat) (trowA)
//   d = (x_hat - denA)*inv_sh;  x_eul = x_hat + dsc*d
//   denB from net(cinB*x_eul) (trowB);  d' = (x_eul - denB)*inv_sn
//   out = sel*(x_hat + hh*(d + d')) + (1 - sel)*x_eul
// At the last step sigma_next = 0 and sel = 0 selects x_eul by
// multiplication, as the TPU kernel does; the second leg runs anyway.
template <typename T>
__global__ void __launch_bounds__(kTcThreads)
churn_step_kernel(const float* __restrict__ x, const float* __restrict__ noise,
                  const float* __restrict__ embin, const float* __restrict__ trowA,
                  const float* __restrict__ trowB, const float* __restrict__ a,
                  const float* __restrict__ c, const T* __restrict__ Wf,
                  const long long* __restrict__ net, float* __restrict__ out, int BG, int L,
                  int E, int Ce, int G, int cmax, int clamp, int R) {
  extern __shared__ __align__(16) char smem[];
  const Bufs<T> b = carve<T>(smem, sampler_plan(L, cmax, E, Ce, G, 4), R);
  const int row0 = blockIdx.x * R;
  const int RL = R * L;
  float* X = b.XC;
  float* XH = b.XC + RL;      // x_hat
  float* XE = b.XC + 2 * RL;  // x_eul
  float* D = b.XC + 3 * RL;   // d
  load_sampler_rows(b, x, embin, row0, R, BG, L, Ce * E);
  __syncthreads();
  // from here to the store, the step body of churn_sampler_kernel
  // (churn_sampler.cu), its twin
  for (int idx = threadIdx.x; idx < RL; idx += blockDim.x) {
    const float nz = row0 + idx / L < BG ? noise[(size_t)row0 * L + idx] : 0.f;
    XH[idx] = X[idx] + a[3] * nz;
  }
  __syncthreads();
  for (int leg = 0; leg < 2; ++leg) {
    const float* k = leg ? c : a;
    const float* src = leg ? XE : XH;
    const float* nout =
        net_step<T, kChurnTc<T>>(b, src, k[0], leg ? trowB : trowA, R, L, E, Ce, G, Wf, net);
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
  for (int idx = threadIdx.x; idx < RL; idx += blockDim.x)
    if (row0 + idx / L < BG) out[(size_t)row0 * L + idx] = X[idx];
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16. Each returns the
// cudaError_t of the launch (0 = launched).
// ---------------------------------------------------------------------------
extern "C" {

int gl_ddim_step(int dtype, const float* x, const float* embin, const float* trow,
                 const float* coef, const float* noise, const void* w, const long long* net,
                 float* out, int BG, int L, int E, int Ce, int G, int cmax, int clip,
                 float clip_range, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Plan p = sampler_plan(L, cmax, E, Ce, G, 1);
  if (dtype == 0)
    return launch_tc_rows<float>(
        ddim_step_kernel<float>, p, L, BG, st, x, embin, trow, coef, noise, (const float*)w, net,
        out, BG, L, E, Ce, G, cmax, clip, clip_range);
  return launch_tc_rows<__nv_bfloat16>(
      ddim_step_kernel<__nv_bfloat16>, p, L, BG, st, x, embin, trow, coef, noise,
      (const __nv_bfloat16*)w, net, out, BG, L, E, Ce, G, cmax, clip, clip_range);
}

int gl_dpmpp_step(int dtype, const float* x, const float* old, const float* embin,
                  const float* trow, const float* coef, const void* w, const long long* net,
                  float* x_new, float* den, int BG, int L, int E, int Ce, int G, int cmax,
                  int clamp, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_rows<float>(dpmpp_step_kernel<float>, sampler_plan(L, cmax, E, Ce, G, 2), BG,
                              st, x, old, embin, trow, coef, (const float*)w, net, x_new, den,
                              BG, L, E, Ce, G, cmax, clamp);
  return launch_rows<__nv_bfloat16>(dpmpp_step_kernel<__nv_bfloat16>,
                                    sampler_plan(L, cmax, E, Ce, G, 2), BG, st, x, old, embin,
                                    trow, coef, (const __nv_bfloat16*)w, net, x_new, den, BG, L,
                                    E, Ce, G, cmax, clamp);
}

int gl_churn_step(int dtype, const float* x, const float* noise, const float* embin,
                  const float* trowA, const float* trowB, const float* coefA,
                  const float* coefB, const void* w, const long long* net, float* out, int BG,
                  int L, int E, int Ce, int G, int cmax, int clamp, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Plan p = sampler_plan(L, cmax, E, Ce, G, 4);
  if (dtype == 0)
    return launch_tc_rows<float>(
        churn_step_kernel<float>, p, L, BG, st, x, noise, embin, trowA, trowB, coefA, coefB,
        (const float*)w, net, out, BG, L, E, Ce, G, cmax, clamp);
  return launch_tc_rows<__nv_bfloat16>(
      churn_step_kernel<__nv_bfloat16>, p, L, BG, st, x, noise, embin, trowA, trowB, coefA, coefB,
      (const __nv_bfloat16*)w, net, out, BG, L, E, Ce, G, cmax, clamp);
}

}  // extern "C"
