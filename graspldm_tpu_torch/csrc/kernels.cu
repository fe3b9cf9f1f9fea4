// Hand-written Hopper kernels of the LDM generation path:
//
//   stage_kernel         replaces graspldm_tpu/models/stacked_pallas.py:_stage_kernel
//   final_kernel         replaces graspldm_tpu/models/stacked_pallas.py:_final_kernel
//   ddim_sampler_kernel  replaces graspldm_tpu/models/pallas_sampler.py:_mega_kernel
//
// (The EDM sampler kernels are in dpmpp_sampler.cu and churn_sampler.cu;
// each source builds into its own library, all in parallel.)
//
// What bounds them on the H100: the network is ~0.9 M parameters (3.6 MB
// fp32) applied to tiny per-row activations (<= 4096 values at L=16), so
// the work is many small dependent products whose weights do not fit in
// shared memory. The design keeps every activation of R rows resident in
// shared memory for the whole stage (or, in the sampler, the whole
// trajectory: no activation ever goes to device memory between ops or
// steps), and reads each weight once per R rows.
//
// The bf16 ddim_sampler_kernel and the bf16 stage_kernel run their convs,
// projections and the attention's wqkv / wo products on the tensor cores
// (mma.sync.m16n8k16, float32 accumulators, 512 threads; tc_blocks.cuh):
// the block's R*L tokens are the product's M, A fragments come from the
// activations in shared memory through ldmatrix, B from a fragment-ordered
// bf16 copy of the weights made at packing time, found through the
// layout's tensor-core table (stage_kernel takes the layout and its stage
// index for it). Their rounding points are the CUDA-core body's; only the
// order of the float32 sums differs. On the main path stage_kernel<bf16>
// runs the decoder's stages at L = 16, where its plan holds 10, 9, 7 and 6
// rows (M = 160, 144, 112 and 96 tokens: 5, 4.5, 3.5 and 3 warp units of
// 32 tokens, which go round the 16 warps); each product's staging copy
// fits the stage's dead QKV buffer. A decode's 4 launches at BG = 4096 take
// 2.61-2.63 ms against 9.62-9.66 on the CUDA cores (chip_smoke.py, H100
// 80GB HBM3, 700 W); the bound is 0.071 ms (bf16 peak).
// final_kernel and the float32 stage_kernel and sampler keep the CUDA-core
// body (resnet1d_blocks.cuh: one vector load of a weight row reused over a
// 4-token register tile, fp32 FMAs); the float32 stage chain is the
// CUDA-core control of full_kernel<float>'s exact bf16 split (full_net.cu).
// wgmma and TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// interface, loaded with ctypes; see graspldm_tpu_torch/cuda_build.py).
#include "sampler_body.cuh"

using namespace gl;

namespace {

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// stage `stage` of the network: record `stage` of the layout `net` and, for
// bf16, its entries of the tensor-core table
template <typename T>
__global__ void __launch_bounds__(sizeof(T) == 2 ? kTcThreads : kThreads)
stage_kernel(const T* __restrict__ x, const T* __restrict__ emb, const T* __restrict__ Wf,
             const long long* __restrict__ net, int stage, T* __restrict__ out, int BG, int L,
             int C, int Cout, int E, int Ce, int G, int R) {
  constexpr bool TC = sizeof(T) == 2;
  extern __shared__ __align__(16) char smem[];
  const Bufs<T> b = carve<T>(smem, stage_plan(L, C, Cout, E, G), R);
  const long long* rec = net + NET_HDR + stage * REC_SIZE;
  const int row0 = blockIdx.x * R, tc = stage * TC_REC;
  const int W = L * C;
  for (int idx = threadIdx.x; idx < R * W; idx += blockDim.x) {
    const int r = idx / W;
    b.X[idx] = row0 + r < BG ? x[(size_t)row0 * W + idx] : from_f<T>(0.f);
  }
  emb_sum_rows(emb, b.ESUM, row0, R, BG, E, Ce);
  __syncthreads();
  resblock(b, b.X, R, L, C, E, Ce, G, Wf, rec + R_RES1,
           piece_products<T, TC>(b, b.OUT, Wf, net, tc + T_R1, PIECE_RES));
  resblock(b, b.X, R, L, C, E, Ce, G, Wf, rec + R_RES2,
           piece_products<T, TC>(b, b.OUT, Wf, net, tc + T_R2, PIECE_RES));
  attention(b, b.X, R, L, C, Wf, rec,
            piece_products<T, TC>(b, b.OUT, Wf, net, tc + T_ATTN, PIECE_ATTN));
  proj(b.X, b.OUT, R, L, C, Cout, Wf, rec,
       piece_products<T, TC>(b, b.OUT, Wf, net, tc + T_PROJ, PIECE_PROJ));
  const int Wo = L * Cout;
  for (int idx = threadIdx.x; idx < R * Wo; idx += blockDim.x)
    if (row0 + idx / Wo < BG) out[(size_t)row0 * Wo + idx] = b.OUT[idx];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
final_kernel(const T* __restrict__ x, const T* __restrict__ emb, const T* __restrict__ Wf,
             const long long* __restrict__ rec, T* __restrict__ out, int BG, int L, int C,
             int E, int Ce, int G, int R) {
  extern __shared__ __align__(16) char smem[];
  const Bufs<T> b = carve<T>(smem, final_plan(L, C, E, G), R);
  const int row0 = blockIdx.x * R;
  const int W = L * C;
  for (int idx = threadIdx.x; idx < R * W; idx += blockDim.x) {
    const int r = idx / W;
    b.X[idx] = row0 + r < BG ? x[(size_t)row0 * W + idx] : from_f<T>(0.f);
  }
  emb_sum_rows(emb, b.ESUM, row0, R, BG, E, Ce);
  __syncthreads();
  resblock(b, b.X, R, L, C, E, Ce, G, Wf, rec + R_RES1);
  head(b.X, R * L, C, Wf, rec, [&](int m, float v) {
    if (row0 + m / L < BG) out[(size_t)row0 * L + m] = from_f<T>(v);
  });
}

// Whole DDIM / DDPM reverse diffusion for R rows in one launch: the carry x
// (fp32), the conditioning embedding and every activation stay in shared
// memory across all S steps. Per step s (net_step in sampler_body.cuh):
//   emb = silu(embin + trows[s]) (rounded to T), eps = net(x),
//   x0 = clip(c0*x - c1*eps);  ddim: x = c2*x + c3*x0
//                              ddpm: x = c2*x0 + c3*x + c4*noise[s]
template <typename T>
__global__ void __launch_bounds__(sizeof(T) == 2 ? kTcThreads : kThreads)
ddim_sampler_kernel(const float* __restrict__ xT, const float* __restrict__ embin,
                    const float* __restrict__ trows, const float* __restrict__ coefs,
                    const float* __restrict__ noise, const T* __restrict__ Wf,
                    const long long* __restrict__ net, float* __restrict__ out, int BG, int S,
                    int L, int E, int Ce, int G, int cmax, int clip, float clip_range, int R) {
  extern __shared__ __align__(16) char smem[];
  const Bufs<T> b = carve<T>(smem, sampler_plan(L, cmax, E, Ce, G, 1), R);
  const int row0 = blockIdx.x * R;
  const int CeE = Ce * E;
  load_sampler_rows(b, xT, embin, row0, R, BG, L, CeE);
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const float* eps = net_step<T, sizeof(T) == 2>(b, b.XC, 1.0f, trows + (size_t)s * CeE, R, L,
                                                   E, Ce, G, Wf, net);
    const float* c = coefs + (size_t)s * 8;
    for (int idx = threadIdx.x; idx < R * L; idx += blockDim.x) {
      const float xt = b.XC[idx];
      float x0 = c[0] * xt - c[1] * eps[idx];
      if (clip) x0 = fminf(fmaxf(x0, -clip_range), clip_range);
      if (noise == nullptr) {
        b.XC[idx] = c[2] * xt + c[3] * x0;
      } else {
        const float nz = row0 + idx / L < BG ? noise[((size_t)s * BG + row0) * L + idx] : 0.f;
        b.XC[idx] = c[2] * x0 + c[3] * xt + c[4] * nz;
      }
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < R * L; idx += blockDim.x)
    if (row0 + idx / L < BG) out[(size_t)row0 * L + idx] = b.XC[idx];
}

template <typename T>
int launch_stage(const void* x, const void* emb, const void* w, const long long* net, int stage,
                 void* out, int BG, int L, int C, int Cout, int E, int Ce, int G,
                 cudaStream_t st) {
  return launch_rows<T, sizeof(T) == 2 ? kTcThreads : kThreads>(
      stage_kernel<T>, stage_plan(L, C, Cout, E, G), BG, st, (const T*)x, (const T*)emb,
      (const T*)w, net, stage, (T*)out, BG, L, C, Cout, E, Ce, G);
}

template <typename T>
int launch_final(const void* x, const void* emb, const void* w, const long long* rec, void* out,
                 int BG, int L, int C, int E, int Ce, int G, cudaStream_t st) {
  return launch_rows<T>(final_kernel<T>, final_plan(L, C, E, G), BG, st, (const T*)x,
                        (const T*)emb, (const T*)w, rec, (T*)out, BG, L, C, E, Ce, G);
}

template <typename T>
int launch_ddim(const float* xT, const float* embin, const float* trows, const float* coefs,
                const float* noise, const void* w, const long long* net, float* out, int BG,
                int S, int L, int E, int Ce, int G, int cmax, int clip, float clip_range,
                cudaStream_t st) {
  return launch_rows<T, sizeof(T) == 2 ? kTcThreads : kThreads>(
      ddim_sampler_kernel<T>, sampler_plan(L, cmax, E, Ce, G, 1), BG, st, xT,
                        embin, trows, coefs, noise, (const T*)w, net, out, BG, S, L, E, Ce, G,
                        cmax, clip, clip_range);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16. Each returns the
// cudaError_t of the launch (0 = launched).
// ---------------------------------------------------------------------------
extern "C" {

int gl_stage_forward(int dtype, const void* x, const void* emb, const void* w,
                     const long long* net, int stage, void* out, int BG, int L, int C, int Cout,
                     int E, int Ce, int G, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_stage<float>(x, emb, w, net, stage, out, BG, L, C, Cout, E, Ce, G, st);
  return launch_stage<__nv_bfloat16>(x, emb, w, net, stage, out, BG, L, C, Cout, E, Ce, G, st);
}

int gl_final_forward(int dtype, const void* x, const void* emb, const void* w,
                     const long long* rec, void* out, int BG, int L, int C, int E, int Ce, int G,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_final<float>(x, emb, w, rec, out, BG, L, C, E, Ce, G, st);
  return launch_final<__nv_bfloat16>(x, emb, w, rec, out, BG, L, C, E, Ce, G, st);
}

int gl_ddim_sample(int dtype, const float* xT, const float* embin, const float* trows,
                   const float* coefs, const float* noise, const void* w, const long long* net,
                   float* out, int BG, int S, int L, int E, int Ce, int G, int cmax, int clip,
                   float clip_range, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_ddim<float>(xT, embin, trows, coefs, noise, w, net, out, BG, S, L, E, Ce, G,
                              cmax, clip, clip_range, st);
  return launch_ddim<__nv_bfloat16>(xT, embin, trows, coefs, noise, w, net, out, BG, S, L, E,
                                    Ce, G, cmax, clip, clip_range, st);
}

}  // extern "C"
