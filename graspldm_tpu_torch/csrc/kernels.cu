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
// ddim_sampler_kernel, stage_kernel and final_kernel (all in both dtypes)
// run their convs, projections and the attention's wqkv / wo products on
// the tensor cores (mma.sync.m16n8k16, float32 accumulators, 512 threads;
// tc_blocks.cuh):
// the block's R*L tokens are the product's M, A fragments come from the
// activations in shared memory through ldmatrix, B from a fragment-ordered
// bf16 copy of the weights made at packing time, found through the
// layout's tensor-core table (stage_kernel and final_kernel take the
// layout and their record's index for it). Their rounding points are the
// CUDA-core body's; only the order of the float32 sums differs. On the
// main path stage_kernel<bf16>
// runs the decoder's stages at L = 16, where its plan holds 10, 9, 7 and 6
// rows (M = 160, 144, 112 and 96 tokens: 5, 4.5, 3.5 and 3 warp units of
// 32 tokens, which go round the 16 warps); each product's staging copy
// fits the stage's dead QKV buffer. A decode's 4 launches at BG = 4096 take
// 2.61-2.63 ms against 9.62-9.66 on the CUDA cores (chip_smoke.py, H100
// 80GB HBM3, 700 W); the bound is 0.071 ms (bf16 peak).
// ddim_sampler_kernel<float> (the conditioned denoisers' DDIM / DDPM) runs
// full_kernel<float>'s body: the same products as six exact bf16 products
// each (the weights' and the activations' three-part split, tc_blocks.cuh),
// the function still the float32 one, in tc_rows_per_block's rows (8 at
// fpc, where the plan fits 9; 2 at ppc). 100 steps at fpc BG = 4096 / ppc
// BG = 1024 take 163.3 / 162.9 ms (on the CUDA cores at 256 threads:
// 429.0 / 332.4, chip_smoke.py); its error against sampler_plain reads
// 1.7e-6 / 1.3e-6. Against the sources with each decision undone
// (tools/kernel_variants.py, H100 80GB HBM3, 700.00 W): 9 rows at fpc
// 214.8 ms; the tensor-core body at 256 threads (its 8 warps, up to 255
// registers: 235 and no spill) 168.1 / 164.4, and 109.8 / 108.2 against
// 74.9 / 77.2 for the bf16 sampler; net_step not inlined 230.0 / 245.0.
// Registers: 128 with 304 bytes of spill stores and 844 of loads in the
// code (the float32 churn kernels: 400 and 1088); block 0 of a fpc
// evaluation stages the three A parts of 24 products in the dead buffers
// and reads 6 value by value (stage 0's 4-wide convs and wqkv, off the
// 16-wide k-step), a ppc one stages all 30, and none lacks room
// (--staging).
// final_kernel<bf16> (the decoder's final ResnetBlock and 1x1 head at
// L = 16, C = 256; one launch a decode) runs its two k3 convs through
// TcProducts, the head on the CUDA cores. It carves full_kernel's stage
// plan at width C: the QKV buffer, dead in the final block, holds each
// conv's staged A operand (M + 1 tokens of C + 8 values), and the plan fits
// 4 rows (M = 64: 2 warp units of 32 tokens by 16 column pairs, 2 units a
// warp). At BG = 4096 it takes 0.766 ms, 0.184 at 1021 (on the CUDA cores
// at 256 threads: 4.93; the bound 0.052 ms, bf16 peak), 100 registers, no
// spill, both convs staged (--staging). Against the sources with each
// decision undone (tools/kernel_variants.py, H100 80GB HBM3, 700.00 W):
// final_plan with staging room in OUT, 6 rows (M = 96, 3 units a warp;
// 683 blocks in 6 waves of 132 where 4 rows take 1024 in 8), 0.803 /
// 0.258 ms; final_plan's 8 rows with no room, A read value by value,
// 2.118 / 0.520 (2.124 / 0.514 again beside the float32 pair below).
// stage_kernel<float, true> and final_kernel<float, true>, every float32
// decode's 4 + 1 launches, run the same products through the exact bf16
// split (tc_blocks.cuh), the function still the float32 one. What bounds
// them is operations: the decoder's core is 29.77 MFLOP a row at L = 16,
// 2.96 ms at a fpc.vae call's 16,384 rows at the split's 164.8 TFLOP/s.
// At L = 16 the stage plans hold 5, 5, 4 and 3 rows (M = 80, 80, 64 and
// 48 tokens; at L = 4 16, 16, 16 and 12), rows_per_block's: cut to whole
// 32-token warp units (tc_rows_per_block: 4, 4, 4 and 2), a decode's 4
// stage launches at BG = 4096 read the same (3.853 ms against 3.863). The final
// block carves the stage plan at C = 256, 2 rows (M = 32; 8 at L = 4),
// whose QKV holds two of a conv's three staged A parts and OUT the third;
// final_plan's rows with A value by value read 2.864 ms against 1.473.
// Every product stages its A (7 a stage, 2 in the final block;
// --staging). 128 registers each; stage_kernel<float, true> spills 32
// bytes of stores and 68 of loads, final_kernel<float, true> none. At
// 16,384 rows a decode's 5 launches take 20.45-20.50 ms against
// 51.85-51.88 on the CUDA cores, and one full_kernel<float> launch on the
// same operands 22.73-22.76, its output bitwise equal to the chain's; per
// launch 1.97, 2.28, 3.29, 6.91 and 5.79 ms (CUDA cores 3.23, 4.15, 6.72,
// 17.73 and 20.01): stage 3 and the final block, which carry 81 % of the
// FLOPs, take 63 % of the time. Errors against stage_plain / final_plain read 1.1-2.0 x
// the CUDA-core instances' on the same operands (BG = 4096 and 1021).
// (H100 80GB HBM3, 700.00 W, CUDA events; the 4096-row readings by
// tools/kernel_variants.py.)
// stage_kernel<float, false> and final_kernel<float, false> keep the
// CUDA-core body (resnet1d_blocks.cuh: one vector load of a weight row
// reused over a 4-token register tile, fp32 FMAs; 256 threads,
// rows_per_block's rows of stage_plan and final_plan; 123 and 99
// registers, no spill): the CUDA-core control that every float32
// tensor-core kernel's split is held against (chip_smoke.py and the card
// tests, through gl_stage_forward_cuda_cores / gl_final_forward_cuda_cores);
// no main path launches them.
// Each resblock of the float32 tensor-core bodies runs its GroupNorms as
// one pass a warp a (row, group) (resnet1d_blocks.cuh: resblock_gn and
// gn_pass; 6 barriers a resblock where the two passes of each take 8, an
// evaluation's 119 down to 101; the outputs bitwise the two passes'). Against
// the two-pass body in one call (H100 80GB HBM3, 700.00 W, the lesser of two
// turns): the float32 DDIM sampler 159.2 against 163.3 ms at fpc BG 4096
// and 160.4 against 163.0 at ppc 1024, the float32 DPM++ 50.5 against 51.7
// and 50.8 against 51.6, the float32 churn sampler 343.8 against 345.3 and
// 344.7 against 353.9, the float32 decoder pair 3.81 + 1.46 ms either way.
// Registers 128, spill stores 168 bytes and loads 528 (304 and 844 with two
// passes: resblock_gn forms the weights' pointers where they are used).
// bf16 keeps the two passes (TcProducts<T>::kGn): one pass read the bf16
// DDIM sampler 77.4 against 74.3 ms at fpc and 76.4 against 76.7 at ppc.
// Every bf16 kernel and the float32 CUDA-core bodies compile to the same
// SASS as the two-pass resblock. A pair a warp reads ppc's 1024-value
// groups in 8 of the 16 warps, so two warps a pair (each the same
// statistics, half the apply) took the ppc sampler from 163.6 to 160.2 ms;
// the loops unrolled by 4 gain 0.2-0.3 % on the DDIM sampler and nothing
// on DPM++ (both are variants in tools/kernel_variants.py).
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

// stage `stage` of the network: record `stage` of the layout `net` and its
// entries of the tensor-core table. TC: the products on the tensor cores
// (float32 through the exact bf16 split), 512 threads; otherwise the
// CUDA-core body at 256 (the float32 control)
template <typename T, bool TC>
__global__ void __launch_bounds__(TC ? kTcThreads : kThreads)
stage_kernel(const T* __restrict__ x, const T* __restrict__ emb, const T* __restrict__ Wf,
             const long long* __restrict__ net, int stage, T* __restrict__ out, int BG, int L,
             int C, int Cout, int E, int Ce, int G, int R) {
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

// The final block's plan. TC carves full_kernel's stage plan at width C,
// whose QKV buffer, dead in the final block, holds each conv's staged A
// operand (float32: its three parts, those past QKV in OUT); the CUDA-core
// body keeps final_plan, with no such buffers
template <bool TC>
__host__ __device__ inline Plan final_tc_plan(int L, int C, int E, int G) {
  return TC ? stage_plan(L, C, C, E, G) : final_plan(L, C, E, G);
}

// the final resblock and the 1x1 head: record n_st of the layout `net`
// (the record after the n_st stages) and its entries of the tensor-core
// table; TC as stage_kernel
template <typename T, bool TC>
__global__ void __launch_bounds__(TC ? kTcThreads : kThreads)
final_kernel(const T* __restrict__ x, const T* __restrict__ emb, const T* __restrict__ Wf,
             const long long* __restrict__ net, int n_st, T* __restrict__ out, int BG, int L,
             int C, int E, int Ce, int G, int R) {
  extern __shared__ __align__(16) char smem[];
  const Bufs<T> b = carve<T>(smem, final_tc_plan<TC>(L, C, E, G), R);
  const long long* rec = net + NET_HDR + n_st * REC_SIZE;
  const int row0 = blockIdx.x * R;
  const int W = L * C;
  for (int idx = threadIdx.x; idx < R * W; idx += blockDim.x) {
    const int r = idx / W;
    b.X[idx] = row0 + r < BG ? x[(size_t)row0 * W + idx] : from_f<T>(0.f);
  }
  emb_sum_rows(emb, b.ESUM, row0, R, BG, E, Ce);
  __syncthreads();
  resblock(b, b.X, R, L, C, E, Ce, G, Wf, rec + R_RES1,
           piece_products<T, TC>(b, b.OUT, Wf, net, n_st * TC_REC + T_R1, PIECE_RES));
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
__global__ void __launch_bounds__(kTcThreads)
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
    const float* eps =
        net_step<T, true>(b, b.XC, 1.0f, trows + (size_t)s * CeE, R, L, E, Ce, G, Wf, net);
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

// rows_per_block's rows in every instance: the float32 tensor-core stages
// read the same in tc_rows_per_block's (see the notes at the top)
template <typename T, bool TC>
int launch_stage(const void* x, const void* emb, const void* w, const long long* net, int stage,
                 void* out, int BG, int L, int C, int Cout, int E, int Ce, int G,
                 cudaStream_t st) {
  return launch_rows<T, TC ? kTcThreads : kThreads>(
      stage_kernel<T, TC>, stage_plan(L, C, Cout, E, G), BG, st, (const T*)x, (const T*)emb,
      (const T*)w, net, stage, (T*)out, BG, L, C, Cout, E, Ce, G);
}

template <typename T, bool TC>
int launch_final(const void* x, const void* emb, const void* w, const long long* net, int n_st,
                 void* out, int BG, int L, int C, int E, int Ce, int G, cudaStream_t st) {
  const Plan p = final_tc_plan<TC>(L, C, E, G);
  if constexpr (TC)
    return launch_tc_rows<T>(final_kernel<T, TC>, p, L, BG, st, (const T*)x, (const T*)emb,
                             (const T*)w, net, n_st, (T*)out, BG, L, C, E, Ce, G);
  else
    return launch_rows<T>(final_kernel<T, TC>, p, BG, st, (const T*)x, (const T*)emb,
                          (const T*)w, net, n_st, (T*)out, BG, L, C, E, Ce, G);
}

template <typename T>
int launch_ddim(const float* xT, const float* embin, const float* trows, const float* coefs,
                const float* noise, const void* w, const long long* net, float* out, int BG,
                int S, int L, int E, int Ce, int G, int cmax, int clip, float clip_range,
                cudaStream_t st) {
  return launch_tc_rows<T>(ddim_sampler_kernel<T>, sampler_plan(L, cmax, E, Ce, G, 1), L, BG, st,
                           xT, embin, trows, coefs, noise, (const T*)w, net, out, BG, S, L, E, Ce,
                           G, cmax, clip, clip_range);
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
    return launch_stage<float, true>(x, emb, w, net, stage, out, BG, L, C, Cout, E, Ce, G, st);
  return launch_stage<__nv_bfloat16, true>(x, emb, w, net, stage, out, BG, L, C, Cout, E, Ce,
                                           G, st);
}

int gl_final_forward(int dtype, const void* x, const void* emb, const void* w,
                     const long long* net, int n_st, void* out, int BG, int L, int C, int E,
                     int Ce, int G, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_final<float, true>(x, emb, w, net, n_st, out, BG, L, C, E, Ce, G, st);
  return launch_final<__nv_bfloat16, true>(x, emb, w, net, n_st, out, BG, L, C, E, Ce, G, st);
}

// The float32 CUDA-core control of the two (no main path launches it): the
// same arguments, float32 only
int gl_stage_forward_cuda_cores(const void* x, const void* emb, const void* w,
                                const long long* net, int stage, void* out, int BG, int L, int C,
                                int Cout, int E, int Ce, int G, void* stream) {
  return launch_stage<float, false>(x, emb, w, net, stage, out, BG, L, C, Cout, E, Ce, G,
                                    (cudaStream_t)stream);
}

int gl_final_forward_cuda_cores(const void* x, const void* emb, const void* w,
                                const long long* net, int n_st, void* out, int BG, int L, int C,
                                int E, int Ce, int G, void* stream) {
  return launch_final<float, false>(x, emb, w, net, n_st, out, BG, L, C, E, Ce, G,
                                    (cudaStream_t)stream);
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
