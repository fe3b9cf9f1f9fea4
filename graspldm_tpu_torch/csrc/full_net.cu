// full_kernel: the whole conditional ResNet1D core in one launch.
//
//   full_kernel  replaces graspldm_tpu/models/stacked_pallas.py:_full_kernel
//                (the fuse_stages=True lowering of
//                stacked_denoiser_pallas_apply)
//
// What it computes, for each row: from X, the init conv's output [L, dim0]
// in the compute type T, and the FiLM input emb [Ce*E] (T), every network
// stage (2 ResnetBlocks, residual linear attention, k3 projection), the
// final ResnetBlock and the 1x1 head, written as [L] in T. It is the chain
// of stage_kernel launches and final_kernel (kernels.cu) in one launch, and
// net_body, the network of the sampler kernels' net_step
// (sampler_body.cuh), without the time row: the guided samplers call it
// once per denoiser evaluation with a per-row time embedding already
// folded into emb.
//
// What bounds it on the H100: operations. One evaluation is ~7.3 MFLOP per
// row at L = 4 (29.7 GFLOP at BG = 4096) over ~0.9 M weights. Both
// instances run net_body on the tensor cores (tc_blocks.cuh), 512 threads:
//   * bf16: the convs, projections and wqkv / wo as bf16 mma.sync, the
//     body of ddim_sampler_kernel<bf16>; bound 0.0301 ms at fpc BG 4096 on
//     the bf16 peak.
//   * float32 (the conditioned denoisers' and the class CFG call's): the
//     same products as six exact bf16 products each (the weights' and the
//     activations' three-part split), the function still the float32 one.
//     Its bound is the least over the two ways the card can compute it:
//     every product as float32 FMAs (0.444 ms at 4096), or the tensor-core
//     products at six times their bf16 work with the rest as FMAs (0.178
//     ms at 4096, 0.357 at the CFG's 8192 rows).
// The design keeps every activation of a block's R rows in shared memory
// from the first stage to the head (the chain writes and reads them
// through device memory between its 5 launches) and reads each weight
// once per R rows through L1/L2. R is the most rows whose buffers, sized
// for the widest stage, fit the shared-memory budget, cut to a whole
// number of 32-token warp units (two m-tiles; tc_rows_per_block in
// sampler_body.cuh, which the churn kernels share): float32 at fpc fits 9 rows
// (25 KB each), and the ninth row's tokens would take a second unit a
// warp alone, so it runs 8; the ragged last block is masked here, not
// padded by the caller. A float32 activation staged for a product takes
// three bf16 parts, ~3 x (M + 1)(Ck + 8) values, more than the dead QKV
// buffer holds at Ck = 256 (the final resblock): the parts that do not fit
// go to the second dead buffer of the piece (tc_blocks.cuh,
// piece_products), so every k-step reads all three parts and each weight
// part once. Eight rows against nine (the sources with 9 rows, H100 80GB
// HBM3, 700.00 W): 2.91 ms against 3.36 at the class CFG's fpc BG = 8192,
// 1.45 against 1.92 at 4096 (ppc fits 2 rows, 32 tokens, either way). The
// other decisions of the body, with their ms, are in tc_blocks.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// interface, loaded with ctypes; see graspldm_tpu_torch/cuda_build.py).
#include "sampler_body.cuh"

using namespace gl;

namespace {

// buffers of a whole network pass, sized for the widest stage (cmax); no
// carry vectors and no pre-silu embedding rows
__host__ __device__ inline Plan full_plan(int L, int cmax, int E, int G) {
  return stage_plan(L, cmax, cmax, E, G);
}

template <typename T>
__global__ void __launch_bounds__(kTcThreads)
full_kernel(const T* __restrict__ x, const T* __restrict__ emb, const T* __restrict__ Wf,
            const long long* __restrict__ net, T* __restrict__ out, int BG, int L, int E,
            int Ce, int G, int cmax, int R) {
  extern __shared__ __align__(16) char smem[];
  const Bufs<T> b = carve<T>(smem, full_plan(L, cmax, E, G), R);
  const int row0 = blockIdx.x * R;
  const int W = L * (int)net[N_DIM0];
  for (int idx = threadIdx.x; idx < R * W; idx += blockDim.x)
    b.X[idx] = row0 + idx / W < BG ? x[(size_t)row0 * W + idx] : from_f<T>(0.f);
  emb_sum_rows(emb, b.ESUM, row0, R, BG, E, Ce);
  __syncthreads();
  net_body<T, true>(b, (int)net[N_NSTAGES], R, L, E, Ce, G, Wf, net, [&](int m, float v) {
    if (row0 + m / L < BG) out[(size_t)row0 * L + m] = from_f<T>(v);
  });
}

template <typename T>
int launch_full(const void* x, const void* emb, const void* w, const long long* net, void* out,
                int BG, int L, int E, int Ce, int G, int cmax, cudaStream_t st) {
  return launch_tc_rows<T>(full_kernel<T>, full_plan(L, cmax, E, G), L, BG, st, (const T*)x,
                           (const T*)emb, (const T*)w, net, (T*)out, BG, L, E, Ce, G, cmax);
}

}  // namespace

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int gl_full_forward(int dtype, const void* x, const void* emb, const void* w,
                               const long long* net, void* out, int BG, int L, int E, int Ce,
                               int G, int cmax, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_full<float>(x, emb, w, net, out, BG, L, E, Ce, G, cmax, st);
  return launch_full<__nv_bfloat16>(x, emb, w, net, out, BG, L, E, Ce, G, cmax, st);
}
