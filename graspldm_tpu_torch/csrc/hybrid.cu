// Hybrid kernels of the route with attention between launches
// (stacked_cuda.XLA_ATTENTION, L > 4):
//
//   hybrid_stage_kernel  replaces graspldm_tpu/models/stacked_pallas.py:_hybrid_stage_kernel
//   hybrid_final_kernel  replaces graspldm_tpu/models/stacked_pallas.py:_hybrid_final_kernel
//
// The route splits the network at its attentions, which run in plain
// PyTorch between the launches (stacked_denoiser.attention_stacked), so
// each kernel starts where an attention ended:
//   * hybrid stage i: for i > 0 the k3 projection of stage i - 1
//     ([L, C_{i-1}] -> [L, C_i]), then stage i's two ResnetBlocks; it
//     stores [R, L*C_i] and stops before stage i's attention;
//   * hybrid final: the last stage's projection, the final ResnetBlock
//     and the 1x1 head, stored as [R, L].
// Both read their weights from the same PackedNet records as stage_kernel
// (kernels.cu): the projection from record i - 1's R_WP / R_BP slots, the
// resblocks from record i.
//
// What bounds them on the H100: the same as stage_kernel, without the
// attention. A decoder row at L = 16 is ~3.7 MFLOP of dependent k3
// convolutions, group statistics and FiLM over weights that do not fit in
// shared memory, so the design is stage_kernel's: the R rows of a block
// stay in shared memory from the load to the store, every weight is read
// once per R rows through L1/L2 with a vector load reused over a 4-token
// register tile, and products run on the CUDA cores in fp32. Tensor cores
// are later work. The device functions are those of resnet1d_blocks.cuh
// (proj, resblock, head, emb_sum_rows), so each row is reduced in the
// same order as in stage_kernel and final_kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// interface, loaded with ctypes; see graspldm_tpu_torch/cuda_build.py).
#include "sampler_body.cuh"

using namespace gl;

namespace {

// Load the block's rows of x [BG, W] into X (rows past BG read 0) and sum
// their FiLM inputs into ESUM.
template <typename T>
__device__ inline void load_rows(const Bufs<T>& b, const T* __restrict__ x,
                                 const T* __restrict__ emb, int row0, int R, int BG, int W,
                                 int E, int Ce) {
  for (int idx = threadIdx.x; idx < R * W; idx += blockDim.x)
    b.X[idx] = row0 + idx / W < BG ? x[(size_t)row0 * W + idx] : from_f<T>(0.f);
  emb_sum_rows(emb, b.ESUM, row0, R, BG, E, Ce);
  __syncthreads();
}

// X [R][L][Cin] -> the resblocks' input at width C: X itself at stage 0,
// else OUT = stage - 1's projection of X
template <typename T>
__device__ inline T* open_stage(const Bufs<T>& b, int stage, int R, int L, int Cin, int C,
                                const T* __restrict__ Wf, const long long* rec) {
  if (stage == 0) return b.X;
  proj(b.X, b.OUT, R, L, Cin, C, Wf, rec - REC_SIZE);
  return b.OUT;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hybrid_stage_kernel(const T* __restrict__ x, const T* __restrict__ emb, const T* __restrict__ Wf,
                    const long long* __restrict__ net, int stage, T* __restrict__ out, int BG,
                    int L, int Cin, int C, int E, int Ce, int G, int R) {
  extern __shared__ __align__(16) char smem[];
  const Bufs<T> b = carve<T>(smem, hybrid_plan(L, Cin, C, E, G, stage > 0), R);
  const long long* rec = net + NET_HDR + stage * REC_SIZE;
  const int row0 = blockIdx.x * R;
  load_rows(b, x, emb, row0, R, BG, L * Cin, E, Ce);
  T* Y = open_stage(b, stage, R, L, Cin, C, Wf, rec);
  resblock(b, Y, R, L, C, E, Ce, G, Wf, rec + R_RES1);
  resblock(b, Y, R, L, C, E, Ce, G, Wf, rec + R_RES2);
  const int Wo = L * C;
  for (int idx = threadIdx.x; idx < R * Wo; idx += blockDim.x)
    if (row0 + idx / Wo < BG) out[(size_t)row0 * Wo + idx] = Y[idx];
}

// `stage` is the number of network stages: the final record's index
template <typename T>
__global__ void __launch_bounds__(kThreads)
hybrid_final_kernel(const T* __restrict__ x, const T* __restrict__ emb, const T* __restrict__ Wf,
                    const long long* __restrict__ net, int stage, T* __restrict__ out, int BG,
                    int L, int Cin, int C, int E, int Ce, int G, int R) {
  extern __shared__ __align__(16) char smem[];
  const Bufs<T> b = carve<T>(smem, hybrid_plan(L, Cin, C, E, G, true), R);
  const long long* fin = net + NET_HDR + stage * REC_SIZE;
  const int row0 = blockIdx.x * R;
  load_rows(b, x, emb, row0, R, BG, L * Cin, E, Ce);
  T* Y = open_stage(b, stage, R, L, Cin, C, Wf, fin);
  resblock(b, Y, R, L, C, E, Ce, G, Wf, fin + R_RES1);
  head(Y, R * L, C, Wf, fin, [&](int m, float v) {
    if (row0 + m / L < BG) out[(size_t)row0 * L + m] = from_f<T>(v);
  });
}

template <typename T>
int launch_hybrid(bool is_final, const void* x, const void* emb, const void* w,
                  const long long* net, int stage, void* out, int BG, int L, int Cin, int C,
                  int E, int Ce, int G, cudaStream_t st) {
  const Plan p = hybrid_plan(L, Cin, C, E, G, is_final || stage > 0);
  auto kernel = is_final ? hybrid_final_kernel<T> : hybrid_stage_kernel<T>;
  return launch_rows<T>(kernel, p, BG, st, (const T*)x, (const T*)emb, (const T*)w, net, stage,
                        (T*)out, BG, L, Cin, C, E, Ce, G);
}

int dispatch(bool is_final, int dtype, const void* x, const void* emb, const void* w,
             const long long* net, int stage, void* out, int BG, int L, int Cin, int C, int E,
             int Ce, int G, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hybrid<float>(is_final, x, emb, w, net, stage, out, BG, L, Cin, C, E, Ce, G, st);
  return launch_hybrid<__nv_bfloat16>(is_final, x, emb, w, net, stage, out, BG, L, Cin, C, E, Ce,
                                      G, st);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16. x is [BG, L*Cin]
// (Cin = the input width: the previous stage's, or stage 0's own), the
// output [BG, L*C] (stage) or [BG, L] (final). Each returns the
// cudaError_t of the launch (0 = launched).
// ---------------------------------------------------------------------------
extern "C" {

int gl_hybrid_stage_forward(int dtype, const void* x, const void* emb, const void* w,
                            const long long* net, int stage, void* out, int BG, int L, int Cin,
                            int C, int E, int Ce, int G, void* stream) {
  return dispatch(false, dtype, x, emb, w, net, stage, out, BG, L, Cin, C, E, Ce, G, stream);
}

int gl_hybrid_final_forward(int dtype, const void* x, const void* emb, const void* w,
                            const long long* net, int stage, void* out, int BG, int L, int Cin,
                            int C, int E, int Ce, int G, void* stream) {
  return dispatch(true, dtype, x, emb, w, net, stage, out, BG, L, Cin, C, E, Ce, G, stream);
}

}  // extern "C"
