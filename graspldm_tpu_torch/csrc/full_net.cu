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
// the net_step of the sampler kernels (sampler_body.cuh) without the time
// row: the guided samplers call it once per denoiser evaluation with a
// per-row time embedding already folded into emb.
//
// What bounds it on the H100: the same as the step kernels. One evaluation
// is ~7.3 MFLOP per row at L = 4 (29.7 GFLOP at BG = 4096) over ~0.9 M
// weights, so it is bound by operations, and the products run on the CUDA
// cores in fp32. The design keeps every activation of a block's R rows in
// shared memory from the first stage to the head (the chain writes and
// reads them through device memory between its 5 launches) and reads each
// weight once per R rows through L1/L2. R is the most rows whose buffers,
// sized for the widest stage, fit the shared-memory budget; the ragged
// last block is masked here, not padded by the caller. Each row is reduced
// in the same order as in the chain, so the two agree bitwise.
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
__global__ void __launch_bounds__(kThreads)
full_kernel(const T* __restrict__ x, const T* __restrict__ emb, const T* __restrict__ Wf,
            const long long* __restrict__ net, T* __restrict__ out, int BG, int L, int E,
            int Ce, int G, int cmax, int R) {
  extern __shared__ __align__(16) char smem[];
  const Bufs<T> b = carve<T>(smem, full_plan(L, cmax, E, G), R);
  const int row0 = blockIdx.x * R;
  const int n_st = (int)net[N_NSTAGES], dim0 = (int)net[N_DIM0];
  const int W = L * dim0;
  for (int idx = threadIdx.x; idx < R * W; idx += blockDim.x)
    b.X[idx] = row0 + idx / W < BG ? x[(size_t)row0 * W + idx] : from_f<T>(0.f);
  emb_sum_rows(emb, b.ESUM, row0, R, BG, E, Ce);
  __syncthreads();
  T* X = b.X;
  T* OUT = b.OUT;
  for (int st = 0; st < n_st; ++st) {
    const long long* rec = net + NET_HDR + st * REC_SIZE;
    const int C = (int)rec[R_C], Cout = (int)rec[R_COUT];
    resblock(b, X, R, L, C, E, Ce, G, Wf, rec + R_RES1);
    resblock(b, X, R, L, C, E, Ce, G, Wf, rec + R_RES2);
    attention(b, X, R, L, C, Wf, rec);
    proj(X, OUT, R, L, C, Cout, Wf, rec);
    T* tmp = X; X = OUT; OUT = tmp;
  }
  const long long* fin = net + NET_HDR + n_st * REC_SIZE;
  const int Cf = (int)fin[R_C];
  resblock(b, X, R, L, Cf, E, Ce, G, Wf, fin + R_RES1);
  head(X, R * L, Cf, Wf, fin, [&](int m, float v) {
    if (row0 + m / L < BG) out[(size_t)row0 * L + m] = from_f<T>(v);
  });
}

template <typename T>
int launch_full(const void* x, const void* emb, const void* w, const long long* net, void* out,
                int BG, int L, int E, int Ce, int G, int cmax, cudaStream_t st) {
  return launch_rows<T>(full_kernel<T>, full_plan(L, cmax, E, G), BG, st, (const T*)x,
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
