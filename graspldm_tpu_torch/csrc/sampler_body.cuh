// Block sizing and the per-step network shared by the whole-trajectory
// sampler kernels (ddim_sampler_kernel in kernels.cu, dpmpp_sampler_kernel
// in dpmpp_sampler.cu, churn_sampler_kernel in churn_sampler.cu).
//
// A sampler block owns R rows for the whole trajectory: their fp32 carry
// vectors (x and whatever the sampler keeps beside it), the pre-silu
// conditioning embedding and every activation of the network live in
// shared memory from the first step to the last. net_step is one
// evaluation of the whole denoiser on those rows; the kernels differ only
// in the fp32 update around it. Its network after the init conv is
// net_body, which full_kernel (full_net.cu) runs too. net_body<T, true>
// runs the convs, the projections and the attention's wqkv / wo on the
// tensor cores (tc_blocks.cuh), from the fragment-ordered weights of the
// layout's tensor-core table: ddim_sampler_kernel<bf16> (net_step<bf16,
// true>), full_kernel<bf16> and full_kernel<float> (float32 through the
// exact bf16 split). Everything else, and the other sampler kernels, run
// resnet1d_blocks.cuh's CUDA-core body.
#pragma once

#include "tc_blocks.cuh"

namespace gl {

constexpr size_t kSmemBudget = 225 * 1024;  // of the 227 KB a block may use
constexpr int kMaxRows = 16;

template <typename T>
size_t row_bytes(const Plan& p) {
  return (size_t)p.t_elems() * sizeof(T) + (size_t)p.f_elems() * sizeof(float);
}

template <typename T>
int rows_per_block(const Plan& p) {
  const size_t per = row_bytes<T>(p);
  int r = (int)(kSmemBudget / per);
  return r > kMaxRows ? kMaxRows : r;
}

// Launch `kernel` over ceil(BG / R) blocks of R rows (of plan p) and
// Threads threads. Returns the cudaError_t of the launch (0 = launched).
template <typename T, int Threads = kThreads, typename Kernel, typename... Args>
int launch_rows_at(Kernel kernel, const Plan& p, int R, int BG, cudaStream_t st, Args... args) {
  if (R < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = R * row_bytes<T>(p);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(BG + R - 1) / R, Threads, bytes, st>>>(args..., R);
  return (int)cudaGetLastError();
}

// launch_rows_at with R the most rows of plan p that fit the shared-memory
// budget
template <typename T, int Threads = kThreads, typename Kernel, typename... Args>
int launch_rows(Kernel kernel, const Plan& p, int BG, cudaStream_t st, Args... args) {
  return launch_rows_at<T, Threads>(kernel, p, rows_per_block<T>(p), BG, st, args...);
}

// Load the block's rows of x_T into the first carry vector b.XC[0, R*L)
// and of the conditioning embedding into b.EMBIN; rows past BG read 0.
template <typename T>
__device__ inline void load_sampler_rows(const Bufs<T>& b, const float* __restrict__ xT,
                                         const float* __restrict__ embin, int row0, int R,
                                         int BG, int L, int CeE) {
  for (int idx = threadIdx.x; idx < R * L; idx += blockDim.x)
    b.XC[idx] = row0 + idx / L < BG ? xT[(size_t)row0 * L + idx] : 0.f;
  for (int idx = threadIdx.x; idx < R * CeE; idx += blockDim.x)
    b.EMBIN[idx] = row0 + idx / CeE < BG ? embin[(size_t)row0 * CeE + idx] : 0.f;
}

// The network after the init conv on the block's R rows: X holds the init
// conv's output [R][L][dim0] in T; each of its n_st stages (2 resblocks,
// attention, k3 projection), the final resblock and the 1x1 head, whose
// value for token m, rounded to T, goes to store(m, v). TC: the products on
// the tensor cores (tc_blocks.cuh; float32 T through the exact bf16 split).
// The one network body of full_kernel and of every sampler kernel's
// net_step. net_step reads n_st before its barrier and hands it in: read
// after it, inside net_body, the float32 DDIM sampler took 462.2 ms against
// 431.1 at fpc BG = 4096 (tools/kernel_variants.py, H100 80GB HBM3, 700.00
// W).
template <typename T, bool TC, typename Store>
__device__ __forceinline__ void net_body(const Bufs<T>& b, int n_st, int R, int L, int E, int Ce,
                                         int G, const T* __restrict__ Wf,
                                         const long long* __restrict__ net, Store store) {
  T* X = b.X;
  T* OUT = b.OUT;
  for (int st = 0; st < n_st; ++st) {
    const long long* rec = net + NET_HDR + st * REC_SIZE;
    const int C = (int)rec[R_C], Cout = (int)rec[R_COUT], tc = st * TC_REC;
    resblock(b, X, R, L, C, E, Ce, G, Wf, rec + R_RES1,
             piece_products<T, TC>(b, OUT, Wf, net, tc + T_R1, PIECE_RES));
    resblock(b, X, R, L, C, E, Ce, G, Wf, rec + R_RES2,
             piece_products<T, TC>(b, OUT, Wf, net, tc + T_R2, PIECE_RES));
    attention(b, X, R, L, C, Wf, rec,
              piece_products<T, TC>(b, OUT, Wf, net, tc + T_ATTN, PIECE_ATTN));
    proj(X, OUT, R, L, C, Cout, Wf, rec,
         piece_products<T, TC>(b, OUT, Wf, net, tc + T_PROJ, PIECE_PROJ));
    T* tmp = X; X = OUT; OUT = tmp;
  }
  const long long* fin = net + NET_HDR + n_st * REC_SIZE;
  const int Cf = (int)fin[R_C];
  resblock(b, X, R, L, Cf, E, Ce, G, Wf, fin + R_RES1,
           piece_products<T, TC>(b, OUT, Wf, net, n_st * TC_REC + T_R1, PIECE_RES));
  head(X, R * L, Cf, Wf, fin, store);
}

// One evaluation of the whole denoiser on the block's R rows:
//   emb  = silu(EMBIN + trow) rounded to T, summed over the Ce channels;
//   h    = init conv (1 -> dim0 channels, k7, pad 3) on round_T(scale*src);
//   out  = net_body(h): every stage, the final resblock + 1x1 head, rounded
//          to T, stored as fp32.
// src [R*L] is fp32 in shared memory; the caller synchronises after
// writing it. Returns out = b.SS [R*L], valid when this returns (it ends
// synchronised) and until the next net_step. TC (bf16 only): the
// products on the tensor cores.
template <typename T, bool TC = false>
__device__ inline const float* net_step(const Bufs<T>& b, const float* src, float scale,
                                        const float* __restrict__ trow, int R, int L, int E,
                                        int Ce, int G, const T* __restrict__ Wf,
                                        const long long* __restrict__ net) {
  const int CeE = Ce * E;
  const int n_st = (int)net[N_NSTAGES], dim0 = (int)net[N_DIM0];
  const T* init_w = Wf + net[N_INIT_W];  // [7, dim0]
  const T* init_b = Wf + net[N_INIT_B];
  for (int idx = threadIdx.x; idx < R * E; idx += blockDim.x) {
    const int r = idx / E, k = idx % E;
    float acc = 0.f;
    for (int c = 0; c < Ce; ++c)
      acc += rnd<T>(silu(b.EMBIN[r * CeE + c * E + k] + trow[c * E + k]));
    b.ESUM[idx] = acc;
  }
  for (int idx = threadIdx.x; idx < R * L * dim0; idx += blockDim.x) {
    const int c = idx % dim0, m = idx / dim0, r = m / L, l = m % L;
    float acc = 0.f;
    for (int t = 0; t < 7; ++t) {
      const int sl = l + t - 3;
      if (sl >= 0 && sl < L)
        acc = fmaf(rnd<T>(scale * src[r * L + sl]), ldw(init_w + t * dim0 + c), acc);
    }
    b.X[idx] = from_f<T>(acc + ldw(init_b + c));
  }
  __syncthreads();
  float* out = b.SS;  // free after the final resblock
  net_body<T, TC>(b, n_st, R, L, E, Ce, G, Wf, net, [&](int m, float v) { out[m] = v; });
  __syncthreads();
  return out;
}

}  // namespace gl
