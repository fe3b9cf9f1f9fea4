// Hand-written Hopper kernels of the LDM generation path:
//
//   stage_kernel         replaces graspldm_tpu/models/stacked_pallas.py:_stage_kernel
//   final_kernel         replaces graspldm_tpu/models/stacked_pallas.py:_final_kernel
//   ddim_sampler_kernel  replaces graspldm_tpu/models/pallas_sampler.py:_mega_kernel
//
// What bounds them on the H100: the network is ~0.9 M parameters (3.6 MB
// fp32) applied to tiny per-row activations (<= 4096 values at L=16), so
// the work is many small dependent products whose weights do not fit in
// shared memory. The design keeps every activation of R rows resident in
// shared memory for the whole stage (or, in the sampler, the whole
// trajectory: no activation ever goes to device memory between ops or
// steps), and reads each weight once per R rows through L1/L2 with one
// vector load reused over a 4-token register tile. Products run on the CUDA
// cores in fp32; tensor cores (wgmma) and TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// interface, loaded with ctypes; see graspldm_tpu_torch/cuda_build.py).
#include "resnet1d_blocks.cuh"

using namespace gl;

namespace {

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

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
stage_kernel(const T* __restrict__ x, const T* __restrict__ emb, const T* __restrict__ Wf,
             const long long* __restrict__ rec, T* __restrict__ out, int BG, int R, int L,
             int C, int Cout, int E, int Ce, int G) {
  extern __shared__ __align__(16) char smem[];
  const Bufs<T> b = carve<T>(smem, stage_plan(L, C, Cout, E, G), R);
  const int row0 = blockIdx.x * R;
  const int W = L * C;
  for (int idx = threadIdx.x; idx < R * W; idx += blockDim.x) {
    const int r = idx / W;
    b.X[idx] = row0 + r < BG ? x[(size_t)row0 * W + idx] : from_f<T>(0.f);
  }
  emb_sum_rows(emb, b.ESUM, row0, R, BG, E, Ce);
  __syncthreads();
  resblock(b, b.X, R, L, C, E, Ce, G, Wf, rec + R_RES1);
  resblock(b, b.X, R, L, C, E, Ce, G, Wf, rec + R_RES2);
  attention(b, b.X, R, L, C, Wf, rec);
  proj(b.X, b.OUT, R, L, C, Cout, Wf, rec);
  const int Wo = L * Cout;
  for (int idx = threadIdx.x; idx < R * Wo; idx += blockDim.x)
    if (row0 + idx / Wo < BG) out[(size_t)row0 * Wo + idx] = b.OUT[idx];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
final_kernel(const T* __restrict__ x, const T* __restrict__ emb, const T* __restrict__ Wf,
             const long long* __restrict__ rec, T* __restrict__ out, int BG, int R, int L,
             int C, int E, int Ce, int G) {
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
// memory across all S steps. Per step s:
//   emb = silu(embin + trows[s]) (rounded to T), eps = net(x),
//   x0 = clip(c0*x - c1*eps);  ddim: x = c2*x + c3*x0
//                              ddpm: x = c2*x0 + c3*x + c4*noise[s]
template <typename T>
__global__ void __launch_bounds__(kThreads)
ddim_sampler_kernel(const float* __restrict__ xT, const float* __restrict__ embin,
                    const float* __restrict__ trows, const float* __restrict__ coefs,
                    const float* __restrict__ noise, const T* __restrict__ Wf,
                    const long long* __restrict__ net, float* __restrict__ out, int BG, int S,
                    int R, int L, int E, int Ce, int G, int cmax, int clip, float clip_range) {
  extern __shared__ __align__(16) char smem[];
  const Bufs<T> b = carve<T>(smem, sampler_plan(L, cmax, E, Ce, G), R);
  const int row0 = blockIdx.x * R;
  const int CeE = Ce * E;
  const int n_st = (int)net[N_NSTAGES], dim0 = (int)net[N_DIM0];
  const T* init_w = Wf + net[N_INIT_W];  // [7, dim0]
  const T* init_b = Wf + net[N_INIT_B];
  for (int idx = threadIdx.x; idx < R * L; idx += blockDim.x)
    b.XC[idx] = row0 + idx / L < BG ? xT[(size_t)row0 * L + idx] : 0.f;
  for (int idx = threadIdx.x; idx < R * CeE; idx += blockDim.x)
    b.EMBIN[idx] = row0 + idx / CeE < BG ? embin[(size_t)row0 * CeE + idx] : 0.f;
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const float* trow = trows + (size_t)s * CeE;
    for (int idx = threadIdx.x; idx < R * E; idx += blockDim.x) {
      const int r = idx / E, k = idx % E;
      float acc = 0.f;
      for (int c = 0; c < Ce; ++c)
        acc += rnd<T>(silu(b.EMBIN[r * CeE + c * E + k] + trow[c * E + k]));
      b.ESUM[idx] = acc;
    }
    // init conv: 1 channel -> dim0 channels, k=7, pad 3, on x rounded to T
    T* X = b.X;
    T* OUT = b.OUT;
    for (int idx = threadIdx.x; idx < R * L * dim0; idx += blockDim.x) {
      const int c = idx % dim0, m = idx / dim0, r = m / L, l = m % L;
      float acc = 0.f;
      for (int t = 0; t < 7; ++t) {
        const int sl = l + t - 3;
        if (sl >= 0 && sl < L) acc = fmaf(rnd<T>(b.XC[r * L + sl]), ldw(init_w + t * dim0 + c), acc);
      }
      X[idx] = from_f<T>(acc + ldw(init_b + c));
    }
    __syncthreads();
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
    float* eps = b.SS;  // free after the final resblock
    head(X, R * L, Cf, Wf, fin, [&](int m, float v) { eps[m] = v; });
    __syncthreads();
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

// ---------------------------------------------------------------------------
// host launchers
// ---------------------------------------------------------------------------

template <typename T>
int launch_stage(const void* x, const void* emb, const void* w, const long long* rec, void* out,
                 int BG, int L, int C, int Cout, int E, int Ce, int G, cudaStream_t st) {
  const Plan p = stage_plan(L, C, Cout, E, G);
  const int R = rows_per_block<T>(p);
  if (R < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = R * row_bytes<T>(p);
  cudaError_t e = cudaFuncSetAttribute(stage_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  stage_kernel<T><<<(BG + R - 1) / R, kThreads, bytes, st>>>(
      (const T*)x, (const T*)emb, (const T*)w, rec, (T*)out, BG, R, L, C, Cout, E, Ce, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_final(const void* x, const void* emb, const void* w, const long long* rec, void* out,
                 int BG, int L, int C, int E, int Ce, int G, cudaStream_t st) {
  const Plan p = final_plan(L, C, E, G);
  const int R = rows_per_block<T>(p);
  if (R < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = R * row_bytes<T>(p);
  cudaError_t e = cudaFuncSetAttribute(final_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  final_kernel<T><<<(BG + R - 1) / R, kThreads, bytes, st>>>(
      (const T*)x, (const T*)emb, (const T*)w, rec, (T*)out, BG, R, L, C, E, Ce, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sampler(const float* xT, const float* embin, const float* trows, const float* coefs,
                   const float* noise, const void* w, const long long* net, float* out, int BG,
                   int S, int L, int E, int Ce, int G, int cmax, int clip, float clip_range,
                   cudaStream_t st) {
  const Plan p = sampler_plan(L, cmax, E, Ce, G);
  const int R = rows_per_block<T>(p);
  if (R < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = R * row_bytes<T>(p);
  cudaError_t e = cudaFuncSetAttribute(ddim_sampler_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  ddim_sampler_kernel<T><<<(BG + R - 1) / R, kThreads, bytes, st>>>(
      xT, embin, trows, coefs, noise, (const T*)w, net, out, BG, S, R, L, E, Ce, G, cmax, clip,
      clip_range);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16. Each returns the
// cudaError_t of the launch (0 = launched).
// ---------------------------------------------------------------------------
extern "C" {

int gl_stage_forward(int dtype, const void* x, const void* emb, const void* w,
                     const long long* rec, void* out, int BG, int L, int C, int Cout, int E,
                     int Ce, int G, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_stage<float>(x, emb, w, rec, out, BG, L, C, Cout, E, Ce, G, st);
  return launch_stage<__nv_bfloat16>(x, emb, w, rec, out, BG, L, C, Cout, E, Ce, G, st);
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
    return launch_sampler<float>(xT, embin, trows, coefs, noise, w, net, out, BG, S, L, E, Ce,
                                 G, cmax, clip, clip_range, st);
  return launch_sampler<__nv_bfloat16>(xT, embin, trows, coefs, noise, w, net, out, BG, S, L,
                                       E, Ce, G, cmax, clip, clip_range, st);
}

}  // extern "C"
