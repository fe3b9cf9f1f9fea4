// Furthest point sampling on the H100.
//
//   fps_kernel  replaces graspldm_tpu/ops/pallas_fps.py:_fps_kernel
//               (the function of graspldm_tpu/ops/sampling.py:furthest_point_sample)
//
// What it computes, for each cloud b of coords [B, N, 3] (float32): index 0
// is picked first; then, M - 1 times, every point's running minimum squared
// distance to the picked set is lowered by its distance to the last pick,
// and the argmax of that minimum is picked next, ties going to the lowest
// index. The indices are written as int64 [B, M] as they are picked.
//
// What bounds it on the H100: the work is ~9 flops per point and step
// (3 sub, 3 mul, 2 add, 1 min), ~151 MFLOP at B = 16, N = M = 1024, which
// the CUDA cores do in ~2 us, and the bytes (12 B per point in, 8 B per pick
// out) take less. But the M steps form a chain: each step needs the
// previous step's block-wide argmax before it can start. So the kernel is
// bound by the latency of M dependent block reductions, not by either
// rate; blocks of different clouds run side by side on the 132 SMs.
//
// The design: one block per cloud, kThreads threads. Thread t keeps points
// t, t + kThreads, ... (PPT of them) -- their xyz and running minimum -- in
// registers for the whole run, so no step touches device memory except to
// read the last pick's xyz (one broadcast 12-byte load, an L1 hit) and to
// write the pick. A step is: the thread's own (value, index) argmax over its
// points in index order with a strict ">", a warp argmax with
// __shfl_xor_sync, one slot per warp in shared memory, and a final argmax
// by warp 0, which writes the pick and broadcasts it through shared memory.
// The order rule everywhere: the larger value wins, an equal value goes to
// the lower index. Points past N are masked (value -1, index INT_MAX: a
// real minimum distance is >= 0, so they never win). The distance is
// written with __fmul_rn/__fadd_rn in the plain version's order,
// (dx*dx + dy*dy) + dz*dz, so nvcc cannot contract it into an FMA: an
// argmax turns a last-bit difference into another index. N is limited to
// kThreads * kMaxPPT points per cloud (one block holds the whole cloud).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// interface, loaded with ctypes; see graspldm_tpu_torch/cuda_build.py).
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPPT = 32;  // N <= 8192

// (v, i) replaces (bv, bi) if it is larger, or equal at a lower index
__device__ __forceinline__ void take_better(float v, int i, float& bv, int& bi) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ coords, long long* __restrict__ out, int N, int M) {
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_pick;
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* c = coords + (size_t)b * N * 3;
  long long* o = out + (size_t)b * M;

  float px[PPT], py[PPT], pz[PPT], dist[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int n = t + k * kThreads;
    const bool ok = n < N;
    px[k] = ok ? c[3 * n] : 0.f;
    py[k] = ok ? c[3 * n + 1] : 0.f;
    pz[k] = ok ? c[3 * n + 2] : 0.f;
    dist[k] = ok ? __int_as_float(0x7f800000) : -1.f;  // +inf; masked: never wins
  }
  if (t == 0) o[0] = 0;
  int last = 0;
  for (int j = 1; j < M; ++j) {
    const float lx = __ldg(c + 3 * last), ly = __ldg(c + 3 * last + 1),
                lz = __ldg(c + 3 * last + 2);
    float bv = -1.f;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int n = t + k * kThreads;
      if (n < N) {
        const float dx = __fsub_rn(px[k], lx), dy = __fsub_rn(py[k], ly),
                    dz = __fsub_rn(pz[k], lz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        dist[k] = fminf(dist[k], d);
        if (dist[k] > bv) {  // points in index order: an equal value keeps the lower index
          bv = dist[k];
          bi = n;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      take_better(__shfl_xor_sync(0xffffffffu, bv, off), __shfl_xor_sync(0xffffffffu, bi, off),
                  bv, bi);
    if (lane == 0) {
      s_val[warp] = bv;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? s_val[lane] : -1.f;
      bi = lane < kWarps ? s_idx[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        take_better(__shfl_xor_sync(0xffffffffu, bv, off),
                    __shfl_xor_sync(0xffffffffu, bi, off), bv, bi);
      if (lane == 0) {
        s_pick = bi;
        o[j] = bi;
      }
    }
    // warp 0 has read every slot before it writes s_pick, and every thread
    // reads s_pick before the next step's first barrier: two barriers a step
    __syncthreads();
    last = s_pick;
  }
}

template <int PPT>
int launch(const float* coords, long long* out, int B, int N, int M, cudaStream_t st) {
  fps_kernel<PPT><<<B, kThreads, 0, st>>>(coords, out, N, M);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). coords: float32 [B, N, 3], out: int64 [B, M].
// Returns the cudaError_t of the launch (0 = launched), or -1 for N outside
// [1, gl_fps_max_points()] or M < 1.
extern "C" int gl_fps_max_points() { return kThreads * kMaxPPT; }

extern "C" int gl_fps(const void* coords, void* out, int B, int N, int M, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* c = (const float*)coords;
  long long* o = (long long*)out;
  if (N < 1 || M < 1 || N > kThreads * kMaxPPT) return -1;
  if (B == 0) return 0;
  const int ppt = (N + kThreads - 1) / kThreads;
  if (ppt <= 1) return launch<1>(c, o, B, N, M, st);
  if (ppt <= 2) return launch<2>(c, o, B, N, M, st);
  if (ppt <= 4) return launch<4>(c, o, B, N, M, st);
  if (ppt <= 8) return launch<8>(c, o, B, N, M, st);
  if (ppt <= 16) return launch<16>(c, o, B, N, M, st);
  return launch<32>(c, o, B, N, M, st);
}
