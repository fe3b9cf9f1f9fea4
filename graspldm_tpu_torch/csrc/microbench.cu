// The micro-benchmark kernels on the H100: each is the body of one of the
// port's micro-benchmark entry points (graspldm_tpu_torch/tools/).
//
//   mm_chain_kernel<form>     replaces tools/bench_mm.py:make_kernel
//   silu_chain_kernel<form>   replaces tools/bench_silu.py:make_kernel
//   bcast_chain_kernel<form>  replaces tools/bench_repeat.py:make_kernel
//
// Each runs its tool's dependent chain of reps inside one launch. The rep
// count and the chain's multipliers are runtime arguments (bf16 bits from
// the wrapper): bf16(0.999) is 1.0, and a constant 1.0 would let the
// compiler fold the multiply and hoist the reps, timing one rep as twelve.
// Rows past R are masked (any R is taken; the TPU grid drops R % 512).
//
// mm_chain_kernel: acc = sum over reps of (x*x) @ pool, x bf16 [R, K], pool
// [K, 128], acc float32 [R, 128]; after each rep x = bf16(x * mult).
//   Bound: 2 * R * K * 128 * reps operations, 5.15e10 at R = 8192, K =
//   2048, 12 reps, against ~39 MB of bytes: operations bound, at 989
//   TFLOP/s on the tensor cores (bf16; split x2; f32 x5 there, or once at
//   67 TFLOP/s on the CUDA cores, whichever is less).
//   Design: every form runs on the tensor cores, mma.sync.m16n8k16 bf16 x
//   bf16 -> float32; the forms differ only in the A operands a rep forms
//   from x and the B operands (pool parts) they meet:
//     bf16:  bf16(x*x) against pb;
//     split: hi = bf16(x*x), lo = bf16(x*x - hi) (x*x has 16 significant
//            bits, so hi + lo is x*x exactly) against pb;
//     f32:   hi and lo against the exact three-part bf16 split of the
//            float32 pool, pf = p1 + p2 + p3 (the wrapper makes it): hi*p1,
//            hi*p2, hi*p3, lo*p1, lo*p2, each product exact; lo*p3 is at
//            most 2^-24 of its term and is dropped. The function is the
//            float32 one (x*x times pf, summed in float32), as a TPU's matrix
//            unit computes an f32 product.
//   A block of 8 warps owns 64 rows: warp w the 16 rows of m-tile w % 4 and
//   all 128 columns (16 n-tiles), over the k-steps of its half, w / 4, of
//   each 32-deep K tile; the halves are added through shared memory at the
//   end (R = 8192: 128 blocks, one an SM). The x and pool tiles of each K
//   tile arrive by cp.async in a kMmStages ring (rows padded by 16 bytes:
//   conflict-free ldmatrix); each warp reads its A fragments of x with
//   ldmatrix and the B fragments of each pool part with ldmatrix.trans, once
//   a K tile, and runs every rep on them, carrying x_r in registers, so x
//   and the pool are read from memory once and the reps cost only products.
//   The sums are taken in another order than the plain version's (rep by
//   rep), within float32 rounding.
//
// silu_chain_kernel: reps of y = silu(x), x = bf16(y * mult) on bf16 x.
//   Bound: 2 bytes in and 2 out per element (20 us at 8192 x 2048), but the
//   SFU does 2 multi-function operations (exp, reciprocal) per element and
//   rep at 16 per SM per clock: that floor (~96 us at 1.98 GHz) is what
//   the forms meet. Design: one thread per bf16 pair, all reps in
//   registers. f32: x * (1 / (1 + expf(-x))) in float32, one rounding;
//   bf16exp: exp, 1 + e and the quotient each computed in float32 and
//   rounded to bf16, the TPU's bf16 op-by-op rounding (h2exp's ex2.approx
//   would not reproduce it); mixexp: float32 exp and quotient, one
//   rounding. Division is IEEE (no fast math), as in the plain version.
//
// bcast_chain_kernel: L = 16, H = 4, D = 32. Each rep folds
//   acc[:, h*D + d] = bf16 sum over l of bf16(s[:, l*H + h] * v[:, l*128 +
//   h*D + d]) in reduce order, then s = bf16(bf16(s * half) +
//   bf16(acc[:, :64] * zero)); the output is the last acc, bf16 [R, 128].
//   Bound: bytes (~37 MB, 11 us) for repeat / narrow; matmul adds 20 x 2 x
//   R x 64 x 2048 tensor operations (43 us at 989 TFLOP/s).
//   Design: a block of 4 warps owns 16 rows; its v rows (64 KB) stay in
//   shared memory for all reps (rows padded by 16 bytes: conflict-free
//   reads); warp w is head h = w and each thread holds rows g, g + 8 x 8
//   columns of acc in the mma C-fragment layout. The forms differ only in
//   how s reaches the lanes: matmul: the one-hot product on the tensor
//   cores (mma.sync, B fragments from the cached one-hot matrix), rounded
//   to bf16; repeat: a lane broadcast (__shfl_sync from the lane holding
//   s[row][l*H + h]); narrow: each l's scalar read from shared memory. The
//   s update goes through shared memory (acc[:, :64] lives in warps 0-1).
//   All three give the plain version's bits: every product and sum is one
//   rounding of an exact float32 result.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C
// interface, loaded with ctypes; see graspldm_tpu_torch/cuda_build.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// bf16 helpers: a bf16 value is carried as the float32 it equals
// ---------------------------------------------------------------------------

__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ float bits_f(unsigned short b) { return __uint_as_float((uint32_t)b << 16); }

// round to bf16 (nearest, ties to even) and back
__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// two floats -> bf16x2, each rounded to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pair16(const unsigned short* p, size_t i0, size_t i1) {
  return (uint32_t)__ldg(p + i0) | ((uint32_t)__ldg(p + i1) << 16);
}

// D = A (16x16, row) * B (16x8, col) + D, bf16 operands, float32 accumulate
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// mm_chain_kernel
// ---------------------------------------------------------------------------

constexpr int kMmN = 128;
constexpr int kMmThreads = 256;
constexpr int kMmRows = 64;                // rows a block owns
constexpr int kMmBK = 32;                  // K tile: two k-steps, one a warp half
constexpr int kMmStages = 4;               // K tiles in flight
constexpr int kMmXStride = kMmBK + 8;      // bf16 per x row in shared memory (80 bytes)
constexpr int kMmPStride = kMmN + 8;       // bf16 per pool row (272 bytes)
constexpr int kMmXTile = kMmRows * kMmXStride;
constexpr int kMmPTile = kMmBK * kMmPStride;
enum { kFormF32 = 0, kFormBf16 = 1, kFormSplit = 2 };

template <int FORM>
__host__ __device__ constexpr int mm_parts() { return FORM == kFormF32 ? 3 : 1; }
template <int FORM>
__host__ __device__ constexpr size_t mm_smem() {
  return sizeof(unsigned short) * kMmStages * (kMmXTile + mm_parts<FORM>() * kMmPTile);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// x: bf16 [R, K]; pool: bf16 [parts][K][128] (f32: p1, p2, p3; else pb)
template <int FORM>
__global__ void __launch_bounds__(kMmThreads)
mm_chain_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ pool,
                float* __restrict__ out, int R, int K, int reps, unsigned short mult_bits) {
  constexpr int P = mm_parts<FORM>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned short* xs = reinterpret_cast<unsigned short*>(smem_raw);  // [stage][kMmXTile]
  unsigned short* ps = xs + kMmStages * kMmXTile;                     // [stage][P][kMmPTile]
  const float m = bits_f(mult_bits);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, mt = warp & 3, kh = warp >> 2;
  const int row0 = blockIdx.x * kMmRows;
  const int ntiles = K / kMmBK;

  // one K tile into ring slot `slot`: x rows (4 16-byte chunks a row), each
  // pool part (16 chunks a row); rows past R are zero-filled
  auto issue = [&](int tile, int slot) {
    const int k0 = tile * kMmBK;
    {
      const int r = tid >> 2, c = (tid & 3) * 8;
      const bool ok = row0 + r < R;
      cp_async16(xs + slot * kMmXTile + r * kMmXStride + c,
                 x + (size_t)(ok ? row0 + r : 0) * K + k0 + c, ok);
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kMmThreads, r = idx >> 4, c = (idx & 15) * 8;
        cp_async16(ps + (slot * P + p) * kMmPTile + r * kMmPStride + c,
                   pool + ((size_t)p * K + k0 + r) * kMmN + c, true);
      }
  };

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kMmStages - 1; ++s) {
    if (s < ntiles) issue(s, s);
    cp_async_commit();
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<kMmStages - 2>();
    __syncthreads();  // tile's copies landed; every warp is done with tile - 1's slot
    if (tile + kMmStages - 1 < ntiles) issue(tile + kMmStages - 1, (tile + kMmStages - 1) % kMmStages);
    cp_async_commit();
    const int slot = tile % kMmStages;
    // A pairs of x: rows 16*mt + (g, g + 8), k 16*kh + (2t, 2t + 8)
    uint32_t xa[4];
    ldsm_x4(xa, xs + slot * kMmXTile + (16 * mt + (lane & 15)) * kMmXStride + 16 * kh +
                    (lane >> 4) * 8);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      // B fragments of n-tiles 2q, 2q + 1: k rows 16*kh + 0..15, columns 16q..16q+15
      uint32_t b[8][4];
      const unsigned short* pt = ps + (slot * P + p) * kMmPTile +
                                 (16 * kh + (lane & 7) + ((lane >> 3) & 1) * 8) * kMmPStride +
                                 (lane >> 4) * 8;
#pragma unroll
      for (int q = 0; q < 8; ++q) ldsm_x4_t(b[q], pt + 16 * q);
      // the A operands a rep forms against this part: hi, and lo but for p3
      const bool with_lo = FORM == kFormSplit || (FORM == kFormF32 && p < 2);
      uint32_t xr[4] = {xa[0], xa[1], xa[2], xa[3]};
      for (int r = 0; r < reps; ++r) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float f0 = lo_f(xr[i]), f1 = hi_f(xr[i]);
          const float q0 = f0 * f0, q1 = f1 * f1;  // exact in float32
          hi[i] = pack2(q0, q1);
          lo[i] = pack2(q0 - lo_f(hi[i]), q1 - hi_f(hi[i]));
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          mma16816(acc[2 * q], hi, b[q][0], b[q][1]);
          mma16816(acc[2 * q + 1], hi, b[q][2], b[q][3]);
          if (with_lo) {
            mma16816(acc[2 * q], lo, b[q][0], b[q][1]);
            mma16816(acc[2 * q + 1], lo, b[q][2], b[q][3]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) xr[i] = pack2(lo_f(xr[i]) * m, hi_f(xr[i]) * m);
      }
    }
  }
  // add the two K halves: warps kh = 1 hand theirs over through the ring
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw) + mt * 64 * 32;  // [mt][64 values][32 lanes]
  if (kh == 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(j * 4 + e) * 32 + lane] = acc[j][e];
  }
  __syncthreads();
  if (kh == 0) {
    const int ra = row0 + 16 * mt + g, rb = ra + 8;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc[j][e] + red[(j * 4 + e) * 32 + lane];
      const int col = 8 * j + 2 * t;
      if (ra < R) *reinterpret_cast<float2*>(out + (size_t)ra * kMmN + col) = make_float2(v[0], v[1]);
      if (rb < R) *reinterpret_cast<float2*>(out + (size_t)rb * kMmN + col) = make_float2(v[2], v[3]);
    }
  }
}

template <int FORM>
int launch_mm(const unsigned short* x, const unsigned short* pool, float* out, int R, int K,
              int reps, unsigned short mb, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      mm_chain_kernel<FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)mm_smem<FORM>());
  if (e != cudaSuccess) return (int)e;
  mm_chain_kernel<FORM><<<(R + kMmRows - 1) / kMmRows, kMmThreads, mm_smem<FORM>(), st>>>(
      x, pool, out, R, K, reps, mb);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// silu_chain_kernel
// ---------------------------------------------------------------------------

constexpr int kSiluThreads = 256;
enum { kSiluF32 = 0, kSiluBf16Exp = 1, kSiluMixExp = 2 };

template <int FORM>
__device__ __forceinline__ float silu_rep(float x, float m) {
  float y;
  if constexpr (FORM == kSiluF32) {
    const float s = 1.0f / (1.0f + expf(-x));
    y = rbf(x * s);
  } else if constexpr (FORM == kSiluBf16Exp) {
    const float e = rbf(expf(-x));
    const float d = rbf(1.0f + e);
    y = rbf(x / d);
  } else {
    y = rbf(x / (1.0f + expf(-x)));
  }
  return rbf(y * m);
}

template <int FORM>
__global__ void __launch_bounds__(kSiluThreads)
silu_chain_kernel(const unsigned short* __restrict__ x, unsigned short* __restrict__ out,
                  long long n, int reps, unsigned short mult_bits) {
  const float m = bits_f(mult_bits);
  const long long pairs = n >> 1;
  const long long i = (long long)blockIdx.x * kSiluThreads + threadIdx.x;
  if (i < pairs) {
    const uint32_t u = __ldg(reinterpret_cast<const uint32_t*>(x) + i);
    float a = lo_f(u), b = hi_f(u);
    for (int r = 0; r < reps; ++r) {
      a = silu_rep<FORM>(a, m);
      b = silu_rep<FORM>(b, m);
    }
    reinterpret_cast<uint32_t*>(out)[i] = pack2(a, b);
  } else if (i == pairs && (n & 1)) {  // the last element of an odd count
    float a = bits_f(__ldg(x + n - 1));
    for (int r = 0; r < reps; ++r) a = silu_rep<FORM>(a, m);
    out[n - 1] = __bfloat16_as_ushort(__float2bfloat16_rn(a));
  }
}

// ---------------------------------------------------------------------------
// bcast_chain_kernel
// ---------------------------------------------------------------------------

constexpr int kL = 16, kH = 4, kD = 32, kHD = kH * kD, kLH = kL * kH, kLHD = kL * kHD;
constexpr int kBcRows = 16, kBcThreads = 128;  // 4 warps: warp h owns head h
constexpr int kVStride = kLHD + 8;             // bf16 per v row in shared memory
constexpr int kSStride = kLH + 2;              // bf16 per s row in shared memory
constexpr size_t kBcSmem =
    sizeof(unsigned short) * (kBcRows * kVStride + kBcRows * kSStride + kBcRows * kLH);
enum { kBcMatmul = 0, kBcRepeat = 1, kBcNarrow = 2 };

template <int FORM>
__global__ void __launch_bounds__(kBcThreads)
bcast_chain_kernel(const unsigned short* __restrict__ s_in, const unsigned short* __restrict__ v,
                   const unsigned short* __restrict__ onehot, unsigned short* __restrict__ out,
                   int R, int reps, unsigned short half_bits, unsigned short zero_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* vs = reinterpret_cast<unsigned short*>(smem);  // [kBcRows][kVStride]
  unsigned short* ss = vs + kBcRows * kVStride;                  // [kBcRows][kSStride]
  unsigned short* as = ss + kBcRows * kSStride;                  // [kBcRows][kLH]: acc[:, :64]
  const int tid = threadIdx.x, lane = tid & 31, h = tid >> 5, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kBcRows;
  const float half = bits_f(half_bits), zero = bits_f(zero_bits);

  for (int idx = tid; idx < kBcRows * (kLHD / 8); idx += kBcThreads) {
    const int rr = idx / (kLHD / 8), c = idx % (kLHD / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + rr < R) val = __ldg(reinterpret_cast<const uint4*>(v + (size_t)(row0 + rr) * kLHD) + c);
    *reinterpret_cast<uint4*>(vs + rr * kVStride + c * 8) = val;
  }
  for (int idx = tid; idx < kBcRows * kLH; idx += kBcThreads) {
    const int rr = idx / kLH, c = idx % kLH;
    ss[rr * kSStride + c] = row0 + rr < R ? __ldg(s_in + (size_t)(row0 + rr) * kLH + c) : 0;
  }
  __syncthreads();

  // acc[q][j*2 + e]: row g (q = 0) or g + 8 (q = 1), column h*D + 8j + 2t + e
  float acc[2][8];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[q][c] = 0.f;
  const unsigned short* v0 = vs + g * kVStride;
  const unsigned short* v1 = vs + (g + 8) * kVStride;
  for (int r = 0; r < reps; ++r) {
    uint32_t afr[4][4];  // matmul: A fragments of the s tile, k-steps of 16
    float sreg[2][4];    // repeat: s[row][(4t + q)*H + h], the lanes' share
    if constexpr (FORM == kBcMatmul) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = 16 * kk + 2 * t;
        afr[kk][0] = *reinterpret_cast<const uint32_t*>(ss + g * kSStride + k);
        afr[kk][1] = *reinterpret_cast<const uint32_t*>(ss + (g + 8) * kSStride + k);
        afr[kk][2] = *reinterpret_cast<const uint32_t*>(ss + g * kSStride + k + 8);
        afr[kk][3] = *reinterpret_cast<const uint32_t*>(ss + (g + 8) * kSStride + k + 8);
      }
    } else if constexpr (FORM == kBcRepeat) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sreg[0][q] = bits_f(ss[g * kSStride + (4 * t + q) * kH + h]);
        sreg[1][q] = bits_f(ss[(g + 8) * kSStride + (4 * t + q) * kH + h]);
      }
    }
#pragma unroll 2
    for (int l = 0; l < kL; ++l) {
      float s0 = 0.f, s1 = 0.f;
      if constexpr (FORM == kBcRepeat) {
        const int src = g * 4 + (l >> 2);
        float r0 = sreg[0][0], r1 = sreg[1][0];
        switch (l & 3) {  // the register index must be uniform: l is
          case 1: r0 = sreg[0][1]; r1 = sreg[1][1]; break;
          case 2: r0 = sreg[0][2]; r1 = sreg[1][2]; break;
          case 3: r0 = sreg[0][3]; r1 = sreg[1][3]; break;
          default: break;
        }
        s0 = __shfl_sync(0xffffffffu, r0, src);
        s1 = __shfl_sync(0xffffffffu, r1, src);
      } else if constexpr (FORM == kBcNarrow) {
        s0 = bits_f(ss[g * kSStride + l * kH + h]);
        s1 = bits_f(ss[(g + 8) * kSStride + l * kH + h]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = l * kHD + h * kD + 8 * j + 2 * t;
        const uint32_t va = *reinterpret_cast<const uint32_t*>(v0 + col);
        const uint32_t vb = *reinterpret_cast<const uint32_t*>(v1 + col);
        float sb[4] = {s0, s0, s1, s1};
        if constexpr (FORM == kBcMatmul) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          const size_t n = (size_t)l * kHD + h * kD + 8 * j + g;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const size_t kr = (size_t)(16 * kk + 2 * t) * kLHD;
            mma16816(c, afr[kk], pair16(onehot, kr + n, kr + kLHD + n),
                     pair16(onehot, kr + 8 * kLHD + n, kr + 9 * kLHD + n));
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) sb[e] = rbf(c[e]);
        }
        const float term[4] = {rbf(sb[0] * lo_f(va)), rbf(sb[1] * hi_f(va)),
                               rbf(sb[2] * lo_f(vb)), rbf(sb[3] * hi_f(vb))};
        if (l == 0) {
          acc[0][2 * j] = term[0]; acc[0][2 * j + 1] = term[1];
          acc[1][2 * j] = term[2]; acc[1][2 * j + 1] = term[3];
        } else {
          acc[0][2 * j] = rbf(acc[0][2 * j] + term[0]);
          acc[0][2 * j + 1] = rbf(acc[0][2 * j + 1] + term[1]);
          acc[1][2 * j] = rbf(acc[1][2 * j] + term[2]);
          acc[1][2 * j + 1] = rbf(acc[1][2 * j + 1] + term[3]);
        }
      }
    }
    // s = bf16(bf16(s * half) + bf16(acc[:, :64] * zero)); acc[:, :64] is heads 0-1
    if (h < 2) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = h * kD + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(as + g * kLH + c) = pack2(acc[0][2 * j], acc[0][2 * j + 1]);
        *reinterpret_cast<uint32_t*>(as + (g + 8) * kLH + c) = pack2(acc[1][2 * j], acc[1][2 * j + 1]);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < kBcRows * kLH; idx += kBcThreads) {
      const int rr = idx / kLH, c = idx % kLH;
      const float sv = bits_f(ss[rr * kSStride + c]), av = bits_f(as[rr * kLH + c]);
      ss[rr * kSStride + c] = __bfloat16_as_ushort(__float2bfloat16_rn(rbf(sv * half) + rbf(av * zero)));
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = h * kD + 8 * j + 2 * t;
    if (row0 + g < R)
      *reinterpret_cast<uint32_t*>(out + (size_t)(row0 + g) * kHD + c) = pack2(acc[0][2 * j], acc[0][2 * j + 1]);
    if (row0 + g + 8 < R)
      *reinterpret_cast<uint32_t*>(out + (size_t)(row0 + g + 8) * kHD + c) = pack2(acc[1][2 * j], acc[1][2 * j + 1]);
  }
}

template <int FORM>
int launch_bcast(const unsigned short* s, const unsigned short* v, const unsigned short* b,
                 unsigned short* o, int R, int reps, unsigned short hb, unsigned short zb,
                 cudaStream_t st) {
  // above 48 KB of shared memory needs the opt-in, made for the current
  // device on every launch (it is per device, and cheap)
  const cudaError_t e = cudaFuncSetAttribute(
      bcast_chain_kernel<FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBcSmem);
  if (e != cudaSuccess) return (int)e;
  bcast_chain_kernel<FORM><<<(R + kBcRows - 1) / kBcRows, kBcThreads, kBcSmem, st>>>(
      s, v, b, o, R, reps, hb, zb);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). Each returns the cudaError_t of its launch (0 =
// launched), or -1 for arguments the kernel does not take.
extern "C" {

// x: bf16 [R, K] (K a multiple of 32), pool: bf16 [3, K, 128] (form 0 f32:
// the float32 pool's three-part split) or [K, 128] (form 1 bf16, 2 split),
// out: float32 [R, 128]
int gl_mm_chain(int form, const void* x, const void* pool, void* out, int R, int K, int reps,
                int mult_bits, void* stream) {
  if (form < 0 || form > 2 || R < 0 || K < kMmBK || K % kMmBK || reps < 1) return -1;
  if (R == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const auto* xs = (const unsigned short*)x;
  const auto* ps = (const unsigned short*)pool;
  const unsigned short mb = (unsigned short)mult_bits;
  if (form == kFormF32) return launch_mm<kFormF32>(xs, ps, (float*)out, R, K, reps, mb, st);
  if (form == kFormBf16) return launch_mm<kFormBf16>(xs, ps, (float*)out, R, K, reps, mb, st);
  return launch_mm<kFormSplit>(xs, ps, (float*)out, R, K, reps, mb, st);
}

// x, out: bf16 [n]; form 0 f32, 1 bf16exp, 2 mixexp
int gl_silu_chain(int form, const void* x, void* out, long long n, int reps, int mult_bits,
                  void* stream) {
  if (form < 0 || form > 2 || n < 0 || reps < 1) return -1;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long threads = (n >> 1) + (n & 1);
  const unsigned blocks = (unsigned)((threads + kSiluThreads - 1) / kSiluThreads);
  const auto* xs = (const unsigned short*)x;
  auto* os = (unsigned short*)out;
  const unsigned short mb = (unsigned short)mult_bits;
  if (form == kSiluF32)
    silu_chain_kernel<kSiluF32><<<blocks, kSiluThreads, 0, st>>>(xs, os, n, reps, mb);
  else if (form == kSiluBf16Exp)
    silu_chain_kernel<kSiluBf16Exp><<<blocks, kSiluThreads, 0, st>>>(xs, os, n, reps, mb);
  else
    silu_chain_kernel<kSiluMixExp><<<blocks, kSiluThreads, 0, st>>>(xs, os, n, reps, mb);
  return (int)cudaGetLastError();
}

// s: bf16 [R, 64], v: bf16 [R, 2048], onehot: bf16 [64, 2048], out: bf16
// [R, 128]; form 0 matmul, 1 repeat, 2 narrow
int gl_bcast_chain(int form, const void* s, const void* v, const void* onehot, void* out, int R,
                   int reps, int half_bits, int zero_bits, void* stream) {
  if (form < 0 || form > 2 || R < 0 || reps < 1) return -1;
  if (R == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const auto* ss = (const unsigned short*)s;
  const auto* vs = (const unsigned short*)v;
  const auto* bs = (const unsigned short*)onehot;
  auto* os = (unsigned short*)out;
  const unsigned short hb = (unsigned short)half_bits, zb = (unsigned short)zero_bits;
  if (form == kBcMatmul) return launch_bcast<kBcMatmul>(ss, vs, bs, os, R, reps, hb, zb, st);
  if (form == kBcRepeat) return launch_bcast<kBcRepeat>(ss, vs, bs, os, R, reps, hb, zb, st);
  return launch_bcast<kBcNarrow>(ss, vs, bs, os, R, reps, hb, zb, st);
}

}  // extern "C"
