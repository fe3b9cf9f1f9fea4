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
//   2048, 12 reps, against ~39 MB of bytes: operations bound, at 67 TFLOP/s
//   on the CUDA cores (f32) or 989 on the tensor cores (bf16, split x2).
//   Design: the product stays dense (the tool times a dense product; the
//   one-hot pool is not exploited). The reps loop runs inside the K loop:
//   a block loads its x tile and pool tile once and runs every rep on them,
//   carrying x_r in registers, so x and the pool are read from memory once
//   and the reps cost only products. The sums are taken in another order
//   than the plain version's (rep by rep), within float32 rounding.
//   * f32: SIMT float32 FMA (no TF32: x*x has 16 significant bits). A
//     block of 128 threads owns 32 rows x 128 columns, 4 x 8 outputs a
//     thread; per K tile of 16 the float32 pool tile and each rep's squares
//     sit in shared memory.
//   * bf16 / split: tensor cores, mma.sync.m16n8k16 bf16 x bf16 -> float32.
//     A block of 4 warps owns 32 rows; a warp owns 16 rows x 64 columns (8
//     n-tiles of 8). Per k-step of 16 each thread loads its A-fragment
//     pairs of x straight from device memory and its B fragments of the
//     bf16 pool (16-bit loads, cached), keeps both in registers for all
//     reps, and forms each rep's A in registers: bf16: bf16(x*x); split:
//     hi = bf16(x*x), lo = bf16(x*x - hi), two products into one sum.
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
constexpr int kMmThreads = 128;
constexpr int kMmRows = 32;  // rows a block owns, both bodies
constexpr int kF32BK = 16;
enum { kFormF32 = 0, kFormBf16 = 1, kFormSplit = 2 };

template <int FORM>
__global__ void __launch_bounds__(kMmThreads)
mm_chain_kernel(const unsigned short* __restrict__ x, const float* __restrict__ pf,
                const unsigned short* __restrict__ pb, float* __restrict__ out, int R, int K,
                int reps, unsigned short mult_bits) {
  const float m = bits_f(mult_bits);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kMmRows;
  if constexpr (FORM == kFormF32) {
    __shared__ __align__(16) float Ss[kF32BK][kMmRows];  // this rep's squares, k-major
    __shared__ __align__(16) float Bs[kF32BK][kMmN];
    const int tx = tid & 15, ty = tid >> 4;        // outputs: rows ty*4+i, cols tx*4+j, 64+tx*4+j
    const int lr = tid >> 2, lk = (tid & 3) * 4;   // x tile: row lr, k lk..lk+3
    const bool lok = row0 + lr < R;
    const unsigned short* xr = x + (size_t)(lok ? row0 + lr : 0) * K;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kF32BK) {
      // every thread passed the previous tile's last barrier: its readers are done
      float xv[4] = {0.f, 0.f, 0.f, 0.f};
      if (lok) {
        const uint2 raw = __ldg(reinterpret_cast<const uint2*>(xr + k0 + lk));
        xv[0] = lo_f(raw.x); xv[1] = hi_f(raw.x); xv[2] = lo_f(raw.y); xv[3] = hi_f(raw.y);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + i * kMmThreads, kk = idx >> 5, c4 = idx & 31;
        reinterpret_cast<float4*>(&Bs[kk][0])[c4] =
            __ldg(reinterpret_cast<const float4*>(pf + (size_t)(k0 + kk) * kMmN) + c4);
      }
      for (int r = 0; r < reps; ++r) {
#pragma unroll
        for (int i = 0; i < 4; ++i) Ss[lk + i][lr] = xv[i] * xv[i];  // exact in float32
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kF32BK; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(&Ss[kk][ty * 4]);
          const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
          const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = rbf(xv[i] * m);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
      if (row < R) {
        float4* o = reinterpret_cast<float4*>(out + (size_t)row * kMmN);
        o[tx] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        o[16 + tx] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
  } else {
    const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
    const int rbase = row0 + (warp >> 1) * 16, cbase = (warp & 1) * 64;
    const bool ok0 = rbase + g < R, ok1 = rbase + g + 8 < R;
    const uint32_t* x0 = reinterpret_cast<const uint32_t*>(x + (size_t)(ok0 ? rbase + g : 0) * K);
    const uint32_t* x1 = reinterpret_cast<const uint32_t*>(x + (size_t)(ok1 ? rbase + g + 8 : 0) * K);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 16) {
      // A pairs: (row g, k0+2t), (row g+8, k0+2t), (row g, k0+2t+8), (row g+8, k0+2t+8)
      const int p = (k0 >> 1) + t;
      uint32_t xa[4] = {ok0 ? __ldg(x0 + p) : 0u, ok1 ? __ldg(x1 + p) : 0u,
                        ok0 ? __ldg(x0 + p + 4) : 0u, ok1 ? __ldg(x1 + p + 4) : 0u};
      // B pairs of column n = cbase + 8j + g: rows (k0+2t, +1) and (k0+2t+8, +9)
      uint32_t b[8][2];
      const size_t kr = (size_t)(k0 + 2 * t) * kMmN;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const size_t n = cbase + 8 * j + g;
        b[j][0] = pair16(pb, kr + n, kr + kMmN + n);
        b[j][1] = pair16(pb, kr + 8 * kMmN + n, kr + 9 * kMmN + n);
      }
      for (int r = 0; r < reps; ++r) {
        uint32_t a[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float f0 = lo_f(xa[i]), f1 = hi_f(xa[i]);
          const float q0 = f0 * f0, q1 = f1 * f1;  // exact in float32
          a[i] = pack2(q0, q1);
          if constexpr (FORM == kFormSplit) alo[i] = pack2(q0 - lo_f(a[i]), q1 - hi_f(a[i]));
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mma16816(acc[j], a, b[j][0], b[j][1]);
          if constexpr (FORM == kFormSplit) mma16816(acc[j], alo, b[j][0], b[j][1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) xa[i] = pack2(lo_f(xa[i]) * m, hi_f(xa[i]) * m);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cbase + 8 * j + 2 * t;
      if (ok0)
        *reinterpret_cast<float2*>(out + (size_t)(rbase + g) * kMmN + col) =
            make_float2(acc[j][0], acc[j][1]);
      if (ok1)
        *reinterpret_cast<float2*>(out + (size_t)(rbase + g + 8) * kMmN + col) =
            make_float2(acc[j][2], acc[j][3]);
    }
  }
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

// x: bf16 [R, K] (K a multiple of 16), pf: float32 [K, 128], pb: bf16
// [K, 128], out: float32 [R, 128]; form 0 f32, 1 bf16, 2 split
int gl_mm_chain(int form, const void* x, const void* pf, const void* pb, void* out, int R, int K,
                int reps, int mult_bits, void* stream) {
  if (form < 0 || form > 2 || R < 0 || K < 16 || K % 16 || reps < 1) return -1;
  if (R == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((R + kMmRows - 1) / kMmRows);
  const auto* xs = (const unsigned short*)x;
  const auto* pbs = (const unsigned short*)pb;
  const unsigned short mb = (unsigned short)mult_bits;
  if (form == kFormF32)
    mm_chain_kernel<kFormF32><<<grid, kMmThreads, 0, st>>>(xs, (const float*)pf, pbs, (float*)out,
                                                          R, K, reps, mb);
  else if (form == kFormBf16)
    mm_chain_kernel<kFormBf16><<<grid, kMmThreads, 0, st>>>(xs, (const float*)pf, pbs,
                                                           (float*)out, R, K, reps, mb);
  else
    mm_chain_kernel<kFormSplit><<<grid, kMmThreads, 0, st>>>(xs, (const float*)pf, pbs,
                                                            (float*)out, R, K, reps, mb);
  return (int)cudaGetLastError();
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
