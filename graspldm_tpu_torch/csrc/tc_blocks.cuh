// The network's products on the tensor cores, for ddim_sampler_kernel's
// bfloat16 instantiation (kernels.cu; net_step<T, true> in sampler_body.cuh).
//
// What moves here from resnet1d_blocks.cuh's CUDA-core products: the
// resblocks' two k3 convs, the k3 projection (conv3) and the attention's
// wqkv and wo products (gemm<4>). Each runs as mma.sync.m16n8k16, bf16
// operands, float32 accumulators; the epilogue is the caller's, as before
// (bias, rounding to bf16 at the same points). Only the order of the float32
// sums changes. The FiLM MLP, the init conv, the head, GroupNorm, SiLU, both
// softmaxes and the L x L score and value products stay on the CUDA cores
// (the scores in another summation order, below).
//
// The block: 16 warps (kTcThreads), twice the CUDA-core body's 8. The
// sampler keeps R rows' activations in shared memory for the whole
// trajectory (221 KB at fpc: one block an SM), so every warp the SM gets
// is one of this block's; 8 left both the CUDA-core passes (norms, SiLU,
// softmaxes) and the products waiting on latency. 512 threads cap a
// thread at 128 registers.
// M: the block's R*L tokens (64 at both flagship shapes: 4 m16 tiles); the
//   warps form 2 (M) x 8 (N), a warp owning kTcMT = 2 m-tiles x kTcNT = 2
//   n-tiles (16 columns), looping over column groups where N > 128.
// A: each product first copies its A (token-major [M][Ck], channel fastest:
//   K-major) into a buffer that is dead during the product (QKV, or OUT for
//   wqkv) with the token stride padded by 16 bytes and a zero row after it:
//   at the activations' own stride, 2*Ck bytes, the 8 rows of an ldmatrix
//   tile share a bank group from Ck = 64 on (8-way conflicts). ldmatrix.x4
//   reads the A fragments, one row address a lane, set once a tap: the k3
//   conv's tap shift moves it by one token, and a tap outside the token's
//   row (or a token past M) points it at the zero row. Widths off the
//   16-wide k-step (the init conv emits L = 4 channels, narrow models'
//   8-wide stages) read A value by value where it lies, zero past Ck.
// B: the weights' fragment-ordered bf16 copy (stacked_cuda.tc_fragments,
//   made at packing time, offsets in the tensor-core table of the layout):
//   one coalesced 16-byte __ldg a lane per two n-tiles and k-step, kTcDepth
//   k-steps ahead in registers. It needs no shared memory (there is none to
//   spare beside R rows of activations; a ring of weight slabs would have
//   cost rows), and each weight byte is read by 2 warps a block and step.
//   K and N tails are zero in the copy, so every width the CUDA-core body
//   takes runs here too.
// The CUDA-core passes of this path take their index math from FastDiv
// (TcProducts::Div) in place of the integer division, the same quotients.
// Where a step goes (H100, clock64 sections of one block, fpc): ~50 % in
// these products (staging copies and the FiLM MLP included); GroupNorm
// statistics 16 %, the FiLM and output passes 11 %, softmaxes 8 %,
// LayerNorms 7 %, the rest below 4 % each. Deeper B prefetch did not help;
// 4 m-tiles a warp (each weight byte read once a block) spilled at 128
// registers. wgmma and TMA are later work.
#pragma once

#include "resnet1d_blocks.cuh"

namespace gl {

// the tensor-core table (stacked_cuda.py TC_SLOTS / TC_REC): per stage
// [r1_w1, r1_w2, r2_w1, r2_w2, wqkv, wo, wp, -], then the final block's
// [w1, w2, ...]; each entry an offset into the flat weights
enum : int { T_R1 = 0, T_R2 = 2, T_ATTN = 4, T_PROJ = 6, TC_REC = 8, N_TC = 4 };
constexpr int kTcThreads = 512;  // the block of ddim_sampler_kernel<bf16>: 16 warps
constexpr int kTcMT = 2;         // m-tiles a warp (4 / kTcMT warps share a column group)
constexpr int kTcNT = 2;         // n-tiles a warp: one 16-byte B load a k-step
constexpr int kTcDepth = 2;      // k-steps of B in flight a warp

// n / d and n % d by a multiply-high: m = ceil(2^32 / d) gives the exact
// quotient for n * d < 2^32 (the block's indices: n <= R*L*C, d <= L*C),
// where the integer division (~20 instructions) made the CUDA-core passes
// issue-bound (the same quotients as PlainDiv)
struct FastDiv {
  uint32_t d, m;
  __device__ explicit FastDiv(int d_)
      : d((uint32_t)d_), m(d_ == 1 ? 0u : 0xffffffffu / (uint32_t)d_ + 1u) {}
  __device__ int div(int n) const { return d == 1u ? n : (int)__umulhi((uint32_t)n, m); }
  __device__ int mod(int n) const { return n - div(n) * (int)d; }
};

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[m, n] = sum_k A_k[m] W[k, n] over M tokens, on the tensor cores. The
// k index runs over `taps` taps of Ck channels (Ck padded to 16 in Bf):
// taps 3 is the k3 conv, token m of a row of L reading token m + tap - 1 of
// the same row (zero outside it); taps 1 a dense product of depth Ck (L 1).
// A: bf16 in shared memory, token stride lda. Bf: tc_fragments of W.
// FAST: Ck % 16 == 0, A 16-byte aligned rows and 16 zero bytes at A + M*lda
// (tc_product's staging): each lane's ldmatrix row address is set once a
// tap (the zero row where its token falls outside its row or past M) and
// moves 32 bytes a k-step. Otherwise A is read value by value, zero past Ck.
template <bool FAST, typename Epi>
__device__ inline void tc_mma(int M, int L, int taps, int Ck, int lda, int N,
                              const __nv_bfloat16* A, const __nv_bfloat16* __restrict__ Bf,
                              Epi epi) {
  constexpr int MT = kTcMT, NT = kTcNT, NQ = NT / 2, WM = 4 / MT;
  constexpr int WN = kTcThreads / 32 / WM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int kpt = (Ck + 15) >> 4, KS = taps * kpt;
  const int NP = (N + 15) >> 4;
  const int ngroups = (N + 8 * NT - 1) / (8 * NT);
  const int shift = taps == 3 ? 1 : 0;
  const unsigned short* Au = reinterpret_cast<const unsigned short*>(A);
  const uint32_t a_s = (uint32_t)__cvta_generic_to_shared(A);
  // the row this lane addresses in m-tile i: lane & 15 (ldmatrix), or
  // (generic path) g and g + 8, the rows of its A registers
  const int off = FAST ? lane & 15 : g;

  for (int m0 = wm * 16 * MT; m0 < M; m0 += 64) {
    // source token of row r at tap offset dl, or -1 outside its row / past M
    auto src_of = [&](int r, int dl) {
      const int sl = r % L + dl;
      return r < M && sl >= 0 && sl < L ? r + dl : -1;
    };
    for (int cg = wn; cg < ngroups; cg += WN) {
      const int p0 = cg * NQ;
      float acc[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

      const uint4* bsrc = reinterpret_cast<const uint4*>(Bf) + (size_t)p0 * 32 + lane;
      const size_t bstep = (size_t)NP * 32;
      uint4 bq[kTcDepth][NQ];
      auto load_b = [&](uint4(&dst)[NQ], int ks) {
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          dst[q] = p0 + q < NP ? __ldg(bsrc + ks * bstep + q * 32) : make_uint4(0u, 0u, 0u, 0u);
      };
#pragma unroll
      for (int d = 0; d < kTcDepth; ++d)
        if (d < KS) load_b(bq[d], d);

      uint32_t addr[MT], inc[MT];  // FAST: ldmatrix row address, its step
      int sg[MT], sg8[MT];         // generic: source tokens of rows g, g + 8
      int tap = 0, c0 = 0;
      for (int ks0 = 0; ks0 < KS; ks0 += kTcDepth) {
#pragma unroll
        for (int d = 0; d < kTcDepth; ++d) {
          const int ks = ks0 + d;
          if (ks >= KS) break;
          if (c0 == 0) {  // a new tap
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              const int r = m0 + 16 * i + off, s = src_of(r, tap - shift);
              if (FAST) {
                addr[i] = s < 0 ? a_s + 2u * (uint32_t)(M * lda)
                                : a_s + 2u * (uint32_t)(s * lda + (lane >> 4) * 8);
                inc[i] = s < 0 ? 0u : 32u;
              } else {
                sg[i] = s;
                sg8[i] = src_of(r + 8, tap - shift);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            uint32_t a[4];
            if (FAST) {
              asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                           : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                           : "r"(addr[i]));
              addr[i] += inc[i];
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int s = e & 1 ? sg8[i] : sg[i];
                const int c = c0 + 2 * t + (e & 2 ? 8 : 0);
                const uint32_t lo = s >= 0 && c < Ck ? Au[(size_t)s * lda + c] : 0u;
                const uint32_t hi = s >= 0 && c + 1 < Ck ? Au[(size_t)s * lda + c + 1] : 0u;
                a[e] = lo | (hi << 16);
              }
            }
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              mma_bf16(acc[i][2 * q], a, bq[d][q].x, bq[d][q].y);
              mma_bf16(acc[i][2 * q + 1], a, bq[d][q].z, bq[d][q].w);
            }
          }
          if (ks + kTcDepth < KS) load_b(bq[d], ks + kTcDepth);
          c0 += 16;
          if (c0 == kpt * 16) { c0 = 0; ++tap; }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = m0 + 16 * i + g + (e >> 1) * 8;
            const int n = (2 * p0 + j) * 8 + 2 * t + (e & 1);
            if (m < M && n < N) epi(m, n, acc[i][j][e]);
          }
    }
  }
}

// The product, its A first copied into `scratch` (a buffer that is dead
// during the product, `cap` elements) with the token stride padded by 16
// bytes and a zero row after it: at the activations' own stride, 2*Ck
// bytes, the 8 rows of an ldmatrix tile share one bank group from Ck = 64
// on (8-way conflicts). Widths that are not a multiple of 16, or a scratch
// too small, take the value-by-value path on A where it lies.
template <typename Epi>
__device__ inline void tc_product(int M, int L, int taps, int Ck, int lda, int N,
                                  const __nv_bfloat16* A, const __nv_bfloat16* __restrict__ Bf,
                                  __nv_bfloat16* scratch, int cap, Epi epi) {
  const int ld = Ck + 8;
  if ((Ck & 15) == 0 && (lda & 7) == 0 && (M + 1) * ld <= cap) {
    const int cpr = Ck >> 3;  // 16-byte chunks a row
    for (int idx = threadIdx.x; idx < (M + 1) * cpr; idx += blockDim.x) {
      const int m = idx / cpr, c = (idx - m * cpr) * 8;
      *reinterpret_cast<uint4*>(scratch + (size_t)m * ld + c) =
          m < M ? *reinterpret_cast<const uint4*>(A + (size_t)m * lda + c)
                : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    tc_mma<true>(M, L, taps, Ck, ld, N, scratch, Bf, epi);
  } else {
    tc_mma<false>(M, L, taps, Ck, lda, N, A, Bf, epi);
  }
}

// The products of one network piece (a resblock, the attention or the
// projection) on the tensor cores: `slots` are the piece's entries in the
// tensor-core table, scratch[i] / cap[i] a buffer that is dead during
// product i; the math-form weight pointer the body passes is unused.
struct TcProducts {
  using Div = FastDiv;
  const __nv_bfloat16* Wf;
  const long long* slots;
  __nv_bfloat16* scratch[2];
  int cap[2];

  // the attention's scores on the CUDA cores (SimtProducts::scores), each
  // thread's dot product over d taken from d = 2j on (mod 32): the L
  // threads of one (r, h, l) then read k rows j in distinct banks (the rows
  // lie 3 * kHd values apart, one bank group; from d = 0 they conflict L-way)
  __device__ void scores(const __nv_bfloat16* QKV, float* S, int R, int L) const {
    constexpr int W3 = 3 * kHd;
    for (int p = threadIdx.x; p < R * kHeads * L * L; p += blockDim.x) {
      const int j = p % L, l = (p / L) % L, h = (p / (L * L)) % kHeads, r = p / (L * L * kHeads);
      const __nv_bfloat162* q =
          reinterpret_cast<const __nv_bfloat162*>(QKV + (size_t)(r * L + l) * W3 + h * kDimHead);
      const __nv_bfloat162* k = reinterpret_cast<const __nv_bfloat162*>(
          QKV + (size_t)(r * L + j) * W3 + kHd + h * kDimHead);
      float s = 0.f;
#pragma unroll 8
      for (int w = 0; w < kDimHead / 2; ++w) {
        const int d2 = (w + j) & (kDimHead / 2 - 1);
        const float2 qv = __bfloat1622float2(q[d2]), kv = __bfloat1622float2(k[d2]);
        s = fmaf(qv.x, kv.x, s);
        s = fmaf(qv.y, kv.y, s);
      }
      S[p] = s;
    }
  }
  template <typename Epi>
  __device__ void conv3(int i, int M, int L, int C, int N, const __nv_bfloat16* X,
                        const __nv_bfloat16*, Epi epi) const {
    tc_product(M, L, 3, C, C, N, X, Wf + slots[i], scratch[i], cap[i], epi);
  }
  template <typename Epi>
  __device__ void gemm(int i, int M, int N, int K, const __nv_bfloat16* A, int lda,
                       const __nv_bfloat16*, Epi epi) const {
    tc_product(M, 1, 1, K, lda, N, A, Wf + slots[i], scratch[i], cap[i], epi);
  }
};

}  // namespace gl
