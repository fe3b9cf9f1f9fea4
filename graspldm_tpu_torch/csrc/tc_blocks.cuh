// The network's products on the tensor cores: TcProducts<T>, for the
// network bodies of ddim_sampler_kernel (both dtypes; kernels.cu),
// full_kernel<bf16> and full_kernel<float> (full_net.cu), the float32
// ddim_step_kernel, churn_sampler_kernel, churn_step_kernel and
// dpmpp_sampler_kernel (step_samplers.cu, churn_sampler.cu,
// dpmpp_sampler.cu; all through net_body in sampler_body.cuh), and
// stage_kernel and final_kernel in both dtypes (kernels.cu).
//
// What moves here from resnet1d_blocks.cuh's CUDA-core products: the
// resblocks' two k3 convs, the k3 projection (conv3) and the attention's
// wqkv and wo products (gemm<4>). Each runs as mma.sync.m16n8k16, bf16
// operands, float32 accumulators; the epilogue is the caller's, as before
// (bias, rounding to T at the same points). Only the order of the float32
// sums changes. The FiLM MLP, the init conv, the head, GroupNorm, SiLU, both
// softmaxes and the L x L score and value products stay on the CUDA cores
// (the scores in another summation order, below).
//
// float32 (full_kernel<float>, the float32 decoder pair, DDIM, DPM++ and
// churn kernels): the exact bf16 split. The function stays the float32 one.
// A float32 value is the sum of three bf16 values exactly (8 + 8 + 8
// significant bits hold its 24 wherever no part underflows bf16):
// x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2). The weights are
// split at packing time (stacked_cuda.bf16_parts), the activations when a
// product stages its A operand. Of the nine bf16 products a_i * w_j the six
// with i + j <= 4 (1-based) run: a1w1, a1w2, a1w3, a2w1, a2w2, a3w1. The three
// dropped are each at most 2^-24 of their term, below float32's own
// rounding. a1w1 accumulates in one set of float32 fragments, the five
// smaller products in another, added at the end: each mma aligns its sum
// to the largest of its addends and drops the bits below, so the small
// products lose their low bits against a sum 2^-8 as large as the main
// one, not against the main sum itself.
//
// The block: 16 warps (kTcThreads), twice the CUDA-core body's 8. The
// sampler keeps R rows' activations in shared memory for the whole
// trajectory (221 KB at fpc: one block an SM), so every warp the SM gets
// is one of this block's; 8 left both the CUDA-core passes (norms, SiLU,
// softmaxes) and the products waiting on latency. 512 threads cap a
// thread at 128 registers.
// M: the block's R*L tokens. A warp's unit is kTcMT = 2 m-tiles (32 tokens)
//   x kTcNT = 2 n-tiles (16 columns) over the whole depth; the units of a
//   product go round the 16 warps, token pairs fastest: at M = 64 (every
//   bf16 network body at fpc and ppc) that is the 2 (M) x 8 (N) warp grid,
//   looping over column groups where N > 128 (final_kernel<bf16>'s 4 rows
//   at the decoder too); at M = 32 (full_kernel<float> and the float32
//   DDIM, DPM++ and churn kernels at fpc and ppc) 16 warps over 256
//   columns; at M = 96-160 (the bf16 decoder stages) 3 to 5 token pairs.
//   A unit finds its tokens' positions in their rows once (the k3 conv's
//   taps test them against the row's ends), not at each tap. An m-tile
//   wholly past M (the second of the last pair where M / 16 is odd) runs on
//   the zero row: skipping it cost more in the k-loop's branches than it
//   saved.
// A: each product first copies its A (token-major [M][Ck], channel fastest:
//   K-major) into buffers that are dead during the product with the token
//   stride padded by 16 bytes and a zero row after it: at the activations'
//   own stride, 2*Ck bytes, the 8 rows of an ldmatrix tile share a bank
//   group from Ck = 64 on (8-way conflicts). float32 A is split into its
//   three parts on the way, each staged the same way. ldmatrix.x4 reads the
//   A fragments, one row address a lane, set once a tap: the k3 conv's tap
//   shift moves it by one token, and a tap outside the token's row (or a
//   token past M) points it at the zero row. Widths off the 16-wide k-step
//   (the init conv emits L = 4 channels, narrow models' 8-wide stages), or
//   parts that the dead buffers cannot hold, read A value by value where it
//   lies (split in registers for float32), zero past Ck.
// B: the weights' fragment-ordered bf16 copy (stacked_cuda.tc_fragments,
//   made at packing time, offsets in the tensor-core table of the layout;
//   float32: the three parts one after the other, each a whole copy, so the
//   table keeps one entry a product and the part stride is the copy's
//   length, taps * Ck16 * N16): one coalesced 16-byte __ldg a lane per two
//   n-tiles, part and k-step, two k-steps ahead in registers (the split:
//   one). It needs no shared memory (there is none to spare beside R rows
//   of activations; a ring of weight slabs would have cost rows), and each
//   weight byte is read by 2 warps a block and step at M = 64, by one at
//   M = 32. K and N tails are zero in
//   the copy, so every width the CUDA-core body takes runs here too.
// The CUDA-core passes of this path take their index math from FastDiv
// (TcProducts::Div) in place of the integer division, the same quotients.
// Where a bf16 sampler step goes (H100, clock64 sections of one block,
// fpc): ~50 % in these products (staging copies and the FiLM MLP
// included); GroupNorm statistics 16 %, the FiLM and output passes 11 %,
// softmaxes 8 %, LayerNorms 7 %, the rest below 4 % each. Deeper B
// prefetch did not help; 4 m-tiles a warp (each weight byte read once a
// block) spilled at 128 registers. wgmma and TMA are later work.
// Where a float32 sampler step goes (ddim_sampler_kernel<float>, fpc BG
// 4096, block 0, clock64 at each barrier; 0.80 M cycles an evaluation):
// the products' unit loops 50 % (warp 0: 0.40 M the staged ones, 44 K the
// value-by-value ones), their staging copies 10 %, GroupNorm 16 % (the two
// statistics passes 34-36 K each, the normalise pass 31 K, the output pass
// 26 K), the attention's CUDA-core passes 12 %, the head 3 %. The float32
// body runs at the 128-register cap of 512 threads, and what stays live
// through a product's k-loop spills into it: every design that kept more
// there (GroupNorm statistics in the convs' epilogues and its apply in the
// next product's staging, in five forms) read 200-292 ms against 163-164,
// its unit loops 0.54-0.70 M cycles against 0.40 M; tc_mma out of line
// reads 325 ms even in the two-pass body. What gained is float32 GroupNorm
// as one warp pass a group (resnet1d_blocks.cuh: gn_pass), which adds no
// long-lived value (kernels.cu gives its times).
//
// Decisions, each timed against the sources without it by
// tools/kernel_variants.py (H100 80GB HBM3, 700.00 W; full_kernel<float> at
// the class CFG's fpc BG = 8192 unless named; variants that cannot touch it
// read 2.83-2.91 ms, the noise):
//   * the split's three A parts are staged side by side, in the piece's
//     dead buffers (piece_products), so each k-step reads every weight part
//     once; staging them in turns into one buffer would read the weights
//     three times a k-step;
//   * six products, not five: without a3w1 the error against full_plain
//     reads 6.9e-5 of max(1, max|ref|), 37x the float32 stage chain's
//     1.9e-6 (4096 rows: 6.5e-5; ppc 2048: 1.8e-5), for 2.63 ms against
//     2.91. It stays under TOL_FP32 (1e-4); chip_smoke.py's CUDA-core
//     control (4x the chain's error) is what fails it;
//   * the five small products in accumulators of their own: 3.2e-6 where
//     one accumulator for all six reads 6.2e-6 (4096: 2.3e-6 against 7.0e-6;
//     ppc 2048: 1.9e-6 against 6.8e-6), for 2.79 -> 2.91 ms;
//   * one k-step of B ahead for the split (a second k-step of its three
//     parts spills): 2.91 ms against 3.03 with two (4096: 1.45 / 1.52; ppc
//     2048: 2.94 / 3.14); bf16 keeps two (the bf16 DDIM sampler 75.3 ms
//     against 78.3 with one, the decode's 4 stage launches 2.65 against
//     2.77);
//   * the warp units go round the warps (the loop in tc_mma) rather than
//     a fixed 2 (M) x 8 (N) warp grid: 2.91 ms against 3.78 (at M = 32 the
//     grid idles half its warps) and the decode's stage launches 2.65
//     against 2.84 (their 3 to 5 token pairs balance), for 75.3 against
//     74.8 ms in the bf16 DDIM sampler (M = 64: the same units to the same
//     warps);
//   * a unit's row positions found once, not at each tap (an integer
//     division a tap and m-tile): the bf16 DDIM sampler 75.3 ms against
//     76.9, below the sampler's own body before net_body was shared
//     (76.6-76.9 in chip_smoke.py's runs of the same call);
//   * bf16's single A part placed without the division that counts the
//     split's parts into the first buffer (the bf16 DDIM sampler 75.3 ms
//     against 75.6);
//   * an m-tile wholly past M runs on the zero row (skipping it: 3.15 ms
//     against 2.91; the bf16 DDIM sampler 76.7 against 75.3);
//   * net_body forced inline (not inlined into full_kernel<float>, it
//     reads 3.49 ms against 2.91; ppc 2048: 3.65 against 2.94).
#pragma once

#include "resnet1d_blocks.cuh"

namespace gl {

// the tensor-core table (stacked_cuda.py TC_SLOTS / TC_REC): per stage
// [r1_w1, r1_w2, r2_w1, r2_w2, wqkv, wo, wp, -], then the final block's
// [w1, w2, ...]; each entry an offset into the flat weights
enum : int { T_R1 = 0, T_R2 = 2, T_ATTN = 4, T_PROJ = 6, TC_REC = 8, N_TC = 4 };
constexpr int kTcThreads = 512;  // the tensor-core body's block: 16 warps
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcMT = 2;         // m-tiles a warp's unit
constexpr int kTcNT = 2;         // n-tiles a unit: one 16-byte B load a k-step and part
constexpr int kTcDepth = 2;      // k-steps of B in flight a warp (bf16)

// bf16 parts of an A operand of type TA: bf16 activations are their own
// single part, float32 ones the exact three-part split
template <typename TA> constexpr int kParts = 1;
template <> constexpr int kParts<float> = 3;

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

// v = h1 + h2 + h3 exactly, the bits of three bf16 values (the rule of
// stacked_cuda.bf16_parts)
__device__ __forceinline__ void split3(float v, uint32_t (&h)[3]) {
  const __nv_bfloat16 a1 = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(a1);
  const __nv_bfloat16 a2 = __float2bfloat16_rn(r1);
  const __nv_bfloat16 a3 = __float2bfloat16_rn(r1 - __bfloat162float(a2));
  h[0] = __bfloat16_as_ushort(a1);
  h[1] = __bfloat16_as_ushort(a2);
  h[2] = __bfloat16_as_ushort(a3);
}

// the parts' bits of A[s, c]: zero outside the row (s < 0) or past Ck
template <typename TA>
__device__ __forceinline__ void a_bits(const TA* A, int lda, int s, int c, int Ck,
                                       uint32_t (&h)[kParts<TA>]) {
  if (s < 0 || c >= Ck) {
#pragma unroll
    for (int p = 0; p < kParts<TA>; ++p) h[p] = 0u;
  } else if constexpr (kParts<TA> == 1) {
    h[0] = __bfloat16_as_ushort(A[(size_t)s * lda + c]);
  } else {
    split3(A[(size_t)s * lda + c], h);
  }
}

// out[m, n] = sum_k A_k[m] W[k, n] over M tokens, on the tensor cores. The
// k index runs over `taps` taps of Ck channels (Ck padded to 16 in Bf):
// taps 3 is the k3 conv, token m of a row of L reading token m + tap - 1 of
// the same row (zero outside it); taps 1 a dense product of depth Ck (L 1).
// Bf: tc_fragments of W (float32 A: of its three parts, one after another).
// FAST: Ck % 16 == 0 and A's parts staged by tc_product (shared addresses
// a_s, token stride lda, 16 zero bytes at each part + M*lda): each lane's
// ldmatrix row address is set once a tap (the zero row where its token
// falls outside its row or past M) and moves 32 bytes a k-step. Otherwise
// A (type TA, token stride lda) is read value by value, zero past Ck.
template <bool FAST, typename TA, typename Epi>
__device__ inline void tc_mma(int M, int L, int taps, int Ck, int lda, int N, const TA* A,
                              const uint32_t (&a_s)[kParts<TA>],
                              const __nv_bfloat16* __restrict__ Bf, Epi epi) {
  constexpr int NA = kParts<TA>, MT = kTcMT, NT = kTcNT, NQ = NT / 2;
  // k-steps of B in flight: the split's three parts a k-step take three
  // times the registers, and a second k-step of them spills
  constexpr int DEPTH = NA == 1 ? kTcDepth : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kpt = (Ck + 15) >> 4, KS = taps * kpt;
  const int NP = (N + 15) >> 4;
  const int ngroups = (N + 8 * NT - 1) / (8 * NT);
  const int mgroups = (M + 16 * MT - 1) / (16 * MT);
  const int shift = taps == 3 ? 1 : 0;
  const size_t bstep = (size_t)NP * 32;   // uint4 of B a k-step
  const size_t bpart = (size_t)KS * bstep;  // and a part
  // the row this lane addresses in m-tile i: lane & 15 (ldmatrix), or
  // (generic path) g and g + 8, the rows of its A registers
  const int off = FAST ? lane & 15 : g;
  // source token of row r (at position rl in its row) at tap offset dl, or
  // -1 outside its row / past M
  auto src_of = [&](int r, int rl, int dl) {
    return r < M && rl + dl >= 0 && rl + dl < L ? r + dl : -1;
  };

  const FastDiv md(mgroups);
  for (int u = warp; u < mgroups * ngroups; u += kTcWarps) {
    const int m0 = md.mod(u) * 16 * MT, p0 = md.div(u) * NQ;
    int rl[MT], rl8[MT];  // positions in their rows of this lane's rows
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      rl[i] = (m0 + 16 * i + off) % L;
      rl8[i] = (m0 + 16 * i + off + 8) % L;
    }
    float acc[MT][NT][4], acs[MT][NT][4];  // acs: the five small split products
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = acs[i][j][e] = 0.f;

    const uint4* bsrc = reinterpret_cast<const uint4*>(Bf) + (size_t)p0 * 32 + lane;
    uint4 bq[DEPTH][NA][NQ];
    auto load_b = [&](uint4(&dst)[NA][NQ], int ks) {
#pragma unroll
      for (int p = 0; p < NA; ++p)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          dst[p][q] = p0 + q < NP ? __ldg(bsrc + p * bpart + ks * bstep + q * 32)
                                  : make_uint4(0u, 0u, 0u, 0u);
    };
#pragma unroll
    for (int d = 0; d < DEPTH; ++d)
      if (d < KS) load_b(bq[d], d);

    uint32_t addr[MT], inc[MT];  // FAST: part 0's ldmatrix row address, its step
    int sg[MT], sg8[MT];         // generic: source tokens of rows g, g + 8
    int tap = 0, c0 = 0;
    for (int ks0 = 0; ks0 < KS; ks0 += DEPTH) {
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) {
        const int ks = ks0 + d;
        if (ks >= KS) break;
        if (c0 == 0) {  // a new tap
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const int r = m0 + 16 * i + off, s = src_of(r, rl[i], tap - shift);
            if (FAST) {
              addr[i] = s < 0 ? a_s[0] + 2u * (uint32_t)(M * lda)
                              : a_s[0] + 2u * (uint32_t)(s * lda + (lane >> 4) * 8);
              inc[i] = s < 0 ? 0u : 32u;
            } else {
              sg[i] = s;
              sg8[i] = src_of(r + 8, rl8[i], tap - shift);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t a[NA][4];
          if (FAST) {
#pragma unroll
            for (int p = 0; p < NA; ++p)
              asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                           : "=r"(a[p][0]), "=r"(a[p][1]), "=r"(a[p][2]), "=r"(a[p][3])
                           : "r"(addr[i] + (a_s[p] - a_s[0])));
            addr[i] += inc[i];
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int s = e & 1 ? sg8[i] : sg[i];
              const int c = c0 + 2 * t + (e & 2 ? 8 : 0);
              uint32_t lo[NA], hi[NA];
              a_bits(A, lda, s, c, Ck, lo);
              a_bits(A, lda, s, c + 1, Ck, hi);
#pragma unroll
              for (int p = 0; p < NA; ++p) a[p][e] = lo[p] | (hi[p] << 16);
            }
          }
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            mma_bf16(acc[i][2 * q], a[0], bq[d][0][q].x, bq[d][0][q].y);
            mma_bf16(acc[i][2 * q + 1], a[0], bq[d][0][q].z, bq[d][0][q].w);
            if constexpr (NA == 3) {  // the five small products of the split
              auto small = [&](const uint32_t(&av)[4], const uint4& bv) {
                mma_bf16(acs[i][2 * q], av, bv.x, bv.y);
                mma_bf16(acs[i][2 * q + 1], av, bv.z, bv.w);
              };
              small(a[0], bq[d][1][q]);
              small(a[0], bq[d][2][q]);
              small(a[1], bq[d][0][q]);
              small(a[1], bq[d][1][q]);
              small(a[2], bq[d][0][q]);
            }
          }
        }
        if (ks + DEPTH < KS) load_b(bq[d], ks + DEPTH);
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
          if (m < M && n < N) epi(m, n, NA == 3 ? acc[i][j][e] + acs[i][j][e] : acc[i][j][e]);
        }
  }
}

// Two buffers, in bf16 elements, that are dead while a product runs: its A
// parts are staged into the first, and those that do not fit into the second
struct TcScratch {
  __nv_bfloat16* p[2];
  int cap[2];
};

// The product, its A first staged (float32 A: split into its three parts)
// into the scratch with the token stride padded by 16 bytes and a zero row
// after each part. Widths that are not a multiple of 16, or parts the
// scratch cannot hold, take the value-by-value path on A where it lies.
template <typename TA, typename Epi>
__device__ inline void tc_product(int M, int L, int taps, int Ck, int lda, int N, const TA* A,
                                  const __nv_bfloat16* __restrict__ Bf, const TcScratch& sc,
                                  Epi epi) {
  constexpr int NA = kParts<TA>;
  const int ld = Ck + 8, part = (M + 1) * ld;
  // parts the first buffer holds (bf16's one part: no division)
  const int n0 = NA == 1 ? (part <= sc.cap[0] ? 1 : 0) : sc.cap[0] / part;
  bool fast = (Ck & 15) == 0 && (lda & 7) == 0;
  __nv_bfloat16* dst[NA];
  uint32_t a_s[NA];
#pragma unroll
  for (int p = 0; p < NA; ++p) {
    dst[p] = p < n0 ? sc.p[0] + p * part : sc.p[1] + (p - n0) * part;
    if (p >= n0 && (p - n0 + 1) * part > sc.cap[1]) fast = false;
    a_s[p] = 0u;
  }
  if (!fast) {
    tc_mma<false>(M, L, taps, Ck, lda, N, A, a_s, Bf, epi);
    return;
  }
  const int cpr = Ck >> 3;  // 8-value chunks a row (16 bytes a part)
  for (int idx = threadIdx.x; idx < (M + 1) * cpr; idx += blockDim.x) {
    const int m = idx / cpr, c = (idx - m * cpr) * 8;
    const TA* src = A + (size_t)m * lda + c;
    if constexpr (NA == 1) {
      *reinterpret_cast<uint4*>(dst[0] + (size_t)m * ld + c) =
          m < M ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint32_t w[NA][4] = {};
      if (m < M) {
        const float4 v0 = *reinterpret_cast<const float4*>(src);
        const float4 v1 = *reinterpret_cast<const float4*>(src + 4);
        const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t lo[NA], hi[NA];
          split3(v[2 * k], lo);
          split3(v[2 * k + 1], hi);
#pragma unroll
          for (int p = 0; p < NA; ++p) w[p][k] = lo[p] | (hi[p] << 16);
        }
      }
#pragma unroll
      for (int p = 0; p < NA; ++p)
        *reinterpret_cast<uint4*>(dst[p] + (size_t)m * ld + c) =
            make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < NA; ++p) a_s[p] = (uint32_t)__cvta_generic_to_shared(dst[p]);
  tc_mma<true>(M, L, taps, Ck, ld, N, A, a_s, Bf, epi);
}

// The products of one network piece (a resblock, the attention or the
// projection) on the tensor cores: `slots` are the piece's entries in the
// tensor-core table (offsets into Wf, in T elements), s[i] the scratch of
// product i; the math-form weight pointer the body passes is unused.
template <typename T>
struct TcProducts {
  using Div = FastDiv;
  // GroupNorm in one pass (resblock_gn) in float32; bf16 keeps the two
  // passes, which read faster there (kernels.cu)
  static constexpr bool kGn = sizeof(T) == 4;
  const T* Wf;
  const long long* slots;
  TcScratch s[2];

  __device__ const __nv_bfloat16* frags(int i) const {
    return reinterpret_cast<const __nv_bfloat16*>(Wf + slots[i]);
  }
  // the attention's scores on the CUDA cores (SimtProducts::scores), each
  // thread's dot product over d taken from d = 2j (bf16 pairs) or j
  // (float32) on, mod 32: the L threads of one (r, h, l) then read k rows j
  // in distinct banks (the rows lie 3 * kHd values apart, one bank group;
  // from d = 0 they conflict L-way)
  __device__ void scores(const T* QKV, float* S, int R, int L) const {
    constexpr int W3 = 3 * kHd;
    for (int p = threadIdx.x; p < R * kHeads * L * L; p += blockDim.x) {
      const int j = p % L, l = (p / L) % L, h = (p / (L * L)) % kHeads, r = p / (L * L * kHeads);
      const T* q = QKV + (size_t)(r * L + l) * W3 + h * kDimHead;
      const T* k = QKV + (size_t)(r * L + j) * W3 + kHd + h * kDimHead;
      float s = 0.f;
      if constexpr (sizeof(T) == 2) {
        const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(q);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(k);
#pragma unroll 8
        for (int w = 0; w < kDimHead / 2; ++w) {
          const int d2 = (w + j) & (kDimHead / 2 - 1);
          const float2 qv = __bfloat1622float2(q2[d2]), kv = __bfloat1622float2(k2[d2]);
          s = fmaf(qv.x, kv.x, s);
          s = fmaf(qv.y, kv.y, s);
        }
      } else {
#pragma unroll 8
        for (int w = 0; w < kDimHead; ++w) {
          const int d = (w + j) & (kDimHead - 1);
          s = fmaf(q[d], k[d], s);
        }
      }
      S[p] = s;
    }
  }
  template <typename Epi>
  __device__ void conv3(int i, int M, int L, int C, int N, const T* X, const T*, Epi epi) const {
    tc_product(M, L, 3, C, C, N, X, frags(i), s[i], epi);
  }
  template <typename Epi>
  __device__ void gemm(int i, int M, int N, int K, const T* A, int lda, const T*, Epi epi) const {
    tc_product(M, 1, 1, K, lda, N, A, frags(i), s[i], epi);
  }
};

// the network pieces, by the buffers dead during their products
enum : int { PIECE_RES = 0, PIECE_ATTN, PIECE_PROJ };

template <typename T>
__device__ inline TcScratch scratch_of(T* a, int na, T* b, int nb) {
  constexpr int k = (int)(sizeof(T) / sizeof(__nv_bfloat16));
  return {{reinterpret_cast<__nv_bfloat16*>(a), reinterpret_cast<__nv_bfloat16*>(b)},
          {na * k, nb * k}};
}

// The products of a piece of a stage-plan network body (stage_plan buffers
// carved in order: X, OUT, H, H2, QKV, then S), whose tensor-core table
// entries start at `slot`: on the tensor cores (TC) or the CUDA cores.
// `out` is whichever of b.X and b.OUT does not hold the piece's input (the
// network bodies swap the two after each stage): it is dead until the
// projection writes it. Scratch (see resblock / attention / proj): the
// resblocks' convs and the projection stage into QKV, then `out` (a
// resblock's) or H (the projection's); the attention's wqkv (writing QKV)
// into `out`, then H2, and its wo into QKV, then `out`.
template <typename T, bool TC>
__device__ inline auto piece_products(const Bufs<T>& b, T* out, const T* __restrict__ Wf,
                                      const long long* __restrict__ net, int slot, int piece) {
  if constexpr (TC) {
    const int nq = (int)(reinterpret_cast<T*>(b.S) - b.QKV);
    const int no = (int)(out == b.X ? b.OUT - b.X : b.H - b.OUT);
    const int nh = (int)(b.H2 - b.H), nh2 = (int)(b.QKV - b.H2);
    const TcScratch qo = scratch_of(b.QKV, nq, out, no);
    TcProducts<T> p{Wf, net + net[N_TC] + slot, {qo, qo}};
    if (piece == PIECE_ATTN) p.s[0] = scratch_of(out, no, b.H2, nh2);
    if (piece == PIECE_PROJ) p.s[0] = scratch_of(b.QKV, nq, b.H, nh);
    return p;
  } else {
    return SimtProducts{};
  }
}

}  // namespace gl
