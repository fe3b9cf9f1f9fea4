// Device building blocks of the conditional 1-D ResNet (denoiser / VAE
// decoder core) for the Hopper kernels in kernels.cu.
//
// Counterpart of the shared Pallas bodies in
// graspldm_tpu/models/stacked_pallas.py (_resblock_k, _attention_k,
// _conv3_k, _norm_apply_k). What they compute, per row of the batch:
//   * ResnetBlock1D: WS-conv k3 -> GroupNorm -> FiLM x*(sum_e scale_e + Ce)
//     + sum_e shift_e -> SiLU -> conv k3 -> GroupNorm -> SiLU, + residual;
//   * residual linear attention x + LN(Wo((q k^T) v) + bo) on LN(x), q
//     softmaxed over the head channels, k over the positions;
//   * k3 projection conv to the next width; 1x1 head to one channel.
//
// Data layout: a block owns R rows; every activation lives in shared memory
// token-major, [R][L][C] with the channel fastest (the [R, L*C]
// position-major layout of the Pallas kernels). Weights stay in global
// memory (read through L1/L2) in their "math" form: k3 convs as
// [3*Cin, Cout] matrices (row index tap*Cin + c), dense layers as [in, out].
//
// Precision: activations are stored in the compute type T (float or bf16)
// between ops; every product accumulates in fp32, and norm statistics,
// softmax, SiLU and the FiLM scale/shift are fp32. The plain PyTorch
// versions in models/stacked_cuda.py round at the same points.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gl {

// ---------------------------------------------------------------------------
// layout of the int64 weight-offset records (models/stacked_cuda.py builds
// them; keep the two in step)
// ---------------------------------------------------------------------------
enum : int {
  R_L = 0, R_C, R_COUT, R_E, R_CE, R_G, R_HEADS, R_DHEAD,
  R_RES1 = 8,    // 10 resblock slots
  R_RES2 = 18,   // 10 resblock slots (stage records)
  R_ATTN_G = 28, R_WQKV, R_WO, R_BO, R_OUT_G, R_WP, R_BP,
  R_FW = 18, R_FB = 19,  // final record: head after its single resblock
  REC_SIZE = 40,
};
enum : int { S_MLPW = 0, S_MLPB, S_W1, S_B1, S_G1, S_BE1, S_W2, S_B2, S_G2, S_BE2 };
enum : int { N_NSTAGES = 0, N_INIT_W, N_INIT_B, N_DIM0, NET_HDR = 8 };

constexpr int kHeads = 4;
constexpr int kDimHead = 32;  // one warp lane per head channel
constexpr int kHd = kHeads * kDimHead;
constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// storage-type helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

template <typename T> __device__ __forceinline__ float ldw(const T* p) { return to_f(__ldg(p)); }

__device__ __forceinline__ void load4(const float* p, float w[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float w[4]) {
  uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.y));
  w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// n / d and n % d in the block's index math (token, channel, group, row):
// the plain integer division. tc_blocks.cuh's FastDiv gives the same
// quotients by a multiply-high.
struct PlainDiv {
  int d;
  __device__ explicit PlainDiv(int d_) : d(d_) {}
  __device__ int div(int n) const { return n / d; }
  __device__ int mod(int n) const { return n % d; }
};

// ---------------------------------------------------------------------------
// shared-memory plan: per-row element counts of every buffer
// ---------------------------------------------------------------------------
__host__ __device__ inline int up8(int n) { return (n + 7) & ~7; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

struct Plan {
  int x, out, h, h2, qkv;             // compute-type buffers
  int s, ss, esum, st, embin, xc;     // fp32 buffers
  __host__ __device__ int t_elems() const { return x + out + h + h2 + qkv; }
  __host__ __device__ int f_elems() const { return s + ss + esum + st + embin + xc; }
};

// one network stage (2 resblocks + attention + proj) at width C -> Cout
__host__ __device__ inline Plan stage_plan(int L, int C, int Cout, int E, int G) {
  Plan p;
  p.x = up8(L * C); p.out = up8(L * Cout); p.h = up8(L * C);
  p.h2 = up8(L * imax(C, kHd)); p.qkv = up8(3 * L * kHd);
  p.s = up8(kHeads * L * L); p.ss = up8(2 * C); p.esum = up8(E); p.st = up8(2 * G);
  p.embin = 0; p.xc = 0;
  return p;
}
// hybrid stage / final block (hybrid.cu): input [L][Cin], an optional k3
// projection to C into OUT (otherwise the resblocks run in X), then
// resblocks at width C; no attention buffers
__host__ __device__ inline Plan hybrid_plan(int L, int Cin, int C, int E, int G, bool proj) {
  Plan p;
  p.x = up8(L * Cin); p.out = proj ? up8(L * C) : 0; p.h = up8(L * C); p.h2 = up8(L * C);
  p.qkv = 0; p.s = 0; p.ss = up8(2 * C); p.esum = up8(E); p.st = up8(2 * G);
  p.embin = 0; p.xc = 0;
  return p;
}
// final resblock + head at width C
__host__ __device__ inline Plan final_plan(int L, int C, int E, int G) {
  Plan p;
  p.x = up8(L * C); p.out = 0; p.h = up8(L * C); p.h2 = up8(L * C); p.qkv = 0;
  p.s = 0; p.ss = up8(imax(2 * C, L)); p.esum = up8(E); p.st = up8(2 * G);
  p.embin = 0; p.xc = 0;
  return p;
}
// whole network for the sampler: buffers sized for the widest stage, plus
// `carry` fp32 vectors of L per row (x, and what the sampler keeps beside
// it); carry vector k of the block starts at XC + k*R*L
__host__ __device__ inline Plan sampler_plan(int L, int cmax, int E, int Ce, int G, int carry) {
  Plan p = stage_plan(L, cmax, cmax, E, G);
  p.ss = up8(imax(2 * cmax, L));
  p.embin = up8(Ce * E); p.xc = carry * up8(L);
  return p;
}

template <typename T>
struct Bufs {
  T *X, *OUT, *H, *H2, *QKV;
  float *S, *SS, *ESUM, *ST, *EMBIN, *XC;
};

template <typename T>
__device__ inline Bufs<T> carve(char* smem, const Plan& p, int R) {
  Bufs<T> b;
  T* t = reinterpret_cast<T*>(smem);
  b.X = t; t += R * p.x;
  b.OUT = t; t += R * p.out;
  b.H = t; t += R * p.h;
  b.H2 = t; t += R * p.h2;
  b.QKV = t; t += R * p.qkv;
  float* f = reinterpret_cast<float*>(t);
  b.S = f; f += R * p.s;
  b.SS = f; f += R * p.ss;
  b.ESUM = f; f += R * p.esum;
  b.ST = f; f += R * p.st;
  b.EMBIN = f; f += R * p.embin;
  b.XC = f;
  return b;
}

// ---------------------------------------------------------------------------
// block-level products. Each thread owns TM x 4 output tiles; a weight row
// segment W[k, n0:n0+4] is one vector load reused over the TM rows.
// ---------------------------------------------------------------------------

// out[m, n] = sum_k A[m*lda + k] * W[k*N + n]   (M % TM == 0, N % 4 == 0)
template <int TM, typename TA, typename TW, typename Epi>
__device__ inline void gemm(int M, int N, int K, const TA* A, int lda,
                            const TW* __restrict__ W, Epi epi) {
  const int ntn = N >> 2;
  const int tiles = (M / TM) * ntn;
  for (int tile = threadIdx.x; tile < tiles; tile += blockDim.x) {
    const int n0 = (tile % ntn) * 4, m0 = (tile / ntn) * TM;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const TA* a = A + (size_t)m0 * lda;
    const TW* w = W + n0;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float wv[4];
      load4(w + (size_t)k * N, wv);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = to_f(a[i * lda + k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(m0 + i, n0 + j, acc[i][j]);
  }
}

// k=3, pad=1 conv along the positions of each row:
// out[m, n] = sum_{t, c} X[m + t - 1, c] * W[(t*C + c)*N + n], taps that
// fall outside the row read zero. M = R*L tokens, L % 4 == 0.
template <typename T, typename Epi>
__device__ inline void conv3(int M, int L, int C, int N, const T* X,
                             const T* __restrict__ W, Epi epi) {
  constexpr int TM = 4;
  const int ntn = N >> 2;
  const int tiles = (M / TM) * ntn;
  for (int tile = threadIdx.x; tile < tiles; tile += blockDim.x) {
    const int n0 = (tile % ntn) * 4, m0 = (tile / ntn) * TM;
    const int l0 = m0 % L;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const T* src[TM];
      bool ok[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int sl = l0 + i + t - 1;
        ok[i] = sl >= 0 && sl < L;
        src[i] = X + (size_t)(ok[i] ? m0 + i + t - 1 : m0) * C;
      }
      const T* w = W + (size_t)t * C * N + n0;
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        float wv[4];
        load4(w + (size_t)c * N, wv);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = ok[i] ? to_f(src[i][c]) : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(m0 + i, n0 + j, acc[i][j]);
  }
}

// The products of a network piece (the resblocks' convs, the attention's
// wqkv / wo / scores, the projection), as the pieces below call them: `i`
// names the product within its piece. These run them on the CUDA cores
// (every kernel); tc_blocks.cuh's TcProducts runs all but the scores on the
// tensor cores.
struct SimtProducts {
  using Div = PlainDiv;
  static constexpr bool kGn = false;  // GroupNorm in two passes (resblock)
  // the attention's scores S[r][h][l][j] = sum_d q[r,l,h,d] k[r,j,h,d], from
  // q and k in QKV [R][L][3 * kHd]
  template <typename T>
  __device__ void scores(const T* QKV, float* S, int R, int L) const {
    constexpr int W3 = 3 * kHd;
    for (int p = threadIdx.x; p < R * kHeads * L * L; p += blockDim.x) {
      const int j = p % L, l = (p / L) % L, h = (p / (L * L)) % kHeads, r = p / (L * L * kHeads);
      const T* q = QKV + (size_t)(r * L + l) * W3 + h * kDimHead;
      const T* k = QKV + (size_t)(r * L + j) * W3 + kHd + h * kDimHead;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < kDimHead; ++d) s = fmaf(to_f(q[d]), to_f(k[d]), s);
      S[p] = s;
    }
  }
  template <typename T, typename Epi>
  __device__ void conv3(int, int M, int L, int C, int N, const T* X, const T* __restrict__ W,
                        Epi epi) const {
    gl::conv3(M, L, C, N, X, W, epi);
  }
  template <typename T, typename Epi>
  __device__ void gemm(int, int M, int N, int K, const T* A, int lda, const T* __restrict__ W,
                       Epi epi) const {
    gl::gemm<4>(M, N, K, A, lda, W, epi);
  }
};

// ---------------------------------------------------------------------------
// norms
// ---------------------------------------------------------------------------

// GroupNorm statistics over (L positions x C/G channels) of each (row,
// group): ST[2*(r*G+g)] = mean, [+1] = rsqrt(var + 1e-5). One warp per pair.
template <typename T, typename D = PlainDiv>
__device__ inline void group_stats(const T* H, int R, int L, int C, int G, float* ST) {
  const int gs = C / G, n = L * gs;
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const D gsd(gs);
  for (int p = threadIdx.x >> 5; p < R * G; p += nw) {
    const T* base = H + (size_t)(p / G) * L * C + (p % G) * gs;
    float s = 0.f;
    for (int i = lane; i < n; i += 32) s += to_f(base[gsd.div(i) * C + gsd.mod(i)]);
    const float mu = warp_sum(s) / n;
    float v = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float d = to_f(base[gsd.div(i) * C + gsd.mod(i)]) - mu;
      v += d * d;
    }
    v = warp_sum(v) / n;
    if (lane == 0) { ST[2 * p] = mu; ST[2 * p + 1] = rsqrtf(v + 1e-5f); }
  }
}

// GroupNorm of Hs in one pass, a warp a (row, group) (resblock, the
// tensor-core bodies): the warp sums the pair's n = L * gs values and their
// squared deviations in group_stats' order (mean and rstd with its bits),
// then applies the norm to the same values, into another buffer (a pair's
// second warp may still be reading Hs): OUT_X == false, the first norm,
// FiLM and SiLU, D = silu(film(gn(Hs))); true, the output pass D = X =
// silu(gn(Hs)) + X.
// One pass and one barrier where group_stats and the apply take two, and
// the outputs are bitwise the two passes'. The loops unrolled by 4 overlap
// the reads (ppc's groups are 1024 values, 32 a lane).
template <bool OUT_X, typename T, typename D>
__device__ inline void gn_pass(const T* Hs, T* Dst, int R, int L, int C, int G,
                               const T* __restrict__ g, const T* __restrict__ be,
                               const float* SS, float ce) {
  const int gs = C / G, n = L * gs, C2 = 2 * C, pairs = R * G;
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  // warps a pair where there are more warps than pairs (ppc: 8 pairs for 16
  // warps): each computes the pair's statistics, the same bits, and applies
  // its share of the values
  const int split = nw >= 2 * pairs ? nw / pairs : 1;
  const D gsd(gs);
  for (int w = threadIdx.x >> 5; w < pairs * split; w += nw) {
    const int p = w % pairs, part = w / pairs;
    const int r = p / G, c0 = (p % G) * gs;
    const T* base = Hs + (size_t)r * L * C + c0;
    float s = 0.f;
#pragma unroll 4
    for (int i = lane; i < n; i += 32) s += to_f(base[gsd.div(i) * C + gsd.mod(i)]);
    const float mu = warp_sum(s) / n;
    float q = 0.f;
#pragma unroll 4
    for (int i = lane; i < n; i += 32) {
      const float d = to_f(base[gsd.div(i) * C + gsd.mod(i)]) - mu;
      q += d * d;
    }
    const float rs = rsqrtf(warp_sum(q) / n + 1e-5f);
#pragma unroll 4
    for (int i = lane + 32 * part; i < n; i += 32 * split) {
      const int cg = gsd.mod(i), c = c0 + cg;
      const size_t idx = (size_t)r * L * C + c0 + gsd.div(i) * C + cg;
      if (OUT_X) {
        const float y = (to_f(Hs[idx]) - mu) * rs * ldw(g + c) + ldw(be + c);
        Dst[idx] = from_f<T>(silu(y) + to_f(Dst[idx]));
      } else {
        float y = (to_f(Hs[idx]) - mu) * rs * ldw(g + c) + ldw(be + c);
        y = y * (SS[r * C2 + c] + ce) + SS[r * C2 + C + c];
        Dst[idx] = from_f<T>(silu(y));
      }
    }
  }
}

// per-token channel LayerNorm (gain only, eps 1e-5): one warp per token.
// resid == nullptr: DST = LN(SRC) * g. Otherwise DST = resid + LN(SRC) * g.
template <typename T>
__device__ inline void layer_norm_tokens(const T* SRC, T* DST, const T* resid, int M, int C,
                                         const T* __restrict__ g) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int m = threadIdx.x >> 5; m < M; m += nw) {
    const T* x = SRC + (size_t)m * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f(x[c]);
    const float mu = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) { const float d = to_f(x[c]) - mu; v += d * d; }
    const float inv = rsqrtf(warp_sum(v) / C + 1e-5f);
    for (int c = lane; c < C; c += 32) {
      float y = (to_f(x[c]) - mu) * inv * ldw(g + c);
      if (resid) y += to_f(resid[(size_t)m * C + c]);
      DST[(size_t)m * C + c] = from_f<T>(y);
    }
  }
}

// ---------------------------------------------------------------------------
// network pieces (each ends with the block synchronised)
// ---------------------------------------------------------------------------

// resblock with each GroupNorm one pass (gn_pass; P::kGn, the float32
// tensor-core bodies): 6 barriers where the two passes of each take 8, with
// the same bits. The weights' pointers are formed where they are used: the
// float32 sampler kernels run at their 128 registers, and what stays live
// through a product's k-loop there is spilled (tc_blocks.cuh says what that
// cost). The body, forced inline: net_body's float32 tensor-core instances
// call it directly (sampler_body.cuh: body_resblock); resblock_gn below is
// the entry of every other caller.
template <typename T, typename P>
__device__ __forceinline__ void resblock_gn_body(const Bufs<T>& b, T* X, int R, int L, int C,
                                                 int E, int Ce, int G, const T* __restrict__ Wf,
                                                 const long long* sl, const P& prod) {
  const int M = R * L, C2 = 2 * C;
  const float ce = (float)Ce;
  float* SS = b.SS;
  T* H = b.H;
  T* H2 = b.H2;
  using D = typename P::Div;

  {
    const T* mlpB = Wf + sl[S_MLPB];
    gemm<1>(R, C2, E, b.ESUM, E, Wf + sl[S_MLPW],
            [&](int r, int n, float acc) { SS[r * C2 + n] = acc + ce * ldw(mlpB + n); });
  }
  {
    const T* b1 = Wf + sl[S_B1];
    prod.conv3(0, M, L, C, C, X, Wf + sl[S_W1],
               [&](int m, int n, float acc) { H[m * C + n] = from_f<T>(acc + ldw(b1 + n)); });
  }
  __syncthreads();
  gn_pass<false, T, D>(H, H2, R, L, C, G, Wf + sl[S_G1], Wf + sl[S_BE1], SS, ce);
  __syncthreads();
  {
    const T* b2 = Wf + sl[S_B2];
    prod.conv3(1, M, L, C, C, H2, Wf + sl[S_W2],
               [&](int m, int n, float acc) { H[m * C + n] = from_f<T>(acc + ldw(b2 + n)); });
  }
  __syncthreads();
  gn_pass<true, T, D>(H, X, R, L, C, G, Wf + sl[S_G2], Wf + sl[S_BE2], SS, ce);
  __syncthreads();
}

template <typename T, typename P>
__device__ inline void resblock_gn(const Bufs<T>& b, T* X, int R, int L, int C, int E, int Ce,
                                   int G, const T* __restrict__ Wf, const long long* sl,
                                   const P& prod) {
  resblock_gn_body(b, X, R, L, C, E, Ce, G, Wf, sl, prod);
}

// ResnetBlock1D at width C on X (in place). ESUM [R][E] is the fp32 sum of
// the Ce conditioning-channel embeddings (sum_e emb_e @ W == sum_e (emb_e @
// W): the multi-channel FiLM needs only the sum). Where P::kGn, it runs as
// resblock_gn.
template <typename T, typename P = SimtProducts>
__device__ inline void resblock(const Bufs<T>& b, T* X, int R, int L, int C, int E, int Ce,
                                int G, const T* __restrict__ Wf, const long long* sl,
                                const P& prod = P()) {
  if constexpr (P::kGn) {  // each GroupNorm one pass
    resblock_gn(b, X, R, L, C, E, Ce, G, Wf, sl, prod);
    return;
  }
  const T* mlpW = Wf + sl[S_MLPW];
  const T* mlpB = Wf + sl[S_MLPB];
  const T* w1 = Wf + sl[S_W1];
  const T* b1 = Wf + sl[S_B1];
  const T* g1 = Wf + sl[S_G1];
  const T* be1 = Wf + sl[S_BE1];
  const T* w2 = Wf + sl[S_W2];
  const T* b2 = Wf + sl[S_B2];
  const T* g2 = Wf + sl[S_G2];
  const T* be2 = Wf + sl[S_BE2];
  const int M = R * L, C2 = 2 * C, gs = C / G;
  const float ce = (float)Ce;
  float* SS = b.SS;
  T* H = b.H;
  T* H2 = b.H2;
  using D = typename P::Div;
  const D cd(C), lcd(L * C), gsd(gs);

  gemm<1>(R, C2, E, b.ESUM, E, mlpW,
          [&](int r, int n, float acc) { SS[r * C2 + n] = acc + ce * ldw(mlpB + n); });
  prod.conv3(0, M, L, C, C, X, w1,
             [&](int m, int n, float acc) { H[m * C + n] = from_f<T>(acc + ldw(b1 + n)); });
  __syncthreads();
  group_stats<T, D>(H, R, L, C, G, b.ST);
  __syncthreads();
  for (int idx = threadIdx.x; idx < M * C; idx += blockDim.x) {
    const int c = cd.mod(idx), r = lcd.div(idx), p = r * G + gsd.div(c);
    float y = (to_f(H[idx]) - b.ST[2 * p]) * b.ST[2 * p + 1] * ldw(g1 + c) + ldw(be1 + c);
    y = y * (SS[r * C2 + c] + ce) + SS[r * C2 + C + c];
    H[idx] = from_f<T>(silu(y));
  }
  __syncthreads();
  prod.conv3(1, M, L, C, C, H, w2,
             [&](int m, int n, float acc) { H2[m * C + n] = from_f<T>(acc + ldw(b2 + n)); });
  __syncthreads();
  group_stats<T, D>(H2, R, L, C, G, b.ST);
  __syncthreads();
  for (int idx = threadIdx.x; idx < M * C; idx += blockDim.x) {
    const int c = cd.mod(idx), r = lcd.div(idx), p = r * G + gsd.div(c);
    const float y = (to_f(H2[idx]) - b.ST[2 * p]) * b.ST[2 * p + 1] * ldw(g2 + c) + ldw(be2 + c);
    X[idx] = from_f<T>(silu(y) + to_f(X[idx]));
  }
  __syncthreads();
}

// Residual linear attention at width C on X (in place):
// X += LN_out(Wo @ ((q k^T) v) + bo), q/k/v from LN_in(X). The body, forced
// inline (net_body's float32 tensor-core instances: body_attention in
// sampler_body.cuh); attention below is the entry of every other caller.
template <typename T, typename P>
__device__ __forceinline__ void attention_body(const Bufs<T>& b, T* X, int R, int L, int C,
                                               const T* __restrict__ Wf, const long long* rec,
                                               const P& prod) {
  const T* gin = Wf + rec[R_ATTN_G];
  const T* wqkv = Wf + rec[R_WQKV];
  const T* wo = Wf + rec[R_WO];
  const T* bo = Wf + rec[R_BO];
  const T* gout = Wf + rec[R_OUT_G];
  const int M = R * L, W3 = 3 * kHd;
  const float qscale = rsqrtf((float)kDimHead);
  T* H = b.H;
  T* H2 = b.H2;
  T* QKV = b.QKV;
  float* S = b.S;

  layer_norm_tokens<T>(X, H, nullptr, M, C, gin);
  __syncthreads();
  prod.gemm(0, M, W3, C, H, C, wqkv,
            [&](int m, int n, float acc) { QKV[m * W3 + n] = from_f<T>(acc); });
  __syncthreads();
  {  // q: softmax over the head channels (one warp per token x head)
    const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int p = threadIdx.x >> 5; p < M * kHeads; p += nw) {
      T* q = QKV + (size_t)(p / kHeads) * W3 + (p % kHeads) * kDimHead;
      const float v = to_f(q[lane]);
      const float e = expf(v - warp_max(v));
      q[lane] = from_f<T>(e / warp_sum(e) * qscale);
    }
    // k: softmax over the L positions (one thread per row x head channel)
    for (int p = threadIdx.x; p < R * kHd; p += blockDim.x) {
      T* k = QKV + (size_t)(p / kHd) * L * W3 + kHd + p % kHd;
      float mx = __int_as_float(0xff800000);  // -inf
      for (int l = 0; l < L; ++l) mx = fmaxf(mx, to_f(k[l * W3]));
      float s = 0.f;
      for (int l = 0; l < L; ++l) s += expf(to_f(k[l * W3]) - mx);
      for (int l = 0; l < L; ++l) k[l * W3] = from_f<T>(expf(to_f(k[l * W3]) - mx) / s);
    }
  }
  __syncthreads();
  prod.scores(QKV, S, R, L);
  __syncthreads();
  // out[r, l, h*D + e] = sum_j S[r][h][l][j] v[r, j, h, e]
  const typename P::Div ld(L);
  for (int p = threadIdx.x; p < M * kHd; p += blockDim.x) {
    const int he = p % kHd, m = p / kHd, r = ld.div(m), l = ld.mod(m), h = he / kDimHead;
    const float* s = S + ((size_t)(r * kHeads + h) * L + l) * L;
    const T* v = QKV + (size_t)r * L * W3 + 2 * kHd + he;
    float o = 0.f;
    for (int j = 0; j < L; ++j) o = fmaf(s[j], to_f(v[j * W3]), o);
    H2[p] = from_f<T>(o);
  }
  __syncthreads();
  prod.gemm(1, M, C, kHd, H2, kHd, wo,
            [&](int m, int n, float acc) { H[m * C + n] = from_f<T>(acc + ldw(bo + n)); });
  __syncthreads();
  layer_norm_tokens<T>(H, X, X, M, C, gout);
  __syncthreads();
}

template <typename T, typename P = SimtProducts>
__device__ inline void attention(const Bufs<T>& b, T* X, int R, int L, int C,
                                 const T* __restrict__ Wf, const long long* rec,
                                 const P& prod = P()) {
  attention_body(b, X, R, L, C, Wf, rec, prod);
}

// k3 projection conv X [R][L][C] -> OUT [R][L][Cout]
template <typename T, typename P = SimtProducts>
__device__ inline void proj(T* X, T* OUT, int R, int L, int C, int Cout,
                            const T* __restrict__ Wf, const long long* rec,
                            const P& prod = P()) {
  const T* wp = Wf + rec[R_WP];
  const T* bp = Wf + rec[R_BP];
  prod.conv3(0, R * L, L, C, Cout, X, wp,
             [&](int m, int n, float acc) { OUT[m * Cout + n] = from_f<T>(acc + ldw(bp + n)); });
  __syncthreads();
}

// 1x1 head to one channel: out(m, value) for every token, value rounded to T
template <typename T, typename Store>
__device__ inline void head(const T* X, int M, int C, const T* __restrict__ Wf,
                            const long long* rec, Store store) {
  const T* fw = Wf + rec[R_FW];
  const float fb = ldw(Wf + rec[R_FB]);
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const T* x = X + (size_t)m * C;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc = fmaf(to_f(x[c]), ldw(fw + c), acc);
    store(m, rnd<T>(acc + fb));
  }
}

// ESUM[r][k] = sum_e emb[r][e*E + k] over the Ce conditioning channels
template <typename T>
__device__ inline void emb_sum_rows(const T* __restrict__ emb, float* ESUM, int row0, int R,
                                    int BG, int E, int Ce) {
  for (int idx = threadIdx.x; idx < R * E; idx += blockDim.x) {
    const int r = idx / E, k = idx % E;
    float s = 0.f;
    if (row0 + r < BG) {
      const T* e = emb + (size_t)(row0 + r) * Ce * E + k;
      for (int c = 0; c < Ce; ++c) s += to_f(e[c * E]);
    }
    ESUM[idx] = s;
  }
}

}  // namespace gl
