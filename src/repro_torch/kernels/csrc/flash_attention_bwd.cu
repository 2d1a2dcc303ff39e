// K1b: the flash-attention backward for Hopper (sm_90a), CUDA C++.
//
// Mirrors the reference's custom VJP backward, _flash_bwd_rule in
// src/repro/models/layers.py: a jnp function, not a Pallas TPU kernel.
// The port's attention forward is K1 (flash_attention.cu), a kernel, so
// its gradient is a kernel too.  Given q, k, v, the forward's output o,
// its float32 row log-sum-exp lse (K1 writes it) and the output's
// gradient do, it computes dq, dk and dv:
//
//   D   = rowsum(do * o)                      (float32)
//   s   = scale * q k^T, t = tanh(s / cap), s = cap * t under a softcap
//   p   = exp(s - lse), exactly 0 where the causal / window mask is off
//   dp  = do v^T
//   ds  = p (dp - D), times (1 - t^2) under the softcap
//   dq  = scale * ds k,  dk = scale * ds^T q,  dv = p^T do
//
// with dk and dv summed over the G query heads of each KV head (GQA).
// The reference casts q, k, v and do to float32 and takes every product
// in float32; both bodies keep that arithmetic (only the order of the
// sums differs).  The inputs' type picks the body, one per type:
//
// * bfloat16: wgmma on the tensor cores (the helpers in hopper.cuh, as
//   K1's bf16 body uses them).  A bf16 x bf16 product is exact in float32,
//   so S = Q K^T and dP = dO V^T take the bf16 inputs as shared-memory
//   operands.  P and dS are float32; for dV = P^T dO, dK = dS^T Q and
//   dQ = dS K each of their values x is split in registers into bf16
//   terms hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), whose
//   sum is x exactly, and each term is the register A operand of its own
//   wgmma into one float32 accumulator: the products are the float32
//   products.  (Rounding P and dS to bf16 once, as FlashAttention-3 does,
//   keeps 8 bits and would not be the reference's arithmetic.)  So dkdv
//   makes 8 product passes (S, dP, 3 x dV, 3 x dK; 9 where dk and dv take
//   a block each) and dq 5 (S, dP, 3 x dQ): 13 where the function needs
//   5, so at most 5/13 of the bf16 tensor-core bound, which counts the 5.
//   What bounds the design is that ratio and, at these tile sizes, the
//   per-tile waits: each tile's products are waited for before the next
//   tile's start.
//   - flash_bwd_dkdv_wgmma_kernel: one warpgroup per (64-key tile, query
//     head, batch row), the keys the M of every product, so the score
//     fragments are transposed (S^T = K Q^T, P^T, dP^T = V dO^T, dS^T in
//     registers; lse and D read per column from shared memory).  K and V
//     arrive once by TMA; Q and dO tiles of BM rows stream through a
//     2-stage TMA ring signalled by mbarriers.  dV += P^T dO and dK +=
//     dS^T Q take dO and Q as MN-major B operands (the transpose bit, as
//     K1's P V takes V).  Up to dh and dv 64 one block accumulates both
//     (64 + 64 accumulator registers a thread); beyond, a block per key
//     tile accumulates dv only (it needs no dP) and another dk only, and
//     from dh 192 the query tiles are 32 rows, so no accumulator spills.
//   - flash_bwd_dq_wgmma_kernel: one warpgroup per (64-row query tile,
//     query head, batch row), heaviest tiles first; Q and dO arrive once,
//     K and V tiles of KN keys through a 2-stage ring; dQ += dS K with K
//     an MN-major B operand.
//   Head dims are tiled to 64, 128, 192 or 256 and TMA zero-fills the box
//   past the true dh/dv (and past S), so dh and dv need only be multiples
//   of 8.  The tensor maps are built on the host per call.
// * float32: scalar FMA on the CUDA cores (67 TFLOP/s at best): the
//   tensor cores have no full-float32 mode, and TF32 would round the
//   operands.  flash_bwd_dkdv_kernel and flash_bwd_dq_kernel below.
//
// Four device kernels per call, no atomics, every sum in a fixed order
// (the result does not change from run to run):
//
// 1. bwd_delta_kernel: D, one warp per (b, q head, row).
// 2. dkdv: one block per (key tile, q head, b).  The block keeps its K
//    and V tiles in shared memory and walks the query tiles that can see
//    them (tiles wholly above the causal diagonal or past the window are
//    skipped), recomputing s and p from lse, and accumulates this head's
//    share of dk and dv in float32 registers.  It writes them once, into
//    a float32 scratch (B, Sk, Hq, dh + dv).  A block per query head
//    rather than per KV head keeps B * Hq * tiles blocks in flight: at
//    qwen2's training shape (B 2, 2 KV heads) a block per KV head would
//    leave half the card idle.
// 3. bwd_reduce_kernel: dk and dv as the sum over the G heads of the
//    scratch, in head order, cast to the input type.
// 4. dq: one block per (query tile, q head, b), heaviest tiles first; it
//    walks the visible key tiles and writes dq once.
//
// The float32 body: each thread of a 256-thread block owns a (BM / 16) x
// (BN / 16) tile of scores (rows ty * RM + i, keys tx + 16 j), and a strip
// of output rows by columns tx + 16 j for the products over the tile;
// operands sit in shared memory as float32 with odd row strides, so
// column reads are free of bank conflicts.  Tiles of 64 x 64 up to dh 192
// / dv 128, 32 x 32 beyond (dh 256), so that K, V, Q, dO, P and dS fit
// in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "hopper.cuh"

namespace {

struct BwdParams {
  const void* q; const void* k; const void* v; const void* o; const void* go;
  const float* lse;             // (B, Hq, Sq) float32, contiguous
  float* delta;                 // (B, Hq, Sq) float32 scratch
  float* part;                  // (B, Sk, Hq, dh + dv) float32 scratch
  void* gq; void* gk; void* gv; // dq, dk, dv
  int B, Sq, Sk, Hq, Hkv, dh, dv;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int64_t go_sb, go_ss, go_sh, gq_sb, gq_ss, gq_sh, gk_sb, gk_ss, gk_sh, gv_sb, gv_ss, gv_sh;
  float scale, softcap;         // softcap <= 0: none
  int causal, window, q_offset; // window <= 0: none
};

constexpr int NT = 256;         // threads: 16 row groups x 16 column lanes

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ bool visible(const BwdParams& p, int row, int key) {
  const int qpos = p.q_offset + row;
  bool ok = row < p.Sq && key < p.Sk;
  if (p.causal) ok = ok && key <= qpos;
  if (p.window > 0) ok = ok && qpos - key < p.window;
  return ok;
}

// rows x depth of a (., S, ., depth) tensor into shared memory as float32
// with row stride ld; rows past `limit` are zero
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld_, const T* src, int64_t row_stride,
                                          int r0, int rows, int limit, int depth) {
  for (int idx = threadIdx.x; idx < rows * depth; idx += NT) {
    const int r = idx / depth, d = idx - r * depth;
    const int row = r0 + r;
    dst[r * ld_ + d] = row < limit ? ld(src + row * row_stride + d) : 0.f;
  }
}

// acc[i][j] = sum_kk A[(ty RM + i) lda + kk] * Bm[(tx + 16 j) ldb + kk]
template <int RM, int RN>
__device__ __forceinline__ void tile_products(const float* A, int lda, const float* Bm, int ldb,
                                              int depth, int ty, int tx, float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  for (int kk = 0; kk < depth; ++kk) {
    float a[RM], c[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = A[(ty * RM + i) * lda + kk];
#pragma unroll
    for (int j = 0; j < RN; ++j) c[j] = Bm[(tx + 16 * j) * ldb + kk];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
  }
}

// p and ds of the thread's score tile (query rows m0 + ty RM + i, keys
// n0 + tx + 16 j) into P and dS (row stride pld); P may be null
template <int RM, int RN>
__device__ __forceinline__ void probs_and_ds(const BwdParams& p, const float (&s)[RM][RN],
                                             const float (&dp)[RM][RN], const float* Ls,
                                             const float* Ds, int m0, int n0, int ty, int tx,
                                             float* Ps, float* Ss, int pld) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = tx + 16 * j;
      float x = s[i][j] * p.scale, t = 0.f;
      if (p.softcap > 0.f) {
        t = tanhf(x / p.softcap);
        x = p.softcap * t;
      }
      // masked pairs are exactly 0, as jnp.where(mask, ..., 0.0) makes them
      const float pr = visible(p, m0 + r, n0 + c) ? expf(x - Ls[r]) : 0.f;
      float ds = pr * (dp[i][j] - Ds[r]);
      if (p.softcap > 0.f) ds *= 1.f - t * t;
      if (Ps != nullptr) Ps[r * pld + c] = pr;
      Ss[r * pld + c] = ds;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) bwd_delta_kernel(BwdParams p) {
  const int64_t w = (int64_t)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= (int64_t)p.B * p.Hq * p.Sq) return;
  const int row = (int)(w % p.Sq);
  const int h = (int)((w / p.Sq) % p.Hq);
  const int b = (int)(w / ((int64_t)p.Sq * p.Hq));
  const T* op = static_cast<const T*>(p.o) + b * p.o_sb + row * p.o_ss + h * p.o_sh;
  const T* gp = static_cast<const T*>(p.go) + b * p.go_sb + row * p.go_ss + h * p.go_sh;
  float acc = 0.f;
  for (int c = lane; c < p.dv; c += 32) acc = fmaf(ld(gp + c), ld(op + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[w] = acc;
}

template <typename T, int BM, int BN, int DHJ, int DVJ>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(BwdParams p) {
  constexpr int RM = BM / 16, RN = BN / 16;
  constexpr int PLD = BN + 16 / RM;        // P rows RM apart land 16 banks apart
  extern __shared__ float smem[];
  const int ldk = p.dh | 1, ldv = p.dv | 1;
  float* Ks = smem;                        // BN x ldk
  float* Vs = Ks + BN * ldk;               // BN x ldv
  float* Qs = Vs + BN * ldv;               // BM x ldk
  float* Gs = Qs + BM * ldk;               // BM x ldv: dO
  float* Ps = Gs + BM * ldv;               // BM x PLD
  float* Ss = Ps + BM * PLD;               // BM x PLD: dS
  float* Ls = Ss + BM * PLD;               // BM: lse
  float* Ds = Ls + BM;                     // BM: D

  const int n0 = blockIdx.x * BN;          // tile 0, the one most rows see, first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_rows(Ks, ldk, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, n0, BN, p.Sk, p.dh);
  load_rows(Vs, ldv, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, n0, BN, p.Sk, p.dv);
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* gp = static_cast<const T*>(p.go) + b * p.go_sb + h * p.go_sh;
  const float* lp = p.lse + ((int64_t)b * p.Hq + h) * p.Sq;
  const float* dl = p.delta + ((int64_t)b * p.Hq + h) * p.Sq;

  // the query rows that can see a key of this tile
  int m_begin = 0, m_end = p.Sq;
  if (p.causal) m_begin = max(0, n0 - p.q_offset);
  if (p.window > 0) m_end = min(p.Sq, n0 + BN - 1 + p.window - p.q_offset);
  m_begin = (m_begin / BM) * BM;

  float ak[RN][DHJ], av[RN][DVJ];
#pragma unroll
  for (int i = 0; i < RN; ++i) {
#pragma unroll
    for (int j = 0; j < DHJ; ++j) ak[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < DVJ; ++j) av[i][j] = 0.f;
  }

  for (int m0 = m_begin; m0 < m_end; m0 += BM) {
    __syncthreads();                       // the previous tile fully consumed
    load_rows(Qs, ldk, qp, p.q_ss, m0, BM, p.Sq, p.dh);
    load_rows(Gs, ldv, gp, p.go_ss, m0, BM, p.Sq, p.dv);
    for (int r = tid; r < BM; r += NT) {
      Ls[r] = m0 + r < p.Sq ? lp[m0 + r] : 0.f;
      Ds[r] = m0 + r < p.Sq ? dl[m0 + r] : 0.f;
    }
    __syncthreads();
    float s[RM][RN], dp[RM][RN];
    tile_products(Qs, ldk, Ks, ldk, p.dh, ty, tx, s);
    tile_products(Gs, ldv, Vs, ldv, p.dv, ty, tx, dp);
    probs_and_ds(p, s, dp, Ls, Ds, m0, n0, ty, tx, Ps, Ss, PLD);
    __syncthreads();
    // dv += p^T dO and dk += ds^T Q over the tile's rows: this thread's
    // keys ty RN + i, columns tx + 16 j
    for (int m = 0; m < BM; ++m) {
      float pr[RN], dsr[RN];
#pragma unroll
      for (int i = 0; i < RN; ++i) {
        pr[i] = Ps[m * PLD + ty * RN + i];
        dsr[i] = Ss[m * PLD + ty * RN + i];
      }
#pragma unroll
      for (int j = 0; j < DVJ; ++j) {
        const int c = tx + 16 * j;
        const float g = c < p.dv ? Gs[m * ldv + c] : 0.f;
#pragma unroll
        for (int i = 0; i < RN; ++i) av[i][j] = fmaf(pr[i], g, av[i][j]);
      }
#pragma unroll
      for (int j = 0; j < DHJ; ++j) {
        const int c = tx + 16 * j;
        const float qq = c < p.dh ? Qs[m * ldk + c] : 0.f;
#pragma unroll
        for (int i = 0; i < RN; ++i) ak[i][j] = fmaf(dsr[i], qq, ak[i][j]);
      }
    }
  }

  // this head's share, into the float32 scratch (B, Sk, Hq, dh + dv)
  const int dd = p.dh + p.dv;
#pragma unroll
  for (int i = 0; i < RN; ++i) {
    const int key = n0 + ty * RN + i;
    if (key >= p.Sk) continue;
    float* dst = p.part + (((int64_t)b * p.Sk + key) * p.Hq + h) * dd;
#pragma unroll
    for (int j = 0; j < DHJ; ++j) {
      const int c = tx + 16 * j;
      if (c < p.dh) dst[c] = ak[i][j] * p.scale;
    }
#pragma unroll
    for (int j = 0; j < DVJ; ++j) {
      const int c = tx + 16 * j;
      if (c < p.dv) dst[p.dh + c] = av[i][j];
    }
  }
}

// dk and dv: the sum over the G query heads of each KV head, in head
// order, cast to the input type
template <typename T>
__global__ void __launch_bounds__(NT) bwd_reduce_kernel(BwdParams p) {
  const int dd = p.dh + p.dv;
  const int64_t idx = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (idx >= (int64_t)p.B * p.Sk * p.Hkv * dd) return;
  const int c = (int)(idx % dd);
  const int hk = (int)((idx / dd) % p.Hkv);
  const int key = (int)((idx / ((int64_t)dd * p.Hkv)) % p.Sk);
  const int b = (int)(idx / ((int64_t)dd * p.Hkv * p.Sk));
  const int G = p.Hq / p.Hkv;
  const float* src = p.part + (((int64_t)b * p.Sk + key) * p.Hq + hk * G) * dd + c;
  float acc = 0.f;
  for (int g = 0; g < G; ++g) acc += src[(int64_t)g * dd];
  if (c < p.dh)
    st(static_cast<T*>(p.gk) + b * p.gk_sb + key * p.gk_ss + hk * p.gk_sh + c, acc);
  else
    st(static_cast<T*>(p.gv) + b * p.gv_sb + key * p.gv_ss + hk * p.gv_sh + (c - p.dh), acc);
}

template <typename T, int BM, int BN, int DHJ>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(BwdParams p) {
  constexpr int RM = BM / 16, RN = BN / 16;
  constexpr int PLD = BN + 16 / RM;
  extern __shared__ float smem[];
  const int ldk = p.dh | 1, ldv = p.dv | 1;
  float* Qs = smem;                        // BM x ldk
  float* Gs = Qs + BM * ldk;               // BM x ldv: dO
  float* Ks = Gs + BM * ldv;               // BN x ldk
  float* Vs = Ks + BN * ldk;               // BN x ldv
  float* Ss = Vs + BN * ldv;               // BM x PLD: dS
  float* Ls = Ss + BM * PLD;               // BM: lse
  float* Ds = Ls + BM;                     // BM: D

  const int nq = (p.Sq + BM - 1) / BM;
  const int q0 = (nq - 1 - blockIdx.x) * BM;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_rows(Qs, ldk, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, q0, BM, p.Sq, p.dh);
  load_rows(Gs, ldv, static_cast<const T*>(p.go) + b * p.go_sb + h * p.go_sh, p.go_ss, q0, BM, p.Sq,
            p.dv);
  const float* lp = p.lse + ((int64_t)b * p.Hq + h) * p.Sq;
  const float* dl = p.delta + ((int64_t)b * p.Hq + h) * p.Sq;
  for (int r = tid; r < BM; r += NT) {
    Ls[r] = q0 + r < p.Sq ? lp[q0 + r] : 0.f;
    Ds[r] = q0 + r < p.Sq ? dl[q0 + r] : 0.f;
  }
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // the key range [n_begin, n_end) the tile's rows can see
  const int rows = min(BM, p.Sq - q0);
  const int q_lo = p.q_offset + q0, q_hi = q_lo + rows - 1;
  int n_begin = 0, n_end = p.Sk;
  if (p.causal) n_end = min(p.Sk, q_hi + 1);
  if (p.window > 0) n_begin = max(0, q_lo - p.window + 1);
  n_begin = (n_begin / BN) * BN;

  float aq[RM][DHJ];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DHJ; ++j) aq[i][j] = 0.f;

  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    __syncthreads();                       // the previous tile fully consumed
    load_rows(Ks, ldk, kp, p.k_ss, n0, BN, p.Sk, p.dh);
    load_rows(Vs, ldv, vp, p.v_ss, n0, BN, p.Sk, p.dv);
    __syncthreads();
    float s[RM][RN], dp[RM][RN];
    tile_products(Qs, ldk, Ks, ldk, p.dh, ty, tx, s);
    tile_products(Gs, ldv, Vs, ldv, p.dv, ty, tx, dp);
    probs_and_ds(p, s, dp, Ls, Ds, q0, n0, ty, tx, nullptr, Ss, PLD);
    __syncthreads();
    // dq += ds K: this thread's rows ty RM + i, columns tx + 16 j
    for (int n = 0; n < BN; ++n) {
      float dsr[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) dsr[i] = Ss[(ty * RM + i) * PLD + n];
#pragma unroll
      for (int j = 0; j < DHJ; ++j) {
        const int c = tx + 16 * j;
        const float kk = c < p.dh ? Ks[n * ldk + c] : 0.f;
#pragma unroll
        for (int i = 0; i < RM; ++i) aq[i][j] = fmaf(dsr[i], kk, aq[i][j]);
      }
    }
  }

  T* dq = static_cast<T*>(p.gq) + b * p.gq_sb + h * p.gq_sh;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < DHJ; ++j) {
      const int c = tx + 16 * j;
      if (c < p.dh) st(dq + row * p.gq_ss + c, aq[i][j] * p.scale);
    }
  }
}

// One instantiation: BM query rows and BN keys per tile; DHJ and DVJ
// output columns per thread (16 * DHJ >= dh, 16 * DVJ >= dv)
template <int BM_, int BN_, int DHJ_, int DVJ_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, DHJ = DHJ_, DVJ = DVJ_;
  static constexpr int PLD = BN + 16 / (BM / 16);
  static size_t dkdv_smem(int dh, int dv) {
    return sizeof(float) * ((size_t)(BN + BM) * ((dh | 1) + (dv | 1)) + 2 * BM * PLD + 2 * BM);
  }
  static size_t dq_smem(int dh, int dv) {
    return sizeof(float) * ((size_t)(BN + BM) * ((dh | 1) + (dv | 1)) + BM * PLD + 2 * BM);
  }
};

// 64 x 64 tiles up to dh 192 / dv 128 (MLA); 32 x 32 up to 256, so the
// float32 operands stay inside a block's 227 KB of shared memory
template <typename F>
auto with_tile(int dh, int dv, F f) {
  if (dh <= 64 && dv <= 64) return f(Tile<64, 64, 4, 4>{});
  if (dh <= 128 && dv <= 128) return f(Tile<64, 64, 8, 8>{});
  if (dh <= 192 && dv <= 128) return f(Tile<64, 64, 12, 8>{});
  return f(Tile<32, 32, 16, 16>{});
}

template <typename T>
cudaError_t launch_all(const BwdParams& p, cudaStream_t stream) {
  const int64_t rows = (int64_t)p.B * p.Hq * p.Sq;
  if (rows > 0) {
    bwd_delta_kernel<T><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return with_tile(p.dh, p.dv, [&](auto tile) {
    using TL = decltype(tile);
    auto dkdv = flash_bwd_dkdv_kernel<T, TL::BM, TL::BN, TL::DHJ, TL::DVJ>;
    auto dq = flash_bwd_dq_kernel<T, TL::BM, TL::BN, TL::DHJ>;
    const size_t s1 = TL::dkdv_smem(p.dh, p.dv), s2 = TL::dq_smem(p.dh, p.dv);
    cudaError_t e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
    if (e != cudaSuccess) return e;
    if (p.Sk > 0) {
      dkdv<<<dim3((p.Sk + TL::BN - 1) / TL::BN, p.Hq, p.B), NT, s1, stream>>>(p);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
      const int64_t n = (int64_t)p.B * p.Sk * p.Hkv * (p.dh + p.dv);
      bwd_reduce_kernel<T><<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(p);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    if (p.Sq > 0) dq<<<dim3((p.Sq + TL::BM - 1) / TL::BM, p.Hq, p.B), NT, s2, stream>>>(p);
    return cudaGetLastError();
  });
}


// ===========================================================================
// bfloat16: wgmma on the tensor cores, every product exact in float32

constexpr int WG_NT = 128;      // threads: one warpgroup
constexpr int WG_KEYS = 64;     // dkdv: keys per block, the M of its products
constexpr int WG_ROWS = 64;     // dq: query rows per block, the M of its products
constexpr int TERMS = 3;        // bf16 terms per float32 operand

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// A float32 accumulator fragment (an m64nN product's NA = N / 2 registers)
// as register-A operands of k-steps of 16 columns, each value
// split into TERMS bf16 terms: hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid).  Each difference is exact, and hi + mid + lo is x
// for every normal float32, so the products of the terms with a bf16
// operand, summed in float32, are the float32 products.
template <int NA>
__device__ __forceinline__ void split_frags(const float (&a)[NA], uint32_t (&f)[TERMS][NA / 8][4]) {
#pragma unroll
  for (int j = 0; j < NA / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = a[8 * j + 2 * r], x1 = a[8 * j + 2 * r + 1];
      const uint32_t h = pack_bf16(x0, x1);
      const float y0 = x0 - bf16_lo(h), y1 = x1 - bf16_hi(h);
      const uint32_t m = pack_bf16(y0, y1);
      f[0][j][r] = h;
      f[1][j][r] = m;
      f[2][j][r] = pack_bf16(y0 - bf16_lo(m), y1 - bf16_hi(m));
    }
}

template <int N, int C>
__device__ __forceinline__ void fence_acc(float (&d)[C][N]) {
#pragma unroll
  for (int c = 0; c < C; ++c) fence_regs(d[c]);
}

// D[c] += A B over k-steps of the split A fragments; B is MN-major in
// shared memory at sB, its 64-column chunks `chunk` bytes apart, 16 rows
// (one k-step) 2048 bytes apart.  Issued, not committed.
template <int KSTEPS, int C>
__device__ __forceinline__ void split_products(float (&d)[C][32], const uint32_t (&f)[TERMS][KSTEPS][4],
                                               uint32_t sB, uint32_t chunk) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int t = 0; t < TERMS; ++t)
        wgmma_rs(d[c], f[t][kk], gmma_desc(sB + c * chunk + kk * 16 * 128, chunk, 1024));
}

// D (+)= A B^T over DEPTH columns, A and B K-major in shared memory (their
// 64-column chunks achunk / bchunk bytes apart).  Issued, not committed.
template <int DEPTH, int NA>
__device__ __forceinline__ void kmajor_products(float (&d)[NA], uint32_t sA, uint32_t achunk,
                                                uint32_t sB, uint32_t bchunk) {
#pragma unroll
  for (int kk = 0; kk < DEPTH / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;    // 16 columns = 32 bytes
    wgmma_ss(d, gmma_desc(sA + (kk >> 2) * achunk + off, 16, 1024),
             gmma_desc(sB + (kk >> 2) * bchunk + off, 16, 1024), kk > 0);
  }
}

// zero the 64-column chunks [from, to) of a tile whose chunks are `chunk`
// bytes apart (those TMA never writes: past dh or dv)
__device__ __forceinline__ void zero_chunks(unsigned char* raw, uint32_t raw_addr, uint32_t tile,
                                            int from, int to, uint32_t chunk) {
  uint4* t = reinterpret_cast<uint4*>(raw + (tile - raw_addr));
  const int n = (int)chunk / 16;
  for (int i = from * n + (int)threadIdx.x; i < to * n; i += WG_NT) t[i] = make_uint4(0, 0, 0, 0);
}

// p and ds of one score fragment in place: s holds raw scores (q . k), dp
// (if DS) the do . v products.  Element i is query row row_of(i) and key
// key_of(i); L(i) and D(i) its row's lse and D.  Masked pairs get exactly
// 0 (MASK: a boundary tile); under the softcap ds takes (1 - t^2).
template <bool CAP, bool MASK, bool DS, int NA, typename Row, typename Key, typename LF, typename DF>
__device__ __forceinline__ void probs(const BwdParams& p, float (&s)[NA], float (&dp)[NA],
                                      Row row_of, Key key_of, LF L, DF D) {
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    float x = s[i] * p.scale, t = 0.f;
    if (CAP) {
      t = tanhf(x / p.softcap);
      x = p.softcap * t;
    }
    float pr = expf(x - L(i));
    if (MASK) pr = visible(p, row_of(i), key_of(i)) ? pr : 0.f;
    s[i] = pr;
    if (DS) {
      float ds = pr * (dp[i] - D(i));
      if (CAP) ds *= 1.f - t * t;
      dp[i] = ds;
    }
  }
}

// the four cases of probs, chosen once per tile
template <bool DS, int NA, typename Row, typename Key, typename LF, typename DF>
__device__ __forceinline__ void probs_tile(const BwdParams& p, bool interior, float (&s)[NA],
                                           float (&dp)[NA], Row row_of, Key key_of, LF L, DF D) {
  if (p.softcap > 0.f) {
    if (interior) probs<true, false, DS>(p, s, dp, row_of, key_of, L, D);
    else probs<true, true, DS>(p, s, dp, row_of, key_of, L, D);
  } else {
    if (interior) probs<false, false, DS>(p, s, dp, row_of, key_of, L, D);
    else probs<false, true, DS>(p, s, dp, row_of, key_of, L, D);
  }
}

// The dkdv body of one block: keys n0 .. n0 + 63 of KV head hk, query
// head h, batch row b.  DK / DV: which of dk and dv it accumulates (a
// block makes both up to dh 64, one of them beyond, so that its
// accumulators fit in registers).  Accumulator fragments here are
// transposed: their rows are keys, their columns query rows.
template <int DHT, int DVT, int BM, bool DK, bool DV>
__device__ __forceinline__ void dkdv_body(const BwdParams& p, const CUtensorMap* tq,
                                          const CUtensorMap* tk, const CUtensorMap* tv,
                                          const CUtensorMap* tdo, int n0, unsigned char* raw) {
  constexpr int KCH = WG_KEYS * 128;       // a 64-column chunk of K or V
  constexpr int RCH = BM * 128;            // a 64-column chunk of Q or dO
  constexpr int K_BYTES = DHT / 64 * KCH, V_BYTES = DVT / 64 * KCH;
  constexpr int Q_BYTES = DHT / 64 * RCH, STAGE = Q_BYTES + DVT / 64 * RCH;
  const uint32_t raw_addr = smem_u32(raw);
  const uint32_t sK = (raw_addr + 1023u) & ~1023u;   // swizzled tiles on 1024 bytes
  const uint32_t sV = sK + K_BYTES, sR = sV + V_BYTES; // stage s: Q, dO at sR + s * STAGE
  float* LD = reinterpret_cast<float*>(raw + (sR + 2 * STAGE - raw_addr));  // [stage][lse, D][BM]
  const uint32_t bar_kv = sR + 2 * STAGE + 16 * BM, bar_r = bar_kv + 8;

  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);  // keys n0 + r0 and n0 + r0 + 8
  const int cq = 2 * (lane & 3);
  const int dh_chunks = (p.dh + 63) / 64, dv_chunks = (p.dv + 63) / 64;

  // the query rows that can see a key of this tile (the float32 body's ints)
  int m_begin = 0, m_end = p.Sq;
  if (p.causal) m_begin = max(0, n0 - p.q_offset);
  if (p.window > 0) m_end = min(p.Sq, n0 + WG_KEYS - 1 + p.window - p.q_offset);
  m_begin = (m_begin / BM) * BM;
  const int n_tiles = m_end > m_begin ? (m_end - m_begin + BM - 1) / BM : 0;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar_kv + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (dh_chunks < DHT / 64 || dv_chunks < DVT / 64) {
    zero_chunks(raw, raw_addr, sK, dh_chunks, DHT / 64, KCH);
    zero_chunks(raw, raw_addr, sV, dv_chunks, DVT / 64, KCH);
    for (int st = 0; st < 2; ++st) {
      zero_chunks(raw, raw_addr, sR + st * STAGE, dh_chunks, DHT / 64, RCH);
      zero_chunks(raw, raw_addr, sR + st * STAGE + Q_BYTES, dv_chunks, DVT / 64, RCH);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // seen by wgmma
  }
  __syncthreads();

  // one thread: query tile j's Q and dO into stage j % 2
  auto issue = [&](int j) {
    const uint32_t bar = bar_r + 8 * (j & 1), dst = sR + (j & 1) * STAGE;
    const int m0 = m_begin + j * BM;
    mbar_expect_tx(bar, (uint32_t)(dh_chunks + dv_chunks) * RCH);
    for (int c = 0; c < dh_chunks; ++c) tma_load_4d(dst + c * RCH, tq, bar, c * 64, h, m0, b);
    for (int c = 0; c < dv_chunks; ++c)
      tma_load_4d(dst + Q_BYTES + c * RCH, tdo, bar, c * 64, h, m0, b);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_kv, (uint32_t)(dh_chunks + (DK ? dv_chunks : 0)) * KCH);
    for (int c = 0; c < dh_chunks; ++c) tma_load_4d(sK + c * KCH, tk, bar_kv, c * 64, hk, n0, b);
    if constexpr (DK)
      for (int c = 0; c < dv_chunks; ++c) tma_load_4d(sV + c * KCH, tv, bar_kv, c * 64, hk, n0, b);
    for (int j = 0; j < 2 && j < n_tiles; ++j) issue(j);
  }

  float dk[DK ? DHT / 64 : 1][32], dv[DV ? DVT / 64 : 1][32];
#pragma unroll
  for (int c = 0; c < (DK ? DHT / 64 : 1); ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = 0.f;
#pragma unroll
  for (int c = 0; c < (DV ? DVT / 64 : 1); ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[c][i] = 0.f;
  const float* lp = p.lse + ((int64_t)b * p.Hq + h) * p.Sq;
  const float* dl = p.delta + ((int64_t)b * p.Hq + h) * p.Sq;
  if (n_tiles > 0) mbar_wait(bar_kv, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int m0 = m_begin + j * BM;
    float* Ls = LD + (j & 1) * 2 * BM;
    float* Ds = Ls + BM;
    for (int i = tid; i < BM; i += WG_NT) {
      const bool in = m0 + i < p.Sq;
      Ls[i] = in ? lp[m0 + i] : 0.f;
      Ds[i] = in ? dl[m0 + i] : 0.f;
    }
    __syncthreads();                       // this tile's lse and D are in
    mbar_wait(bar_r + 8 * (j & 1), (j >> 1) & 1);
    const uint32_t sQ = sR + (j & 1) * STAGE, sG = sQ + Q_BYTES;

    // S^T = K Q^T and (for dk) dP^T = V dO^T, both K-major, issued together
    float st[BM / 2], dpt[BM / 2];
    fence_regs(st);
    if constexpr (DK) fence_regs(dpt);
    wgmma_fence();
    kmajor_products<DHT>(st, sK, KCH, sQ, RCH);
    if constexpr (DK) kmajor_products<DVT>(dpt, sV, KCH, sG, RCH);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    if constexpr (DK) fence_regs(dpt);

    // element i: key n0 + r0 + 8 ((i / 2) % 2), query row m0 + c(i)
    auto col = [&](int i) { return 8 * (i >> 2) + cq + (i & 1); };
    const bool interior = n0 + WG_KEYS <= p.Sk && m0 + BM <= p.Sq &&
                          (!p.causal || n0 + WG_KEYS - 1 <= p.q_offset + m0) &&
                          (p.window <= 0 || p.q_offset + m0 + BM - 1 - n0 < p.window);
    probs_tile<DK>(p, interior, st, dpt, [&](int i) { return m0 + col(i); },
                   [&](int i) { return n0 + r0 + 8 * ((i >> 1) & 1); },
                   [&](int i) { return Ls[col(i)]; }, [&](int i) { return Ds[col(i)]; });

    // dv += P^T dO and dk += dS^T Q, the split fragments against the
    // MN-major dO and Q tiles
    uint32_t pf[TERMS][DV ? BM / 16 : 1][4], df[TERMS][DK ? BM / 16 : 1][4];
    if constexpr (DV) split_frags(st, pf);
    if constexpr (DK) split_frags(dpt, df);
    if constexpr (DV) fence_acc(dv);
    if constexpr (DK) fence_acc(dk);
    wgmma_fence();
    if constexpr (DV) split_products(dv, pf, sG, RCH);
    if constexpr (DK) split_products(dk, df, sQ, RCH);
    wgmma_commit();
    wgmma_wait_all();
    if constexpr (DV) fence_acc(dv);
    if constexpr (DK) fence_acc(dk);
    __syncthreads();                       // stage j % 2 and its lse / D consumed
    if (tid == 0 && j + 2 < n_tiles) issue(j + 2);
  }

  // this head's share, into the float32 scratch (B, Sk, Hq, dh + dv)
  const int dd = p.dh + p.dv;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = n0 + r0 + 8 * half;
    if (key >= p.Sk) continue;
    float* dst = p.part + (((int64_t)b * p.Sk + key) * p.Hq + h) * dd;
    if constexpr (DK) {
#pragma unroll
      for (int c = 0; c < DHT / 64; ++c)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int cc = c * 64 + nb * 8 + cq;
          if (cc < p.dh)
            *reinterpret_cast<float2*>(dst + cc) =
                make_float2(dk[c][4 * nb + 2 * half] * p.scale, dk[c][4 * nb + 2 * half + 1] * p.scale);
        }
    }
    if constexpr (DV) {
#pragma unroll
      for (int c = 0; c < DVT / 64; ++c)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int cc = c * 64 + nb * 8 + cq;
          if (cc < p.dv)
            *reinterpret_cast<float2*>(dst + p.dh + cc) =
                make_float2(dv[c][4 * nb + 2 * half], dv[c][4 * nb + 2 * half + 1]);
        }
    }
  }
}

// One block per (64-key tile, query head, batch row); with SPLIT two,
// the even one accumulating dv and the odd one dk, key tile 0 (the one
// most rows see) first
template <int DHT, int DVT, int BM, int SPLIT>
__global__ void __launch_bounds__(WG_NT)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo, BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  if constexpr (!SPLIT) {
    dkdv_body<DHT, DVT, BM, true, true>(p, &tq, &tk, &tv, &tdo, blockIdx.x * WG_KEYS, smem_raw);
  } else {
    const int n0 = (blockIdx.x >> 1) * WG_KEYS;
    if (blockIdx.x & 1)
      dkdv_body<DHT, DVT, BM, true, false>(p, &tq, &tk, &tv, &tdo, n0, smem_raw);
    else
      dkdv_body<DHT, DVT, BM, false, true>(p, &tq, &tk, &tv, &tdo, n0, smem_raw);
  }
}

// One block per (64-row query tile, query head, batch row), heaviest
// tiles first: S = Q K^T and dP = dO V^T over the visible key tiles of
// KN keys, then dq += dS K with the split dS against the MN-major K tile.
// K and V arrive in a 2-stage TMA ring.
template <int DHT, int DVT, int KN>
__global__ void __launch_bounds__(WG_NT)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, BwdParams p) {
  constexpr int RCH = WG_ROWS * 128, KCH = KN * 128;
  constexpr int Q_BYTES = DHT / 64 * RCH, G_BYTES = DVT / 64 * RCH;
  constexpr int K_BYTES = DHT / 64 * KCH, STAGE = K_BYTES + DVT / 64 * KCH;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t sQ = (raw_addr + 1023u) & ~1023u, sG = sQ + Q_BYTES;
  const uint32_t sKV = sG + G_BYTES;       // stage s: K, V at sKV + s * STAGE
  const uint32_t bar_q = sKV + 2 * STAGE, bar_kv = bar_q + 8;

  const int nq = (p.Sq + WG_ROWS - 1) / WG_ROWS;
  const int q0 = (nq - 1 - blockIdx.x) * WG_ROWS;    // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);  // rows q0 + r0 and q0 + r0 + 8
  const int cq = 2 * (lane & 3);
  const int dh_chunks = (p.dh + 63) / 64, dv_chunks = (p.dv + 63) / 64;

  // the key range [n_begin, n_end) the tile's rows can see
  const int rows = min(WG_ROWS, p.Sq - q0);
  const int q_lo = p.q_offset + q0, q_hi = q_lo + rows - 1;
  int n_begin = 0, n_end = p.Sk;
  if (p.causal) n_end = min(p.Sk, q_hi + 1);
  if (p.window > 0) n_begin = max(0, q_lo - p.window + 1);
  n_begin = (n_begin / KN) * KN;
  const int n_tiles = n_end > n_begin ? (n_end - n_begin + KN - 1) / KN : 0;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar_q + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (dh_chunks < DHT / 64 || dv_chunks < DVT / 64) {
    zero_chunks(smem_raw, raw_addr, sQ, dh_chunks, DHT / 64, RCH);
    zero_chunks(smem_raw, raw_addr, sG, dv_chunks, DVT / 64, RCH);
    for (int st = 0; st < 2; ++st) {
      zero_chunks(smem_raw, raw_addr, sKV + st * STAGE, dh_chunks, DHT / 64, KCH);
      zero_chunks(smem_raw, raw_addr, sKV + st * STAGE + K_BYTES, dv_chunks, DVT / 64, KCH);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // seen by wgmma
  }
  __syncthreads();

  // one thread: key tile j's K and V into stage j % 2
  auto issue = [&](int j) {
    const uint32_t bar = bar_kv + 8 * (j & 1), dst = sKV + (j & 1) * STAGE;
    const int k0 = n_begin + j * KN;
    mbar_expect_tx(bar, (uint32_t)(dh_chunks + dv_chunks) * KCH);
    for (int c = 0; c < dh_chunks; ++c) tma_load_4d(dst + c * KCH, &tk, bar, c * 64, hk, k0, b);
    for (int c = 0; c < dv_chunks; ++c)
      tma_load_4d(dst + K_BYTES + c * KCH, &tv, bar, c * 64, hk, k0, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, (uint32_t)(dh_chunks + dv_chunks) * RCH);
    for (int c = 0; c < dh_chunks; ++c) tma_load_4d(sQ + c * RCH, &tq, bar_q, c * 64, h, q0, b);
    for (int c = 0; c < dv_chunks; ++c) tma_load_4d(sG + c * RCH, &tdo, bar_q, c * 64, h, q0, b);
    for (int j = 0; j < 2 && j < n_tiles; ++j) issue(j);
  }

  const float* lp = p.lse + ((int64_t)b * p.Hq + h) * p.Sq;
  const float* dl = p.delta + ((int64_t)b * p.Hq + h) * p.Sq;
  float Lr[2], Dr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + 8 * half;
    Lr[half] = row < p.Sq ? lp[row] : 0.f;
    Dr[half] = row < p.Sq ? dl[row] : 0.f;
  }
  float dq[DHT / 64][32];
#pragma unroll
  for (int c = 0; c < DHT / 64; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = n_begin + j * KN;
    mbar_wait(bar_kv + 8 * (j & 1), (j >> 1) & 1);
    const uint32_t sK = sKV + (j & 1) * STAGE, sV = sK + K_BYTES;
    float s[KN / 2], dp[KN / 2];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    kmajor_products<DHT>(s, sQ, RCH, sK, KCH);
    kmajor_products<DVT>(dp, sG, RCH, sV, KCH);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // element i: query row q0 + r0 + 8 ((i / 2) % 2), key n0 + k(i)
    const bool interior = n0 + KN <= p.Sk && q0 + WG_ROWS <= p.Sq &&
                          (!p.causal || n0 + KN - 1 <= q_lo) &&
                          (p.window <= 0 || q_hi - n0 < p.window);
    probs_tile<true>(p, interior, s, dp, [&](int i) { return q0 + r0 + 8 * ((i >> 1) & 1); },
                     [&](int i) { return n0 + 8 * (i >> 2) + cq + (i & 1); },
                     [&](int i) { return Lr[(i >> 1) & 1]; }, [&](int i) { return Dr[(i >> 1) & 1]; });

    uint32_t df[TERMS][KN / 16][4];
    split_frags(dp, df);
    fence_acc(dq);
    wgmma_fence();
    split_products(dq, df, sK, KCH);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(dq);
    __syncthreads();                       // stage j % 2 consumed
    if (tid == 0 && j + 2 < n_tiles) issue(j + 2);
  }

  __nv_bfloat16* gq = static_cast<__nv_bfloat16*>(p.gq) + b * p.gq_sb + h * p.gq_sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + 8 * half;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < DHT / 64; ++c)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int cc = c * 64 + nb * 8 + cq;
        if (cc < p.dh)
          *reinterpret_cast<__nv_bfloat162*>(gq + row * p.gq_ss + cc) = __floats2bfloat162_rn(
              dq[c][4 * nb + 2 * half] * p.scale, dq[c][4 * nb + 2 * half + 1] * p.scale);
      }
  }
}

// One bf16 instantiation: head-dim tiles DHT (q, k) and DVT (v); dkdv
// walks query tiles of BM rows, as one block per key tile (SPLIT 0) or
// two (SPLIT 1: dv and dk apart); dq walks key tiles of KN keys
template <int DHT_, int DVT_, int BM_, int SPLIT_, int KN_>
struct WgTile {
  static constexpr int DHT = DHT_, DVT = DVT_, BM = BM_, SPLIT = SPLIT_, KN = KN_;
  // alignment slack, K and V, a 2-stage Q/dO ring, lse and D, 3 barriers
  static constexpr size_t DKDV_SMEM =
      1024 + (size_t)WG_KEYS * 2 * (DHT + DVT) + 2 * (size_t)BM * 2 * (DHT + DVT) + 16 * BM + 24;
  // alignment slack, Q and dO, a 2-stage K/V ring, 3 barriers
  static constexpr size_t DQ_SMEM =
      1024 + (size_t)WG_ROWS * 2 * (DHT + DVT) + 2 * (size_t)KN * 2 * (DHT + DVT) + 24;
};

// dh, dv up to 64: one block makes dk and dv; beyond, dk and dv take a
// block each, and from dh 192 the tiles are 32 wide, so that every
// accumulator fits in registers without spilling
template <typename F>
auto with_wgmma_tile(int dh, int dv, F f) {
  if (dh <= 64 && dv <= 64) return f(WgTile<64, 64, 64, 0, 64>{});
  if (dh <= 128 && dv <= 128) return f(WgTile<128, 128, 64, 1, 64>{});
  if (dh <= 192 && dv <= 128) return f(WgTile<192, 128, 32, 1, 32>{});
  return f(WgTile<256, 256, 32, 1, 32>{});
}

cudaError_t launch_bf16(const BwdParams& p, cudaStream_t stream) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int64_t rows = (int64_t)p.B * p.Hq * p.Sq;
  bwd_delta_kernel<__nv_bfloat16><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return with_wgmma_tile(p.dh, p.dv, [&](auto tile) {
    using T = decltype(tile);
    // the maps of each kernel: boxes of its own tile rows
    CUtensorMap q1, k1, v1, g1, q2, k2, v2, g2;
    if (!encode_map(fn, &q1, p.q, p.dh, p.Hq, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, T::BM) ||
        !encode_map(fn, &g1, p.go, p.dv, p.Hq, p.Sq, p.B, p.go_sh, p.go_ss, p.go_sb, T::BM) ||
        !encode_map(fn, &k1, p.k, p.dh, p.Hkv, p.Sk, p.B, p.k_sh, p.k_ss, p.k_sb, WG_KEYS) ||
        !encode_map(fn, &v1, p.v, p.dv, p.Hkv, p.Sk, p.B, p.v_sh, p.v_ss, p.v_sb, WG_KEYS) ||
        !encode_map(fn, &q2, p.q, p.dh, p.Hq, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, WG_ROWS) ||
        !encode_map(fn, &g2, p.go, p.dv, p.Hq, p.Sq, p.B, p.go_sh, p.go_ss, p.go_sb, WG_ROWS) ||
        !encode_map(fn, &k2, p.k, p.dh, p.Hkv, p.Sk, p.B, p.k_sh, p.k_ss, p.k_sb, T::KN) ||
        !encode_map(fn, &v2, p.v, p.dv, p.Hkv, p.Sk, p.B, p.v_sh, p.v_ss, p.v_sb, T::KN))
      return cudaErrorInvalidValue;
    auto dkdv = flash_bwd_dkdv_wgmma_kernel<T::DHT, T::DVT, T::BM, T::SPLIT>;
    auto dq = flash_bwd_dq_wgmma_kernel<T::DHT, T::DVT, T::KN>;
    cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)T::DKDV_SMEM);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::DQ_SMEM);
    if (err != cudaSuccess) return err;
    const int key_tiles = (p.Sk + WG_KEYS - 1) / WG_KEYS;
    dkdv<<<dim3(key_tiles * (T::SPLIT ? 2 : 1), p.Hq, p.B), WG_NT, T::DKDV_SMEM, stream>>>(
        q1, k1, v1, g1, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t n = (int64_t)p.B * p.Sk * p.Hkv * (p.dh + p.dv);
    bwd_reduce_kernel<__nv_bfloat16><<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dq<<<dim3((p.Sq + WG_ROWS - 1) / WG_ROWS, p.Hq, p.B), WG_NT, T::DQ_SMEM, stream>>>(
        q2, k2, v2, g2, p);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// dtype: 0 float32 (scalar body), 1 bfloat16 (tensor-core body); q, k,
// v, o, do and the gradients share it.  Strides are in elements, the head
// dimension of every tensor is contiguous; for bfloat16, dh and dv are
// multiples of 8, Sq and Sk at least 1, and q, k, v and do have 16-byte
// aligned pointers and strides (the wrapper checks).  lse: the forward's
// (B, Hq, Sq) float32 row log-sum-exp; delta: a (B, Hq, Sq) float32
// scratch; part: a (B, Sk, Hq, dh + dv) float32 scratch.  Returns the CUDA
// error of the launches (0 on success); the caller checks it.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* go, const float* lse, float* delta, float* part,
                        void* gq, void* gk, void* gv,
                        int B, int Sq, int Sk, int Hq, int Hkv, int dh, int dv,
                        int64_t q_sb, int64_t q_ss, int64_t q_sh,
                        int64_t k_sb, int64_t k_ss, int64_t k_sh,
                        int64_t v_sb, int64_t v_ss, int64_t v_sh,
                        int64_t o_sb, int64_t o_ss, int64_t o_sh,
                        int64_t go_sb, int64_t go_ss, int64_t go_sh,
                        int64_t gq_sb, int64_t gq_ss, int64_t gq_sh,
                        int64_t gk_sb, int64_t gk_ss, int64_t gk_sh,
                        int64_t gv_sb, int64_t gv_ss, int64_t gv_sh,
                        float scale, float softcap, int causal, int window,
                        int q_offset, int dtype, void* stream) {
  if (dh < 1 || dh > 256 || dv < 1 || dv > 256 || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (dh % 8 || dv % 8 || Sq < 1 || Sk < 1)) return (int)cudaErrorInvalidValue;
  if (B == 0 || (Sq == 0 && Sk == 0)) return (int)cudaSuccess;
  BwdParams p{q, k, v, o, go, lse, delta, part, gq, gk, gv,
              B, Sq, Sk, Hq, Hkv, dh, dv,
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
              go_sb, go_ss, go_sh, gq_sb, gq_ss, gq_sh, gk_sb, gk_ss, gk_sh, gv_sb, gv_ss, gv_sh,
              scale, softcap, causal, window, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? launch_bf16(p, s)
                    : dtype == 0 ? launch_all<float>(p, s)
                                 : cudaErrorInvalidValue;
  return (int)err;
}

// The dynamic shared memory per block at (dh, dv) of the float32 body's
// dkdv (which 0) or dq (which 1) kernel, or of the bfloat16 body's dkdv
// (2) or dq (3) kernel.
int64_t flash_attention_bwd_smem_bytes(int dh, int dv, int which) {
  if (which >= 2)
    return (int64_t)with_wgmma_tile(dh, dv, [&](auto tile) {
      using TL = decltype(tile);
      return which == 2 ? TL::DKDV_SMEM : TL::DQ_SMEM;
    });
  return (int64_t)with_tile(dh, dv, [&](auto tile) {
    using TL = decltype(tile);
    return which == 0 ? TL::dkdv_smem(dh, dv) : TL::dq_smem(dh, dv);
  });
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
