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
//
// Arithmetic: scalar float32 FMA on the CUDA cores for both input types.
// The reference's backward casts q, k, v and do to float32 and takes
// every product in float32, so this is its arithmetic; the tensor cores
// would round the operands.  What bounds it on the H100 is therefore the
// float32 FMA rate (67 TFLOP/s at best), against five products of dh or
// dv terms per visible score: a bf16 backward on wgmma is later work.
//
// Four device kernels per call, no atomics, every sum in a fixed order
// (the result does not change from run to run):
//
// 1. bwd_delta_kernel: D, one warp per (b, q head, row).
// 2. flash_bwd_dkdv_kernel: one block per (key tile, q head, b).  The
//    block keeps its K and V tiles in shared memory and walks the query
//    tiles that can see them (tiles wholly above the causal diagonal or
//    past the window are skipped), recomputing s and p from lse, and
//    accumulates this head's share of dk and dv in float32 registers.  It
//    writes them once, into a float32 scratch (B, Sk, Hq, dh + dv).  A
//    block per query head rather than per KV head keeps B * Hq * tiles
//    blocks in flight: at qwen2's training shape (B 2, 2 KV heads) a
//    block per KV head would leave half the card idle.
// 3. bwd_reduce_kernel: dk and dv as the sum over the G heads of the
//    scratch, in head order, cast to the input type.
// 4. flash_bwd_dq_kernel: one block per (query tile, q head, b), heaviest
//    tiles first; it walks the visible key tiles and writes dq once.
//
// Each thread of a 256-thread block owns a (BM / 16) x (BN / 16) tile of
// scores (rows ty * RM + i, keys tx + 16 j), and a strip of output rows
// by columns tx + 16 j for the products over the tile; operands sit in
// shared memory as float32 with odd row strides, so column reads are free
// of bank conflicts.  Tiles of 64 x 64 up to dh 192 / dv 128, 32 x 32
// beyond (dh 256), so that K, V, Q, dO, P and dS fit in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

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

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v, o, do and the gradients share
// it).  Strides are in elements, the head dimension of every tensor is
// contiguous (the wrapper checks).  lse: the forward's (B, Hq, Sq)
// float32 row log-sum-exp; delta: a (B, Hq, Sq) float32 scratch; part: a
// (B, Sk, Hq, dh + dv) float32 scratch.  Returns the CUDA error of the
// launches (0 on success); the caller checks it.
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
  if (B == 0 || (Sq == 0 && Sk == 0)) return (int)cudaSuccess;
  BwdParams p{q, k, v, o, go, lse, delta, part, gq, gk, gv,
              B, Sq, Sk, Hq, Hkv, dh, dv,
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
              go_sb, go_ss, go_sh, gq_sb, gq_ss, gq_sh, gk_sb, gk_ss, gk_sh, gv_sb, gv_ss, gv_sh,
              scale, softcap, causal, window, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? launch_all<__nv_bfloat16>(p, s)
                    : dtype == 0 ? launch_all<float>(p, s)
                                 : cudaErrorInvalidValue;
  return (int)err;
}

// The dynamic shared memory of the dkdv (which 0) or dq (which 1) kernel
// at (dh, dv).
int64_t flash_attention_bwd_smem_bytes(int dh, int dv, int which) {
  return (int64_t)with_tile(dh, dv, [&](auto tile) {
    using TL = decltype(tile);
    return which == 0 ? TL::dkdv_smem(dh, dv) : TL::dq_smem(dh, dv);
  });
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
