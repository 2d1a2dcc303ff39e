// K1: prefill flash attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_kernel, body _flash_kernel): causal, optionally
// windowed and softcapped GQA attention with an online softmax whose
// running max m, sum l and output accumulator acc stay in float32.
//
// What bounds it on the H100: at prefill lengths attention does
// O(S^2 * dh) work on O(S * dh) bytes, so it is bound by operations.
//
// Two bodies, chosen by the inputs' type (an explicit dispatch, not a
// fallback: each type has exactly one body):
//
// * bfloat16 runs flash_wgmma_kernel, on the tensor cores.  One warpgroup
//   (128 threads) owns 64 query rows.  S = Q K^T and O += P V are
//   wgmma.mma_async m64nNk16 products (bf16 in, float32 accumulators in
//   registers): Q and the K tile are K-major shared-memory operands, P
//   goes from the S accumulator to bf16 in registers and is the register
//   A operand of the second product (it never touches shared memory), V
//   is the MN-major (transposed) shared-memory B operand.  The online
//   softmax runs on the accumulator fragment: row max and sum across the
//   4 threads of a quad by shuffle, ex2.approx with scale * log2(e) folded
//   in, masks only on boundary tiles.  S of tile i + 1 is issued ahead of
//   P V of tile i, and tile i + 1's softmax runs while P V does
//   (FlashAttention-3's intra-warpgroup overlap).  Q and the K/V tiles
//   arrive by TMA (cp.async.bulk.tensor, 128-byte swizzle, the (B, S, H,
//   D) layout read through its strides); K and V each have a 2-stage ring
//   signalled by mbarriers, refilled by one thread as soon as a stage is
//   consumed, so each copy goes out 1.5 to 2 tiles ahead of its use.
//   Head dims are tiled to 64, 128, 192 or 256; TMA
//   zero-fills the box past the true dh/dv, so dh and dv need only be
//   multiples of 8 (TMA's 16-byte stride rule).  The tensor maps are built
//   on the host per call, with cuTensorMapEncodeTiled fetched through
//   cudaGetDriverEntryPoint (the library links no -lcuda).
// * float32 runs flash_fwd_kernel, scalar FMA on the CUDA cores (67
//   TFLOP/s at best).  The tensor cores have no full-float32 mode, and
//   TF32 keeps about three digits, which would break the float32 parity
//   tolerance (2e-5) and the float32 model gates.  Each thread computes a
//   4x4 tile of scores and a 4 x dv/16 tile of output from float32
//   copies of the tiles in shared memory.
//
// Both bodies: one block per (64-row query tile, query head, batch row),
// the TPU's sequential KV grid axis a loop inside the block; tiles wholly
// above the causal diagonal or left of the window are never loaded; the
// mask is evaluated only in boundary tiles; blocks start with the
// heaviest (last) query tiles so the causal tail does not trail.
// A row with no valid key at all (a window or q_offset that puts every key
// out of reach) gets what the oracles give it: they mask with a finite
// NEG_INF, so their softmax is uniform and the row is the mean of v over
// all Sk keys.  The model's path never makes such a row.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

struct FlashParams {
  const void* q; const void* k; const void* v; void* o;
  int B, Sq, Sk, Hq, Hkv, dh, dv;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float scale, softcap;         // softcap <= 0: none
  int causal, window, q_offset; // window <= 0: none
};

// The key range [n_begin, n_end) that can be unmasked for query rows
// [q0, q0 + rows), n_begin rounded down to a tile of `tile` keys.
__device__ __forceinline__ void key_range(const FlashParams& p, int q0, int rows,
                                          int tile, int* n_begin, int* n_end) {
  const int q_lo = p.q_offset + q0;
  const int q_hi = p.q_offset + q0 + rows - 1;
  int b = 0, e = p.Sk;
  if (p.causal) e = min(p.Sk, q_hi + 1);
  if (p.window > 0) b = max(0, q_lo - p.window + 1);
  *n_begin = (b / tile) * tile;
  *n_end = e;
}

// ===========================================================================
// float32: scalar FMA on the CUDA cores

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int NT = 256;       // threads: 16 row groups x 16 column lanes
constexpr int PLD = BN + 4;   // P row stride: rows 4 apart land 16 banks apart

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// max / sum across the 16 lanes that share a row group (lanes differ in
// their low four bits)
__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(FlashParams p) {
  extern __shared__ float smem[];
  const int ld = p.dh | 1;                 // odd stride: conflict-free columns
  float* Qs = smem;                        // BM x ld
  float* Ks = Qs + BM * ld;                // BN x ld
  float* Vs = Ks + BN * ld;                // BN x dv
  float* Ps = Vs + BN * p.dv;              // BM x PLD

  const int nq = (p.Sq + BM - 1) / BM;
  const int qt = nq - 1 - blockIdx.x;      // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * BM;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;                 // rows ty*4 .. ty*4+3
  const int tx = tid & 15;                 // columns tx + 16*j

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < BM * p.dh; idx += NT) {
    const int r = idx / p.dh, d = idx - r * p.dh;
    const int row = q0 + r;
    Qs[r * ld + d] = row < p.Sq ? to_f32(qp[row * p.q_ss + d]) : 0.f;
  }

  const int rows = min(BM, p.Sq - q0);
  const int q_lo = p.q_offset + q0;
  const int q_hi = p.q_offset + q0 + rows - 1;
  int n_begin, n_end;
  key_range(p, q0, rows, BN, &n_begin, &n_end);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY; l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    __syncthreads();                       // previous tile fully consumed
    for (int idx = tid; idx < BN * p.dh; idx += NT) {
      const int n = idx / p.dh, d = idx - n * p.dh;
      const int key = n0 + n;
      Ks[n * ld + d] = key < p.Sk ? to_f32(kp[key * p.k_ss + d]) : 0.f;
    }
    for (int idx = tid; idx < BN * p.dv; idx += NT) {
      const int n = idx / p.dv, d = idx - n * p.dv;
      const int key = n0 + n;
      Vs[n * p.dv + d] = key < p.Sk ? to_f32(vp[key * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int kk = 0; kk < p.dh; ++kk) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * ld + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * ld + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    const bool interior = n0 + BN <= p.Sk && q0 + BM <= p.Sq &&
                          (!p.causal || n0 + BN - 1 <= q_lo) &&
                          (p.window <= 0 || q_hi - n0 < p.window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      const int qpos = p.q_offset + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        if (!interior) {
          const int key = n0 + tx + 16 * j;
          bool ok = key < p.Sk && row < p.Sq;
          if (p.causal) ok = ok && key <= qpos;
          if (p.window > 0) ok = ok && qpos - key < p.window;
          if (!ok) x = -INFINITY;
        }
        s[i][j] = x;
      }
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mx = group16_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float alpha = 1.f, rs = 0.f;
      if (m_new != -INFINITY) {
        alpha = expf(m[i] - m_new);        // 0 when m[i] is still -inf
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new); // masked: exp(-inf) = 0
          rs += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
      rs = group16_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * PLD + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    for (int n = 0; n < BN; ++n) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty * 4 + i) * PLD + n];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float vv = c < p.dv ? Vs[n * p.dv + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    if (l[i] == 0.f) {                     // no valid key: mean of v
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        if (c >= p.dv) continue;
        float sum = 0.f;
        for (int key = 0; key < p.Sk; ++key) sum += to_f32(vp[key * p.v_ss + c]);
        op[row * p.o_ss + c] = from_f32<T>(p.Sk > 0 ? sum / p.Sk : 0.f);
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < p.dv) op[row * p.o_ss + c] = from_f32<T>(acc[i][j] / l[i]);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  const int ld = p.dh | 1;
  const size_t smem = sizeof(float) * (size_t)(BM * ld + BN * ld + BN * p.dv + BM * PLD);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BM - 1) / BM, p.Hq, p.B);
  flash_fwd_kernel<T, NJ><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_dv(const FlashParams& p, cudaStream_t stream) {
  if (p.dv <= 16) return launch<float, 1>(p, stream);
  if (p.dv <= 32) return launch<float, 2>(p, stream);
  if (p.dv <= 64) return launch<float, 4>(p, stream);
  if (p.dv <= 128) return launch<float, 8>(p, stream);
  return launch<float, 16>(p, stream);
}

// ===========================================================================
// bfloat16: wgmma on the tensor cores, TMA into a 2-stage ring

constexpr int WG_BM = 64;     // query rows per block: one warpgroup
constexpr int WG_NT = 128;    // threads: the warpgroup
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}
// one TMA box from a 4-d tensor map (coordinates innermost first) into
// shared memory, completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// 2^x on the special-function unit; results below 2^-126 flush to zero,
// which a softmax weight can afford
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S(64 x 32) (+)= A(64 x 16) B(32 x 16)^T, both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S(64 x 64) (+)= A(64 x 16) B(64 x 16)^T, both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O(64 x 64) += A(64 x 16, registers) B(16 x 64), B from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O(64 x 128) += A(64 x 16, registers) B(16 x 128), B from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O(64 x 256) += A(64 x 16, registers) B(16 x 256), B from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Accumulator fragment of an m64nN product: register i of thread `lane`
// in warp w holds row 16w + lane/4 + 8*((i/2)%2), column 8*(i/4) +
// 2*(lane%4) + i%2.
template <int DHT, int DVT, int KN, int MINB>
__global__ void __launch_bounds__(WG_NT, MINB)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, FlashParams p) {
  constexpr int Q_CHUNK = WG_BM * 128;   // 64 rows x 64 columns of bf16
  constexpr int KV_CHUNK = KN * 128;     // KN rows x 64 columns
  constexpr int Q_BYTES = (DHT / 64) * Q_CHUNK;
  constexpr int K_BYTES = (DHT / 64) * KV_CHUNK;
  constexpr int STAGE = K_BYTES + (DVT / 64) * KV_CHUNK;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles sit on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = base + Q_BYTES;             // stage s at sKV + s * STAGE
  // 8-byte barriers: K of stage 0 and 1, V of stage 0 and 1, Q
  const uint32_t bar_k = sKV + 2 * STAGE, bar_v = bar_k + 16, bar_q = bar_k + 32;

  const int nq = (p.Sq + WG_BM - 1) / WG_BM;
  const int qt = nq - 1 - blockIdx.x;              // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * WG_BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);          // rows r0 and r0 + 8
  const int cq = 2 * (lane & 3);                   // column within an 8-block

  const int rows = min(WG_BM, p.Sq - q0);
  int n_begin, n_end;
  key_range(p, q0, rows, KN, &n_begin, &n_end);
  const int n_tiles = n_end > n_begin ? (n_end - n_begin + KN - 1) / KN : 0;
  const int q_lo = p.q_offset + q0, q_hi = q_lo + rows - 1;

  // only the 64-column chunks that hold some of dh / dv are loaded; the
  // chunks past them are zeroed once, so the products over the whole tile
  // add nothing there, and output columns past dv are never stored
  const int dh_chunks = (p.dh + 63) / 64, dv_chunks = (p.dv + 63) / 64;

  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bar_k + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (dh_chunks < DHT / 64) {
    uint4* sq = reinterpret_cast<uint4*>(smem_raw + (sQ - smem_u32(smem_raw)));
    for (int i = dh_chunks * Q_CHUNK / 16 + tid; i < Q_BYTES / 16; i += WG_NT)
      sq[i] = make_uint4(0, 0, 0, 0);
    for (int st = 0; st < 2; ++st) {
      uint4* sk = reinterpret_cast<uint4*>(smem_raw + (sKV + st * STAGE - smem_u32(smem_raw)));
      for (int i = dh_chunks * KV_CHUNK / 16 + tid; i < K_BYTES / 16; i += WG_NT)
        sk[i] = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // seen by wgmma
  }
  __syncthreads();

  // one thread: the K (or V) tile j into its stage j % 2.  K and V have
  // rings of their own: a K stage is free once S of its tile is done, a
  // V stage once P V is, so each tile's copies go out 1.5 to 2 tiles
  // ahead of their use
  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  auto issue_k = [=](int j) {
    const uint32_t bar = bar_k + 8 * (j & 1), dst = sKV + (j & 1) * STAGE;
    mbar_expect_tx(bar, (uint32_t)dh_chunks * KV_CHUNK);
    for (int c = 0; c < dh_chunks; ++c)
      tma_load_4d(dst + c * KV_CHUNK, mk, bar, c * 64, hk, n_begin + j * KN, b);
  };
  auto issue_v = [=](int j) {
    const uint32_t bar = bar_v + 8 * (j & 1), dst = sKV + (j & 1) * STAGE + K_BYTES;
    mbar_expect_tx(bar, (uint32_t)dv_chunks * KV_CHUNK);
    for (int c = 0; c < dv_chunks; ++c)
      tma_load_4d(dst + c * KV_CHUNK, mv, bar, c * 64, hk, n_begin + j * KN, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, (uint32_t)dh_chunks * Q_CHUNK);
    for (int c = 0; c < dh_chunks; ++c) tma_load_4d(sQ + c * Q_CHUNK, &tq, bar_q, c * 64, h, q0, b);
    for (int j = 0; j < 2 && j < n_tiles; ++j) { issue_k(j); issue_v(j); }
  }

  float o[DVT / 2];
#pragma unroll
  for (int i = 0; i < DVT / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;    // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;                // this thread's share of the sums
  const float sl2 = p.scale * LOG2E;
  float s[KN / 2];                         // S of one tile, then its P
  uint32_t pa[KN / 16][4];                 // P as the bf16 A operand

  // S = Q K^T of tile j once its K is in, issued and committed, not waited for
  auto qk = [&](int j) {
    mbar_wait(bar_k + 8 * (j & 1), (j >> 1) & 1);
    const uint32_t sK = sKV + (j & 1) * STAGE;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DHT / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;  // 16 columns = 32 bytes
      wgmma_ss(s, gmma_desc(sQ + (kk >> 2) * Q_CHUNK + off, 16, 1024),
               gmma_desc(sK + (kk >> 2) * KV_CHUNK + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile j once its V is in: V is MN-major, its 64-column
  // chunks KV_CHUNK bytes apart; issued and committed, not waited for
  auto pv = [&](int j) {
    mbar_wait(bar_v + 8 * (j & 1), (j >> 1) & 1);
    const uint32_t sV = sKV + (j & 1) * STAGE + K_BYTES;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk)
      wgmma_rs(o, pa[kk], gmma_desc(sV + kk * 16 * 128, KV_CHUNK, 1024));
    wgmma_commit();
  };
  // the online softmax of S (keys n0 ..) in place on the fragment, in the
  // log2 domain; the rescale of O for this tile goes to a0 / a1.  Each
  // case (softcap or not, boundary tile or not) is its own unrolled loop,
  // chosen once per tile: a runtime branch inside the element loop costs
  // the softmax 2-5x its time.
  auto softmax = [&](int n0, float& a0, float& a1) {
    if (p.softcap > 0.f) {
      const float inner = p.scale / p.softcap, outer = p.softcap * LOG2E;
#pragma unroll
      for (int i = 0; i < KN / 2; ++i) s[i] = outer * tanhf(s[i] * inner);
    } else {
#pragma unroll
      for (int i = 0; i < KN / 2; ++i) s[i] *= sl2;
    }
    const bool interior = n0 + KN <= p.Sk && q0 + WG_BM <= p.Sq &&
                          (!p.causal || n0 + KN - 1 <= q_lo) &&
                          (p.window <= 0 || q_hi - n0 < p.window);
    if (!interior) {
#pragma unroll
      for (int i = 0; i < KN / 2; ++i) {
        const int key = n0 + (i >> 2) * 8 + cq + (i & 1);
        const int row = q0 + r0 + ((i >> 1) & 1) * 8;
        const int qpos = p.q_offset + row;
        bool ok = key < p.Sk && row < p.Sq;
        if (p.causal) ok = ok && key <= qpos;
        if (p.window > 0) ok = ok && qpos - key < p.window;
        s[i] = ok ? s[i] : -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) {
      if ((i >> 1) & 1) mx1 = fmaxf(mx1, s[i]); else mx0 = fmaxf(mx0, s[i]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with nothing unmasked yet keeps m = -inf, p = 0, alpha = 0
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    a0 = ex2(m0 - mu0);
    a1 = ex2(m1 - mu1);
    m0 = mn0; m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) {
      const bool hi_row = (i >> 1) & 1;
      const float e = ex2(s[i] - (hi_row ? mu1 : mu0));
      s[i] = e;
      if (hi_row) rs1 += e; else rs0 += e;
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
  };
  // P to bf16 A fragments: k-step j covers keys 16j .. 16j + 15
  auto to_a = [&]() {
#pragma unroll
    for (int j = 0; j < KN / 16; ++j) {
      pa[j][0] = pack_bf16(s[8 * j + 0], s[8 * j + 1]);
      pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
      pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
      pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
    }
  };

  mbar_wait(bar_q, 0);
  if (n_tiles > 0) {
    float a0, a1;                          // O is still zero
    qk(0);
    wgmma_wait_all();
    fence_regs(s);
    softmax(n_begin, a0, a1);
    to_a();
    __syncthreads();                       // K stage 0 is free
    if (tid == 0 && n_tiles > 2) issue_k(2);
  }
  // Each tile but the last: S of the next tile goes to the tensor cores
  // ahead of this tile's P V, and the next tile's softmax runs while P V
  // does (FlashAttention-3's intra-warpgroup overlap).  Nothing in the
  // body is conditional, so ptxas keeps the products asynchronous.
  for (int it = 0; it + 1 < n_tiles; ++it) {
    qk(it + 1);
    pv(it);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");   // S done
    fence_regs(s);
    float a0, a1;
    softmax(n_begin + (it + 1) * KN, a0, a1);
    wgmma_wait_all();                      // P V done: pa may be rewritten
    fence_regs(o);
    fence_regs(s);                         // ... by packs that come after it
    to_a();
#pragma unroll
    for (int i = 0; i < DVT / 2; ++i) o[i] *= ((i >> 1) & 1) ? a1 : a0;
    __syncthreads();                       // K of tile it + 1, V of tile it consumed
    if (tid == 0) {
      if (it + 3 < n_tiles) issue_k(it + 3);
      if (it + 2 < n_tiles) issue_v(it + 2);
    }
  }
  if (n_tiles > 0) {
    pv(n_tiles - 1);
    wgmma_wait_all();
    fence_regs(o);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + 8 * half;
    if (row >= p.Sq) continue;
    const float l = half ? l1 : l0;
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int nb = 0; nb < DVT / 8; ++nb) {
      const int c = nb * 8 + cq;
      if (c >= p.dv) continue;
      float x0 = o[4 * nb + 2 * half] * inv, x1 = o[4 * nb + 2 * half + 1] * inv;
      if (l == 0.f) {                       // no valid key: mean of v
        x0 = 0.f; x1 = 0.f;
        for (int key = 0; key < p.Sk; ++key) {
          x0 += __bfloat162float(vp[key * p.v_ss + c]);
          x1 += __bfloat162float(vp[key * p.v_ss + c + 1]);
        }
        if (p.Sk > 0) { x0 /= p.Sk; x1 /= p.Sk; }
      }
      *reinterpret_cast<__nv_bfloat162*>(op + row * p.o_ss + c) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A (B, S, H, D) bf16 tensor as a 4-d map over (D, H, S, B), innermost
// first; boxes of 64 columns x `rows` positions of one head
bool encode_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int D, int H, int S,
                int B, int64_t sh, int64_t ss, int64_t sb, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// One bf16 instantiation: head-dim tiles DHT (q, k) and DVT (v), KN keys
// per tile, MINB blocks per SM for the register budget
template <int DHT_, int DVT_, int KN_, int MINB_>
struct Bf16Tile {
  static constexpr int DHT = DHT_, DVT = DVT_, KN = KN_, MINB = MINB_;
  // dynamic shared memory: alignment slack, Q, a 2-stage K/V ring, barriers
  static constexpr size_t SMEM = 1024 + (size_t)WG_BM * DHT * 2 + 2 * (size_t)KN * 2 * (DHT + DVT) + 40;
};

// head-dim tiles 64, 128, 192 (MLA: dh 192, dv 128) and 256; keys per
// tile and blocks per SM chosen so the accumulators fit in registers
template <typename F>
auto with_bf16_tile(int dh, int dv, F f) {
  if (dh <= 64 && dv <= 64) return f(Bf16Tile<64, 64, 64, 3>{});
  if (dh <= 128 && dv <= 128) return f(Bf16Tile<128, 128, 64, 2>{});
  if (dh <= 192 && dv <= 128) return f(Bf16Tile<192, 128, 64, 2>{});
  return f(Bf16Tile<256, 256, 32, 2>{});
}

cudaError_t launch_bf16(const FlashParams& p, cudaStream_t stream) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  return with_bf16_tile(p.dh, p.dv, [&](auto tile) {
    using T = decltype(tile);
    CUtensorMap tq, tk, tv;
    if (!encode_map(fn, &tq, p.q, p.dh, p.Hq, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, WG_BM) ||
        !encode_map(fn, &tk, p.k, p.dh, p.Hkv, p.Sk, p.B, p.k_sh, p.k_ss, p.k_sb, T::KN) ||
        !encode_map(fn, &tv, p.v, p.dv, p.Hkv, p.Sk, p.B, p.v_sh, p.v_ss, p.v_sb, T::KN))
      return cudaErrorInvalidValue;
    auto kernel = flash_wgmma_kernel<T::DHT, T::DVT, T::KN, T::MINB>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)T::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + WG_BM - 1) / WG_BM, p.Hq, p.B);
    kernel<<<grid, WG_NT, T::SMEM, stream>>>(tq, tk, tv, p);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// dtype: 0 float32 (scalar body), 1 bfloat16 (tensor-core body).  Strides
// are in elements; for bfloat16, dh and dv are multiples of 8 and the
// pointers and the strides of dimensions longer than 1 are 16-byte
// aligned (the wrapper checks).  Returns the CUDA error of the launch (0
// on success); the caller checks it.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Sk, int Hq, int Hkv, int dh, int dv,
                        int64_t q_sb, int64_t q_ss, int64_t q_sh,
                        int64_t k_sb, int64_t k_ss, int64_t k_sh,
                        int64_t v_sb, int64_t v_ss, int64_t v_sh,
                        int64_t o_sb, int64_t o_ss, int64_t o_sh,
                        float scale, float softcap, int causal, int window,
                        int q_offset, int dtype, void* stream) {
  if (dh < 1 || dh > 256 || dv < 1 || dv > 256 || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (dh % 8 || dv % 8)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  FlashParams p{q, k, v, o, B, Sq, Sk, Hq, Hkv, dh, dv,
                q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                o_sb, o_ss, o_sh, scale, softcap, causal, window, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? launch_bf16(p, s)
                               : dtype == 0 ? dispatch_dv(p, s)
                                            : cudaErrorInvalidValue;
  return (int)err;
}

// The dynamic shared memory a bfloat16 launch at (dh, dv) asks for.
int64_t flash_attention_bf16_smem_bytes(int dh, int dv) {
  return (int64_t)with_bf16_tile(dh, dv, [](auto tile) { return decltype(tile)::SMEM; });
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
