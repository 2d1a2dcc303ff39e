// K4: the MoE layer's routed experts as one grouped SwiGLU GEMM over the
// rows that carry a kept assignment, Hopper (sm_90a), CUDA C++.
//
// Replaces no TPU kernel.  The reference computes its experts outside
// Pallas (src/repro/models/moe.py, _expert_ffn: einsum/bmm over the
// (E, G*C, d) capacity buffer that the one-hot dispatch fills), so XLA
// runs every expert over every capacity row.  At a capacity that drops
// nothing (factor E/k) that is E/k times the routed work: DeepSeek-V2-
// Lite's 64 experts top-6 compute 9.375% routed rows, granite's 32 top-8
// 25%.  This kernel computes the same function, with the same drops,
// on the T*k rows alone.
//
// What bounds it on the H100: in decode (a few tokens) the expert weights
// streamed from device memory (bytes); in prefill (thousands of tokens)
// the products (operations).
//
// Three device kernels per call, on the caller's stream, no host sync:
//
// * moe_plan_kernel, one block: the routing metadata.  Each kept
//   assignment (rank pos < C within its group and expert, expert in the
//   slice [e0, e0 + E_loc)) gets a row in expert-major order: its
//   expert's offset, then its group's within the expert, plus its rank
//   (counts by shared-memory atomics, integers, so the result is the same
//   every run; prefix sums by one warp).  row_slot[row] is the
//   assignment (t * k + j); rows past the kept ones hold -1.  The tile
//   list holds (expert, first row, rows) for each tile of tile_rows rows
//   of an expert, up to its static bound ceil(T*k / tile_rows) + E_loc;
//   slots past its live end hold expert -1 and their blocks exit.  The
//   down projection's output rows of the assignments not kept are zeroed
//   here, so the sum over k adds nothing for them.
// * the up projection: h = silu(x W_g) * (x W_i) in float32 from float32
//   accumulators, stored in the input type, for every row of every tile;
//   the rows of x are gathered by token (row_slot / k) as they load.
// * the down projection: y = h W_o, times the assignment's gate in
//   float32, stored to the assignment's own (T, k) slot; the caller sums
//   the k slots in a fixed order, so replays are bit-repeatable (no
//   atomics anywhere).
//
// bfloat16 runs on the tensor cores (wgmma, float32 accumulators), with a
// tile shape that follows the rows per expert, T*k / E_loc, which the host
// fixes with the shapes:
//
// * under 64 (every decode step) the product is swapped: the expert's
//   weight tile, 64 output features, is wgmma's M operand (MN-major from
//   shared memory, the transpose bit set), the tile's <= 8 rows its N.
//   The grid runs over (64 output features, tile), so the card's SMs all
//   stream weights and each weight byte is read once per tile.  The
//   tile's rows load once, by cp.async; the weights by TMA (64 x 64 boxes,
//   128-byte swizzle) through a ring of 64 KB on mbarriers.
// * otherwise (prefill) 128-row tiles: two warpgroups of 64 rows, 128
//   output features, rows through a cp.async ring (Hopper's TMA gathers
//   no rows: each thread copies 16-byte pieces into the 128-byte swizzle
//   TMA would have written) and the weights through a TMA ring beside it,
//   S stages ahead of the products.
//
// float32 runs a scalar body (one thread per output feature of a tile,
// FMA over the inputs): the tensor cores have no full-float32 mode, and
// the card-side float32 gates need the reference's precision.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int KT = 64;             // inputs per stage: one 128-byte row of bf16
constexpr int SMALL_ROWS = 8;      // rows per swapped tile (wgmma's N)
constexpr int SMALL_COLS = 64;     // outputs per swapped tile (wgmma's M)
constexpr int LARGE_ROWS = 128;    // rows per large tile: two warpgroups of 64
constexpr int LARGE_COLS = 128;    // outputs per large tile (wgmma's N)
constexpr int PLAN_THREADS = 1024;
constexpr int F32_COLS = 128;      // outputs per float32 block

struct PlanParams {
  const int64_t* idx;      // (T*k) global experts
  const int* pos;          // (T*k) rank within its group and expert, k-major
  int* row_slot;           // (T*k) out
  int* tiles;              // (n_slots, 3) out
  unsigned char* slots;    // (T*k, d): the assignments not kept are zeroed
  int T, k, gs, C, e0, E_loc, tile_rows, n_slots;
  int64_t slot_bytes;      // d * element size, a multiple of 16
};

struct GemmParams {
  const void* a;           // up: x (T, d); down: h (T*k, d_ff)
  const int* row_slot;
  const int* tiles;
  const float* gates;      // (T*k) float32
  void* out;               // up: h (T*k, d_ff); down: the slots (T*k, d)
  int K, N, k;
  int gather;              // 1: row r reads token row_slot[r] / k of a; 0: row r
};

// ===========================================================================
// the routing metadata

// warp 0: a[0..n) to its exclusive prefix sum in place, the total to *total
__device__ void warp_scan(int* a, int n, int* total) {
  const int lane = threadIdx.x & 31;
  const int chunk = (n + 31) / 32;
  const int b = min(n, lane * chunk), e = min(n, b + chunk);
  int s = 0;
  for (int i = b; i < e; ++i) s += a[i];
  int inc = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  int run = inc - s;
  for (int i = b; i < e; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  if (lane == 31) *total = inc;
}

__device__ __forceinline__ bool kept(const PlanParams& p, int a, int* e) {
  *e = (int)(p.idx[a] - p.e0);
  return *e >= 0 && *e < p.E_loc && p.pos[a] < p.C;
}

__global__ void __launch_bounds__(PLAN_THREADS) moe_plan_kernel(PlanParams p) {
  extern __shared__ int plan_smem[];
  const int G = p.T / p.gs;
  const int n = p.T * p.k;
  const int nb = p.E_loc * G;
  int* base = plan_smem;               // (E_loc, G) kept rows, then their prefix
  int* toff = base + nb;               // E_loc + 1: tiles per expert, then their prefix
  int* totals = toff + p.E_loc + 1;    // kept rows, tiles
  const int tid = threadIdx.x;
  for (int i = tid; i < nb; i += blockDim.x) base[i] = 0;
  __syncthreads();
  for (int a = tid; a < n; a += blockDim.x) {
    int e;
    if (kept(p, a, &e)) atomicAdd(&base[e * G + (a / p.k) / p.gs], 1);
  }
  __syncthreads();
  if (tid < 32) warp_scan(base, nb, &totals[0]);
  __syncthreads();
  const int live = totals[0];
  for (int e = tid; e < p.E_loc; e += blockDim.x) {
    const int end = e + 1 < p.E_loc ? base[(e + 1) * G] : live;
    toff[e] = (end - base[e * G] + p.tile_rows - 1) / p.tile_rows;
  }
  __syncthreads();
  if (tid < 32) warp_scan(toff, p.E_loc, &totals[1]);
  __syncthreads();
  if (tid == 0) toff[p.E_loc] = totals[1];
  __syncthreads();

  for (int a = tid; a < n; a += blockDim.x) {
    int e;
    if (kept(p, a, &e)) {
      p.row_slot[base[e * G + (a / p.k) / p.gs] + p.pos[a]] = a;
    } else {
      uint4* dst = reinterpret_cast<uint4*>(p.slots + (int64_t)a * p.slot_bytes);
      for (int64_t i = 0; i < p.slot_bytes / 16; ++i) dst[i] = make_uint4(0, 0, 0, 0);
    }
  }
  for (int r = live + tid; r < n; r += blockDim.x) p.row_slot[r] = -1;
  const int n_tiles = totals[1];
  for (int s = tid; s < p.n_slots; s += blockDim.x) {
    int e = -1, row0 = 0, rows = 0;
    if (s < n_tiles) {
      int lo = 0, hi = p.E_loc;        // toff[lo] <= s < toff[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (toff[mid] <= s) lo = mid; else hi = mid;
      }
      e = lo;
      const int end = e + 1 < p.E_loc ? base[(e + 1) * G] : live;
      row0 = base[e * G] + (s - toff[e]) * p.tile_rows;
      rows = min(p.tile_rows, end - row0);
    }
    p.tiles[3 * s] = e;
    p.tiles[3 * s + 1] = row0;
    p.tiles[3 * s + 2] = rows;
  }
}

// ===========================================================================
// shared pieces of the products

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the row of `a` that expert-major row r reads
template <typename T>
__device__ __forceinline__ const T* a_row(const GemmParams& p, int r) {
  const int64_t src = p.gather ? p.row_slot[r] / p.k : r;
  return static_cast<const T*>(p.a) + src * p.K;
}

// one output of row r, feature f: the up projection's silu(g) * u into h,
// or the down projection's g times the assignment's gate into its slot
template <int NW, typename T>
__device__ __forceinline__ void store_out(const GemmParams& p, int r, int f, float g, float u) {
  T* out = static_cast<T*>(p.out);
  if constexpr (NW == 2) {
    out[(int64_t)r * p.N + f] = from_f32<T>(silu_mul(g, u));
  } else {
    const int slot = p.row_slot[r];
    out[(int64_t)slot * p.N + f] = from_f32<T>(g * p.gates[slot]);
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// D(64 x 8) += A(64 x 16) B(8 x 16)^T from shared memory: A MN-major (its
// 64 rows contiguous: the transpose bit), B K-major
__device__ __forceinline__ void wgmma_n8_mn_a(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

// D(64 x 128) += A(64 x 16) B(16 x 128) from shared memory: A K-major, B
// MN-major (its 128 columns contiguous: the transpose bit)
__device__ __forceinline__ void wgmma_n128_mn_b(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ===========================================================================
// bfloat16, swapped: weights as M, the tile's <= 8 rows as N.  NW 2: the
// up projection (W_g, W_i), NW 1: the down projection (W_o).

template <int NW>
struct Small {
  static constexpr int S = 8 / NW;           // ring stages: 64 KB of weights
  static constexpr int WBOX = KT * 128;      // one weight's 64 x 64 box, 8 KB
  static constexpr int STAGE = NW * WBOX;
  static size_t smem(int K) {                // alignment slack, ring, rows, barriers
    return 1024 + (size_t)S * STAGE + (size_t)(K / KT) * 1024 + 8 * S;
  }
};

template <int NW>
__global__ void __launch_bounds__(128)
moe_small_kernel(const __grid_constant__ CUtensorMap w0, const __grid_constant__ CUtensorMap w1,
                 GemmParams p) {
  using L = Small<NW>;
  constexpr int S = L::S, WBOX = L::WBOX, STAGE = L::STAGE;
  const int* t = p.tiles + 3 * blockIdx.y;
  const int e = t[0];
  if (e < 0) return;                         // past the tile list's live end
  const int row0 = t[1], rows = t[2];
  const int m0 = blockIdx.x * SMALL_COLS;
  const int nk = p.K / KT;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles sit on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sX = base + S * STAGE;      // nk chunks of 8 rows x 128 bytes
  const uint32_t bar = sX + nk * 1024;       // S barriers
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const CUtensorMap* m_0 = &w0;
  const CUtensorMap* m_1 = &w1;
  // one thread: stage j's weight boxes (inputs j*KT.., outputs m0..) into slot j % S
  auto issue = [=](int j) {
    const uint32_t b = bar + 8 * (j % S), dst = base + (j % S) * STAGE;
    mbar_expect_tx(b, (uint32_t)STAGE);
    tma_load_3d(dst, m_0, b, m0, j * KT, e);
    if constexpr (NW == 2) tma_load_3d(dst + WBOX, m_1, b, m0, j * KT, e);
  };
  if (tid == 0)
    for (int j = 0; j < S && j < nk; ++j) issue(j);

  // the tile's rows (the first one again past `rows`: computed, never
  // stored), K-major in 128-byte swizzled chunks of 64 inputs
  const int cpr = p.K / 8;                   // 16-byte pieces per row
  for (int i = tid; i < SMALL_ROWS * cpr; i += 128) {
    const int j = i / cpr, c = i - j * cpr;
    const __nv_bfloat16* src = a_row<__nv_bfloat16>(p, row0 + (j < rows ? j : 0)) + c * 8;
    cp_async16(sX + (c >> 3) * 1024 + j * 128 + (((c & 7) ^ j) << 4), src);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();                       // seen by wgmma
  __syncthreads();

  float g[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    mbar_wait(bar + 8 * s, (kt / S) & 1);
    const uint32_t st = base + s * STAGE;
    fence_regs(g);
    fence_regs(u);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint64_t db = gmma_desc(sX + kt * 1024 + kk * 32, 16, 1024);
      wgmma_n8_mn_a(g, gmma_desc(st + kk * 2048, WBOX, 1024), db);
      if constexpr (NW == 2) wgmma_n8_mn_a(u, gmma_desc(st + WBOX + kk * 2048, WBOX, 1024), db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(g);
    fence_regs(u);
    __syncthreads();                         // slot s consumed by the whole warpgroup
    if (tid == 0 && kt + S < nk) issue(kt + S);
  }

  // register i of thread `lane` in warp w: output 16w + lane/4 + 8(i/2),
  // row 2(lane % 4) + i % 2
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = m0 + 16 * warp + (lane >> 2) + 8 * (i >> 1);
    const int j = 2 * (lane & 3) + (i & 1);
    if (j < rows && f < p.N) store_out<NW, __nv_bfloat16>(p, row0 + j, f, g[i], u[i]);
  }
}

// ===========================================================================
// bfloat16, 128-row tiles: the rows as M (two warpgroups), 128 outputs as N

template <int NW>
struct Large {
  static constexpr int S = NW == 2 ? 4 : 6;                 // ring stages
  static constexpr int A_BYTES = LARGE_ROWS * 128;          // 128 rows x 64 inputs
  static constexpr int WBOX = KT * 128;                     // 64 inputs x 64 outputs
  static constexpr int W_BYTES = (LARGE_COLS / 64) * WBOX;  // 64 inputs x 128 outputs
  static constexpr int STAGE = A_BYTES + NW * W_BYTES;
  static size_t smem() { return 1024 + (size_t)S * STAGE + 8 * S; }
};

template <int NW>
__global__ void __launch_bounds__(256, 1)
moe_large_kernel(const __grid_constant__ CUtensorMap w0, const __grid_constant__ CUtensorMap w1,
                 GemmParams p) {
  using L = Large<NW>;
  constexpr int S = L::S, A_BYTES = L::A_BYTES, WBOX = L::WBOX, W_BYTES = L::W_BYTES,
                STAGE = L::STAGE;
  const int* t = p.tiles + 3 * blockIdx.y;
  const int e = t[0];
  if (e < 0) return;                         // past the tile list's live end
  const int row0 = t[1], rows = t[2];
  const int n0 = blockIdx.x * LARGE_COLS;
  const int nk = p.K / KT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + S * STAGE;     // S barriers
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this thread's 16-byte column c of four rows of every A stage (a row
  // past `rows` reads the tile's first: computed, never stored)
  const int c = tid & 7;
  const __nv_bfloat16* src[4];
  uint32_t dst[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (tid >> 3) + 32 * i;
    src[i] = a_row<__nv_bfloat16>(p, row0 + (r < rows ? r : 0)) + c * 8;
    dst[i] = r * 128 + ((c ^ (r & 7)) << 4);
  }
  const CUtensorMap* m_0 = &w0;
  const CUtensorMap* m_1 = &w1;
  // stage j into slot j % S: the rows by every thread, the weights by one
  auto load = [&](int j) {
    const uint32_t st = base + (j % S) * STAGE;
#pragma unroll
    for (int i = 0; i < 4; ++i) cp_async16(st + dst[i], src[i] + j * KT);
    if (tid == 0) {
      const uint32_t b = bar + 8 * (j % S);
      mbar_expect_tx(b, (uint32_t)(NW * W_BYTES));
#pragma unroll
      for (int h = 0; h < LARGE_COLS / 64; ++h) {
        tma_load_3d(st + A_BYTES + h * WBOX, m_0, b, n0 + 64 * h, j * KT, e);
        if constexpr (NW == 2)
          tma_load_3d(st + A_BYTES + W_BYTES + h * WBOX, m_1, b, n0 + 64 * h, j * KT, e);
      }
    }
  };
  for (int j = 0; j < S - 1; ++j) {
    if (j < nk) load(j);
    cp_async_commit();                       // one group a stage, empty or not
  }

  float g[64], u[NW == 2 ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) g[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (NW == 2 ? 64 : 1); ++i) u[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();                  // this thread's rows of stage kt are in
    fence_proxy_async();
    __syncthreads();                         // everyone's are; stage kt - 1 is consumed
    if (kt + S - 1 < nk) load(kt + S - 1);   // into slot (kt - 1) % S
    cp_async_commit();
    const int s = kt % S;
    mbar_wait(bar + 8 * s, (kt / S) & 1);
    const uint32_t st = base + s * STAGE;
    fence_regs(g);
    fence_regs(u);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint64_t da = gmma_desc(st + wg * 64 * 128 + kk * 32, 16, 1024);
      wgmma_n128_mn_b(g, da, gmma_desc(st + A_BYTES + kk * 2048, WBOX, 1024));
      if constexpr (NW == 2)
        wgmma_n128_mn_b(u, da, gmma_desc(st + A_BYTES + W_BYTES + kk * 2048, WBOX, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(g);
    fence_regs(u);
  }
  cp_async_wait<0>();                        // no copy outlives the block

  // register i of thread `lane` in warp w of warpgroup wg: row 64wg + 16w +
  // lane/4 + 8((i/2) % 2), output 8(i/4) + 2(lane % 4) + i % 2
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = 64 * wg + 16 * warp + (lane >> 2) + 8 * half;
    if (r >= rows) continue;
    int64_t dst_row = row0 + r;
    float gate = 1.f;
    if constexpr (NW == 1) {
      dst_row = p.row_slot[row0 + r];
      gate = p.gates[dst_row];
    }
#pragma unroll
    for (int nb = 0; nb < LARGE_COLS / 8; ++nb) {
      const int col = n0 + 8 * nb + 2 * (lane & 3);
      if (col >= p.N) continue;
      const int i = 4 * nb + 2 * half;
      float v0, v1;
      if constexpr (NW == 2) {
        v0 = silu_mul(g[i], u[i]);
        v1 = silu_mul(g[i + 1], u[i + 1]);
      } else {
        v0 = g[i] * gate;
        v1 = g[i + 1] * gate;
      }
      *reinterpret_cast<__nv_bfloat162*>(out + dst_row * p.N + col) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// ===========================================================================
// float32: scalar FMA on the CUDA cores, one thread per output of a tile

template <int NW>
__global__ void __launch_bounds__(F32_COLS)
moe_f32_kernel(const float* w0, const float* w1, GemmParams p) {
  const int* t = p.tiles + 3 * blockIdx.y;
  const int e = t[0];
  if (e < 0) return;
  const int row0 = t[1], rows = t[2];
  const int f = blockIdx.x * F32_COLS + threadIdx.x;
  if (f >= p.N) return;
  const float* W0 = w0 + (int64_t)e * p.K * p.N + f;
  const float* W1 = NW == 2 ? w1 + (int64_t)e * p.K * p.N + f : nullptr;
  for (int j = 0; j < rows; ++j) {
    const float* x = a_row<float>(p, row0 + j);
    float g = 0.f, u = 0.f;
    for (int kk = 0; kk < p.K; ++kk) {
      const float xv = x[kk];
      g = fmaf(xv, W0[(int64_t)kk * p.N], g);
      if constexpr (NW == 2) u = fmaf(xv, W1[(int64_t)kk * p.N], u);
    }
    store_out<NW, float>(p, row0 + j, f, g, u);
  }
}

// ===========================================================================
// host side

// an (E, K, N) bf16 weight stack as a 3-d map over (N, K, E), innermost
// first; boxes of 64 outputs x KT inputs of one expert, 128-byte swizzle
bool encode_weights(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int N, int K, int E) {
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)KT, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

size_t plan_smem_bytes(int E_loc, int G) { return sizeof(int) * ((size_t)E_loc * G + E_loc + 3); }

size_t smem_bytes(int which, int K) {
  switch (which) {
    case 0: return Small<2>::smem(K);
    case 1: return Small<1>::smem(K);
    case 2: return Large<2>::smem();
    case 3: return Large<1>::smem();
    default: return 0;
  }
}

template <typename K_>
cudaError_t set_smem(K_ kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

cudaError_t launch_bf16(const GemmParams& up, const GemmParams& down, const void* wg,
                        const void* wi, const void* wo, int E_loc, int tile_rows, int n_slots,
                        cudaStream_t stream) {
  const int d = up.K, d_ff = up.N;
  const bool small = tile_rows == SMALL_ROWS;
  // the runtime calls first: they make the device's primary context current
  // in this thread, which cuTensorMapEncodeTiled needs
  cudaError_t err;
  if (small) {
    if ((err = set_smem(moe_small_kernel<2>, Small<2>::smem(d))) != cudaSuccess) return err;
    if ((err = set_smem(moe_small_kernel<1>, Small<1>::smem(d_ff))) != cudaSuccess) return err;
  } else {
    if ((err = set_smem(moe_large_kernel<2>, Large<2>::smem())) != cudaSuccess) return err;
    if ((err = set_smem(moe_large_kernel<1>, Large<1>::smem())) != cudaSuccess) return err;
  }
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tg, ti, to;
  if (!encode_weights(fn, &tg, wg, d_ff, d, E_loc) || !encode_weights(fn, &ti, wi, d_ff, d, E_loc) ||
      !encode_weights(fn, &to, wo, d, d_ff, E_loc))
    return cudaErrorInvalidValue;
  if (small) {
    moe_small_kernel<2><<<dim3(d_ff / SMALL_COLS, n_slots), 128, Small<2>::smem(d), stream>>>(
        tg, ti, up);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    moe_small_kernel<1><<<dim3(d / SMALL_COLS, n_slots), 128, Small<1>::smem(d_ff), stream>>>(
        to, to, down);
  } else {
    const int nu = (d_ff + LARGE_COLS - 1) / LARGE_COLS, nd = (d + LARGE_COLS - 1) / LARGE_COLS;
    moe_large_kernel<2><<<dim3(nu, n_slots), 256, Large<2>::smem(), stream>>>(tg, ti, up);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    moe_large_kernel<1><<<dim3(nd, n_slots), 256, Large<1>::smem(), stream>>>(to, to, down);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (T, d), idx (T*k) int64, pos (T*k) int32, gates (T*k) float32; the
// expert stacks wg, wi (E_loc, d, d_ff) and wo (E_loc, d_ff, d), contiguous,
// in x's type; row_slot (T*k) and tiles (n_slots, 3) int32, h (T*k, d_ff)
// and slots (T*k, d) in x's type, written here.  dtype: 0 float32 (scalar
// body), 1 bfloat16 (tensor cores; d and d_ff multiples of 64, 16-byte
// aligned pointers).  tile_rows: 8 (swapped tiles) or 128; n_slots the tile
// list's static bound.  Returns the CUDA error of the launches (0 on
// success); the caller checks it.
int moe_grouped(const void* x, const int64_t* idx, const int* pos, const float* gates,
                const void* wg, const void* wi, const void* wo, int* row_slot, int* tiles,
                void* h, void* slots, int T, int k, int d, int d_ff, int E_loc, int gs, int C,
                int e0, int tile_rows, int n_slots, int dtype, void* stream) {
  if (T < 1 || k < 1 || gs < 1 || T % gs || E_loc < 1 || d < 1 || d_ff < 1 || n_slots < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && ((d % KT) || (d_ff % KT) || (tile_rows != SMALL_ROWS && tile_rows != LARGE_ROWS)))
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 1 ? 2 : 4;
  if ((int64_t)d * elem % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = T / gs;
  const size_t psmem = plan_smem_bytes(E_loc, G);
  cudaError_t err = set_smem(moe_plan_kernel, psmem);
  if (err != cudaSuccess) return (int)err;
  PlanParams pp{idx, pos, row_slot, tiles, static_cast<unsigned char*>(slots), T, k, gs, C, e0,
                E_loc, tile_rows, n_slots, (int64_t)d * elem};
  moe_plan_kernel<<<1, PLAN_THREADS, psmem, s>>>(pp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  GemmParams up{x, row_slot, tiles, gates, h, d, d_ff, k, 1};
  GemmParams down{h, row_slot, tiles, gates, slots, d_ff, d, k, 0};
  if (dtype == 1) return (int)launch_bf16(up, down, wg, wi, wo, E_loc, tile_rows, n_slots, s);
  moe_f32_kernel<2><<<dim3((d_ff + F32_COLS - 1) / F32_COLS, n_slots), F32_COLS, 0, s>>>(
      static_cast<const float*>(wg), static_cast<const float*>(wi), up);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  moe_f32_kernel<1><<<dim3((d + F32_COLS - 1) / F32_COLS, n_slots), F32_COLS, 0, s>>>(
      static_cast<const float*>(wo), nullptr, down);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a launch: which 0 the swapped up
// projection (K = d), 1 the swapped down projection (K = d_ff), 2 and 3
// the 128-row ones; 4 the plan at (E_loc, G) = (K, G).
int64_t moe_grouped_smem_bytes(int which, int K, int G) {
  if (which == 4) return (int64_t)plan_smem_bytes(K, G);
  return (int64_t)smem_bytes(which, K);
}

const char* moe_grouped_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
