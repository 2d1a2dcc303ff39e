// K3b: the backward of the RG-LRU linear recurrence h_t = a_t * h_{t-1} +
// b_t, for Hopper (sm_90a), CUDA C++.
//
// Mirrors the VJP of the reference's scan (src/repro/models/rglru.py,
// rglru_scan: jax.lax.associative_scan, differentiated by JAX; the Pallas
// kernel K3 replaces has no VJP).  The port's forward is the kernel K3
// (rglru_scan.cu), so its gradient is a kernel as well.  From the float32
// a (B, S, r), the forward's y (every step's state), an optional h0
// (B, r), dy (B, S, r) and an optional dh_T (B, r), it carries c from
// dh_T (or 0) backwards over t = S-1 ... 0:
//     g_t = dy_t + c,  db_t = g_t,  da_t = g_t * h_{t-1},  c = a_t * g_t
// with h_{t-1} = y_{t-1}, h_{-1} = h0 (or 0), and writes da, db (B, S, r)
// and, when h0 is given, dh0 = c (B, r).
//
// What bounds it on the H100: bytes.  a, y and dy are read once and da
// and db written once, 5 * B * S * r * 4 bytes (plus B * r * 4 for each
// of h0, dh_T and dh0 that is given), for 3 float32 operations per
// element (3/20 FLOP per byte).  At B 2, S 1024, r 2560, the training
// microbatch, that is 104.9 MB: 31.3 us at 3.35 TB/s.
//
// The design is K3's ring walked backwards (rglru_scan.cu):
//  * a block of C = 32 or 16 threads owns C channels of one batch row and
//    walks the sequence from step S-1 down to 0; the host's plan
//    (kernels/rglru_scan_bwd.py:plan_scan_bwd) takes the widest C that
//    gives at least one block per SM;
//  * the block streams its boxes of T steps x C channels of a, y and dy
//    by TMA (cp.async.bulk.tensor.3d, completion counted in bytes on an
//    mbarrier per stage) into a ring of 12 KB stages, last box first;
//    one thread refills a stage as soon as the walk has left it;
//  * h_{t-1} is y one step earlier: the y box of steps [t0, t0 + T) is
//    read at step coordinate t0 - 1, and TMA's zero fill before the
//    tensor's first step gives h_{-1} = 0.  A given h0 is read once and
//    written by each lane over its own zero in the first box (the last
//    one walked, whose stage is never refilled);
//  * the walk reads a, h and dy from shared memory (lane c reads word
//    t*C + c: no bank conflicts), loading the next 8 steps while it
//    computes these 8; c stays in a register;
//  * da and db go out as y does in K3: each step's values into a pair of
//    staged boxes (three pairs, in turn) that one thread stores by TMA
//    once the box is walked;
//  * any r and S: TMA zero-fills a loaded box past r and S and clips a
//    stored one there; the last box is walked only from S - 1.
// Each step is a separately rounded add and two multiplies (__fadd_rn,
// __fmul_rn, no FMA), in the plain version's order
// (kernels/ref.py:rglru_scan_bwd_ref), so the kernel matches it bit for
// bit.  The chain a step carries is one add and one multiply, as in K3.
//
// The launch allocates nothing and does not synchronise: the tensor maps
// are built on the host per call and go to the kernel as
// __grid_constant__ parameters.  TMA needs a's, y's, dy's base and the
// strides of their rows and steps 16-byte aligned, so r % 4 == 0 and the
// channel dimension contiguous (the host module checks).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BOX_BYTES = 4096;                  // T steps x C channels
constexpr int STAGE_BYTES = 3 * BOX_BYTES;       // boxes of a, y, dy
constexpr int OUT_BYTES = 2 * BOX_BYTES;         // boxes of da, db
constexpr int OUT_BUFFERS = 3;                   // staged for TMA stores
constexpr int MAX_STAGES = 16;
constexpr int SMEM_ALIGN = 1024;                 // slack to align the ring
constexpr int UNROLL = 8;                        // steps loaded together

struct BwdParams {
  const float* h0; const float* dhT; float* dh0;
  int S, r, stages;
  int64_t h0_sb, dhT_sb, dh0_sb;
};

size_t smem_bytes(int stages) {
  return SMEM_ALIGN + (size_t)stages * STAGE_BYTES + OUT_BUFFERS * OUT_BYTES +
         8 * (size_t)stages;
}

// One step backwards: g = dy + c; db = g; da = g * h_{t-1}; c = a * g.
__device__ __forceinline__ void step_back(float a, float h, float dy, float& c, float* da,
                                          float* db) {
  const float g = __fadd_rn(dy, c);
  *db = g;
  *da = __fmul_rn(g, h);
  c = __fmul_rn(a, g);
}

// One block: C channels of one batch row, the whole sequence backwards.
// blockDim.x == C, one warp or half of one; grid (ceil(r / C), B).
template <int C>
__global__ void __launch_bounds__(C) rglru_scan_bwd_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap ty,
    const __grid_constant__ CUtensorMap tdy, const __grid_constant__ CUtensorMap tda,
    const __grid_constant__ CUtensorMap tdb, BwdParams p) {
  constexpr int T = BOX_BYTES / (4 * C);         // steps per box
  constexpr int BOX = T * C;                     // floats per box
  constexpr unsigned MASK = 0xffffffffu >> (32 - C);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  float* ring = reinterpret_cast<float*>(smem_raw + ((SMEM_ALIGN - (raw & (SMEM_ALIGN - 1))) &
                                                     (SMEM_ALIGN - 1)));
  float* obuf = ring + p.stages * (STAGE_BYTES / 4);   // OUT_BUFFERS (da, db) pairs
  const uint32_t ring_u32 = smem_u32(ring), obuf_u32 = smem_u32(obuf);
  const uint32_t bars = obuf_u32 + OUT_BUFFERS * OUT_BYTES;

  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * C, ch = c0 + lane;
  const int row = blockIdx.y;
  const bool live = ch < p.r;
  const int n_boxes = (p.S + T - 1) / T;

  if (lane == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // box j of a, of y one step earlier (h_{t-1}) and of dy into stage s
  const CUtensorMap* ma = &ta;
  const CUtensorMap* my = &ty;
  const CUtensorMap* mdy = &tdy;
  auto load_stage = [=](int s, int j) {
    const uint32_t bar = bars + 8 * s, dst = ring_u32 + s * STAGE_BYTES;
    mbar_expect_tx(bar, STAGE_BYTES);
    tma_load_3d(dst, ma, bar, c0, j * T, row);
    tma_load_3d(dst + BOX_BYTES, my, bar, c0, j * T - 1, row);
    tma_load_3d(dst + 2 * BOX_BYTES, mdy, bar, c0, j * T, row);
  };
  // the k-th box walked is box n_boxes - 1 - k
  if (lane == 0)
    for (int k = 0; k < p.stages && k < n_boxes; ++k) load_stage(k, n_boxes - 1 - k);

  float c = (p.dhT != nullptr && live) ? p.dhT[row * p.dhT_sb + ch] : 0.f;
  const float h0v = (p.h0 != nullptr && live) ? p.h0[row * p.h0_sb + ch] : 0.f;
  int s = 0, ob = 0;              // walk k's stage and output pair
  uint32_t phase = 0;             // the parity of stage s's barrier
  for (int k = 0; k < n_boxes; ++k) {
    const int j = n_boxes - 1 - k;
    mbar_wait(bars + 8 * s, phase);
    float* stage = ring + s * (STAGE_BYTES / 4) + lane;
    const float* as = stage;
    float* hs = stage + BOX;
    const float* ds = stage + 2 * BOX;
    float* das = obuf + ob * (OUT_BYTES / 4) + lane;
    float* dbs = das + BOX;
    const int t0 = j * T;
    if (j == 0 && p.h0 != nullptr) hs[0] = h0v;   // h_{-1}: TMA put 0 there
    if (t0 + T <= p.S) {
      // a whole box, from its last step: the next UNROLL steps' loads are
      // in flight while these UNROLL steps compute
      float av[UNROLL], hv[UNROLL], dv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int t = T - 1 - u;
        av[u] = as[t * C]; hv[u] = hs[t * C]; dv[u] = ds[t * C];
      }
#pragma unroll
      for (int u0 = 0; u0 < T; u0 += UNROLL) {
        float an[UNROLL], hn[UNROLL], dn[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int t = T - 1 - (u0 + UNROLL + u);
          an[u] = t >= 0 ? as[t * C] : 0.f;
          hn[u] = t >= 0 ? hs[t * C] : 0.f;
          dn[u] = t >= 0 ? ds[t * C] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int t = T - 1 - (u0 + u);
          step_back(av[u], hv[u], dv[u], c, &das[t * C], &dbs[t * C]);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) { av[u] = an[u]; hv[u] = hn[u]; dv[u] = dn[u]; }
      }
    } else {
      for (int t = p.S - t0 - 1; t >= 0; --t)      // the last, partial box
        step_back(as[t * C], hs[t * C], ds[t * C], c, &das[t * C], &dbs[t * C]);
    }
    fence_proxy_async();          // this lane's da and db, before TMA reads them
    __syncwarp(MASK);             // every lane has left stage s and written its pair
    if (lane == 0) {
      // the pair out (TMA clips it at S and r) and stage s refilled; then
      // wait until walk k - 1's stores have read their pair, the one walk
      // k + 2 writes: the lanes pass the barrier above only after this
      // wait, so no lane writes a pair that a store still reads
      const uint32_t src = obuf_u32 + ob * OUT_BYTES;
      tma_store_3d(&tda, src, c0, t0, row);
      tma_store_3d(&tdb, src + BOX_BYTES, c0, t0, row);
      bulk_commit();
      if (k + p.stages < n_boxes) load_stage(s, j - p.stages);
      bulk_wait_read<OUT_BUFFERS - 2>();
    }
    if (++s == p.stages) { s = 0; phase ^= 1u; }
    if (++ob == OUT_BUFFERS) ob = 0;
  }
  if (lane == 0) bulk_wait_read<0>();
  if (live && p.dh0 != nullptr) p.dh0[row * p.dh0_sb + ch] = c;
}

// S == 0: no step, dh0 is dh_T (or zeros)
__global__ void rglru_scan_bwd_empty_kernel(BwdParams p, int B) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * p.r) return;
  const int64_t row = i / p.r, ch = i % p.r;
  p.dh0[row * p.dh0_sb + ch] = p.dhT != nullptr ? p.dhT[row * p.dhT_sb + ch] : 0.f;
}

template <int C>
cudaError_t launch(const void* a, const void* y, const void* dy, void* da, void* db, int B,
                   const int64_t (&st)[10], const BwdParams& p, cudaStream_t stream) {
  constexpr int T = BOX_BYTES / (4 * C);
  // A runtime call first: it makes the device's primary context current
  // in this thread.  cuTensorMapEncodeTiled fails without one, and
  // autograd runs a backward on a thread of its own that may have made no
  // CUDA call yet.
  const size_t smem = smem_bytes(p.stages);
  cudaError_t err = cudaFuncSetAttribute(rglru_scan_bwd_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap ta, ty, tdy, tda, tdb;
  if (!encode_map_3d(fn, &ta, a, B, p.S, p.r, st[0], st[1], C, T) ||
      !encode_map_3d(fn, &ty, y, B, p.S, p.r, st[2], st[3], C, T) ||
      !encode_map_3d(fn, &tdy, dy, B, p.S, p.r, st[4], st[5], C, T) ||
      !encode_map_3d(fn, &tda, da, B, p.S, p.r, st[6], st[7], C, T) ||
      !encode_map_3d(fn, &tdb, db, B, p.S, p.r, st[8], st[9], C, T))
    return cudaErrorInvalidValue;
  const dim3 grid((p.r + C - 1) / C, B);
  rglru_scan_bwd_kernel<C><<<grid, C, smem, stream>>>(ta, ty, tdy, tda, tdb, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Strides are in elements; the channel dimension of every tensor is
// contiguous, and a's, y's, dy's, da's and db's base and the strides of
// their dimensions longer than 1 are 16-byte aligned (the host module
// checks).  h0 and dhT may be null (zeros); dh0 is written only when it
// is not null.  `channels` (16 or 32) and `stages` come from the host's
// plan.  Returns the CUDA error of the launch (0 on success).
int rglru_scan_bwd(const void* a, const void* y, const void* dy, const void* h0,
                   const void* dhT, void* da, void* db, void* dh0, int B, int S, int r,
                   int channels, int stages, int64_t a_sb, int64_t a_ss, int64_t y_sb,
                   int64_t y_ss, int64_t dy_sb, int64_t dy_ss, int64_t h0_sb, int64_t dhT_sb,
                   int64_t da_sb, int64_t da_ss, int64_t db_sb, int64_t db_ss, int64_t dh0_sb,
                   void* stream) {
  if (B < 0 || S < 0 || r < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if ((channels != 16 && channels != 32) || stages < 1 || stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || r == 0) return (int)cudaSuccess;
  BwdParams p{static_cast<const float*>(h0), static_cast<const float*>(dhT),
              static_cast<float*>(dh0), S, r, stages, h0_sb, dhT_sb, dh0_sb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 0) {
    if (dh0 == nullptr) return (int)cudaSuccess;
    const int64_t n = (int64_t)B * r;
    rglru_scan_bwd_empty_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(p, B);
    return (int)cudaGetLastError();
  }
  const int64_t st[10] = {a_sb, a_ss, y_sb, y_ss, dy_sb, dy_ss, da_sb, da_ss, db_sb, db_ss};
  const cudaError_t err = channels == 32 ? launch<32>(a, y, dy, da, db, B, st, p, s)
                                         : launch<16>(a, y, dy, da, db, B, st, p, s);
  return (int)err;
}

// The dynamic shared memory a launch with `stages` stages asks for.
int64_t rglru_scan_bwd_smem_bytes(int stages) { return (int64_t)smem_bytes(stages); }

const char* rglru_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
