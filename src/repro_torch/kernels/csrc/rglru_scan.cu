// K3: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_scan_kernel, body _rglru_kernel): float32 a, b of (B, S, r) and an
// optional h0 of (B, r) give y (B, S, r), every step's state, and h_T (B, r).
// The TPU grid (B, r / r_blk) walks each (S, r_blk) slice in VMEM; that
// block structure is not carried over.
//
// What bounds it on the H100: bytes.  a and b are read once and y is
// written once, 3 * B * S * r * 4 bytes, plus B * r * 4 for h_T and as
// much again for h0 when it is given, for 2 float32 operations per
// element (1/6 FLOP per byte).  No arithmetic can be saved; only the rate
// at which the bytes move matters.
//
// Bytes in flight set that rate.  By Little's law, 3.35 TB/s at a loaded
// DRAM latency of about half a microsecond needs a few MB in flight
// across the card: tens of KB on every SM.  One thread per (row, channel)
// with 16 four-byte loads in flight keeps 2,560 x 64 B ~ 164 KB in flight
// at B 1, r 2560, on 40 blocks, which is 0.37 TB/s.
//
// What the design does about it:
//  * tiles that fill the card: a block of C = 32 or 16 threads (one warp
//    or half of one) owns C channels of one batch row; the host's plan
//    (kernels/rglru_scan.py:plan_scan) takes the widest C that gives at
//    least one block per SM, so B 1, r 2560 runs 160 blocks;
//  * a deep ring: the block streams its boxes of T steps x C channels of a
//    and b by TMA (cp.async.bulk.tensor.3d, completion counted in bytes
//    on an mbarrier per stage) into a ring of `stages` shared-memory
//    stages of 8 KB (T = 64 at C 16, T = 32 at C 32).  The plan sizes the
//    ring to about 128 KB of shared memory per SM, so each SM keeps tens
//    of KB of loads in flight.  One thread refills a stage as soon as the
//    walk has left it;
//  * the walk reads a and b from shared memory (lane c reads word t*C + c:
//    no bank conflicts), loading the next 8 steps while it computes these
//    8, since the loads do not depend on h; h stays in a register;
//  * y goes out the way a and b come in: the walk writes each step's h
//    into a y box in shared memory (three, in turn), and one thread
//    stores the whole box by TMA (cp.async.bulk.tensor, a bulk group)
//    once the box is walked.  A global store a step from the walk would
//    cost a 64-bit address, a predicate for the ragged tile and a
//    register the next step must wait on: about 55 cycles a step against
//    the ~10 of the walk;
//  * any r and S: TMA zero-fills a loaded box past r and S and clips a
//    stored one there; the last box is walked only to S.
// Each step is a separately rounded multiply then add (__fmul_rn,
// __fadd_rn, no FMA), in sequence order, as the plain version computes
// it, so the kernel matches it bit for bit.  No carry-composition scan:
// it would round differently and read a and b twice.
// The walk is what is left at batch 1.  Each channel's steps form one
// chain of a multiply and an add (8 cycles of latency); with its shared-
// memory loads, its y writes and each box's barrier, store and refill, a
// block takes about 21 cycles a step on an H100 (tools/k3_phase_probe.py),
// ~49 us at S 4096 against the 37.6 us byte bound of B 1, r 2560: there
// the walk, not the bytes, sets the pace.  S is still not split over
// blocks: the state handed from one chunk to the next has to be the exact
// h, so a chunk cannot start before the one before it ends and the chain
// stays S steps long.
//
// The launch allocates nothing and does not synchronise: the tensor maps
// are built on the host per call, with cuTensorMapEncodeTiled fetched
// through cudaGetDriverEntryPoint (the library links no -lcuda), and go
// to the kernel as __grid_constant__ parameters.  TMA needs a and b's
// base and the strides of their rows and steps 16-byte aligned, so r % 4
// == 0 and the channel dimension contiguous (the host module checks).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STAGE_BYTES = 8192;   // one stage: an a box and a b box
constexpr int Y_BOX_BYTES = STAGE_BYTES / 2;
constexpr int Y_BUFFERS = 3;        // y boxes staged for their TMA stores
constexpr int MAX_STAGES = 16;
constexpr int SMEM_ALIGN = 1024;    // slack to align the ring
constexpr int UNROLL = 8;           // steps whose loads go out together

struct ScanParams {
  const float* h0; float* y; float* hT;
  int S, r, stages;
  int64_t h0_sb, y_sb, y_ss, hT_sb;
};

size_t smem_bytes(int stages) {
  return SMEM_ALIGN + (size_t)stages * STAGE_BYTES + Y_BUFFERS * Y_BOX_BYTES +
         8 * (size_t)stages;
}

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
// one box of shared memory out to a 3-d tensor map, in a bulk group
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until at most N bulk groups still read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
// order this thread's shared-memory writes before the async proxy's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// one TMA box from a 3-d tensor map (coordinates innermost first) into
// shared memory, completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// One block: C channels of one batch row, the whole sequence.  blockDim.x
// == C, one warp or half of one; grid (ceil(r / C), B).
template <int C>
__global__ void __launch_bounds__(C) rglru_scan_kernel(const __grid_constant__ CUtensorMap ta,
                                                       const __grid_constant__ CUtensorMap tb,
                                                       const __grid_constant__ CUtensorMap ty,
                                                       ScanParams p) {
  constexpr int T = STAGE_BYTES / (2 * 4 * C);   // steps per box
  constexpr int BOX = T * C;                     // floats per box
  constexpr unsigned MASK = 0xffffffffu >> (32 - C);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  float* ring = reinterpret_cast<float*>(smem_raw + ((SMEM_ALIGN - (raw & (SMEM_ALIGN - 1))) &
                                                     (SMEM_ALIGN - 1)));
  float* ybuf = ring + p.stages * (STAGE_BYTES / 4);   // Y_BUFFERS boxes of y
  const uint32_t ring_u32 = smem_u32(ring), ybuf_u32 = smem_u32(ybuf);
  const uint32_t bars = ybuf_u32 + Y_BUFFERS * Y_BOX_BYTES;

  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * C, c = c0 + lane;
  const int row = blockIdx.y;
  const bool live = c < p.r;
  const int n_boxes = (p.S + T - 1) / T;

  if (lane == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // box j of a and of b into stage s
  const CUtensorMap* ma = &ta;
  const CUtensorMap* mb = &tb;
  auto issue = [=](int s, int j) {
    const uint32_t bar = bars + 8 * s, dst = ring_u32 + s * STAGE_BYTES;
    mbar_expect_tx(bar, 2 * BOX * 4);
    tma_load_3d(dst, ma, bar, c0, j * T, row);
    tma_load_3d(dst + BOX * 4, mb, bar, c0, j * T, row);
  };
  if (lane == 0)
    for (int j = 0; j < p.stages && j < n_boxes; ++j) issue(j, j);

  float h = (p.h0 != nullptr && live) ? p.h0[row * p.h0_sb + c] : 0.f;
  int s = 0, yb = 0;              // box j's stage and y buffer
  uint32_t phase = 0;             // the parity of stage s's barrier
  for (int j = 0; j < n_boxes; ++j) {
    mbar_wait(bars + 8 * s, phase);
    const float* as = ring + s * (STAGE_BYTES / 4) + lane;
    const float* bs = as + BOX;
    float* ys = ybuf + yb * BOX + lane;
    const int t0 = j * T;
    if (t0 + T <= p.S) {
      // a whole box: the next UNROLL steps' loads are in flight while
      // these UNROLL steps compute
      float av[UNROLL], bv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) { av[u] = as[u * C]; bv[u] = bs[u * C]; }
#pragma unroll
      for (int u0 = 0; u0 < T; u0 += UNROLL) {
        float an[UNROLL], bn[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int t = u0 + UNROLL + u;
          an[u] = t < T ? as[t * C] : 0.f;
          bn[u] = t < T ? bs[t * C] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
          ys[(u0 + u) * C] = h;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) { av[u] = an[u]; bv[u] = bn[u]; }
      }
    } else {
      const int steps = p.S - t0;                  // the last, partial box
      for (int u = 0; u < steps; ++u) {
        h = __fadd_rn(__fmul_rn(as[u * C], h), bs[u * C]);
        ys[u * C] = h;
      }
    }
    fence_proxy_async();          // this lane's y, before TMA reads it
    __syncwarp(MASK);             // every lane has left stage s and written y
    if (lane == 0) {
      // the y box out (TMA clips it at S and r) and stage s refilled; then
      // wait until box j - 1's store has read its y buffer, the one box
      // j + 2 writes: the lanes pass the barrier above only after this
      // wait, so no lane writes a buffer that a store still reads
      tma_store_3d(&ty, ybuf_u32 + yb * Y_BOX_BYTES, c0, t0, row);
      bulk_commit();
      if (j + p.stages < n_boxes) issue(s, j + p.stages);
      bulk_wait_read<Y_BUFFERS - 2>();
    }
    if (++s == p.stages) { s = 0; phase ^= 1u; }
    if (++yb == Y_BUFFERS) yb = 0;
  }
  if (lane == 0) bulk_wait_read<0>();
  if (live) p.hT[row * p.hT_sb + c] = h;
}

// S == 0: no step, h_T is h0 (or zeros)
__global__ void rglru_scan_empty_kernel(ScanParams p, int B) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * p.r) return;
  const int64_t row = i / p.r, c = i % p.r;
  p.hT[row * p.hT_sb + c] = p.h0 != nullptr ? p.h0[row * p.h0_sb + c] : 0.f;
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

// A (B, S, r) float32 tensor as a 3-d map over (r, S, B), innermost
// first; boxes of C channels x T steps of one row, zero-filled out of
// bounds when loaded and clipped when stored.  Strides in elements.
bool encode_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int B, int S, int r,
                int64_t sb, int64_t ss, int C, int T) {
  const cuuint64_t dims[3] = {(cuuint64_t)r, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ss * 4, (cuuint64_t)sb * 4};
  const cuuint32_t box[3] = {(cuuint32_t)C, (cuuint32_t)T, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int C>
cudaError_t launch(const void* a, const void* b, int B, int64_t a_sb, int64_t a_ss,
                   int64_t b_sb, int64_t b_ss, const ScanParams& p, cudaStream_t stream) {
  constexpr int T = STAGE_BYTES / (2 * 4 * C);
  // A runtime call first: it makes the device's primary context current
  // in this thread.  cuTensorMapEncodeTiled fails without one, and a
  // pool or router thread may reach K3 before any other CUDA call.
  const size_t smem = smem_bytes(p.stages);
  cudaError_t err = cudaFuncSetAttribute(rglru_scan_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap ta, tb, ty;
  if (!encode_map(fn, &ta, a, B, p.S, p.r, a_sb, a_ss, C, T) ||
      !encode_map(fn, &tb, b, B, p.S, p.r, b_sb, b_ss, C, T) ||
      !encode_map(fn, &ty, p.y, B, p.S, p.r, p.y_sb, p.y_ss, C, T))
    return cudaErrorInvalidValue;
  const dim3 grid((p.r + C - 1) / C, B);
  rglru_scan_kernel<C><<<grid, C, smem, stream>>>(ta, tb, ty, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Strides are in elements; the channel dimension of every tensor is
// contiguous, and a's and b's base and the strides of their dimensions
// longer than 1 are 16-byte aligned (the host module checks).  h0 may be
// null (zeros).  `channels` (16 or 32) and `stages` come from the host's
// plan.  Returns the CUDA error of the launch (0 on success).
int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* y,
                   void* hT, int B, int S, int r, int channels, int stages,
                   int64_t a_sb, int64_t a_ss, int64_t b_sb, int64_t b_ss,
                   int64_t h0_sb, int64_t y_sb, int64_t y_ss, int64_t hT_sb,
                   void* stream) {
  if (B < 0 || S < 0 || r < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if ((channels != 16 && channels != 32) || stages < 1 || stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || r == 0) return (int)cudaSuccess;
  ScanParams p{static_cast<const float*>(h0), static_cast<float*>(y),
               static_cast<float*>(hT), S, r, stages, h0_sb, y_sb, y_ss, hT_sb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 0) {
    const int64_t n = (int64_t)B * r;
    rglru_scan_empty_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(p, B);
    return (int)cudaGetLastError();
  }
  const cudaError_t err = channels == 32 ? launch<32>(a, b, B, a_sb, a_ss, b_sb, b_ss, p, s)
                                         : launch<16>(a, b, B, a_sb, a_ss, b_sb, b_ss, p, s);
  return (int)err;
}

// The dynamic shared memory a launch with `stages` stages asks for.
int64_t rglru_scan_smem_bytes(int stages) { return (int64_t)smem_bytes(stages); }

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
