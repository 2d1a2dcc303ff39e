// K3: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_scan_kernel, body _rglru_kernel): float32 a, b of (B, S, r) and an
// optional h0 of (B, r) give y (B, S, r), every step's state, and h_T (B, r).
// The TPU grid (B, r / r_blk) walks each (S, r_blk) slice in VMEM; that
// block structure is not carried over.
//
// What bounds it on the H100: each element is read twice (a, b) and
// written once (y) for 2 float32 operations, 1/6 FLOP per byte, so it is
// bound by memory bytes: 3 * B * S * r * 4 + 2 * B * r * 4 (h0 in, h_T
// out).  No arithmetic can be saved; only the bytes' rate matters.
//
// What the design does about it:
//  * one thread owns one (batch row, channel) pair and keeps h in a
//    register for the whole sequence: the only traffic is a, b and y;
//  * neighbouring threads own neighbouring channels, so every step's
//    loads of a[b, t, :] and b[b, t, :] and its store of y[b, t, :] are
//    coalesced (the channel dimension must be contiguous);
//  * the loads do not depend on h, so the loop is software-pipelined: the
//    next UNROLL steps' a and b are loaded while the current UNROLL steps
//    compute, keeping 2 * UNROLL loads in flight per thread;
//  * any r: the ragged last block masks its channels; any S: the last
//    chunk predicates its steps.
// Each step is a separately rounded multiply and add (no FMA), as the
// plain version and the reference compute it, so the kernel matches them
// bit for bit.
// The grid is B * ceil(r / 64) blocks of 64 threads: at B * r = 10240
// (batch 4, r 2560) that is 160 blocks, a little over one per SM, and at
// B = 1 only 40 of the 132 SMs get work.  A chunked two-pass scan that
// spreads S over blocks as well is the later design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;       // threads (channels) per block
constexpr int UNROLL = 8;    // steps loaded ahead

struct ScanParams {
  const float* a; const float* b; const float* h0; float* y; float* hT;
  int S, r;
  int64_t a_sb, a_ss, b_sb, b_ss, h0_sb, y_sb, y_ss, hT_sb;
};

__global__ void __launch_bounds__(NT) rglru_scan_kernel(ScanParams p) {
  const int c = blockIdx.x * NT + threadIdx.x;
  const int64_t row = blockIdx.y;
  if (c >= p.r) return;
  const float* __restrict__ ap = p.a + row * p.a_sb + c;
  const float* __restrict__ bp = p.b + row * p.b_sb + c;
  float* __restrict__ yp = p.y + row * p.y_sb + c;
  float h = p.h0 != nullptr ? p.h0[row * p.h0_sb + c] : 0.f;

  float av[UNROLL], bv[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const bool in = u < p.S;
    av[u] = in ? __ldg(ap + (int64_t)u * p.a_ss) : 0.f;
    bv[u] = in ? __ldg(bp + (int64_t)u * p.b_ss) : 0.f;
  }
  for (int t0 = 0; t0 < p.S; t0 += UNROLL) {
    float an[UNROLL], bn[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {        // the next chunk, in flight
      const int t = t0 + UNROLL + u;
      const bool in = t < p.S;
      an[u] = in ? __ldg(ap + (int64_t)t * p.a_ss) : 0.f;
      bn[u] = in ? __ldg(bp + (int64_t)t * p.b_ss) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t < p.S) {
        h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
        yp[(int64_t)t * p.y_ss] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) { av[u] = an[u]; bv[u] = bn[u]; }
  }
  p.hT[row * p.hT_sb + c] = h;
}

}  // namespace

extern "C" {

// Strides are in elements; the channel dimension of every tensor is
// contiguous.  h0 may be null (zeros).  Returns the CUDA error of the
// launch.
int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* y,
                   void* hT, int B, int S, int r,
                   int64_t a_sb, int64_t a_ss, int64_t b_sb, int64_t b_ss,
                   int64_t h0_sb, int64_t y_sb, int64_t y_ss, int64_t hT_sb,
                   void* stream) {
  if (B < 0 || S < 0 || r < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || r == 0) return (int)cudaSuccess;
  ScanParams p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<const float*>(h0), static_cast<float*>(y),
               static_cast<float*>(hT), S, r,
               a_sb, a_ss, b_sb, b_ss, h0_sb, y_sb, y_ss, hT_sb};
  const dim3 grid((r + NT - 1) / NT, B);
  rglru_scan_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
