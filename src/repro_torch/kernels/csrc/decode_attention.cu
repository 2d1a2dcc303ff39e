// K2: single-token decode attention over a KV cache, for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention_kernel, body _decode_kernel): attention of one query
// token per row against a cache of S slots, slot validity from the row's
// position pos (a ring buffer when window == S: slot j holds position
// pos - ((pos - j) mod W)), optional softcap, float32 softmax.
//
// What bounds it on the H100: it reads every valid cache slot once and
// does 4 * dh FLOPs per slot per query head, about G FLOPs per byte, far
// below the ~295 FLOP/byte ridge: it is bound by memory bytes.
//
// What the design does about it:
//  * one block per (batch row, KV head) computes all G query heads of the
//    group, so each cache byte is read from device memory once per group,
//    not once per query head (G = 7 for qwen2);
//  * slots past pos, and left of a non-ring window, are never loaded: the
//    loop bound comes from pos itself;
//  * pos is read from device memory, not passed as a host scalar, so the
//    decode step can later be captured in a CUDA graph;
//  * K/V tiles of 64 slots go through shared memory (odd row stride for
//    conflict-free reads); the softmax is float32, reduced within a warp
//    per query head, with running max/sum across tiles.
// With B * Hkv blocks a small batch fills few of the 132 SMs; splitting
// the cache across blocks (flash-decoding) is later work.
// Masked slots score the oracles' finite NEG_INF, so a row with no valid
// slot (pos < 0, or a plain window that ends before the cache does) gets
// what the oracles give it, the mean of v over all S slots: the kernel
// visits every slot for such a row.  The model's path never makes one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int TN = 64;        // cache slots per tile
constexpr int NT = 256;       // threads per block
constexpr int NW = NT / 32;   // warps; warp w owns query heads w, w+8, ...
constexpr int MAXG = 4 * NW;  // at most 32 query heads per KV head
constexpr float NEG_INF = -1e30f;  // the oracles' mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool slot_valid(int pos, int j, int window, int ring) {
  if (ring) {
    int d = (pos - j) % window;            // C remainder: make it a true modulo
    if (d < 0) d += window;
    return pos - d >= 0;
  }
  bool ok = j <= pos;
  if (window > 0) ok = ok && pos - j < window;
  return ok;
}

struct DecodeParams {
  const void* q; const void* k; const void* v; const int* pos; void* o;
  int S, Hkv, G, dh, dv;
  int64_t q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale, softcap;         // softcap <= 0: none
  int window, ring;             // window <= 0: none
};

template <typename T, int NACC>
__global__ void __launch_bounds__(NT) decode_kernel(DecodeParams p) {
  extern __shared__ float smem[];
  const int ld = p.dh | 1;
  float* Qs = smem;                        // G x dh
  float* Ks = Qs + p.G * p.dh;             // TN x ld
  float* Vs = Ks + TN * ld;                // TN x dv
  float* Ps = Vs + TN * p.dv;              // G x TN
  float* alpha_s = Ps + p.G * TN;          // G
  float* l_s = alpha_s + p.G;              // G

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int pos = p.pos[b];

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + (int64_t)hk * p.G * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* op = static_cast<T*>(p.o) + b * p.o_sb + (int64_t)hk * p.G * p.o_sh;

  for (int idx = tid; idx < p.G * p.dh; idx += NT) {
    const int g = idx / p.dh, d = idx - g * p.dh;
    Qs[idx] = to_f32(qp[g * p.q_sh + d]);
  }

  // slots past pos are invalid in every mode (a ring slot j > pos holds
  // the negative position j - W); a plain window also cuts the left.  In
  // a ring, slot pos mod W holds pos itself, so [n_begin, n_end) is empty
  // exactly when no slot is valid: then every slot is visited, all masked,
  // and the softmax comes out uniform, as in the oracles.
  int n_end = min(p.S, pos + 1), n_begin = 0;
  if (!p.ring && p.window > 0) n_begin = max(0, pos - p.window + 1);
  if (n_begin >= n_end) { n_begin = 0; n_end = p.S; }
  n_begin = (n_begin / TN) * TN;

  float m[4], l[4], acc[NACC];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
#pragma unroll
  for (int a = 0; a < NACC; ++a) acc[a] = 0.f;

  for (int n0 = n_begin; n0 < n_end; n0 += TN) {
    __syncthreads();
    for (int idx = tid; idx < TN * p.dh; idx += NT) {
      const int j = idx / p.dh, d = idx - j * p.dh;
      const int slot = n0 + j;
      Ks[j * ld + d] = slot < p.S ? to_f32(kp[slot * p.k_ss + d]) : 0.f;
    }
    for (int idx = tid; idx < TN * p.dv; idx += NT) {
      const int j = idx / p.dv, d = idx - j * p.dv;
      const int slot = n0 + j;
      Vs[j * p.dv + d] = slot < p.S ? to_f32(vp[slot * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    for (int idx = tid; idx < p.G * TN; idx += NT) {
      const int g = idx / TN, j = idx - g * TN;
      const int slot = n0 + j;
      // a masked slot scores NEG_INF, as in the oracles; padding past the
      // cache's end scores -inf and never counts
      float x = slot < p.S ? NEG_INF : -INFINITY;
      if (slot < p.S && slot_valid(pos, slot, p.window, p.ring)) {
        const float* qr = Qs + g * p.dh;
        const float* kr = Ks + j * ld;
        float dot = 0.f;
        for (int d = 0; d < p.dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        x = dot * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      }
      Ps[idx] = x;
    }
    __syncthreads();

#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      const int g = warp + NW * gi;
      if (g >= p.G) break;                 // uniform across the warp
      float* row = Ps + g * TN;
      float mx = -INFINITY;
      for (int j = lane; j < TN; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      // slot n0 < S is in every tile, so m_new is finite
      const float m_new = fmaxf(m[gi], mx);
      const float alpha = expf(m[gi] - m_new);   // 0 on the first tile
      float sum = 0.f;
      for (int j = lane; j < TN; j += 32) {
        const float e = expf(row[j] - m_new);
        row[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      l[gi] = l[gi] * alpha + sum;
      m[gi] = m_new;
      if (lane == 0) alpha_s[g] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      const int idx = tid + a * NT;
      if (idx < p.G * p.dv) {
        const int g = idx / p.dv, c = idx - g * p.dv;
        const float* pr = Ps + g * TN;
        float sum = 0.f;
        for (int j = 0; j < TN; ++j) sum = fmaf(pr[j], Vs[j * p.dv + c], sum);
        acc[a] = acc[a] * alpha_s[g] + sum;
      }
    }
  }

#pragma unroll
  for (int gi = 0; gi < 4; ++gi) {
    const int g = warp + NW * gi;
    if (g < p.G && lane == 0) l_s[g] = l[gi];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    const int idx = tid + a * NT;
    if (idx < p.G * p.dv) {
      const int g = idx / p.dv, c = idx - g * p.dv;
      const float lg = l_s[g];
      op[g * p.o_sh + c] = from_f32<T>(lg > 0.f ? acc[a] / lg : 0.f);
    }
  }
}

template <typename T, int NACC>
cudaError_t launch(const DecodeParams& p, int B, cudaStream_t stream) {
  const int ld = p.dh | 1;
  const size_t smem = sizeof(float) *
      (size_t)(p.G * p.dh + TN * ld + TN * p.dv + p.G * TN + 2 * p.G);
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, NACC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  decode_kernel<T, NACC><<<dim3(p.Hkv, B), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_acc(const DecodeParams& p, int B, cudaStream_t stream) {
  const int outs = p.G * p.dv;             // outputs per block
  if (outs <= NT) return launch<T, 1>(p, B, stream);
  if (outs <= 2 * NT) return launch<T, 2>(p, B, stream);
  if (outs <= 4 * NT) return launch<T, 4>(p, B, stream);
  if (outs <= 8 * NT) return launch<T, 8>(p, B, stream);
  return launch<T, 16>(p, B, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  Strides are in elements; pos is a device
// pointer to B int32 positions.  Returns the CUDA error of the launch.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* pos, void* o,
                         int B, int S, int Hq, int Hkv, int dh, int dv,
                         int64_t q_sb, int64_t q_sh,
                         int64_t k_sb, int64_t k_ss, int64_t k_sh,
                         int64_t v_sb, int64_t v_ss, int64_t v_sh,
                         int64_t o_sb, int64_t o_sh,
                         float scale, float softcap, int window, int dtype,
                         void* stream) {
  if (dh < 1 || dh > 256 || dv < 1 || dv > 256 || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  if (G > MAXG || G * dv > 16 * NT) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int ring = window > 0 && S == window;
  DecodeParams p{q, k, v, static_cast<const int*>(pos), o, S, Hkv, G, dh, dv,
                 q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh,
                 scale, softcap, window, ring};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? dispatch_acc<__nv_bfloat16>(p, B, s)
                               : dtype == 0 ? dispatch_acc<float>(p, B, s)
                                            : cudaErrorInvalidValue;
  return (int)err;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
