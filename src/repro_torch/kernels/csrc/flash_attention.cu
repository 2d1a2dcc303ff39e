// K1: prefill flash attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_kernel, body _flash_kernel): causal, optionally
// windowed and softcapped GQA attention with an online softmax whose
// running max m, sum l and output accumulator acc stay in float32.
//
// What bounds it on the H100: at prefill lengths attention does
// O(S^2 * dh) work on O(S * dh) bytes, so it is bound by operations.
// This first version multiplies with scalar FMAs on the CUDA cores
// (67 TFLOP/s of float32, not the tensor cores' 989 of bf16), and within
// that it is bound by shared-memory reads: each thread computes a 4x4
// tile of scores and a 4 x dv/16 tile of output, two FMAs per load.
//
// What the design does about it:
//  * one block per (batch, query head, 64-row query tile); the TPU's
//    sequential KV grid axis becomes a loop inside the block, so m, l and
//    acc never leave registers;
//  * K/V tiles of 64 keys are staged through shared memory once per
//    block and read by all 256 threads; row strides are padded so the
//    column reads hit distinct banks;
//  * tiles wholly above the causal diagonal or left of the window are
//    never loaded (the TPU kernel computes and masks them); the mask is
//    evaluated only in boundary tiles; blocks start with the heaviest
//    (last) query tiles so the causal tail does not trail;
//  * q/k/v are read in their (B, S, H, D) layout through strides, with
//    no transposes; bf16 or float32 in, float32 inside.
// A row with no valid key at all (a window or q_offset that puts every key
// out of reach) gets what the oracles give it: they mask with a finite
// NEG_INF, so their softmax is uniform and the row is the mean of v over
// all Sk keys.  The model's path never makes such a row.
// The mma.sync/wgmma tensor-core version is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int NT = 256;       // threads: 16 row groups x 16 column lanes
constexpr int PLD = BN + 4;   // P row stride: rows 4 apart land 16 banks apart

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

struct FlashParams {
  const void* q; const void* k; const void* v; void* o;
  int B, Sq, Sk, Hq, Hkv, dh, dv;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float scale, softcap;         // softcap <= 0: none
  int causal, window, q_offset; // window <= 0: none
};

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

  // key range that can be unmasked for this query tile
  const int rows = min(BM, p.Sq - q0);
  const int q_lo = p.q_offset + q0;
  const int q_hi = p.q_offset + q0 + rows - 1;
  int n_begin = 0, n_end = p.Sk;
  if (p.causal) n_end = min(p.Sk, q_hi + 1);
  if (p.window > 0) n_begin = max(0, q_lo - p.window + 1);
  n_begin = (n_begin / BN) * BN;

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

template <typename T>
cudaError_t dispatch_dv(const FlashParams& p, cudaStream_t stream) {
  if (p.dv <= 16) return launch<T, 1>(p, stream);
  if (p.dv <= 32) return launch<T, 2>(p, stream);
  if (p.dv <= 64) return launch<T, 4>(p, stream);
  if (p.dv <= 128) return launch<T, 8>(p, stream);
  return launch<T, 16>(p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  Strides are in elements.  Returns the
// CUDA error of the launch (0 on success); the caller checks it.
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
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  FlashParams p{q, k, v, o, B, Sq, Sk, Hq, Hkv, dh, dv,
                q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                o_sb, o_ss, o_sh, scale, softcap, causal, window, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? dispatch_dv<__nv_bfloat16>(p, s)
                               : dtype == 0 ? dispatch_dv<float>(p, s)
                                            : cudaErrorInvalidValue;
  return (int)err;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
