// K2: single-token decode attention over a KV cache, for Hopper
// (sm_90a), CUDA C++: split-KV ("flash-decoding") in two passes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention_kernel, body _decode_kernel): attention of one query
// token per row against a cache of S slots, slot validity from the row's
// position pos (a ring buffer when window == S: slot j holds position
// pos - ((pos - j) mod W)), optional softcap, float32 softmax.
//
// What bounds it on the H100: it reads every valid cache slot once and
// does 4 * dh FLOPs per slot per query head, about G FLOPs per byte, far
// below the ~295 FLOP/byte ridge: it is bound by memory bytes.  Tensor
// cores buy nothing here, so both types run this one design.
//
// What the design does about it:
//  * pass 1 runs one block per (batch row, KV head, split), where a split
//    is a contiguous range of slots: the cache is spread over the card,
//    not over B * Hkv blocks.  The split count comes from the host's
//    plan (kernels/decode_attention.py:plan_splits), from B, Hkv, S and
//    the SM count only, never from pos;
//  * each block computes all G query heads of its group, so each cache
//    byte is read from device memory once per group;
//  * K/V tiles of 32 slots arrive by 16-byte cp.async into a double
//    buffer in shared memory, the next tile's copy in flight while this
//    one is computed;
//  * a dot product of q and a key row is shared by at most 8 lanes of a
//    warp, one 16-byte chunk of the row at a time each, and reduced by
//    shuffles, so a warp computes 4 or more slots' dot products at once;
//  * each block keeps a running (m, l, acc) in float32 and writes it to a
//    float32 workspace (B, Hkv, splits, G, dv + 2) that the wrapper
//    allocates; pass 2 merges the splits of each (row, query head) in a
//    fixed order (no atomics, the same result on every run), reading the
//    partial outputs of the splits that pos reaches only;
//  * pos is read from device memory, so the decode step can be captured
//    in a CUDA graph: slots past pos, and left of a non-ring window, are
//    never loaded, and a split wholly past them writes m = -inf, l = 0,
//    which the merge weighs as 0.
// Masked slots score the oracles' finite NEG_INF, so a row with no valid
// slot (pos < 0, or a plain window that ends before the cache does) gets
// what the oracles give it, the mean of v over all S slots: every split
// of such a row visits all its slots, and the merge of those partials is
// the uniform mean.  The model's path never makes such a row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int TN = 32;        // cache slots per tile; splits are whole tiles
constexpr int NT = 256;       // threads per pass-1 block
constexpr int NW = NT / 32;   // warps; warp w owns query heads w, w+8, ...
constexpr int MAXG = 4 * NW;  // at most 32 query heads per KV head
constexpr int MAX_LPS = 8;    // lanes that share one slot's dot products
constexpr int MERGE_NT = 128; // threads per pass-2 block
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

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// one 16-byte chunk of a row, as float32
__device__ __forceinline__ void chunk_f32(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void chunk_f32(const __nv_bfloat16* p, float* out) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x; out[2 * i + 1] = f.y;
  }
}

struct DecodeParams {
  const void* q; const void* k; const void* v; const int* pos;
  float* ws; void* o;
  int S, Hkv, G, dh, dv, splits, split_len;
  int64_t q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale, softcap;         // softcap <= 0: none
  int window, ring;             // window <= 0: none
};

// pass 1: one block per (split, KV head, batch row)
template <typename T, int NACC>
__global__ void __launch_bounds__(NT) decode_split_kernel(DecodeParams p) {
  constexpr int EPV = 16 / sizeof(T);      // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);      // G x dh, float32
  float* Ps = Qs + p.G * p.dh;                         // G x TN
  float* alpha_s = Ps + p.G * TN;                      // G
  float* l_s = alpha_s + p.G;                          // G
  float* m_s = l_s + p.G;                              // G
  // 2 x TN x dh, 16-byte aligned (dh is a multiple of 8)
  T* Kbuf = reinterpret_cast<T*>(alpha_s + ((3 * p.G + 3) & ~3));
  T* Vbuf = Kbuf + 2 * TN * p.dh;                          // 2 x TN x dv

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int pos = p.pos[b];

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + (int64_t)hk * p.G * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* wp = p.ws + (((int64_t)b * p.Hkv + hk) * p.splits + split) * p.G * (p.dv + 2);

  // slots past pos are invalid in every mode (a ring slot j > pos holds
  // the negative position j - W); a plain window also cuts the left.  In
  // a ring, slot pos mod W holds pos itself, so [n_begin, n_end) is empty
  // exactly when no slot is valid: then every slot is visited, all masked,
  // and the softmax comes out uniform, as in the oracles.
  int n_end = min(p.S, pos + 1), n_begin = 0;
  if (!p.ring && p.window > 0) n_begin = max(0, pos - p.window + 1);
  if (n_begin >= n_end) { n_begin = 0; n_end = p.S; }
  const int s0 = split * p.split_len;
  const int lo = max(s0, n_begin);
  const int hi = min(min(s0 + p.split_len, p.S), n_end);
  if (lo >= hi) {                          // nothing of this split is seen:
    for (int g = tid; g < p.G; g += NT) {  // m = -inf, l = 0; acc is never read
      wp[g * (p.dv + 2) + p.dv] = -INFINITY;
      wp[g * (p.dv + 2) + p.dv + 1] = 0.f;
    }
    return;
  }
  const int t0 = max(s0, (lo / TN) * TN);
  const int n_tiles = (hi - t0 + TN - 1) / TN;

  for (int idx = tid; idx < p.G * p.dh; idx += NT) {
    const int g = idx / p.dh, d = idx - g * p.dh;
    Qs[idx] = to_f32(qp[g * p.q_sh + d]);
  }

  // the tile at slot n0 into buffer `buf`; slots past the cache read zeros
  const int kc = p.dh / EPV, vc = p.dv / EPV;          // chunks per row
  auto load_tile = [&](int n0, int buf) {
    T* Kd = Kbuf + buf * TN * p.dh;
    T* Vd = Vbuf + buf * TN * p.dv;
    for (int idx = tid; idx < TN * kc; idx += NT) {
      const int j = idx / kc, c = idx - j * kc;
      const int slot = min(n0 + j, p.S - 1);
      cp_async16(Kd + j * p.dh + c * EPV, kp + slot * p.k_ss + c * EPV,
                 n0 + j < p.S ? 16 : 0);
    }
    for (int idx = tid; idx < TN * vc; idx += NT) {
      const int j = idx / vc, c = idx - j * vc;
      const int slot = min(n0 + j, p.S - 1);
      cp_async16(Vd + j * p.dv + c * EPV, vp + slot * p.v_ss + c * EPV,
                 n0 + j < p.S ? 16 : 0);
    }
    cp_async_commit();
  };

  // lanes per slot: one 16-byte chunk of the key row each, at most
  // MAX_LPS (more chunks than lanes: each lane takes every MAX_LPS-th), so
  // a warp reduces 32 / MAX_LPS or more slots' dot products at once
  int lps = 1;
  while (lps < kc && lps < MAX_LPS) lps <<= 1;
  const int spw = 32 / lps;                // slots per warp step
  const int grp = lane / lps, ld = lane % lps;

  float m[4], l[4], acc[NACC];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
#pragma unroll
  for (int a = 0; a < NACC; ++a) acc[a] = 0.f;

  load_tile(t0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t0 + t * TN;
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile(n0 + TN, buf ^ 1);         // in flight during this tile
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // tile `buf` (and Qs) visible
    const T* Ks = Kbuf + buf * TN * p.dh;
    const T* Vs = Vbuf + buf * TN * p.dv;

    // raw dot products; scale, softcap and mask come in the softmax below,
    // one slot per lane, so no branch sits in this loop
    for (int j0 = warp * spw; j0 < TN; j0 += NW * spw) {
      const int j = j0 + grp;
      const int jr = min(j, TN - 1);       // lanes past the tile compute, never write
      for (int g = 0; g < p.G; ++g) {
        float part = 0.f;
        for (int c = ld; c < kc; c += lps) {
          float kv[EPV];
          chunk_f32(Ks + jr * p.dh + c * EPV, kv);
          const float4* qr = reinterpret_cast<const float4*>(Qs + g * p.dh + c * EPV);
#pragma unroll
          for (int e = 0; e < EPV / 4; ++e) {
            const float4 qq = qr[e];
            part = fmaf(qq.x, kv[4 * e], part);
            part = fmaf(qq.y, kv[4 * e + 1], part);
            part = fmaf(qq.z, kv[4 * e + 2], part);
            part = fmaf(qq.w, kv[4 * e + 3], part);
          }
        }
        for (int off = lps >> 1; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (ld == 0 && j < TN) Ps[g * TN + j] = part;
      }
    }
    __syncthreads();

    // a masked slot scores NEG_INF, as in the oracles; padding past the
    // cache's end scores -inf and never counts
    const int slot = n0 + lane;            // TN == 32: one slot per lane
    const bool valid = slot < p.S && slot_valid(pos, slot, p.window, p.ring);
    const float pad = slot < p.S ? NEG_INF : -INFINITY;
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      const int g = warp + NW * gi;
      if (g >= p.G) break;                 // uniform across the warp
      float* row = Ps + g * TN;
      float x = row[lane] * p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      x = valid ? x : pad;
      // the tile's first slot < S is in it, so m_new is finite
      const float m_new = fmaxf(m[gi], warp_max(x));
      const float alpha = expf(m[gi] - m_new);   // 0 on the first tile
      const float e = expf(x - m_new);
      row[lane] = e;
      l[gi] = l[gi] * alpha + warp_sum(e);
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
#pragma unroll 8
        for (int j = 0; j < TN; ++j) sum = fmaf(pr[j], to_f32(Vs[j * p.dv + c]), sum);
        acc[a] = acc[a] * alpha_s[g] + sum;
      }
    }
    __syncthreads();                       // buffer `buf` free for tile t + 2
  }

#pragma unroll
  for (int gi = 0; gi < 4; ++gi) {
    const int g = warp + NW * gi;
    if (g < p.G && lane == 0) { l_s[g] = l[gi]; m_s[g] = m[gi]; }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    const int idx = tid + a * NT;
    if (idx < p.G * p.dv) {
      const int g = idx / p.dv, c = idx - g * p.dv;
      wp[g * (p.dv + 2) + c] = acc[a];
    }
  }
  for (int g = tid; g < p.G; g += NT) {
    wp[g * (p.dv + 2) + p.dv] = m_s[g];
    wp[g * (p.dv + 2) + p.dv + 1] = l_s[g];
  }
}

// pass 2: one block per (batch row, query head).  The splits' weights
// exp(m_s - M) and the list of splits of weight > 0 go to shared memory
// once; each thread then sums its output columns over those splits in
// index order, 8 splits' loads in flight
template <typename T>
__global__ void __launch_bounds__(MERGE_NT) decode_merge_kernel(DecodeParams p) {
  extern __shared__ float wts[];                       // splits weights, then den
  int* seen = reinterpret_cast<int*>(wts + p.splits + 1);  // seen splits, then their count
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / p.G, g = h - hk * p.G;
  const int64_t stride = (int64_t)p.G * (p.dv + 2);
  const float* wp = p.ws + ((int64_t)b * p.Hkv + hk) * p.splits * stride + g * (p.dv + 2);
  const int tid = threadIdx.x;
  if (tid < 32) {
    float M = -INFINITY;
    for (int s = tid; s < p.splits; s += 32) M = fmaxf(M, wp[s * stride + p.dv]);
    M = warp_max(M);
    float den = 0.f;                       // lane order, then a fixed shuffle tree
    for (int s = tid; s < p.splits; s += 32) {
      const float m = wp[s * stride + p.dv], l = wp[s * stride + p.dv + 1];
      const float w = l > 0.f ? expf(m - M) : 0.f;   // an unseen split weighs 0
      wts[s] = w;
      den = fmaf(w, l, den);
    }
    den = warp_sum(den);
    if (tid == 0) wts[p.splits] = den;
    // the splits of weight > 0, in split order: the others add nothing,
    // and an unseen split's acc was never written
    int n = 0;
    for (int s0 = 0; s0 < p.splits; s0 += 32) {
      const int s = s0 + tid;
      const bool w = s < p.splits && wts[s] != 0.f;   // this lane wrote wts[s]
      const unsigned mask = __ballot_sync(0xffffffffu, w);
      if (w) seen[n + __popc(mask & ((1u << tid) - 1u))] = s;
      n += __popc(mask);
    }
    if (tid == 0) seen[p.splits] = n;
  }
  __syncthreads();
  const int n_seen = seen[p.splits];
  const float inv = wts[p.splits] > 0.f ? 1.f / wts[p.splits] : 0.f;
  T* op = static_cast<T*>(p.o) + b * p.o_sb + (int64_t)h * p.o_sh;
  for (int c = tid; c < p.dv; c += MERGE_NT) {
    float num = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_seen; ++i) {
      const int s = seen[i];
      num = fmaf(wts[s], wp[s * stride + c], num);
    }
    op[c] = from_f32<T>(num * inv);
  }
}

template <typename T, int NACC>
cudaError_t launch(const DecodeParams& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(p.G * p.dh + p.G * TN + ((3 * p.G + 3) & ~3))
                      + sizeof(T) * (size_t)(2 * TN * (p.dh + p.dv));
  cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<T, NACC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  decode_split_kernel<T, NACC><<<dim3(p.splits, p.Hkv, B), NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<dim3(p.Hkv * p.G, B), MERGE_NT,
                           (sizeof(float) + sizeof(int)) * (p.splits + 1), stream>>>(p);
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
// pointer to B int32 positions; ws a float32 workspace of
// B * Hkv * splits * G * (dv + 2) values.  Returns the CUDA error of the
// launches.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* pos, void* ws, void* o,
                         int B, int S, int Hq, int Hkv, int dh, int dv,
                         int splits, int split_len,
                         int64_t q_sb, int64_t q_sh,
                         int64_t k_sb, int64_t k_ss, int64_t k_sh,
                         int64_t v_sb, int64_t v_ss, int64_t v_sh,
                         int64_t o_sb, int64_t o_sh,
                         float scale, float softcap, int window, int dtype,
                         void* stream) {
  if (dh < 8 || dh > 256 || dv < 8 || dv > 256 || dh % 8 || dv % 8 || Hkv < 1 ||
      Hq % Hkv != 0 || S < 1 || splits < 1 || split_len % TN ||
      (int64_t)splits * split_len < S || (int64_t)(splits - 1) * split_len >= S)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  if (G > MAXG || G * dv > 16 * NT) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int ring = window > 0 && S == window;
  DecodeParams p{q, k, v, static_cast<const int*>(pos), static_cast<float*>(ws), o,
                 S, Hkv, G, dh, dv, splits, split_len,
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
