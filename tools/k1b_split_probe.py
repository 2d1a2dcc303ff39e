#!/usr/bin/env python3
"""How exactly a float32 operand split into bf16 terms multiplies on the
tensor cores, on one GPU.

  python3 tools/k1b_split_probe.py

K1b's bf16 body (``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``)
takes the products P^T dO, dS^T Q and dS K with P and dS in float32: it
splits each float32 value x into bf16 terms hi = bf16(x), mid = bf16(x -
hi), lo = bf16(x - hi - mid), whose sum is x exactly, and issues one
register-A ``wgmma`` per term into one float32 accumulator.  The products
of bf16 terms are exact in float32; what the tensor cores' accumulation
does with them is what this probe measures.

It builds a small kernel into the ignored ``build/probe/``: one
warpgroup computes D = A B with A (64 x K) float32 and B (K x 64) bf16,
B an MN-major shared-memory operand with the 128-byte swizzle (the form
K1b uses for dO, Q and K), in k-steps of 16, with 1, 2 or 3 terms of A.
A second kernel computes the same D as a chain of float32 FMAs (K1b's
float32 body's arithmetic).  Both are held against a float64 product on
the card, for A shaped like P (in [0, 1]), like dS (signed, small) and A
already bf16 (the S = Q K^T and dP = dO V^T products, where the operands
are the bf16 inputs), at K = 64 (one tile) and K = 1024 (a 1024-row
walk).  It prints each error beside the float32 tolerance K1b's gates
use (2e-5 absolute and relative).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5

SOURCE = r'''
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;
  return d;
}
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
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// D (64 x 64) = A (64 x K, float32, row-major) B (K x 64, bf16, row-major)
extern "C" __global__ void __launch_bounds__(128) split_kernel(
    const float* A, const __nv_bfloat16* Bm, float* D, int K, int terms) {
  __shared__ __align__(1024) unsigned char sB[64 * 128];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(sB);
  float d[32];
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 64) {
    __syncthreads();
    // B rows k0 .. k0 + 63 as 64 rows of 128 bytes, 16-byte chunks swizzled
    for (int idx = tid; idx < 64 * 64; idx += 128) {
      const int kr = idx >> 6, n = idx & 63;
      const int off = kr * 128 + ((((n * 2) >> 4) ^ (kr & 7)) << 4) + (n * 2 & 15);
      *reinterpret_cast<__nv_bfloat16*>(sB + off) = Bm[(k0 + kr) * 64 + n];
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    uint32_t fr[3][4][4];
    for (int j = 0; j < 4; ++j)
      for (int r = 0; r < 4; ++r) {
        const int row = r0 + 8 * (r & 1), col = k0 + 16 * j + 8 * (r >> 1) + cq;
        const float x0 = A[row * K + col], x1 = A[row * K + col + 1];
        const uint32_t h = pack(x0, x1);
        const float y0 = x0 - lo_f(h), y1 = x1 - hi_f(h);
        const uint32_t m = pack(y0, y1);
        fr[0][j][r] = h;
        fr[1][j][r] = m;
        fr[2][j][r] = pack(y0 - lo_f(m), y1 - hi_f(m));
      }
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int j = 0; j < 4; ++j)
      for (int t = 0; t < terms; ++t)
        wgmma_rs(d, fr[t][j], desc(base + j * 16 * 128, 64 * 128, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
  }
  for (int i = 0; i < 32; ++i) {
    const int row = r0 + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + cq + (i & 1);
    D[row * 64 + col] = d[i];
  }
}

// the same D as one float32 FMA chain per element, k in order
extern "C" __global__ void chain_kernel(const float* A, const __nv_bfloat16* Bm, float* D, int K) {
  const int row = blockIdx.x, col = threadIdx.x;
  float acc = 0.f;
  for (int k = 0; k < K; ++k) acc = fmaf(A[row * K + k], __bfloat162float(Bm[k * 64 + col]), acc);
  D[row * 64 + col] = acc;
}

extern "C" int run_split(const float* A, const void* Bm, float* D, int K, int terms) {
  split_kernel<<<1, 128>>>(A, static_cast<const __nv_bfloat16*>(Bm), D, K, terms);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
extern "C" int run_chain(const float* A, const void* Bm, float* D, int K) {
  chain_kernel<<<64, 64>>>(A, static_cast<const __nv_bfloat16*>(Bm), D, K);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
'''


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1b_split_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops
    out_dir = ROOT / "build" / "probe" / "k1b_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "split_probe.cu"
    cu.write_text(SOURCE)
    so = out_dir / "split_probe.so"
    res = subprocess.run([ops._nvcc(), *ops.NVCC_FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    print(res.stdout + res.stderr)
    if res.returncode:
        return 1
    lib = ctypes.CDLL(str(so))
    P = ctypes.c_void_p
    lib.run_split.argtypes = [P, P, P, ctypes.c_int, ctypes.c_int]
    lib.run_chain.argtypes = [P, P, P, ctypes.c_int]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for K in (64, 1024):
        b = torch.randn((K, 64), generator=gen, device="cuda").bfloat16()
        z = torch.randn((64, K), generator=gen, device="cuda")
        dists = {
            # softmax weights: exp of a shifted normal, many small values
            "P in [0, 1]": torch.exp(-3.0 * z.abs()),
            # p (dp - D): signed, mostly small
            "dS signed": torch.exp(-3.0 * z.abs()) * 0.1 * torch.randn(
                (64, K), generator=gen, device="cuda"),
            # the bf16 inputs themselves (S and dP)
            "A bf16": z.bfloat16().float(),
        }
        for name, a in dists.items():
            a = a.contiguous()
            want = a.double() @ b.double()
            cond = a.double().abs() @ b.double().abs()    # sum |a_k b_k|
            rows = {}
            for terms in (1, 2, 3):
                d = torch.empty((64, 64), device="cuda")
                err = lib.run_split(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                                    K, terms)
                if err:
                    print(f"split kernel failed: error {err}")
                    return 1
                rows[f"wgmma, {terms} term{'s' * (terms > 1)}"] = d
            d = torch.empty((64, 64), device="cuda")
            if lib.run_chain(a.data_ptr(), b.data_ptr(), d.data_ptr(), K):
                print("chain kernel failed")
                return 1
            rows["float32 FMA chain"] = d
            for label, d in rows.items():
                e = (d.double() - want).abs()
                rel = float((e / cond.clamp_min(1e-300)).max())
                over = float((e - TOL - TOL * want.abs()).max())
                print(f"K {K:5d} {name:12s} {label:20s}: max abs err "
                      f"{float(e.max()):.3e} (max |D| {float(want.abs().max()):.3e}), "
                      f"max err / sum|a b| {rel:.3e}, largest excess over "
                      f"{TOL} + {TOL} |D| {over:.3e}")
                worst[label] = max(worst.get(label, -1.0), over)
    for label, over in worst.items():
        print(f"{label}: largest excess over the float32 tolerance "
              f"{over:.3e} ({'within' if over <= 0 else 'OUTSIDE'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
