#!/usr/bin/env python3
"""Where K1's bf16 body spends its time, phase by phase, on one GPU.

  python3 tools/k1_phase_probe.py

Builds an instrumented copy of ``src/repro_torch/kernels/csrc/
flash_attention.cu`` into the ignored ``build/probe/``: thread 0 of every
block sums ``clock64()`` deltas over the phases of each steady-state key
tile (wait for K and issue S, wait for V and issue P V, wait for S, the
softmax, wait for P V, pack P + rescale O + the block barrier) and over
the block's start (until Q is in) and its whole life.  It runs the
prefill shapes of ``chip_smoke.py``'s long rows and prints cycles per
tile and per block, the blocks each SM holds, and the kernel's device
time beside the uninstrumented library's.  The probe finds its
insertion points by the source's own lines and fails if they moved.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("wait K + issue S", "wait V + issue P V", "wait for S", "softmax",
          "wait for P V", "pack P, rescale O, barrier")
# (B, S, Hq, Hkv, dh, window): chip_smoke.py's long K1 rows
SHAPES = ((1, 4096, 14, 2, 64, None), (1, 2048, 10, 1, 256, 2048))


def instrument(src: str) -> str:
    """The source with phase counters in flash_wgmma_kernel's main loop."""
    def once(text, old, new):
        if text.count(old) != 1:
            raise SystemExit(f"probe: the source no longer has one {old!r}")
        return text.replace(old, new)
    src = once(src, "namespace {\n",
               "__device__ unsigned long long g_probe[16];\nnamespace {\n")
    src = once(src, "  mbar_wait(bar_q, 0);\n",
               "  mbar_wait(bar_q, 0);\n  PROBE_START\n")
    loop = "  for (int it = 0; it + 1 < n_tiles; ++it) {\n"
    head, body = src.split(loop)
    lines = body.split("\n")
    marks = ["qk(it + 1);", "pv(it);", "fence_regs(s);",
             "softmax(n_begin + (it + 1) * KN, a0, a1);", "fence_regs(o);",
             "__syncthreads();"]
    out, k = ["    long long t_ = clock64(), u_;"], 0
    for line in lines:
        out.append(line)
        if k < len(marks) and line.strip().startswith(marks[k]):
            extra = "fence_regs(s); " if k == 3 else ""
            out.append(f"    {extra}u_ = clock64(); acc_[{k + 1}] += u_ - t_; "
                       f"t_ = u_;")
            k += 1
    if k != len(marks):
        raise SystemExit(f"probe: main loop lines moved (found {k} marks)")
    src = head + loop + "\n".join(out)
    src = once(src, "  const int r0 = warp * 16 + (lane >> 2);",
               "  long long start_ = clock64();\n"
               "  unsigned long long acc_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
               "#define PROBE_START acc_[0] = clock64() - start_;\n"
               "  const int r0 = warp * 16 + (lane >> 2);")
    src = once(src, "  const __nv_bfloat16* vp =",
               "  acc_[7] = clock64() - start_;\n"
               "  if (tid == 0) {\n"
               "    for (int i = 0; i < 8; ++i) atomicAdd(&g_probe[i], acc_[i]);\n"
               "    atomicAdd(&g_probe[8], (unsigned long long)n_tiles);\n"
               "    atomicAdd(&g_probe[9], 1ull);\n"
               "  }\n"
               "  const __nv_bfloat16* vp =")
    return src + '''
extern "C" int probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}
extern "C" int probe_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));
}
extern "C" int probe_blocks_per_sm(int dh, int dv) {
  int n = -1;
  with_bf16_tile(dh, dv, [&](auto t) {
    using T = decltype(t);
    auto kernel = flash_wgmma_kernel<T::DHT, T::DVT, T::KN, T::MINB>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, WG_NT, T::SMEM);
  });
  return n;
}
'''


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_phase_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention as fm
    from repro_torch.kernels import ops
    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "flash_attention_probe.cu"
    cu.write_text(instrument((ops.CSRC / fm.SOURCE).read_text()))
    subprocess.run([ops._nvcc(), *ops.NVCC_FLAGS, f"-I{ops.CSRC}", "-o",
                    str(out_dir / "probe.so"), str(cu)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out_dir / "probe.so"))
    fm.bind(lib)
    lib.probe_read.argtypes = [ctypes.c_void_p]
    ops.LIBRARY.load()
    print(torch.cuda.get_device_name(0))
    for dh, dv in ((64, 64), (128, 128), (192, 128), (256, 256)):
        print(f"tile up to dh {dh}, dv {dv}: {lib.probe_blocks_per_sm(dh, dv)} "
              f"blocks per SM")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def device_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    for B, S, Hq, Hkv, dh, window in SHAPES:
        q, k, v = (torch.randn((B, S, h, dh), generator=gen, device="cuda")
                   .bfloat16() for h in (Hq, Hkv, Hkv))
        kw = dict(causal=True, window=window, softcap=None, scale=None,
                  q_offset=0)
        probed = device_ms(lambda: fm.launch(lib, q, k, v, **kw))
        plain = device_ms(lambda: ops.flash_attention(q, k, v, window=window))
        lib.probe_reset()
        fm.launch(lib, q, k, v, **kw)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        lib.probe_read(ctypes.addressof(buf))
        tiles, blocks = buf[8], buf[9]
        steady = max(1, tiles - blocks)
        print(f"B {B} S {S} {Hq}/{Hkv} dh {dh}: {blocks} blocks, {tiles} key "
              f"tiles; device ms {plain:.4f} (instrumented {probed:.4f})")
        print(f"  block start until Q is in: {buf[0] / blocks:9.1f} cycles")
        for i, name in enumerate(PHASES, start=1):
            print(f"  {name:28s} {buf[i] / steady:9.1f} cycles per tile")
        print(f"  whole block: {buf[7] / blocks:11.1f} cycles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
