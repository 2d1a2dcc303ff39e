#!/usr/bin/env python3
"""Where K3 spends its time, per ring stage, on one GPU.

  python3 tools/k3_phase_probe.py

Builds instrumented copies of ``src/repro_torch/kernels/csrc/
rglru_scan.cu`` into the ignored ``build/probe/``.  In the ``phases``
copy, lane 0 of every block sums ``clock64()`` deltas over each box of
the walk: waiting for the box's TMA copies, walking its steps, and the
block barrier, the y box's store and the refill.  More copies are only
timed (``TIMED``): ``walk`` waits for the ring's first fill and then
walks the same stages again without refilling them (the walk alone, from
shared memory; its output is not the scan's), ``no_store`` does not
store the y boxes to device memory (the walk and the loads without y's
bytes), ``no_lds`` walks each box's first 8 steps' a and b over again
from registers (the chain and the y writes without shared-memory loads),
and the others change the unroll depth, the stage size, the ring's
shared memory per SM, the L2 promotion of the TMA loads, or walk a box
as a loop instead of unrolling it whole.  It prints cycles per box and
per step for each shape, the device ms of every copy beside the
uninstrumented kernel's, the kernel's device ms with each tile width
alone, and a count of the instructions of the kernel's machine code
(``cuobjdump -sass``).  The probe finds its insertion points by the
source's own lines and fails if they moved.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("wait for the box", "walk the box", "barriers, y store, refill")
# (B, S, r): chip_smoke.py's K3 rows, r 512 (inputs L2-resident) and
# r 2112 (132 blocks of 16 channels: one on every SM)
SHAPES = ((1, 4096, 2560), (1, 4096, 512), (1, 4096, 2112), (4, 2048, 2560),
          (4, 128, 2560))
WAIT = "    mbar_wait(bars + 8 * s, phase);\n"
BARRIER = "    fence_proxy_async();          // this lane's y, before TMA reads it\n"
REFILL = "      if (j + p.stages < n_boxes) issue(s, j + p.stages);\n"
LOOP_END = "    if (++yb == Y_BUFFERS) yb = 0;\n  }\n"
STORE = ("      tma_store_3d(&ty, ybuf_u32 + yb * Y_BOX_BYTES, c0, t0, row);\n")
STAGE = "constexpr int STAGE_BYTES = 8192;"
UNROLL = "constexpr int UNROLL = 8;"
L2 = "CU_TENSOR_MAP_L2_PROMOTION_L2_128B"
BOX_LOOP = "#pragma unroll\n      for (int u0 = 0; u0 < T; u0 += UNROLL) {\n"
# copies that are only timed: name -> (source changes, host-module
# constants the plan reads for that copy)
TIMED = {
    "walk": ([(WAIT, "    if (j < p.stages) " + WAIT.lstrip()), (REFILL, "")], {}),
    "no_store": ([(STORE, "")], {}),
    "no_lds": ([("          an[u] = t < T ? as[t * C] : 0.f;\n"
                 "          bn[u] = t < T ? bs[t * C] : 0.f;\n",
                 "          an[u] = av[u];\n          bn[u] = bv[u];\n")], {}),
    "unroll4": ([(UNROLL, "constexpr int UNROLL = 4;")], {}),
    "unroll16": ([(UNROLL, "constexpr int UNROLL = 16;")], {}),
    "ring160k": ([], {"RING_BYTES_PER_SM": 160 * 1024}),
    "l2_none": ([(L2, "CU_TENSOR_MAP_L2_PROMOTION_NONE")], {}),
    "l2_256": ([(L2, "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")], {}),
    "box_loop": ([(BOX_LOOP, "#pragma unroll 1\n" + BOX_LOOP.split("\n", 1)[1])],
                 {}),
    "stage16k": ([(STAGE, "constexpr int STAGE_BYTES = 16384;")],
                 {"STAGE_BYTES": 16384}),
}


def _once(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f"probe: the source no longer has one {old!r}")
    return text.replace(old, new)


def instrument(src: str, variant: str) -> str:
    if variant in TIMED:
        for old, new in TIMED[variant][0]:
            src = _once(src, old, new)
        return src
    src = _once(src, "namespace {\n",
                "__device__ unsigned long long g_probe[8];\nnamespace {\n")
    src = _once(src, "  const int n_boxes = (p.S + T - 1) / T;\n",
                "  const int n_boxes = (p.S + T - 1) / T;\n"
                "  long long start_ = clock64(), t_, u_;\n"
                "  unsigned long long acc_[4] = {0, 0, 0, 0};\n")
    src = _once(src, WAIT, "    t_ = clock64();\n" + WAIT
                + "    u_ = clock64(); acc_[0] += u_ - t_; t_ = u_;\n")
    src = _once(src, BARRIER,
                "    u_ = clock64(); acc_[1] += u_ - t_; t_ = u_;\n" + BARRIER)
    src = _once(src, LOOP_END, LOOP_END.replace(
        "  }\n", "    acc_[2] += clock64() - t_;\n  }\n"))
    return _once(
        src, "  if (live) p.hT[row * p.hT_sb + c] = h;\n",
        "  acc_[3] = clock64() - start_;\n"
        "  if (lane == 0) {\n"
        "    for (int i = 0; i < 4; ++i) atomicAdd(&g_probe[i], acc_[i]);\n"
        "    atomicAdd(&g_probe[4], (unsigned long long)n_boxes);\n"
        "    atomicAdd(&g_probe[5], 1ull);\n"
        "  }\n"
        "  if (live) p.hT[row * p.hT_sb + c] = h;\n") + '''
extern "C" int probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}
extern "C" int probe_reset() {
  unsigned long long z[8] = {0};
  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));
}
'''


def sass_counts(so: Path) -> dict:
    """Instruction counts of each rglru_scan_kernel instantiation."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "rglru_scan_kernel" in m.group(1) else None
            if name:
                out[name] = {}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.\S+)?", line)
        if name and m:
            op = m.group(1)
            out[name][op] = out[name].get(op, 0) + 1
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k3_phase_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as km
    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (ops.CSRC / km.SOURCE).read_text()
    libs, procs = {}, {}
    for variant in ("phases", *TIMED):
        cu = out_dir / f"rglru_scan_{variant}.cu"
        cu.write_text(instrument(src, variant))
        procs[variant] = subprocess.Popen(
            [ops._nvcc(), *ops.NVCC_FLAGS, "-o",
             str(out_dir / f"k3_{variant}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for variant, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"probe: nvcc failed for {variant}:\n{log}")
        libs[variant] = ctypes.CDLL(str(out_dir / f"k3_{variant}.so"))
        km.bind(libs[variant])
    libs["phases"].probe_read.argtypes = [ctypes.c_void_p]
    ops.LIBRARY.load()
    for name, counts in sass_counts(
            ops.LIBRARY.build_dir / "rglru_scan.so").items():
        keys = ("LDS", "LD", "STG", "ST", "FMUL", "FADD", "FFMA", "BAR",
                "SYNCS", "UTMALDG")
        print(f"sass {name[:60]}: " + ", ".join(
            f"{k} {counts.get(k, 0)}" for k in keys)
            + f", all {sum(counts.values())}")
    print(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for B, S, r in SHAPES:
        a = torch.sigmoid(cs._rand(torch, gen, (B, S, r), torch.float32))
        b = cs._rand(torch, gen, (B, S, r), torch.float32)
        plan = km.plan_scan(B, S, r, n_sm)
        times = {"kernel": cs.device_ms(torch, lambda: ops.rglru_scan(a, b))}
        for variant, lib in libs.items():
            consts = TIMED.get(variant, ([], {}))[1]
            saved = {k: getattr(km, k) for k in consts}
            for k, v in consts.items():
                setattr(km, k, v)
            try:
                times[variant] = cs.device_ms(
                    torch, lambda: km.launch(lib, a, b))
            finally:
                for k, v in saved.items():
                    setattr(km, k, v)
        lib = libs["phases"]
        lib.probe_reset()
        km.launch(lib, a, b)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 8)()
        lib.probe_read(ctypes.addressof(buf))
        boxes, blocks = buf[4], buf[5]
        print(f"B {B} S {S} r {r}: {blocks} blocks of {plan.channels} "
              f"channels, {plan.stages} stages of {plan.steps} steps; device "
              f"ms " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
        for i, name in enumerate(PHASES):
            print(f"  {name:18s} {buf[i] / boxes:9.1f} cycles per box, "
                  f"{buf[i] / boxes / plan.steps:7.2f} per step")
        print(f"  whole block: {buf[3] / blocks:11.1f} cycles, "
              f"{buf[3] / blocks / S:7.2f} per step")
        for tiles in ((32,), (16,)):            # each tile width alone
            saved, km.TILE_CHANNELS = km.TILE_CHANNELS, tiles
            try:
                p = km.plan_scan(B, S, r, n_sm)
                ms = cs.device_ms(torch, lambda: ops.rglru_scan(a, b))
            finally:
                km.TILE_CHANNELS = saved
            print(f"  with {tiles[0]} channels a block: {p.blocks} blocks, "
                  f"{p.stages} stages: {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
