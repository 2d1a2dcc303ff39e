#!/usr/bin/env python3
"""K3's device time beside an earlier build of the same kernel, on one GPU.

  python3 tools/k3_compare.py --old path/to/earlier/rglru_scan.cu

Builds the earlier source with nvcc into a temporary directory outside
the repository (removed afterwards) and the current kernels as
``chip_smoke.py`` does.  The earlier source must export the
one-thread-per-channel kernel's C interface,
``rglru_scan_fwd(a, b, h0, y, hT, B, S, r, a_sb, a_ss, b_sb, b_ss, h0_sb,
y_sb, y_ss, hT_sb, stream)``.  At K3's rows of ``chip_smoke.py``'s
``times`` phase it checks that both builds give the plain version's bits,
then times them on the device alone in turns (earlier, current, current,
earlier) and prints each one's mean device ms, its share of the byte
bound and its GB/s.  A last row times the current kernel at B 1, S 4096,
r 512, whose 25 MB of inputs and output stay in the 50 MB L2 cache
between launches: there the walk, not device memory, sets the pace, so
it bounds from below what the serial chain costs at S 4096.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (label, B, S, r): chip_smoke.py's K3 rows
SHAPES = (("main", 4, 128, 2560), ("long", 1, 4096, 2560),
          ("long_b4", 4, 2048, 2560), ("gate", 1, 2100, 2560))
WALK = ("walk (L2-resident)", 1, 4096, 512)


def build_old(src: Path, out_dir: Path) -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops
    lib_path = out_dir / "rglru_scan_old.so"
    subprocess.run([ops._nvcc(), *ops.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.rglru_scan_fwd.argtypes = [P] * 5 + [I] * 3 + [L] * 8 + [P]
    lib.rglru_scan_fwd.restype = I
    return lib


def run_old(torch, lib, a, b):
    B, S, r = a.shape
    y = torch.empty((B, S, r), dtype=torch.float32, device=a.device)
    hT = torch.empty((B, r), dtype=torch.float32, device=a.device)
    err = lib.rglru_scan_fwd(
        a.data_ptr(), b.data_ptr(), None, y.data_ptr(), hT.data_ptr(), B, S,
        r, a.stride(0), a.stride(1), b.stride(0), b.stride(1), 0,
        y.stride(0), y.stride(1), hT.stride(0),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the earlier kernel failed to launch ({err})")
    return y, hT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=Path,
                    help="an earlier rglru_scan.cu with the interface above")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k3_compare: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import ops, ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    tmp = Path(tempfile.mkdtemp(prefix="k3-old-"))
    try:
        old = build_old(args.old, tmp)
        ops.LIBRARY.load()
        gen = torch.Generator(device="cuda").manual_seed(7)
        for label, B, S, r in SHAPES:
            a = torch.sigmoid(cs._rand(torch, gen, (B, S, r), torch.float32))
            b = cs._rand(torch, gen, (B, S, r), torch.float32)
            want = ref.rglru_scan_ref(a, b)
            for tag, got in (("earlier", run_old(torch, old, a, b)),
                             ("current", ops.rglru_scan(a, b))):
                torch.cuda.synchronize()
                cs.check(all(torch.equal(g, w) for g, w in zip(got, want)),
                         f"{tag} kernel is not bit for bit at {label}")
            nbytes = 4 * (3 * B * S * r + B * r)
            bound = nbytes / cs.PEAK_BYTES * 1e3
            t = {"earlier": [], "current": []}
            for tag in ("earlier", "current", "current", "earlier"):
                fn = ((lambda: run_old(torch, old, a, b)) if tag == "earlier"
                      else (lambda: ops.rglru_scan(a, b)))
                t[tag].append(cs.device_ms(torch, fn))
            line = []
            for tag, ms in t.items():
                m = sum(ms) / len(ms)
                line.append(f"{tag} {m:.4f} ms (turns {ms[0]:.4f}, "
                            f"{ms[1]:.4f}; {bound / m:.1%} of bound, "
                            f"{nbytes / m / 1e6:.1f} GB/s)")
            print(f"k3 [{label}] B={B} S={S} r={r}: bound {bound:.5f} ms "
                  f"(bytes); " + "; ".join(line), flush=True)
        label, B, S, r = WALK
        a = torch.sigmoid(cs._rand(torch, gen, (B, S, r), torch.float32))
        b = cs._rand(torch, gen, (B, S, r), torch.float32)
        ms = cs.device_ms(torch, lambda: ops.rglru_scan(a, b), iters=50)
        print(f"k3 [{label}] B={B} S={S} r={r}: current {ms:.4f} ms, "
              f"{ms * 1e6 / S:.2f} ns per step", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
