"""Dispatch, build and launch counters for the port's CUDA kernels.

Each kernel op routes by where its tensors lie:

* CPU tensors go to the plain PyTorch version in ``kernels/ref.py``;
* CUDA tensors go to the hand-written kernel, or the call raises — there
  is no fallback from a CUDA tensor to the plain version;
* tensors split across devices, or on any other device, raise.

``force_reference()`` sends CUDA tensors to the plain versions too; it
exists for the card-side parity runs (``chip_smoke.py``) only.

Each op counts its kernel launches in a plain ``launches`` int, bumped
where the kernel launches and nowhere else, so a run can show that the
main path went through the kernels.

The kernels are built at first use: one ``nvcc`` per source in
``csrc/``, all started together, each into a shared library with a
plain C interface loaded through ``ctypes``.  Libraries go to
``build/kernels/<hash of sources and flags>/`` at the repository root
(listed in ``.gitignore``), so a changed source builds anew and an
unchanged one loads from there.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels import decode_attention as _decode_mod
from repro_torch.kernels import flash_attention as _flash_mod
from repro_torch.kernels import ref

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# library name -> host module that declares and launches its entry point
MODULES = {"flash_attention": _flash_mod, "decode_attention": _decode_mod}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or CUDA_HOME)")


def sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for mod in MODULES.values():
        h.update(mod.SOURCE.encode())
        h.update((CSRC / mod.SOURCE).read_bytes())
    return h.hexdigest()[:16]


class KernelLibrary:
    """Builds (or finds) and loads every kernel library, once per process."""

    def __init__(self, build_root: Path = BUILD_ROOT):
        self.build_root = Path(build_root)
        self._lock = threading.Lock()
        self._libs: Optional[Dict[str, ctypes.CDLL]] = None
        self.build_dir: Optional[Path] = None
        self.built: list = []        # libraries nvcc compiled in this process
        self.build_log = ""

    def load(self) -> Dict[str, ctypes.CDLL]:
        with self._lock:
            if self._libs is None:
                # the build lock is taken for the one nvcc run per process;
                # holding it while nvcc runs is what makes concurrent first
                # calls wait for a single build instead of racing
                self._libs = self._build()  # fabriclint: allow[blocking]
            return self._libs

    def get(self, name: str) -> ctypes.CDLL:
        return self.load()[name]

    def _build(self) -> Dict[str, ctypes.CDLL]:
        out_dir = self.build_root / sources_hash()
        paths = {n: out_dir / f"{n}.so" for n in MODULES}
        missing = [n for n in MODULES if not paths[n].exists()]
        if missing:
            out_dir.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for n in missing:            # one nvcc per source, all at once
                tmp = out_dir / f"{n}.{os.getpid()}.tmp.so"
                log = open(out_dir / f"{n}.{os.getpid()}.log", "w")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / MODULES[n].SOURCE)]
                procs[n] = (subprocess.Popen(cmd, stdout=log,
                                             stderr=subprocess.STDOUT),
                            tmp, log)
            failed, logs = [], []
            for n, (proc, tmp, log) in procs.items():
                proc.wait()
                log.close()
                logs.append(f"== {n}\n" + Path(log.name).read_text())
                if proc.returncode:
                    failed.append(n)
                else:
                    os.replace(tmp, paths[n])
            self.build_log = "\n".join(logs)
            if failed:
                raise RuntimeError(f"nvcc failed for {failed}:\n"
                                   f"{self.build_log}")
            self.built = missing
        libs = {}
        for n, mod in MODULES.items():
            lib = ctypes.CDLL(str(paths[n]))
            mod.bind(lib)
            libs[n] = lib
        self.build_dir = out_dir
        return libs


LIBRARY = KernelLibrary()

# -- the parity switch -------------------------------------------------------
_force_lock = threading.Lock()
_force_depth = 0


@contextlib.contextmanager
def force_reference():
    """Send CUDA tensors to the plain versions inside this block.  A
    process-wide switch (the engine runs endpoints on worker threads);
    for the card-side parity runs only."""
    global _force_depth
    with _force_lock:
        _force_depth += 1
    try:
        yield
    finally:
        with _force_lock:
            _force_depth -= 1


def reference_forced() -> bool:
    return _force_depth > 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for all-CUDA inputs, False for all-CPU; raise otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on {sorted(kinds)}: the kernels take CUDA "
                     f"tensors and the plain versions CPU tensors")


class KernelOp:
    """One kernel: dispatch plus its launch count."""

    def __init__(self, name: str, library: KernelLibrary):
        self.name = name
        self.library = library
        self.launches = 0
        self._count_lock = threading.Lock()

    def _counted(self):
        with self._count_lock:
            self.launches += 1


class FlashAttentionOp(KernelOp):
    def __call__(self, q, k, v, *, causal: bool = True,
                 window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 scale: Optional[float] = None,
                 q_offset: int = 0) -> torch.Tensor:
        if not _on_cuda(q, k, v) or reference_forced():
            return ref.flash_attention_ref(
                q, k, v, causal=causal, window=window, softcap=softcap,
                scale=scale, q_offset=q_offset)
        out = _flash_mod.launch(
            self.library.get(self.name), q, k, v, causal=causal,
            window=window, softcap=softcap, scale=scale, q_offset=q_offset)
        self._counted()
        return out


class DecodeAttentionOp(KernelOp):
    def __call__(self, q, k_cache, v_cache, pos, *,
                 window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
        if not _on_cuda(q, k_cache, v_cache, pos) or reference_forced():
            return ref.decode_attention_ref(
                q, k_cache, v_cache, pos, window=window, softcap=softcap,
                scale=scale)
        out = _decode_mod.launch(
            self.library.get(self.name), q, k_cache, v_cache, pos,
            window=window, softcap=softcap, scale=scale)
        self._counted()
        return out


flash_attention = FlashAttentionOp("flash_attention", LIBRARY)
decode_attention = DecodeAttentionOp("decode_attention", LIBRARY)
KERNELS = (flash_attention, decode_attention)


def reset_launches() -> None:
    for op in KERNELS:
        with op._count_lock:
            op.launches = 0
