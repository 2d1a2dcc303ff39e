"""Dispatch, build and launch counters for the port's CUDA kernels.

Each kernel op routes by where its tensors lie:

* CPU tensors go to the plain PyTorch version in ``kernels/ref.py``;
* CUDA tensors go to the hand-written kernel, or the call raises — there
  is no fallback from a CUDA tensor to the plain version;
* tensors split across devices, or on any other device, raise.

``force_reference()`` sends CUDA tensors to the plain versions too; it
exists for the card-side parity runs (``chip_smoke.py``) only.

Gradients: attention is differentiable through ``FlashAttentionFunction``,
a ``torch.autograd.Function`` whose forward is K1 (with its row
log-sum-exp) and whose backward is K1b, or the plain versions of both for
CPU tensors and under ``force_reference()``.  It is taken only when grad
mode is on and an input requires grad; otherwise the call is the single
K1 launch serving makes.  K2 and K3 have no backward kernel yet: on CUDA
tensors that require grad they raise rather than hand back a tensor cut
from the graph.

Each op counts its kernel launches in a plain ``launches`` int, bumped
where the kernel launches and nowhere else, so a run can show that the
main path went through the kernels.

The kernels are built at first use: one ``nvcc`` per source in
``csrc/``, all started together, each into a shared library with a
plain C interface loaded through ``ctypes``.  Libraries go to
``build/kernels/<hash of csrc/ and flags>/`` at the repository root
(listed in ``.gitignore``), so a changed source or shared header
(``csrc/hopper.cuh``) builds anew and an unchanged tree loads from
there.
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
from repro_torch.kernels import flash_attention_bwd as _flash_bwd_mod
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rglru_mod

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# library name -> host module that declares and launches its entry point
MODULES = {"flash_attention": _flash_mod,
           "flash_attention_bwd": _flash_bwd_mod,
           "decode_attention": _decode_mod, "rglru_scan": _rglru_mod}
# where a kernel without a backward names the work that adds it
K3_BACKWARD_ITEM = "ROADMAP.md module item 6c (K3's backward)"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or CUDA_HOME)")


def sources_hash() -> str:
    """Every file in ``csrc/`` (the sources and the headers they share),
    by name and content, and the flags: an edited header builds anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.iterdir() if p.is_file()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
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
                    os.replace(log.name, out_dir / f"{n}.log")
                    os.replace(tmp, paths[n])
            if failed:
                raise RuntimeError(f"nvcc failed for {failed}:\n"
                                   + "\n".join(logs))
            self.built = missing
        # each library's nvcc output (ptxas registers and spills) is kept
        # beside it, so a process that finds the build has its log too
        self.build_log = "\n".join(
            f"== {n}\n" + (out_dir / f"{n}.log").read_text()
            for n in MODULES if (out_dir / f"{n}.log").exists())
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


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the reference's flash VJP: the forward saves q, k,
    v, the output and the float32 row log-sum-exp; the backward recomputes
    the probabilities from them (``layers._flash_bwd_rule``).  Which side
    runs (kernels, or plain versions for CPU tensors and under
    ``force_reference()``) is decided once, in the forward, and the
    backward follows it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset):
        kw = dict(causal=causal, window=window, softcap=softcap,
                  scale=scale, q_offset=q_offset)
        ctx.kw = kw
        ctx.reference = not _on_cuda(q, k, v) or reference_forced()
        if ctx.reference:
            out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        else:
            out, lse = flash_attention.launch_kernel(q, k, v, return_lse=True,
                                                     **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.reference:
            grads = ref.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                **ctx.kw)
        else:
            grads = flash_attention_bwd(q, k, v, out, lse, do, **ctx.kw)
        return (*grads, None, None, None, None, None)


class FlashAttentionOp(KernelOp):
    def __call__(self, q, k, v, *, causal: bool = True,
                 window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 scale: Optional[float] = None,
                 q_offset: int = 0) -> torch.Tensor:
        if _needs_grad(q, k, v):
            return FlashAttentionFunction.apply(q, k, v, causal, window,
                                                softcap, scale, q_offset)
        if not _on_cuda(q, k, v) or reference_forced():
            return ref.flash_attention_ref(
                q, k, v, causal=causal, window=window, softcap=softcap,
                scale=scale, q_offset=q_offset)
        return self.launch_kernel(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale,
                                  q_offset=q_offset)

    def launch_kernel(self, q, k, v, *, return_lse: bool = False, **kw):
        """K1 once on CUDA tensors, counted; raises if it cannot run."""
        out = _flash_mod.launch(self.library.get(self.name), q, k, v,
                                return_lse=return_lse, **kw)
        self._counted()
        return out


class FlashAttentionBwdOp(KernelOp):
    """K1b: (dq, dk, dv) of attention from the forward's residuals, on
    the tensor cores for bfloat16 inputs and the CUDA cores for float32
    (the source picks the body by type).  It does no routing:
    ``FlashAttentionFunction`` picks the side once, in its forward, and
    calls this only for the kernel."""

    def __call__(self, q, k, v, out, lse, do, *, causal: bool = True,
                 window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 scale: Optional[float] = None, q_offset: int = 0):
        """K1b once on CUDA tensors, counted; raises if it cannot run."""
        kw = dict(causal=causal, window=window, softcap=softcap,
                  scale=scale, q_offset=q_offset)
        grads = _flash_bwd_mod.launch(self.library.get(self.name), q, k, v,
                                      out, lse, do, **kw)
        self._counted()
        return grads


class DecodeAttentionOp(KernelOp):
    def __call__(self, q, k_cache, v_cache, pos, *,
                 window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
        if not _on_cuda(q, k_cache, v_cache, pos) or reference_forced():
            return ref.decode_attention_ref(
                q, k_cache, v_cache, pos, window=window, softcap=softcap,
                scale=scale)
        if _needs_grad(q, k_cache, v_cache):
            raise NotImplementedError(
                "decode_attention (K2) has no backward: the reference never "
                "differentiates a decode step, and training runs prefill "
                "attention (K1/K1b)")
        out = _decode_mod.launch(
            self.library.get(self.name), q, k_cache, v_cache, pos,
            window=window, softcap=softcap, scale=scale)
        self._counted()
        return out


class RGLRUScanOp(KernelOp):
    def __call__(self, a, b, h0: Optional[torch.Tensor] = None):
        tensors = (a, b) if h0 is None else (a, b, h0)
        if not _on_cuda(*tensors) or reference_forced():
            return ref.rglru_scan_ref(a, b, h0)
        if _needs_grad(*tensors):
            raise NotImplementedError(
                "rglru_scan (K3) has no backward kernel yet, so a CUDA "
                "RG-LRU model cannot train on the card: "
                f"{K3_BACKWARD_ITEM}")
        out = _rglru_mod.launch(self.library.get(self.name), a, b, h0)
        self._counted()
        return out


flash_attention = FlashAttentionOp("flash_attention", LIBRARY)
flash_attention_bwd = FlashAttentionBwdOp("flash_attention_bwd", LIBRARY)
decode_attention = DecodeAttentionOp("decode_attention", LIBRARY)
rglru_scan = RGLRUScanOp("rglru_scan", LIBRARY)
KERNELS = (flash_attention, flash_attention_bwd, decode_attention,
           rglru_scan)


def reset_launches() -> None:
    for op in KERNELS:
        with op._count_lock:
            op.launches = 0
