"""K1b: the flash-attention backward CUDA kernel's host side.

Source: ``csrc/flash_attention_bwd.cu``.  It mirrors the reference's
custom VJP backward ``repro/models/layers.py:_flash_bwd_rule``, a jnp
function and not a Pallas TPU kernel: the port's forward is the kernel K1
(``kernels/flash_attention.py``), so its gradient is a kernel as well.
This module declares the C entry point's signature and launches it on
tensors that lie on the card; ``kernels/ops.py`` builds the library,
counts launches and wires it into autograd.  Its plain version is
``kernels/ref.py:flash_attention_bwd_ref``.

The reference casts q, k, v, o and do to float32 and takes every product
in float32; both bodies keep that arithmetic, and the inputs' type picks
the body (one per type, no fallback):

* bfloat16 runs on the tensor cores (``wgmma``, TMA rings).  S = q k^T
  and dP = do v^T take the bf16 inputs as operands, whose products are
  exact in float32.  For dv = P^T do, dk = scale dS^T q and dq = scale dS
  k, each float32 value of P and dS is split into three bf16 terms (hi,
  mid, lo: their sum is the value exactly) and each term is a register
  operand of its own product into one float32 accumulator, so the
  products are again the reference's; only the order of the sums
  differs.  That is 13 product passes where the function needs 5 (dkdv 8
  up to dh 64 and 9 beyond, where dk and dv take a block each; dq 5), so
  the design can reach at most 5/13 of the bf16 bound.  Head dims are
  tiled to 64/128/192/256; TMA needs dh and dv multiples of 8 and
  16-byte aligned pointers and strides.
* float32 runs on the CUDA cores, scalar FMA, bound by the 67 TFLOP/s
  float32 rate.

One call is four device kernels either way: the row sums D = rowsum(do *
o), dk and dv per (key tile, query head) into a float32 scratch, their
sum over each KV head's query heads, and dq per query tile; no atomics,
so the result is the same from run to run.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fwd

SOURCE = "flash_attention_bwd.cu"
ENTRY = "flash_attention_bwd"
ERROR_STRING = "flash_attention_bwd_error_string"
SMEM_BYTES = "flash_attention_bwd_smem_bytes"
DTYPE_CODES = _fwd.DTYPE_CODES
DESIGN = {
    "bfloat16": ("wgmma m64n64k16 on the tensor cores, TMA rings; S and dP "
                 "on the bf16 inputs, P and dS split into 3 bf16 terms for "
                 "dv, dk, dq (float32-exact products, 13 passes for 5); "
                 "dk/dv per (key tile, query head) into a float32 scratch "
                 "summed over G, dq per query tile"),
    "float32": ("scalar float32 FMA on the CUDA cores; dk/dv per (key tile, "
                "query head) into a float32 scratch summed over G, dq per "
                "query tile"),
}
DEVICE_KERNELS_PER_CALL = 4

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
ARGTYPES = ([_P] * 11 + [_I] * 7 + [_L] * 24
            + [_F, _F, _I, _I, _I, _I, _P])


def bind(lib: ctypes.CDLL) -> None:
    fn = getattr(lib, ENTRY)
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    err = getattr(lib, ERROR_STRING)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    smem = getattr(lib, SMEM_BYTES)
    smem.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_int64


def check_inputs(q, k, v, out, lse, do, window: Optional[int],
                 q_offset: int) -> None:
    """Raise on what the kernel does not take: K1's rules on q, k, v
    (shapes, types, head dims, one CUDA device, a contiguous head
    dimension), and out / do shaped (B, Sq, Hq, dv) in q's type with a
    contiguous head dimension, lse a contiguous (B, Hq, Sq) float32; for
    bfloat16 also Sq, Sk >= 1 and q, k, v, do readable by TMA."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    B, Sq, Hq, dh = q.shape
    Bk, Sk, Hkv, dhk = k.shape
    dv = v.shape[-1]
    if v.shape[:3] != k.shape[:3] or Bk != B or dhk != dh:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of KV heads {Hkv}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share a type among float32/bfloat16, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    _fwd.check_head_dims(dh, dv, q.dtype)
    for name, t in (("out", out), ("do", do)):
        if tuple(t.shape) != (B, Sq, Hq, dv) or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: expected "
                             f"{(B, Sq, Hq, dv)} {q.dtype}")
    if (tuple(lse.shape) != (B, Hq, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: expected a "
                         f"contiguous {(B, Hq, Sq)} float32")
    tensors = (q, k, v, out, lse, do)
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError("q, k, v, out, lse, do must lie on one CUDA device")
    if any(t.stride(-1) != 1 for t in (q, k, v, out, do)):
        raise ValueError("the head dimension must be contiguous")
    if q.dtype == torch.bfloat16:
        if Sq < 1 or Sk < 1:
            raise ValueError("the bfloat16 backward needs at least one query "
                             "and one key")
        if not all(_fwd.tma_ready(t) for t in (q, k, v, do)):
            raise ValueError("bfloat16 q/k/v/do need 16-byte aligned "
                             "pointers and strides (TMA)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def launch(lib: ctypes.CDLL, q, k, v, out, lse, do, *, causal: bool,
           window: Optional[int], softcap: Optional[float],
           scale: Optional[float], q_offset: int):
    """Run the kernels once; returns (dq, dk, dv) in q's type."""
    if do.stride(-1) != 1 or (do.dtype == torch.bfloat16
                              and not _fwd.tma_ready(do)):
        # the kernels read each row's head dimension contiguously, and the
        # bf16 body through TMA: the one copy they need, made here and
        # nowhere else
        do = do.clone(memory_format=torch.contiguous_format)
    check_inputs(q, k, v, out, lse, do, window, q_offset)
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, dv = v.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    dev = q.device
    dq = torch.empty((B, Sq, Hq, dh), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Sk, Hkv, dh), dtype=q.dtype, device=dev)
    dvv = torch.empty((B, Sk, Hkv, dv), dtype=q.dtype, device=dev)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    part = torch.empty((B, Sk, Hq, dh + dv), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, ENTRY)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), part.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
            B, Sq, Sk, Hq, Hkv, dh, dv,
            *_fwd.tma_strides(q), *_fwd.tma_strides(k),
            *_fwd.tma_strides(v), *out.stride()[:3], *_fwd.tma_strides(do),
            *dq.stride()[:3],
            *dk.stride()[:3], *dvv.stride()[:3],
            float(scale), float(softcap or 0.0), int(bool(causal)),
            int(window or 0), int(q_offset), DTYPE_CODES[q.dtype], stream)
    if err:
        msg = getattr(lib, ERROR_STRING)(err).decode()
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: {msg} "
                           f"({err})")
    return dq, dk, dvv
