"""K1b: the flash-attention backward CUDA kernel's host side.

Source: ``csrc/flash_attention_bwd.cu``.  It mirrors the reference's
custom VJP backward ``repro/models/layers.py:_flash_bwd_rule``, a jnp
function and not a Pallas TPU kernel: the port's forward is the kernel K1
(``kernels/flash_attention.py``), so its gradient is a kernel as well.
This module declares the C entry point's signature and launches it on
tensors that lie on the card; ``kernels/ops.py`` builds the library,
counts launches and wires it into autograd.  Its plain version is
``kernels/ref.py:flash_attention_bwd_ref``.

Every product runs in float32 on the CUDA cores, for bfloat16 inputs
too, as the reference's backward casts everything to float32.  One call
is four device kernels: the row sums D = rowsum(do * o), dk and dv per
(key tile, query head) into a float32 scratch, their sum over each KV
head's query heads, and dq per query tile; no atomics, so the result is
the same from run to run.
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
    "bfloat16": ("scalar float32 FMA on the CUDA cores (the reference's "
                 "backward is float32); dk/dv per (key tile, query head) "
                 "into a float32 scratch summed over G, dq per query tile"),
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
    contiguous head dimension, lse a contiguous (B, Hq, Sq) float32."""
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
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def launch(lib: ctypes.CDLL, q, k, v, out, lse, do, *, causal: bool,
           window: Optional[int], softcap: Optional[float],
           scale: Optional[float], q_offset: int):
    """Run the kernels once; returns (dq, dk, dv) in q's type."""
    if do.stride(-1) != 1:
        # the kernel reads each row's head dimension contiguously: the one
        # copy it needs, made here and nowhere else
        do = do.contiguous()
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
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], *do.stride()[:3], *dq.stride()[:3],
            *dk.stride()[:3], *dvv.stride()[:3],
            float(scale), float(softcap or 0.0), int(bool(causal)),
            int(window or 0), int(q_offset), DTYPE_CODES[q.dtype], stream)
    if err:
        msg = getattr(lib, ERROR_STRING)(err).decode()
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: {msg} "
                           f"({err})")
    return dq, dk, dvv
