"""K1: the prefill flash-attention CUDA kernel's host side.

Source: ``csrc/flash_attention.cu`` (replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py:flash_attention_kernel``).  This module
declares the C entry point's signature and launches it on tensors that
lie on the card; ``kernels/ops.py`` builds the library, counts launches
and dispatches.  Its plain version is ``kernels/ref.py:flash_attention_ref``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

SOURCE = "flash_attention.cu"
ENTRY = "flash_attention_fwd"
ERROR_STRING = "flash_attention_error_string"
MAX_HEAD_DIM = 256
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
ARGTYPES = ([_P] * 4 + [_I] * 7 + [_L] * 12
            + [_F, _F, _I, _I, _I, _I, _P])


def bind(lib: ctypes.CDLL) -> None:
    fn = getattr(lib, ENTRY)
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    err = getattr(lib, ERROR_STRING)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p


def check_inputs(q, k, v, window: Optional[int], q_offset: int) -> None:
    """Raise on what the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    B, Sq, Hq, dh = q.shape
    Bk, Sk, Hkv, dhk = k.shape
    if v.shape[:3] != k.shape[:3] or Bk != B or dhk != dh:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of KV heads {Hkv}")
    if not (1 <= dh <= MAX_HEAD_DIM and 1 <= v.shape[-1] <= MAX_HEAD_DIM):
        raise ValueError(f"head dims must be in [1, {MAX_HEAD_DIM}]")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share a type among float32/bfloat16, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dimension must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def launch(lib: ctypes.CDLL, q, k, v, *, causal: bool, window: Optional[int],
           softcap: Optional[float], scale: Optional[float],
           q_offset: int) -> torch.Tensor:
    """Run the kernel once; returns (B, Sq, Hq, dv) in q's type."""
    check_inputs(q, k, v, window, q_offset)
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, dv = v.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty((B, Sq, Hq, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, ENTRY)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, Hq, Hkv, dh, dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            float(scale), float(softcap or 0.0), int(bool(causal)),
            int(window or 0), int(q_offset), DTYPE_CODES[q.dtype], stream)
    if err:
        msg = getattr(lib, ERROR_STRING)(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} "
                           f"({err})")
    return out
