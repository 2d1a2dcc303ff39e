"""K1: the prefill flash-attention CUDA kernel's host side.

Source: ``csrc/flash_attention.cu`` (replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py:flash_attention_kernel``).  This module
declares the C entry point's signature and launches it on tensors that
lie on the card; ``kernels/ops.py`` builds the library, counts launches
and dispatches.  Its plain version is ``kernels/ref.py:flash_attention_ref``.

The source holds one body per type: bfloat16 runs on the tensor cores
(``wgmma``, TMA loads), float32 on the CUDA cores (scalar FMA), since the
tensor cores have no full-float32 mode.  The bfloat16 body reads its
tensors through TMA maps, which need dh and dv to be multiples of 8 and
16-byte aligned pointers and strides.

With ``return_lse`` the kernel also writes each row's float32
log-sum-exp, (B, Hq, Sq), the residual of the backward (K1b,
``kernels/flash_attention_bwd.py``); the serving path passes a null
pointer and the kernel writes nothing more.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

SOURCE = "flash_attention.cu"
ENTRY = "flash_attention_fwd"
ERROR_STRING = "flash_attention_error_string"
SMEM_BYTES = "flash_attention_bf16_smem_bytes"
MAX_HEAD_DIM = 256
BF16_HEAD_DIM_MULTIPLE = 8   # TMA's 16-byte stride rule
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
DESIGN = {
    "bfloat16": ("wgmma m64nNk16 tensor cores, TMA into 2-stage K and V rings, "
                 "P in registers, softmax overlapped with P V"),
    "float32": "scalar FMA on the CUDA cores (no full-float32 tensor-core mode)",
}
DEVICE_KERNELS_PER_CALL = 1

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
ARGTYPES = ([_P] * 5 + [_I] * 7 + [_L] * 12
            + [_F, _F, _I, _I, _I, _I, _P])


def bind(lib: ctypes.CDLL) -> None:
    fn = getattr(lib, ENTRY)
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    err = getattr(lib, ERROR_STRING)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    smem = getattr(lib, SMEM_BYTES)
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_int64


def check_head_dims(dh: int, dv: int, dtype: torch.dtype) -> None:
    """Raise ValueError on head dims the kernel does not take in ``dtype``."""
    for name, d in (("dh", dh), ("dv", dv)):
        if not 1 <= d <= MAX_HEAD_DIM:
            raise ValueError(f"{name} {d}: head dims must be in "
                             f"[1, {MAX_HEAD_DIM}]")
        if dtype == torch.bfloat16 and d % BF16_HEAD_DIM_MULTIPLE:
            raise ValueError(f"{name} {d}: bfloat16 head dims must be "
                             f"multiples of {BF16_HEAD_DIM_MULTIPLE}")


def tma_strides(t: torch.Tensor) -> tuple:
    """Element strides of a (B, S, H, D) tensor's first three dims.  A
    dim of length 1 is never stepped; it gets its contiguous stride, so
    the bfloat16 body's TMA map sees an aligned one whatever the view."""
    B, S, H, D = t.shape
    natural = (S * H * D, H * D, D)
    return tuple(st if n > 1 else nat
                 for st, n, nat in zip(t.stride()[:3], (B, S, H), natural))


def tma_ready(t: torch.Tensor) -> bool:
    """True if a bfloat16 body's TMA maps can read ``t`` as it lies:
    16-byte aligned pointer and strides."""
    return t.data_ptr() % 16 == 0 and all(
        st * t.element_size() % 16 == 0 for st in tma_strides(t))


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
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share a type among float32/bfloat16, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    check_head_dims(dh, v.shape[-1], q.dtype)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dimension must be contiguous")
    if q.dtype == torch.bfloat16:
        if Sk < 1:
            raise ValueError("bfloat16 attention needs at least one key")
        if not all(tma_ready(t) for t in (q, k, v)):
            raise ValueError("bfloat16 q/k/v need 16-byte aligned "
                             "pointers and strides (TMA)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def launch(lib: ctypes.CDLL, q, k, v, *, causal: bool, window: Optional[int],
           softcap: Optional[float], scale: Optional[float],
           q_offset: int, return_lse: bool = False):
    """Run the kernel once; returns (B, Sq, Hq, dv) in q's type, and with
    ``return_lse`` also the (B, Hq, Sq) float32 row log-sum-exp."""
    check_inputs(q, k, v, window, q_offset)
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, dv = v.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty((B, Sq, Hq, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, ENTRY)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Sq, Sk, Hq, Hkv, dh, dv,
            *tma_strides(q), *tma_strides(k), *tma_strides(v),
            *out.stride()[:3],
            float(scale), float(softcap or 0.0), int(bool(causal)),
            int(window or 0), int(q_offset), DTYPE_CODES[q.dtype], stream)
    if err:
        msg = getattr(lib, ERROR_STRING)(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} "
                           f"({err})")
    return (out, lse) if return_lse else out
