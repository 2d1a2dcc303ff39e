"""K2: the decode-attention CUDA kernel's host side.

Source: ``csrc/decode_attention.cu`` (replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py:decode_attention_kernel``).  This
module declares the C entry point's signature and launches it on
tensors that lie on the card; ``kernels/ops.py`` builds the library,
counts launches and dispatches.  Its plain version is
``kernels/ref.py:decode_attention_ref``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

SOURCE = "decode_attention.cu"
ENTRY = "decode_attention_fwd"
ERROR_STRING = "decode_attention_error_string"
MAX_HEAD_DIM = 256
MAX_GROUP = 32               # query heads per KV head (4 per warp, 8 warps)
MAX_GROUP_OUTPUTS = 4096     # G * dv: 16 accumulators for each of 256 threads
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
ARGTYPES = ([_P] * 5 + [_I] * 6 + [_L] * 10 + [_F, _F, _I, _I, _P])


def bind(lib: ctypes.CDLL) -> None:
    fn = getattr(lib, ENTRY)
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    err = getattr(lib, ERROR_STRING)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p


def check_inputs(q, k_cache, v_cache, pos, window: Optional[int]) -> None:
    """Raise on what the kernel does not take."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, Hq, dh), got {tuple(q.shape)}")
    B, _, Hq, dh = q.shape
    if (k_cache.dim() != 4 or v_cache.shape[:3] != k_cache.shape[:3]
            or k_cache.shape[0] != B or k_cache.shape[-1] != dh):
        raise ValueError(f"cache shapes k{tuple(k_cache.shape)} "
                         f"v{tuple(v_cache.shape)} do not match q{tuple(q.shape)}")
    Hkv, dv = k_cache.shape[2], v_cache.shape[-1]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of KV heads {Hkv}")
    G = Hq // Hkv
    if G > MAX_GROUP or G * dv > MAX_GROUP_OUTPUTS:
        raise ValueError(f"group of {G} query heads x dv {dv} exceeds the "
                         f"kernel's {MAX_GROUP} heads / {MAX_GROUP_OUTPUTS} outputs")
    if not (1 <= dh <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims must be in [1, {MAX_HEAD_DIM}]")
    if (q.dtype not in DTYPE_CODES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise TypeError(f"q/caches must share a type among float32/bfloat16, "
                        f"got {q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if pos.dtype != torch.int32 or pos.shape != (B,) or not pos.is_contiguous():
        raise TypeError("pos must be a contiguous (B,) int32 tensor")
    dev = q.device
    if not (q.is_cuda and k_cache.device == dev and v_cache.device == dev
            and pos.device == dev):
        raise ValueError("q, caches and pos must lie on one CUDA device")
    if q.stride(-1) != 1 or k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1:
        raise ValueError("the head dimension must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def launch(lib: ctypes.CDLL, q, k_cache, v_cache, pos, *,
           window: Optional[int], softcap: Optional[float],
           scale: Optional[float]) -> torch.Tensor:
    """Run the kernel once; returns (B, 1, Hq, dv) in q's type."""
    check_inputs(q, k_cache, v_cache, pos, window)
    B, _, Hq, dh = q.shape
    _, S, Hkv, dv = v_cache.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty((B, 1, Hq, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, ENTRY)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), out.data_ptr(),
            B, S, Hq, Hkv, dh, dv,
            q.stride(0), q.stride(2),
            *k_cache.stride()[:3], *v_cache.stride()[:3],
            out.stride(0), out.stride(2),
            float(scale), float(softcap or 0.0), int(window or 0),
            DTYPE_CODES[q.dtype], stream)
    if err:
        msg = getattr(lib, ERROR_STRING)(err).decode()
        raise RuntimeError(f"decode_attention kernel launch failed: {msg} "
                           f"({err})")
    return out
