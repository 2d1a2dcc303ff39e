"""K3: the RG-LRU scan CUDA kernel's host side.

Source: ``csrc/rglru_scan.cu`` (replaces the Pallas TPU kernel
``repro/kernels/rglru_scan.py:rglru_scan_kernel``).  This module
declares the C entry point's signature and launches it on tensors that
lie on the card; ``kernels/ops.py`` builds the library, counts launches
and dispatches.  Its plain version is ``kernels/ref.py:rglru_scan_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

SOURCE = "rglru_scan.cu"
ENTRY = "rglru_scan_fwd"
ERROR_STRING = "rglru_scan_error_string"
MAX_BATCH = 65535            # the grid's y dimension
DESIGN = "one thread per (row, channel) walks the sequence, 8 steps of loads in flight"
DEVICE_KERNELS_PER_CALL = 1

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
ARGTYPES = [_P] * 5 + [_I] * 3 + [_L] * 8 + [_P]


def bind(lib: ctypes.CDLL) -> None:
    fn = getattr(lib, ENTRY)
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    err = getattr(lib, ERROR_STRING)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p


def check_inputs(a, b, h0: Optional[torch.Tensor]) -> None:
    """Raise on what the kernel does not take."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a and b must be one (B, S, r) shape, got "
                         f"a{tuple(a.shape)} b{tuple(b.shape)}")
    B, _, r = a.shape
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernel's {MAX_BATCH}")
    if h0 is not None and tuple(h0.shape) != (B, r):
        raise ValueError(f"h0 must be (B, r) = {(B, r)}, got "
                         f"{tuple(h0.shape)}")
    tensors = (a, b) if h0 is None else (a, b, h0)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"a, b and h0 must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    if not (a.is_cuda and all(t.device == a.device for t in tensors)):
        raise ValueError("a, b and h0 must lie on one CUDA device")
    if any(t.shape[-1] > 1 and t.stride(-1) != 1 for t in tensors):
        raise ValueError("the channel dimension must be contiguous")


def launch(lib: ctypes.CDLL, a, b, h0=None):
    """Run the kernel once; returns (y (B, S, r), h_T (B, r)), float32."""
    check_inputs(a, b, h0)
    B, S, r = a.shape
    y = torch.empty((B, S, r), dtype=torch.float32, device=a.device)
    hT = torch.empty((B, r), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib, ENTRY)(
            a.data_ptr(), b.data_ptr(),
            h0.data_ptr() if h0 is not None else None,
            y.data_ptr(), hT.data_ptr(), B, S, r,
            a.stride(0), a.stride(1), b.stride(0), b.stride(1),
            h0.stride(0) if h0 is not None else 0,
            y.stride(0), y.stride(1), hT.stride(0), stream)
    if err:
        msg = getattr(lib, ERROR_STRING)(err).decode()
        raise RuntimeError(f"rglru_scan kernel launch failed: {msg} ({err})")
    return y, hT
