"""K3b: the RG-LRU scan backward CUDA kernel's host side.

Source: ``csrc/rglru_scan_bwd.cu``.  It mirrors the VJP of the
reference's scan (``repro/models/rglru.py:rglru_scan``, an associative
scan that JAX differentiates; the Pallas kernel K3 replaces has no VJP):
the port's forward is the kernel K3 (``kernels/rglru_scan.py``), so its
gradient is a kernel as well.  This module declares the C entry point's
signature, plans the tiles and the ring (``plan_scan_bwd``) and launches
the kernel on tensors that lie on the card; ``kernels/ops.py`` builds the
library, counts launches and wires it into autograd.  Its plain version
is ``kernels/ref.py:rglru_scan_bwd_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import rglru_scan as _fwd

SOURCE = "rglru_scan_bwd.cu"
ENTRY = "rglru_scan_bwd"
ERROR_STRING = "rglru_scan_bwd_error_string"
SMEM_BYTES = "rglru_scan_bwd_smem_bytes"
MAX_BATCH = _fwd.MAX_BATCH
TILE_CHANNELS = _fwd.TILE_CHANNELS   # channels (threads) per block
BOX_BYTES = 4096                     # T steps x C channels of float32
STAGE_BYTES = 3 * BOX_BYTES          # one ring stage: boxes of a, y, dy
OUT_BUFFERS = 3                      # (da, db) box pairs staged for stores
MAX_STAGES = _fwd.MAX_STAGES
SMEM_ALIGN = _fwd.SMEM_ALIGN
SMEM_LIMIT = _fwd.SMEM_LIMIT
DESIGN = ("K3's ring walked backwards: a block of 16 or 32 channels of one "
          "row walks from step S-1; TMA boxes of a, y one step earlier "
          "(zero-filled before step 0) and dy stream into a ring of 12 KB "
          "stages, da and db boxes go out by TMA stores")
DEVICE_KERNELS_PER_CALL = 1

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
ARGTYPES = [_P] * 8 + [_I] * 5 + [_L] * 13 + [_P]


def bind(lib: ctypes.CDLL) -> None:
    fn = getattr(lib, ENTRY)
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    err = getattr(lib, ERROR_STRING)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    smem = getattr(lib, SMEM_BYTES)
    smem.argtypes = [ctypes.c_int]
    smem.restype = ctypes.c_int64


def plan_scan_bwd(B: int, S: int, r: int, n_sm: int) -> _fwd.ScanPlan:
    """The kernel's tiles and ring for (B, S, r) on ``n_sm`` SMs, planned
    as K3's (``rglru_scan.ring_plan``): a box holds ``BOX_BYTES`` (T = 32
    steps at 32 channels, 64 at 16), a stage the boxes of a, y and dy,
    and ``OUT_BUFFERS`` (da, db) pairs are staged for their stores.  The
    plan reads only these four numbers."""
    return _fwd.ring_plan(B, S, r, n_sm, BOX_BYTES, 3, 2 * OUT_BUFFERS)


def check_inputs(a, y, dy, h0: Optional[torch.Tensor] = None,
                 dhT: Optional[torch.Tensor] = None) -> None:
    """Raise on what the kernel does not take: ValueError on shapes and
    layouts (a, y and dy as K3 takes a and b, h0 and dh_T with their
    channel dimension contiguous), TypeError on types."""
    if a.dim() != 3 or y.shape != a.shape or dy.shape != a.shape:
        raise ValueError(f"a, y and dy must be one (B, S, r) shape, got "
                         f"a{tuple(a.shape)} y{tuple(y.shape)} "
                         f"dy{tuple(dy.shape)}")
    B, _, r = a.shape
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernel's {MAX_BATCH}")
    states = [t for t in (h0, dhT) if t is not None]
    for name, t in (("h0", h0), ("dhT", dhT)):
        if t is not None and tuple(t.shape) != (B, r):
            raise ValueError(f"{name} must be (B, r) = {(B, r)}, got "
                             f"{tuple(t.shape)}")
    tensors = (a, y, dy, *states)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"a, y, dy, h0 and dhT must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    for t in (a, y, dy):
        _fwd.check_layout(tuple(t.shape), t.stride(), t.data_ptr())
    if r > 1 and any(t.stride(1) != 1 for t in states):
        raise ValueError("the channel dimension must be contiguous")
    if not (a.is_cuda and all(t.device == a.device for t in tensors)):
        raise ValueError("a, y, dy, h0 and dhT must lie on one CUDA device")


def launch(lib: ctypes.CDLL, a, y, dy, h0=None, dhT=None):
    """Run the kernel once; returns (da, db (B, S, r), dh0 (B, r) or None
    when h0 is None), float32."""
    check_inputs(a, y, dy, h0, dhT)
    B, S, r = a.shape
    n_sm = torch.cuda.get_device_properties(a.device).multi_processor_count
    plan = plan_scan_bwd(B, S, r, n_sm)
    da = torch.empty((B, S, r), dtype=torch.float32, device=a.device)
    db = torch.empty((B, S, r), dtype=torch.float32, device=a.device)
    dh0 = (None if h0 is None else
           torch.empty((B, r), dtype=torch.float32, device=a.device))

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib, ENTRY)(
            a.data_ptr(), y.data_ptr(), dy.data_ptr(), ptr(h0), ptr(dhT),
            da.data_ptr(), db.data_ptr(), ptr(dh0), B, S, r, plan.channels,
            plan.stages, *_fwd._strides(a), *_fwd._strides(y),
            *_fwd._strides(dy), h0.stride(0) if h0 is not None else 0,
            dhT.stride(0) if dhT is not None else 0, *_fwd._strides(da),
            *_fwd._strides(db), dh0.stride(0) if dh0 is not None else 0,
            stream)
    if err:
        msg = getattr(lib, ERROR_STRING)(err).decode()
        raise RuntimeError(f"rglru_scan_bwd kernel launch failed: {msg} "
                           f"({err})")
    return da, db, dh0
