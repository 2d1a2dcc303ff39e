"""K3: the RG-LRU scan CUDA kernel's host side.

Source: ``csrc/rglru_scan.cu`` (replaces the Pallas TPU kernel
``repro/kernels/rglru_scan.py:rglru_scan_kernel``).  This module
declares the C entry point's signature, plans the tiles and the ring
(``plan_scan``) and launches the kernel on tensors that lie on the card;
``kernels/ops.py`` builds the library, counts launches and dispatches.
Its plain version is ``kernels/ref.py:rglru_scan_ref``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

SOURCE = "rglru_scan.cu"
ENTRY = "rglru_scan_fwd"
ERROR_STRING = "rglru_scan_error_string"
SMEM_BYTES = "rglru_scan_smem_bytes"
MAX_BATCH = 65535            # the grid's y dimension
TILE_CHANNELS = (32, 16)     # channels (threads) per block, widest first
STAGE_BYTES = 8192           # one ring stage: a box of a and one of b
Y_BUFFERS = 3                # y boxes staged for their TMA stores
RING_BYTES_PER_SM = 128 * 1024
MAX_STAGES = 16
SMEM_ALIGN = 1024            # slack the kernel uses to align its ring
SMEM_LIMIT = 232448          # dynamic shared memory one block may have
ALIGN_BYTES = 16             # TMA: base and strides
DESIGN = ("a block of 16 or 32 channels of one row walks the sequence; "
          "TMA boxes of a and b stream into a ring of 8 KB stages "
          "(~128 KB per SM), y boxes go out by TMA stores")
DEVICE_KERNELS_PER_CALL = 1

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
ARGTYPES = [_P] * 5 + [_I] * 5 + [_L] * 8 + [_P]


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


@dataclass(frozen=True)
class ScanPlan:
    channels: int     # C: channels, and threads, per block
    steps: int        # T: steps per TMA box
    stages: int       # ring depth
    tiles: int        # channel tiles per row, ceil(r / C)
    blocks: int       # B * tiles, each one walks all S steps
    smem_bytes: int   # dynamic shared memory per block


def ring_plan(B: int, S: int, r: int, n_sm: int, box_bytes: int,
              boxes_per_stage: int, out_boxes: int) -> ScanPlan:
    """The tiles and ring of a scan kernel (K3, and its backward K3b in
    ``rglru_scan_bwd.py``) for (B, S, r) on ``n_sm`` SMs.

    The widest tile of ``TILE_CHANNELS`` that gives at least one block per
    SM, else the narrowest; a TMA box holds ``box_bytes`` of one tensor, so
    T is ``box_bytes / (4 C)`` steps, and a stage holds ``boxes_per_stage``
    boxes.  The ring takes about ``RING_BYTES_PER_SM`` of each SM's shared
    memory, split over the blocks an SM holds, with at least two stages
    (one walked, one in flight) and never more stages than boxes; beside
    it a block stages ``out_boxes`` boxes for its TMA stores.  S is not
    split: every block walks its channels over the whole sequence.  The
    plan reads only its arguments and this module's constants."""
    for C in TILE_CHANNELS:
        tiles = -(-r // C)
        if B * tiles >= n_sm:
            break
    T = box_bytes // (4 * C)
    stage_bytes = boxes_per_stage * box_bytes
    blocks = B * tiles
    boxes = max(1, -(-S // T))
    per_sm = max(1, -(-blocks // max(1, n_sm)))
    budget = RING_BYTES_PER_SM // (stage_bytes * per_sm)
    stages = min(boxes, max(2, min(MAX_STAGES, budget)))
    smem = (SMEM_ALIGN + stages * stage_bytes + out_boxes * box_bytes
            + 8 * stages)
    return ScanPlan(C, T, stages, tiles, blocks, smem)


def plan_scan(B: int, S: int, r: int, n_sm: int) -> ScanPlan:
    """K3's tiles and ring for (B, S, r) on ``n_sm`` SMs (``ring_plan``):
    a stage holds ``STAGE_BYTES``, a box of a and one of b, so T is 32
    steps at 32 channels and 64 at 16, and ``Y_BUFFERS`` y boxes are
    staged for their stores.  The plan reads only these four numbers."""
    return ring_plan(B, S, r, n_sm, STAGE_BYTES // 2, 2, Y_BUFFERS)


def check_layout(shape, strides, data_ptr: int) -> None:
    """Raise ValueError unless TMA can read a (B, S, r) float32 tensor of
    this layout: r % 4 == 0, the channel dimension contiguous, the base
    and the strides of the dimensions longer than 1 positive multiples of
    16 bytes."""
    B, S, r = shape
    if r % 4:
        raise ValueError(f"r = {r}: the kernel takes r % 4 == 0 (TMA's "
                         f"16-byte rows)")
    if r > 1 and strides[2] != 1:
        raise ValueError("the channel dimension must be contiguous")
    if data_ptr % ALIGN_BYTES:
        raise ValueError(f"the base of a and b must be {ALIGN_BYTES}-byte "
                         f"aligned")
    for n, st in ((B, strides[0]), (S, strides[1])):
        if n > 1 and (st <= 0 or st * 4 % ALIGN_BYTES):
            raise ValueError(f"the row and step strides of a and b must be "
                             f"positive multiples of {ALIGN_BYTES} bytes, "
                             f"got {tuple(strides)} elements")


def check_inputs(a, b, h0: Optional[torch.Tensor]) -> None:
    """Raise on what the kernel does not take: ValueError on shapes and
    layouts, TypeError on types."""
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
    for t in (a, b):
        check_layout(tuple(t.shape), t.stride(), t.data_ptr())
    if h0 is not None and r > 1 and h0.stride(1) != 1:
        raise ValueError("the channel dimension must be contiguous")
    if not (a.is_cuda and all(t.device == a.device for t in tensors)):
        raise ValueError("a, b and h0 must lie on one CUDA device")


def _strides(t):
    """(row, step) strides in elements; a dimension of length 1 is never
    stepped, so it gets an aligned stride TMA takes."""
    B, S, r = t.shape
    ss = t.stride(1) if S > 1 else r
    sb = t.stride(0) if B > 1 else S * ss
    return sb, ss


def launch(lib: ctypes.CDLL, a, b, h0=None):
    """Run the kernel once; returns (y (B, S, r), h_T (B, r)), float32."""
    check_inputs(a, b, h0)
    B, S, r = a.shape
    n_sm = torch.cuda.get_device_properties(a.device).multi_processor_count
    plan = plan_scan(B, S, r, n_sm)
    y = torch.empty((B, S, r), dtype=torch.float32, device=a.device)
    hT = torch.empty((B, r), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib, ENTRY)(
            a.data_ptr(), b.data_ptr(),
            h0.data_ptr() if h0 is not None else None,
            y.data_ptr(), hT.data_ptr(), B, S, r, plan.channels,
            plan.stages, *_strides(a), *_strides(b),
            h0.stride(0) if h0 is not None else 0,
            y.stride(0), y.stride(1), hT.stride(0), stream)
    if err:
        msg = getattr(lib, ERROR_STRING)(err).decode()
        raise RuntimeError(f"rglru_scan kernel launch failed: {msg} ({err})")
    return y, hT
