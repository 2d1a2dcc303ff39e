"""K2: the decode-attention CUDA kernel's host side.

Source: ``csrc/decode_attention.cu`` (replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py:decode_attention_kernel``).  This
module declares the C entry point's signature, plans the split of the
cache over the card (``plan_splits``) and launches the two passes on
tensors that lie on the card; ``kernels/ops.py`` builds the library,
counts launches and dispatches.  Its plain version is
``kernels/ref.py:decode_attention_ref``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

SOURCE = "decode_attention.cu"
ENTRY = "decode_attention_fwd"
ERROR_STRING = "decode_attention_error_string"
MAX_HEAD_DIM = 256
HEAD_DIM_MULTIPLE = 8        # rows are copied in 16-byte chunks
MAX_GROUP = 32               # query heads per KV head (4 per warp, 8 warps)
MAX_GROUP_OUTPUTS = 4096     # G * dv: 16 accumulators for each of 256 threads
SPLIT_TILE = 32              # slots per tile; a split is whole tiles
BLOCKS_PER_SM = 2            # pass 1 aims to fill the card this many times over
DEVICE_KERNELS_PER_CALL = 2  # pass 1 (partials per split) and pass 2 (merge)
DESIGN = ("split-KV: pass 1 one block per (row, KV head, split), cp.async "
          "double buffer; pass 2 merges the splits in a fixed order")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
ARGTYPES = ([_P] * 6 + [_I] * 8 + [_L] * 10 + [_F, _F, _I, _I, _P])


def bind(lib: ctypes.CDLL) -> None:
    fn = getattr(lib, ENTRY)
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    err = getattr(lib, ERROR_STRING)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p


def plan_splits(B: int, Hkv: int, S: int, n_sm: int) -> Tuple[int, int]:
    """(splits, slots per split) for a cache of S slots.

    Pass 1 runs B * Hkv * splits blocks; the plan aims at
    ``BLOCKS_PER_SM * n_sm`` of them, with each split at least one tile of
    ``SPLIT_TILE`` slots.  The splits tile [0, S) exactly and none is
    empty.  The plan reads only these four numbers, never the positions,
    so one decode step's launches do not depend on where the rows are."""
    tiles = -(-S // SPLIT_TILE)
    want = -(-BLOCKS_PER_SM * n_sm // max(1, B * Hkv))
    per_split = max(1, tiles // max(1, want))
    split_len = per_split * SPLIT_TILE
    return -(-S // split_len), split_len


def check_head_dims(dh: int, dv: int) -> None:
    """Raise ValueError on head dims the kernel does not take."""
    for name, d in (("dh", dh), ("dv", dv)):
        if not (1 <= d <= MAX_HEAD_DIM) or d % HEAD_DIM_MULTIPLE:
            raise ValueError(f"{name} {d}: head dims must be multiples of "
                             f"{HEAD_DIM_MULTIPLE} in [{HEAD_DIM_MULTIPLE}, "
                             f"{MAX_HEAD_DIM}]")


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
    check_head_dims(dh, dv)
    if k_cache.shape[1] < 1:
        raise ValueError("the cache has no slot")
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
    # the caches are copied in 16-byte chunks
    size = k_cache.element_size()
    for t in (k_cache, v_cache):
        if t.data_ptr() % 16 or any(st * size % 16 for st, n in zip(
                t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError("the caches' base and strides must be 16-byte "
                             "aligned")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def launch(lib: ctypes.CDLL, q, k_cache, v_cache, pos, *,
           window: Optional[int], softcap: Optional[float],
           scale: Optional[float]) -> torch.Tensor:
    """Run both passes once; returns (B, 1, Hq, dv) in q's type."""
    check_inputs(q, k_cache, v_cache, pos, window)
    B, _, Hq, dh = q.shape
    _, S, Hkv, dv = v_cache.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits, split_len = plan_splits(B, Hkv, S, n_sm)
    out = torch.empty((B, 1, Hq, dv), dtype=q.dtype, device=q.device)
    ws = torch.empty((B, Hkv, splits, Hq // Hkv, dv + 2), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, ENTRY)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), ws.data_ptr(), out.data_ptr(),
            B, S, Hq, Hkv, dh, dv, splits, split_len,
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
