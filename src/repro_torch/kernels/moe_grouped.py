"""K4: the grouped SwiGLU expert GEMM's host side.

Source: ``csrc/moe_grouped.cu``.  It replaces no TPU kernel: the
reference computes its experts outside Pallas, as batched products over
a capacity buffer (``repro/models/moe.py`` ``_expert_ffn``), which at a
capacity that drops nothing makes every expert compute every token of
its group.  K4 computes the same function on the rows that carry a kept
assignment alone.  This module declares the C entry point's signature,
sizes the tile list and launches it on tensors that lie on the card;
``kernels/ops.py`` builds the library, counts launches and dispatches.
Its plain version is ``kernels/ref.py:moe_grouped_ref`` (with the
routing metadata's, ``moe_plan_ref``).

One call runs three device kernels: the routing metadata (each kept
assignment's row in expert-major order, and a tile list sized to its
static bound), the up projection (silu(x W_g) * x W_i, rows of x
gathered by token as they load) and the down projection (times the
gate, into the assignment's own (T, k) slot); the k slots are then
summed in a fixed order.  Every shape is fixed by the call's shapes, so
the call captures into a CUDA graph.

The tile shape follows the rows per expert, T*k / E_loc: under
``SWAP_BELOW`` (every decode step) the expert's weights are the
product's 64-row side and tiles hold ``SMALL_ROWS`` rows; otherwise tiles
hold ``LARGE_ROWS``.  bfloat16 runs on the tensor cores and needs d and
d_ff to be multiples of 64; float32 runs a scalar body.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

SOURCE = "moe_grouped.cu"
ENTRY = "moe_grouped"
ERROR_STRING = "moe_grouped_error_string"
SMEM_BYTES = "moe_grouped_smem_bytes"
SMALL_ROWS = 8            # rows per tile where the weights are wgmma's M
LARGE_ROWS = 128          # rows per tile otherwise
SWAP_BELOW = 64           # rows per expert under which tiles are swapped
BF16_WIDTH_MULTIPLE = 64  # d and d_ff: whole 128-byte rows of bf16
SMEM_LIMIT = 232448       # an H100 block's dynamic shared memory
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
DESIGN = {
    "bfloat16": ("routing metadata on the device, then wgmma over expert-"
                 "sorted rows: swapped 64x8 tiles streaming each weight byte "
                 "once in decode, 128x128 tiles with a cp.async row gather "
                 "and a TMA weight ring in prefill; the gate in the epilogue"),
    "float32": "scalar FMA on the CUDA cores (no full-float32 tensor-core mode)",
}
DEVICE_KERNELS_PER_CALL = 3   # metadata, up projection, down projection

_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_P] * 11 + [_I] * 11 + [_P]


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


class Tiling(NamedTuple):
    """The tile list of a call: rows per tile and its static length."""
    rows: int
    slots: int


def tiling(T: int, k: int, n_local: int) -> Tiling:
    """Rows per tile from the rows per expert, T*k / n_local, and the
    tile list's bound, ceil(T*k / rows) + n_local: each expert's rows
    fill whole tiles but its last."""
    rows = SMALL_ROWS if T * k < SWAP_BELOW * n_local else LARGE_ROWS
    return Tiling(rows, -(-T * k // rows) + n_local)


def check_inputs(x2d, idx, pos, probs, wg, wi, wo, capacity: int,
                 group_size: int) -> None:
    """Raise on what the kernel does not take."""
    if x2d.dim() != 2 or idx.dim() != 2 or pos.shape != idx.shape \
            or probs.shape != idx.shape:
        raise ValueError(f"x2d (T, d) with idx, pos, probs (T, k): got "
                         f"{tuple(x2d.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(pos.shape)}, {tuple(probs.shape)}")
    T, d = x2d.shape
    if idx.shape[0] != T:
        raise ValueError(f"{idx.shape[0]} routed tokens for {T} tokens")
    E, d_in, d_ff = wg.shape
    if wi.shape != wg.shape or wo.shape != (E, d_ff, d) or d_in != d:
        raise ValueError(f"expert stacks wg {tuple(wg.shape)}, wi "
                         f"{tuple(wi.shape)}, wo {tuple(wo.shape)} for d {d}")
    if x2d.dtype not in DTYPE_CODES or any(
            w.dtype != x2d.dtype for w in (wg, wi, wo)):
        raise TypeError(f"x2d and the expert stacks must share a type among "
                        f"float32/bfloat16, got {x2d.dtype}, {wg.dtype}, "
                        f"{wi.dtype}, {wo.dtype}")
    if idx.dtype != torch.int64 or probs.dtype != torch.float32:
        raise TypeError(f"idx int64 and probs float32, got {idx.dtype}, "
                        f"{probs.dtype}")
    if group_size < 1 or T % group_size or capacity < 1:
        raise ValueError(f"{T} tokens in groups of {group_size} at capacity "
                         f"{capacity}")
    if x2d.dtype == torch.bfloat16 and (d % BF16_WIDTH_MULTIPLE
                                        or d_ff % BF16_WIDTH_MULTIPLE):
        raise ValueError(f"bfloat16 experts need d {d} and d_ff {d_ff} to be "
                         f"multiples of {BF16_WIDTH_MULTIPLE}")
    dev = x2d.device
    if not x2d.is_cuda or any(t.device != dev
                              for t in (idx, pos, probs, wg, wi, wo)):
        raise ValueError("the tokens, routing and expert stacks must lie on "
                         "one CUDA device")
    if not all(w.is_contiguous() for w in (wg, wi, wo)):
        raise ValueError("the expert stacks must be contiguous")


def launch(lib: ctypes.CDLL, x2d, idx, pos, probs, wg, wi, wo, *,
           capacity: int, group_size: int, e0: int = 0,
           return_plan: bool = False):
    """Run the kernels once; returns the routed experts' output (T, d) in
    x2d's type, and with ``return_plan`` also the routing metadata
    (row_slot (T*k,), tiles (slots, 3), both int32)."""
    check_inputs(x2d, idx, pos, probs, wg, wi, wo, capacity, group_size)
    T, d = x2d.shape
    k = idx.shape[1]
    E_loc, _, d_ff = wg.shape
    tl = tiling(T, k, E_loc)
    lib_fn = getattr(lib, ENTRY)
    smem = getattr(lib, SMEM_BYTES)(4, E_loc, T // group_size)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{E_loc} experts x {T // group_size} groups need "
                         f"{smem} bytes of shared memory for the metadata")
    dev = x2d.device
    x2d = x2d.contiguous()
    row_slot = torch.empty(T * k, dtype=torch.int32, device=dev)
    tiles = torch.empty((tl.slots, 3), dtype=torch.int32, device=dev)
    h = torch.empty((T * k, d_ff), dtype=x2d.dtype, device=dev)
    slots = torch.empty((T * k, d), dtype=x2d.dtype, device=dev)
    idx_flat = idx.reshape(-1).contiguous()
    pos_flat = pos.reshape(-1).to(torch.int32).contiguous()
    gates = probs.reshape(-1).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib_fn(
            x2d.data_ptr(), idx_flat.data_ptr(), pos_flat.data_ptr(),
            gates.data_ptr(), wg.data_ptr(), wi.data_ptr(), wo.data_ptr(),
            row_slot.data_ptr(), tiles.data_ptr(), h.data_ptr(),
            slots.data_ptr(), T, k, d, d_ff, E_loc, group_size, capacity,
            e0, tl.rows, tl.slots, DTYPE_CODES[x2d.dtype], stream)
    if err:
        msg = getattr(lib, ERROR_STRING)(err).decode()
        raise RuntimeError(f"moe_grouped kernel launch failed: {msg} ({err})")
    out = slots.view(T, k, d).sum(dim=1)
    return (out, row_slot, tiles) if return_plan else out
