"""Parameter checkpoints in the reference's ``.npz`` layout — the weight
bridge between the JAX package and the port.

The layout (``repro/checkpoint/io.py``): one array per leaf, keyed by its
key path (``seg0/[0]/mixer/wq``, ``final_norm/scale``), plus a JSON
``__meta__`` entry.  bfloat16, which plain numpy cannot store, is written
as a ``uint16`` view with the true type in ``__meta__["dtype_map"]``.
Every leaf keeps its own type: norm scales stay float32 in a bf16 model.

A params tree is nested dicts (string keys) and tuples (``[i]`` keys)
with ``torch.Tensor`` leaves — the same shape as the JAX pytree, so a
checkpoint written by either package loads into the other.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

_BF16 = "bfloat16"


def _path_str(key) -> str:
    return f"[{key}]" if isinstance(key, int) else str(key)


def flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """``{key_path: leaf}`` in the reference's key-path spelling; dict
    keys are visited in sorted order, as JAX flattens them."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for key, sub in items:
        path = f"{prefix}/{_path_str(key)}" if prefix else _path_str(key)
        flat.update(flatten_with_paths(sub, path))
    return flat


def unflatten_paths(flat: Dict[str, Any]) -> Any:
    """Inverse of :func:`flatten_with_paths`: ``[i]`` components become
    tuple positions, every other component a dict key."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def build(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.startswith("[") and k.endswith("]") for k in keys):
            idx = sorted(keys, key=lambda k: int(k[1:-1]))
            if [int(k[1:-1]) for k in idx] != list(range(len(idx))):
                raise ValueError(f"non-contiguous sequence keys {idx}")
            return tuple(build(node[k]) for k in idx)
        return {k: build(v) for k, v in node.items()}

    return build(root)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a dict/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


# ----------------------------------------------------------------------
# numpy <-> torch
def _is_bf16_numpy(arr: np.ndarray) -> bool:
    # a JAX bf16 array converted with np.asarray carries ml_dtypes'
    # bfloat16, a 2-byte type plain numpy only knows by name
    return arr.dtype.name == _BF16


def params_from_numpy(flat: Dict[str, np.ndarray], device: DeviceLike = "cuda",
                      dtype_map: Optional[Dict[str, str]] = None) -> Any:
    """Flat ``{key_path: ndarray}`` (as ``np.asarray`` of JAX leaves, or as
    stored in an ``.npz``) to a params tree of tensors on ``device``.

    A leaf is bfloat16 when ``dtype_map`` says so (its array is then the
    stored ``uint16`` view) or when its numpy type is ml_dtypes'
    bfloat16; its 16 bits are reinterpreted, never converted."""
    dev = resolve_device(device)
    dtype_map = dtype_map or {}
    out = {}
    for key, arr in flat.items():
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:      # e.g. np.asarray of a JAX array
            arr = arr.copy()
        if dtype_map.get(key) == _BF16 or _is_bf16_numpy(arr):
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        elif key in dtype_map:
            raise TypeError(f"leaf {key!r}: unsupported stored type "
                            f"{dtype_map[key]!r}")
        else:
            t = torch.from_numpy(arr)
        out[key] = t.to(dev)
    return unflatten_paths(out)


def params_to_numpy(params) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Inverse of :func:`params_from_numpy`: ``(flat, dtype_map)`` with
    bfloat16 leaves as ``uint16`` views named in ``dtype_map``."""
    flat, dtype_map = {}, {}
    for key, t in flatten_with_paths(params).items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            flat[key] = t.view(torch.int16).numpy().view(np.uint16)
            dtype_map[key] = _BF16
        else:
            flat[key] = t.numpy()
    return flat, dtype_map


# ----------------------------------------------------------------------
# files
def save_pytree(path: str, params, metadata: Optional[dict] = None) -> None:
    """Atomic save in the reference layout: temp file in the same
    directory, then rename."""
    flat, dtype_map = params_to_numpy(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    meta = {"treedef": "repro_torch", "dtype_map": dtype_map,
            **(metadata or {})}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def read_pytree(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """A checkpoint's leaves read into host arrays: ``(flat, dtype_map)``,
    as :func:`params_from_numpy` takes them."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    return flat, meta.get("dtype_map", {})


def load_pytree(path: str, device: DeviceLike = "cuda") -> Any:
    """Load a checkpoint written by either package onto ``device``."""
    flat, dtype_map = read_pytree(path)
    return params_from_numpy(flat, device, dtype_map)
