"""Checkpoints in the JAX package's on-disk format (port of
``repro/training/checkpoint.py``): a directory holding ``arrays.npz``,
leaf ``i`` of the tree in JAX's flatten order stored as ``a{i}``, and
``manifest.msgpack``, a map ``{"treedef": str, "n_leaves": int,
"dtypes": [str]}``.  The port reads JAX's checkpoints and JAX's
``load_checkpoint`` reads the port's.

Trees are in the JAX layout (``bridge.to_numpy`` gives it and
``bridge.params_from_jax`` / ``draft_params_from_jax`` /
``eagle_params_from_jax`` take it): the port's own params save as they
are, their derived ``unembed_f32`` left out.  A bf16 leaf is stored as
NumPy writes JAX's ``ml_dtypes.bfloat16`` arrays, two raw bytes an
element (``|V2``), named ``bfloat16`` in the manifest; the port reads
them back by their bits.

The machine with the card has no ``msgpack``: ``packb``/``unpackb`` are
the port's own, for the manifest's few types (a map of str keys, str,
int, an array of str).
"""
from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np
import torch

from repro_torch.training.pytree import (tree_leaves, tree_unflatten,
                                         treedef_str)

# ---------------------------------------------------------------------------
# msgpack: the subset the manifest uses
# ---------------------------------------------------------------------------


def _pack_len(n: int, fix: int, fix_max: int, tags: tuple) -> bytes:
    if n <= fix_max:
        return bytes([fix | n])
    for tag, fmt in zip(tags, (">B", ">H", ">I")):
        if tag is not None and n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too long")


def packb(obj) -> bytes:
    """msgpack bytes of ``obj`` (a dict with str keys, str, int, list or
    tuple of these), as ``msgpack.packb`` writes them."""
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"msgpack: the manifest holds no {obj!r}")
    if isinstance(obj, int):
        if 0 <= obj < 128:
            return bytes([obj])
        if -32 <= obj < 0:
            return struct.pack(">b", obj)
        for tag, fmt in ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"),
                         (0xcf, ">Q")) if obj > 0 else (
                (0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"), (0xd3, ">q")):
            try:
                return bytes([tag]) + struct.pack(fmt, obj)
            except struct.error:
                continue
        raise ValueError(f"msgpack: int {obj} out of range")
    if isinstance(obj, str):
        b = obj.encode("utf-8")
        return _pack_len(len(b), 0xa0, 31, (0xd9, 0xda, 0xdb)) + b
    if isinstance(obj, (list, tuple)):
        return (_pack_len(len(obj), 0x90, 15, (None, 0xdc, 0xdd))
                + b"".join(packb(v) for v in obj))
    if isinstance(obj, dict):
        out = _pack_len(len(obj), 0x80, 15, (None, 0xde, 0xdf))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError("msgpack: map keys must be str")
            out += packb(k) + packb(v)
        return out
    raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def unpackb(data: bytes):
    """The object of msgpack bytes holding maps, arrays, str and ints."""
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError("msgpack: trailing bytes")
    return obj


_SIZED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_STR = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
_ARRAY = {0xdc: ">H", 0xdd: ">I"}
_MAP = {0xde: ">H", 0xdf: ">I"}


def _read(buf, at: int, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, bytes(buf[at:at + size]))[0], at + size


def _unpack(buf, at: int):
    tag = buf[at]
    at += 1
    if tag < 0x80:
        return tag, at
    if tag >= 0xe0:
        return tag - 0x100, at
    if tag in _SIZED:
        return _read(buf, at, _SIZED[tag])
    if 0xa0 <= tag <= 0xbf or tag in _STR:
        n, at = ((tag & 0x1f), at) if tag < 0xc0 else _read(buf, at,
                                                             _STR[tag])
        return bytes(buf[at:at + n]).decode("utf-8"), at + n
    if 0x90 <= tag <= 0x9f or tag in _ARRAY:
        n, at = ((tag & 0x0f), at) if tag < 0xa0 else _read(buf, at,
                                                             _ARRAY[tag])
        out = []
        for _ in range(n):
            v, at = _unpack(buf, at)
            out.append(v)
        return out, at
    if 0x80 <= tag <= 0x8f or tag in _MAP:
        n, at = ((tag & 0x0f), at) if tag < 0x90 else _read(buf, at,
                                                             _MAP[tag])
        out = {}
        for _ in range(n):
            k, at = _unpack(buf, at)
            out[k], at = _unpack(buf, at)
        return out, at
    raise ValueError(f"msgpack: type byte {tag:#x} is not in the manifest's "
                     "subset")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _to_numpy(leaf: torch.Tensor) -> tuple:
    """(array to store, dtype name) of one leaf."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:           # stored as NumPy stores JAX's
        bits = t.contiguous().view(torch.int16).numpy()
        return bits.view(np.dtype("V2")), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_checkpoint(path: str, pytree: Any) -> None:
    """Saves ``pytree`` (tensors, JAX layout) at ``path``, a directory
    made if missing."""
    os.makedirs(path, exist_ok=True)
    stored = [_to_numpy(leaf) for leaf in tree_leaves(pytree)]
    np.savez(os.path.join(path, "arrays.npz"),
             **{f"a{i}": a for i, (a, _) in enumerate(stored)})
    meta = {"treedef": treedef_str(pytree), "n_leaves": len(stored),
            "dtypes": [name for _, name in stored]}
    with open(os.path.join(path, "manifest.msgpack"), "wb") as f:
        f.write(packb(meta))


def _restore(arr: np.ndarray, name: str, like: torch.Tensor):
    """Stored array ``arr`` (manifest dtype ``name``) as a tensor on
    ``like``'s device in its dtype."""
    if name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors; shapes
    must match, dtypes and devices are ``like``'s).  Returns a tree in the JAX layout (the
    derived ``unembed_f32`` of port params left out: rebuild it with
    ``models/model.py::add_unembed_f32``, or convert through the
    bridge)."""
    data = np.load(os.path.join(path, "arrays.npz"))
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        meta = unpackb(f.read())
    leaves = tree_leaves(like)
    if meta["n_leaves"] != len(leaves):
        raise ValueError(f"structure mismatch: the checkpoint holds "
                         f"{meta['n_leaves']} leaves, the tree {len(leaves)}")
    out = []
    for i, (leaf, name) in enumerate(zip(leaves, meta["dtypes"])):
        arr = data[f"a{i}"]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"leaf {i}: ckpt {arr.shape} vs model "
                             f"{tuple(leaf.shape)}")
        out.append(_restore(arr, name, leaf))
    return tree_unflatten(like, out)
