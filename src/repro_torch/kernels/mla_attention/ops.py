"""Model-layout wrapper of the absorbed-MLA paged tree-verify kernel K5
(port of ``repro/kernels/attention_template/ops.py::
mla_attention_paged_bshd``), with its window hook.

The wrapper validates what the kernel takes and dispatches on the device
the tensors lie on: CPU tensors take the plain version (``ref.py``), with
the tree axis T (and ``q_pos``) padded to a multiple of 8 as the JAX
wrapper pads it (pad rows self-attend at position 0; their outputs are
sliced away); CUDA tensors launch the kernel, which takes any T up to 16
unpadded, or raise; ``meta`` tensors charge the cost counter one call
(``launch/op_cost.py``) and return an empty output.  There is no fallback
from one to the other.  As in JAX, ``window`` (with ``q_pos``) windows
the scores and a window <= 0 is an exact no-op; on CUDA it launches the
kernel's windowed form.  ``launches`` counts kernel launches, and only
those: one per call, the split cache sweep; ``merge_launches`` counts the
merge kernel each call launches after it, and ``f32_launches`` the calls
of the fp32 build.  The split length comes from
``kernels/tree_attention/split.py::plan_mla_split_len`` unless the caller
forces one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.mla_attention import kernel as _k
from repro_torch.kernels.mla_attention.ref import mla_attention_paged_plain
from repro_torch.kernels.tree_attention.ops import (T_PAD, check_split_len,
                                                    pad_tree_mask)
from repro_torch.kernels.tree_attention.split import plan_mla_split_len
from repro_torch.launch.op_cost import dtype_name, mla_charge, record_kernel

launches = 0                  # split-sweep launches since the last reset
merge_launches = 0            # merge launches since the last reset
f32_launches = 0              # launches of an fp32 build (not reset by
                              # kernels.reset_counts)


def _pad_axis1(t, Tp: int):
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, Tp - t.shape[1]))


def _check(q_lat, q_rope, pool_lat, pool_rope, tree_lat, tree_rope,
           tree_mask, cache_len, block_table):
    B, T, H, r = q_lat.shape
    rd = q_rope.shape[-1]
    if q_rope.shape != (B, T, H, rd):
        raise ValueError(f"q_rope must be {(B, T, H, rd)}, got "
                         f"{tuple(q_rope.shape)}")
    if pool_lat.dim() != 3 or pool_lat.shape[2] != r \
            or pool_rope.shape != pool_lat.shape[:2] + (rd,):
        raise ValueError(f"pools must be (N, bs, {r}) and (N, bs, {rd}), "
                         f"got {tuple(pool_lat.shape)} / "
                         f"{tuple(pool_rope.shape)}")
    if tree_lat.shape != (B, T, r) or tree_rope.shape != (B, T, rd):
        raise ValueError(f"tree latents must be {(B, T, r)} and "
                         f"{(B, T, rd)}, got {tuple(tree_lat.shape)} / "
                         f"{tuple(tree_rope.shape)}")
    if tree_mask.shape != (T, T) or tree_mask.dtype != torch.bool:
        raise ValueError(f"tree_mask must be ({T}, {T}) bool")
    if cache_len.shape != (B,) or block_table.dim() != 2 \
            or block_table.shape[0] != B:
        raise ValueError("cache_len must be (B,) and block_table (B, M)")
    if pool_lat.shape[1] % 8 != 0:
        raise ValueError(f"pool block_size {pool_lat.shape[1]} must be a "
                         "multiple of 8")


def _check_cuda(q_lat, q_rope, pool_lat, pool_rope, tree_lat, tree_rope,
                tree_mask, cache_len, block_table):
    tensors = (q_lat, q_rope, pool_lat, pool_rope, tree_lat, tree_rope,
               tree_mask, cache_len, block_table)
    if any(t.device != q_lat.device for t in tensors):
        raise ValueError("all operands must lie on one CUDA device")
    if q_lat.dtype != torch.float32 or q_rope.dtype != torch.float32:
        raise ValueError(f"q_lat and q_rope must be float32, got "
                         f"{q_lat.dtype} / {q_rope.dtype}")
    if pool_lat.dtype not in _k.KV_DTYPE_CODES:
        raise ValueError(f"unsupported pool dtype {pool_lat.dtype}")
    if any(t.dtype != pool_lat.dtype
           for t in (pool_rope, tree_lat, tree_rope)):
        raise ValueError("the pools and tree latents must share one dtype")
    if cache_len.dtype != torch.int32 or block_table.dtype != torch.int32:
        raise ValueError("cache_len and block_table must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous operands only")
    widths = (pool_lat.shape[2], pool_rope.shape[2])
    if widths not in _k.WIDTHS:
        raise ValueError(f"latent and rope widths {widths} not in "
                         f"{_k.WIDTHS}")
    if q_lat.shape[1] > _k.MAX_TREE:
        raise ValueError(f"{q_lat.shape[1]} tree rows exceed the kernel's "
                         f"{_k.MAX_TREE}")


def mla_attention_paged_bshd(q_lat, q_rope, pool_lat, pool_rope, tree_lat,
                             tree_rope, tree_mask, cache_len, block_table, *,
                             scale: float, q_pos=None, window=None,
                             split_len: int | None = None):
    """q_lat: (B,T,H,r) = q_nope @ w_uk (absorbed); q_rope: (B,T,H,rd);
    pool_lat: (N,bs,r) and pool_rope: (N,bs,rd), streamed in place, never
    gathered on the card; tree_lat: (B,T,r); tree_rope: (B,T,rd);
    tree_mask (T,T) bool; cache_len (B,) and block_table (B,M) int32.
    ``scale`` is the absorbed score scale 1/sqrt(nd + rd): NOT derivable
    from the latent ranks.  ``window`` (int; <= 0 means full attention)
    with ``q_pos`` (B,T) absolute query positions windows the scores, as
    JAX's hook does: row t admits cache position k only if ``q_pos[b, t]
    - k < window``, tree key j sitting at ``cache_len + j``; every real
    row must sit at ``q_pos >= cache_len``.  ``split_len`` forces the
    kernel's split (a multiple of 16; default: the planner's).  Returns
    o_lat (B,T,H,r) in q_lat's dtype (fp32 on the card)."""
    global launches, merge_launches, f32_launches
    refuse_grad("mla_attention_paged", q_lat, q_rope, pool_lat, pool_rope,
                tree_lat, tree_rope)
    windowed = window is not None
    if windowed and q_pos is None:
        raise ValueError("windowed MLA requires q_pos alongside window")
    _check(q_lat, q_rope, pool_lat, pool_rope, tree_lat, tree_rope,
           tree_mask, cache_len, block_table)
    B, T, H, r = q_lat.shape
    if windowed:
        if q_pos.shape != (B, T):
            raise ValueError(f"q_pos must be {(B, T)}, got "
                             f"{tuple(q_pos.shape)}")
        win = dict(q_pos=q_pos.to(torch.int32), window=int(window))
    else:
        win = {}
    if q_lat.device.type == "cpu":
        Tp = -(-T // T_PAD) * T_PAD
        if Tp != T:
            q_lat, q_rope, tree_lat, tree_rope = (
                _pad_axis1(t, Tp)
                for t in (q_lat, q_rope, tree_lat, tree_rope))
            tree_mask = pad_tree_mask(tree_mask, Tp)
            if windowed:
                win["q_pos"] = F.pad(win["q_pos"], (0, Tp - T))
        out = mla_attention_paged_plain(
            q_lat, q_rope, pool_lat, pool_rope, tree_lat, tree_rope,
            tree_mask, cache_len, block_table, scale=scale, **win)
        return out[:, :T]
    if q_lat.device.type not in ("cuda", "meta"):
        raise ValueError(f"no mla_attention_paged for device "
                         f"{q_lat.device}")
    q_lat = q_lat.contiguous()
    q_rope = q_rope.to(torch.float32).contiguous()
    tree_lat = tree_lat.to(pool_lat.dtype).contiguous()
    tree_rope = tree_rope.to(pool_rope.dtype).contiguous()
    args = (q_lat, q_rope, pool_lat, pool_rope, tree_lat, tree_rope,
            tree_mask, cache_len, block_table)
    _check_cuda(*args)
    if windowed:
        if win["q_pos"].device != q_lat.device:
            raise ValueError("q_pos must lie on the operands' device")
        win["q_pos"] = win["q_pos"].contiguous()
    if split_len is None:
        split_len = plan_mla_split_len(B, H, T, r, q_rope.shape[-1])
    check_split_len(split_len)
    out = torch.empty((B, T, H, r), dtype=torch.float32,
                      device=q_lat.device)
    if q_lat.device.type == "meta":
        # at capacity, M blocks of block_size positions a slot, windowed
        # or not; the merge's scratch is allocated as the launch
        # allocates it
        M, bs = block_table.shape[1], pool_lat.shape[1]
        _k.scratch(B, T, H, r, M * bs, split_len, q_lat.device)
        shape = dict(B=B, T=T, H=H, r=r, rd=q_rope.shape[-1],
                     dtype=dtype_name(pool_lat.dtype), keys=[M * bs] * B,
                     table_entries=B * M)
        record_kernel("mla_attention_paged", mla_charge(**shape),
                      block_size=bs, **shape)
        return out
    rc = _k.launch(*args, out, scale=scale, split_len=split_len, **win)
    if rc != 0:
        raise RuntimeError(f"mla_attention_paged launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    merge_launches += 1
    f32_launches += pool_lat.dtype == torch.float32
    return out
