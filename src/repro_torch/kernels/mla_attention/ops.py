"""Model-layout wrapper of the absorbed-MLA paged tree-verify kernel K5
(port of ``repro/kernels/attention_template/ops.py::
mla_attention_paged_bshd``).

The wrapper pads the tree axis T to a multiple of 8 as the JAX wrapper
does (pad rows self-attend; their outputs are sliced away), joins
``[q_lat || q_rope]`` into the kernel's one query operand, validates what
the kernel takes, and dispatches on the device the tensors lie on: CPU
tensors take the plain version (``ref.py``), CUDA tensors launch the
kernel or raise.  There is no fallback from one to the other.
``launches`` counts kernel launches, and only those.  The JAX wrapper's
window hook is not ported: no configuration runs windowed MLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mla_attention import kernel as _k
from repro_torch.kernels.mla_attention.ref import mla_attention_paged_plain
from repro_torch.kernels.tree_attention.ops import T_PAD, pad_tree_mask

launches = 0                  # kernel launches since the last reset


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


def _check_cuda(q, pool_lat, pool_rope, tree_lat, tree_rope, tree_mask,
                cache_len, block_table):
    tensors = (q, pool_lat, pool_rope, tree_lat, tree_rope, tree_mask,
               cache_len, block_table)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must lie on one CUDA device")
    if q.dtype != torch.float32:
        raise ValueError(f"q_lat must be float32, got {q.dtype}")
    if pool_lat.dtype not in _k.KV_DTYPE_CODES:
        raise ValueError(f"unsupported pool dtype {pool_lat.dtype}")
    if pool_rope.dtype != pool_lat.dtype:
        raise ValueError("the two pools must share one dtype")
    if cache_len.dtype != torch.int32 or block_table.dtype != torch.int32:
        raise ValueError("cache_len and block_table must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous operands only")
    if pool_lat.shape[2] > _k.MAX_LATENT:
        raise ValueError(f"latent rank {pool_lat.shape[2]} exceeds the "
                         f"kernel's {_k.MAX_LATENT}")
    if q.shape[-1] % 4 != 0:
        raise ValueError(f"latent + rope width {q.shape[-1]} is not a "
                         "multiple of 4")
    if q.shape[1] > _k.MAX_ROWS:
        raise ValueError(f"{q.shape[1]} (padded) tree rows exceed the "
                         f"kernel's {_k.MAX_ROWS}")


def mla_attention_paged_bshd(q_lat, q_rope, pool_lat, pool_rope, tree_lat,
                             tree_rope, tree_mask, cache_len, block_table, *,
                             scale: float, q_pos=None, window=None):
    """q_lat: (B,T,H,r) = q_nope @ w_uk (absorbed); q_rope: (B,T,H,rd);
    pool_lat: (N,bs,r) and pool_rope: (N,bs,rd), streamed in place, never
    gathered on the card; tree_lat: (B,T,r); tree_rope: (B,T,rd);
    tree_mask (T,T) bool; cache_len (B,) and block_table (B,M) int32.
    ``scale`` is the absorbed score scale 1/sqrt(nd + rd): NOT derivable
    from the latent ranks.  Returns o_lat (B,T,H,r) in q_lat's dtype
    (fp32 on the card)."""
    global launches
    if q_pos is not None or window is not None:
        raise NotImplementedError("windowed MLA verify is not ported "
                                  "(no configuration runs it; ROADMAP)")
    _check(q_lat, q_rope, pool_lat, pool_rope, tree_lat, tree_rope,
           tree_mask, cache_len, block_table)
    T = q_lat.shape[1]
    Tp = -(-T // T_PAD) * T_PAD
    if Tp != T:
        q_lat, q_rope, tree_lat, tree_rope = (
            _pad_axis1(t, Tp) for t in (q_lat, q_rope, tree_lat, tree_rope))
        tree_mask = pad_tree_mask(tree_mask, Tp)
    if q_lat.device.type == "cpu":
        out = mla_attention_paged_plain(
            q_lat, q_rope, pool_lat, pool_rope, tree_lat, tree_rope,
            tree_mask, cache_len, block_table, scale=scale)
    elif q_lat.device.type == "cuda":
        q = torch.cat([q_lat, q_rope.to(q_lat.dtype)], dim=-1)
        tree_lat = tree_lat.to(pool_lat.dtype).contiguous()
        tree_rope = tree_rope.to(pool_rope.dtype).contiguous()
        args = (q, pool_lat, pool_rope, tree_lat, tree_rope, tree_mask,
                cache_len, block_table)
        _check_cuda(*args)
        B, _, H, r = q_lat.shape
        out = torch.empty((B, Tp, H, r), dtype=torch.float32,
                          device=q.device)
        rc = _k.launch(*args, out, scale=scale)
        if rc != 0:
            raise RuntimeError(f"mla_attention_paged launch failed: CUDA "
                               f"error {rc}")
        launches += 1
    else:
        raise ValueError(f"no mla_attention_paged for device "
                         f"{q_lat.device}")
    return out[:, :T]
