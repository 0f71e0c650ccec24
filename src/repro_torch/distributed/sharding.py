"""Sharding rules: map every param / input / cache leaf to a partition
spec (port of ``repro/distributed/sharding.py``; the rules are copied
rule for rule).

Scheme (Megatron-style tensor parallelism):
  * batch dims            -> ('pod','data') on the multi-pod mesh, 'data'
                             on single-pod; dropped when not divisible
                             (e.g. long_500k batch=1 — the SEQUENCE dim of
                             the KV cache shards over the data axes instead)
  * attention qkv/o, MLP up/down, vocab/unembed, MoE experts, RWKV
    projections -> 'model' on the dim listed in _RULES, kept only when the
    dim is divisible by the model-axis size
  * Mamba2 in/out projections stay replicated (mixed z|x|B|C|dt output
    layout does not split cleanly)
  * norms / scalars / routers / draft-head MLPs (small) replicate.

Stacked-layer params (under 'groups') carry a leading layer axis: rules are
written for the logical (unstacked) shape and left-padded with None.

A spec is a tuple with one entry per tensor dim, or ``()`` for a
replicated leaf (JAX's ``P()``): an entry is None (replicated), an axis
name, or a tuple of two or more axis names (a one-name tuple is written
as the name, as JAX's ``PartitionSpec`` normalises it).  A path is the
sequence of keys from the tree's root to a leaf: dict keys and
NamedTuple field names as strings, list indices as ints.  The port-only
leaf ``unembed_f32`` (the fp32 copy of the unembedding,
``models/model.py::add_unembed_f32``) takes the rule of ``unembed``.
Applying these specs to tensors across GPUs is not ported (``launch/
mesh.py``); ``shard_shape`` gives the per-device shape they imply.
"""
from __future__ import annotations

import math
from typing import Tuple

from repro_torch.launch.mesh import Mesh

# rule: param name -> tuple of logical-dim axis names (None = replicate),
# aligned to the TRAILING dims of the leaf.
_RULES = {
    # embeddings / unembeddings
    "embed": ("model", None),         # (V, d): vocab-parallel
    "lm_head": (None, "model"),       # (d, V)
    "unembed": (None, "model"),
    "unembed_f32": (None, "model"),   # port-only: unembed's fp32 copy
    "mask_embed": (None,),
    # attention (GQA)
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "wo": ("model", None),
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    # MLA
    "w_dq": (None, "model"), "w_dkv": (None, "model"),
    "w_krope": (None, None),
    "w_uk": (None, "model"), "w_uv": (None, "model"),
    # MLP (2D) and MoE experts (3D, leading expert dim)
    "w_gate": (None, "model"), "w_up": (None, "model"),
    "w_down": ("model", None),
    "router": (None, None),
    # rwkv6
    "wr": (None, "model"), "wg": (None, "model"),
    "gn_gamma": ("model",), "gn_beta": ("model",),
    "u_bonus": ("model", None),
    "cm_wk": (None, "model"), "cm_wv": ("model", None),
    "cm_wr": (None, "model"),
}

# MoE expert stacks: shard the expert axis instead (expert parallelism)
_MOE_3D = {"w_gate": ("model", None, None), "w_up": ("model", None, None),
           "w_down": ("model", None, None)}

_ATTN_QKVO = {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}


def spec(*axes) -> tuple:
    """A spec from per-dim entries, one-name tuples written as the name."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in axes)


def mesh_axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def batch_axis_size(mesh: Mesh) -> int:
    return math.prod(mesh_axis_size(mesh, a) for a in batch_axes(mesh))


def _axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh_axis_size(mesh, a) for a in axis)
    return mesh_axis_size(mesh, axis)


def _fits(dim: int, mesh: Mesh, axis) -> bool:
    return dim % _axis_size(mesh, axis) == 0


def shard_shape(shape, sp: tuple, mesh: Mesh) -> tuple:
    """The per-device shape of a leaf of ``shape`` under spec ``sp`` (as
    JAX's ``NamedSharding(mesh, P(*sp)).shard_shape``); raises where an
    axis does not divide its dim."""
    out = list(shape)
    for i, axis in enumerate(sp):
        n = _axis_size(mesh, axis)
        if out[i] % n != 0:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {axis} ({n})")
        out[i] //= n
    return tuple(out)


def tree_map_with_path(fn, tree, path: tuple = (), *,
                       specs: bool = False):
    """``fn(path, leaf)`` for every leaf of a tree of dicts, lists and
    tuples (NamedTuples by field name), in a tree of the same layout (None
    stays None).  In a spec tree (``specs``) a plain tuple is a leaf: a
    spec."""
    if tree is None:
        return None
    rec = lambda t, key: tree_map_with_path(fn, t, path + (key,),
                                            specs=specs)
    if isinstance(tree, dict):
        return {k: rec(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [rec(v, i) for i, v in enumerate(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(rec(getattr(tree, f), f) for f in tree._fields))
    if isinstance(tree, tuple) and not specs:
        return tuple(rec(v, i) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves_with_path(tree, *, specs: bool = False) -> list:
    """``[(path, leaf)]`` of every leaf, in the tree's order."""
    out = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree,
                       specs=specs)
    return out


def spec_for_param(path, leaf, mesh: Mesh, *, head_dim: int = 0,
                   replicate_ragged_attn: bool = False) -> tuple:
    keys = [k for k in path if isinstance(k, str)]
    name = keys[-1] if keys else None
    if name is None or name not in _RULES:
        return ()
    rule = _RULES[name]
    if name in _MOE_3D and "moe" in keys and "shared" not in keys:
        rule = _MOE_3D[name]         # routed expert stack: (E, din, dout)
    # Ragged-head guard: sharding the fused (H*hd) projection dim when H
    # doesn't divide the model axis would split HEAD_DIM, turning every
    # attention-score contraction into a cross-device partial-sum
    # all-reduce.  Ragged KV projections replicate (small weights; keeps
    # scores local); the Q/O projections replicate too when asked
    # (``replicate_ragged_attn``: inference only).
    if head_dim and "attn" in keys and name in _ATTN_QKVO:
        mp = mesh_axis_size(mesh, "model")
        fused = leaf.shape[-2] if name == "wo" else leaf.shape[-1]
        n_heads = max(fused // head_dim, 1)
        if n_heads % mp != 0:
            if name in ("wk", "wv", "bk", "bv"):
                return ()
            if replicate_ragged_attn:
                return ()
    nd = leaf.dim()
    if len(rule) > nd:
        return ()
    # left-pad for stack axes, then drop axes that don't divide
    full = (None,) * (nd - len(rule)) + tuple(rule)
    return spec(*(ax if _fits(leaf.shape[i], mesh, ax) else None
                  for i, ax in enumerate(full)))


def params_shardings(params, mesh: Mesh, *, head_dim: int = 0,
                     replicate_ragged_attn: bool = False):
    return tree_map_with_path(
        lambda p, leaf: spec_for_param(
            p, leaf, mesh, head_dim=head_dim,
            replicate_ragged_attn=replicate_ragged_attn), params)


# ---------------------------------------------------------------------------
# activations / caches
# ---------------------------------------------------------------------------


def batch_spec_axis(mesh: Mesh, batch: int):
    """Largest batch sharding that divides: ('pod','data'), ('data',), or
    None."""
    ba = batch_axes(mesh)
    if ba and batch % batch_axis_size(mesh) == 0:
        return ba
    if "data" in mesh.shape and batch % mesh_axis_size(mesh, "data") == 0:
        return ("data",)
    return None


def tokens_sharding(mesh: Mesh, batch: int) -> tuple:
    return spec(batch_spec_axis(mesh, batch), None)


def cache_shardings(cache, mesh: Mesh, batch: int):
    """Cache tree -> specs. Layout conventions (models/model.py):
    attn 'k'/'v': (L, B, S, H, hd) or MLA (L, B, S, r);
    'ssd_state': (L, B, H, dk, dv); 'wkv_state': same;
    'conv_win': (L, B, W-1, C); 'shift_*': (L, B, 1, d).

    batch sharded when divisible; otherwise the cache SEQ dim shards over
    the data axes (long-context decode, batch=1)."""
    b_ax = batch_spec_axis(mesh, batch)
    seq_ax = None if b_ax is not None else batch_axes(mesh) or None
    mp = mesh_axis_size(mesh, "model")

    def leaf_spec(path, leaf):
        names = [k for k in path if isinstance(k, str)]
        name = names[-1] if names else None
        nd = leaf.dim()
        if name in ("k", "v"):
            off = 1  # model caches always carry a leading layer axis
            axes = [None] * nd
            axes[off] = b_ax
            axes[off + 1] = seq_ax
            if nd - off == 4 and leaf.shape[off + 2] % mp == 0:
                axes[off + 2] = "model"          # head axis
            elif nd - off == 3 and leaf.shape[off + 2] % mp == 0:
                axes[off + 2] = "model"          # MLA latent rank
            elif (seq_ax is None and nd - off == 4
                  and leaf.shape[off + 1] % mp == 0):
                # ragged KV heads: flash-decoding-style SEQUENCE sharding
                # of the cache over the model axis
                axes[off + 1] = "model"
            return spec(*axes)
        if name in ("ssd_state", "wkv_state"):
            axes = [None] * nd
            axes[1] = b_ax
            if name == "wkv_state" and leaf.shape[2] % mp == 0:
                axes[2] = "model"                # rwkv heads are sharded
            return spec(*axes)
        if name in ("conv_win", "shift_tm", "shift_cm"):
            axes = [None] * nd
            axes[1] = b_ax
            return spec(*axes)
        return ()

    return tree_map_with_path(leaf_spec, cache)


def replicated(mesh: Mesh) -> tuple:
    return ()


def sharded_bytes(tree, specs, mesh: Mesh) -> int:
    """Bytes one device holds of ``tree`` under ``specs`` (a spec tree;
    a leaf it has no spec for is replicated): each leaf's shard shape
    times its element size."""
    sp = dict(tree_leaves_with_path(specs, specs=True))
    return sum(math.prod(shard_shape(leaf.shape, sp.get(path, ()), mesh))
               * leaf.element_size()
               for path, leaf in tree_leaves_with_path(tree))
