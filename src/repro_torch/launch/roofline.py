"""Roofline terms of one step (port of ``repro/launch/hlo_analysis.py``).

Roofline terms (one H100, per step; ``launch/mesh.py``'s constants):
  compute    = sum over dtypes of flops / that dtype's peak (the op
               counter's ``compute_s``: a hand-written kernel's call adds
               its charge's least operations time instead)
  memory     = bytes per device / HBM
  collective = collective bytes per device / the NVLink rate

``collective_bytes`` (JAX's parser of the collectives in post-SPMD HLO)
has no counterpart: the port runs no step across devices, so it has no
collective to count, and the dry run records ``collective_bytes_per_dev``
as null with the reason.  ``analytic_min_bytes``, ``_cache_bytes_dev`` and
``model_flops`` are JAX's arithmetic, copied.
"""
from __future__ import annotations

from repro_torch.configs.base import tree_for
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW


def roofline_terms(compute_s: float, bytes_per_device: float,
                   coll_bytes_per_device: float = 0.0) -> dict:
    """The three roofline times in seconds + the bottleneck."""
    terms = {"compute_s": compute_s,
             "memory_s": bytes_per_device / HBM_BW,
             "collective_s": coll_bytes_per_device / NVLINK_BW}
    terms["bottleneck"] = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    return terms


def analytic_min_bytes(cfg, shape, n_chips: int, model_shards: int) -> float:
    """Per-device HBM-traffic LOWER BOUND assuming ideal kernels (score
    matrices kept on chip):

      train:   3 param passes (fwd read, bwd read, grad write) in bf16 +
               AdamW state read/write (16B/param fp32) + param write +
               ~24 activation r/w passes of (tokens x d) per layer
      prefill: 1 param pass + 4 activation passes/layer + cache write
      decode:  1 param pass + full KV/state-cache read + tree activations
    """
    p_dev = cfg.n_params * 2 / model_shards            # bf16, data-replicated
    p_active_dev = cfg.n_active_params * 2 / model_shards
    data_shards = max(n_chips // model_shards, 1)
    tok_dev = shape.global_batch * shape.seq_len / data_shards
    act = tok_dev * cfg.d_model * 2                    # one (tokens, d) pass
    if shape.kind == "train":
        return (3 * p_dev + (cfg.n_params * 18 / model_shards)
                + 24 * act * cfg.n_layers / 8)
    if shape.kind == "prefill":
        cache_write = _cache_bytes_dev(cfg, shape, data_shards, model_shards)
        return p_active_dev + 4 * act * cfg.n_layers / 8 + cache_write
    # decode: weights + cache dominate
    cache = _cache_bytes_dev(cfg, shape, data_shards, model_shards)
    return p_active_dev + cache


def _cache_bytes_dev(cfg, shape, data_shards, model_shards) -> float:
    B, S = shape.global_batch, shape.seq_len
    per_tok = 0.0
    if cfg.block_kind == "rwkv6":
        H = cfg.n_heads
        hd = cfg.d_model // H
        return cfg.n_layers * B * (H * hd * hd * 4 + 2 * cfg.d_model * 2) \
            / data_shards
    if cfg.block_kind == "mamba2":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        H = d_in // s.head_dim
        state = cfg.n_layers * B * H * s.d_state * s.head_dim * 4
        attn_tok = 0.0
        if cfg.hybrid_attn_every:
            n_inv = -(-cfg.n_layers // cfg.hybrid_attn_every)
            attn_tok = n_inv * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
        return (state + B * S * attn_tok) / data_shards
    if cfg.mla:
        per_tok = cfg.n_layers * (cfg.mla.kv_lora_rank
                                  + cfg.mla.qk_rope_dim) * 2
    else:
        kv_shard = model_shards if (cfg.n_kv_heads % model_shards == 0) else 1
        per_tok = cfg.n_layers * 2 * cfg.n_kv_heads * \
            cfg.resolved_head_dim * 2 / kv_shard
        # sliding-window layers only read `window` tokens
        if any(w > 0 for w in cfg.window_pattern):
            n_local = sum(1 for i in range(cfg.n_layers)
                          if cfg.window_for_layer(i) > 0)
            w = max(cfg.window_pattern)
            frac = (cfg.n_layers - n_local) / cfg.n_layers + \
                n_local / cfg.n_layers * min(1.0, w / S)
            per_tok *= frac
    return B * S * per_tok / data_shards


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); decode shapes use
    the tree/chain token count as D per step."""
    n = cfg.n_active_params
    if shape.kind == "train":
        tok = shape.global_batch * shape.seq_len
        return 6.0 * n * tok
    if shape.kind == "prefill":
        tok = shape.global_batch * shape.seq_len
        return 2.0 * n * tok
    # decode: one speculative step over T tree tokens
    t = tree_for(cfg)
    tok = shape.global_batch * (t.size if t else 1)
    return 2.0 * n * tok
