"""Zamba2-1.2B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

Chain speculation (the candidate tree degenerates to a path): the Mamba2
layers' recurrent state rolls back by selecting a per-token candidate.
The shared attention + MLP block follows the JAX package: one weight set
invoked before every run of ``hybrid_attn_every`` Mamba2 layers, each
invocation with its own KV cache slot (no input-embedding concatenation,
no per-invocation LoRA).
"""
from repro_torch.configs.base import (DraftConfig, ModelConfig, SSMConfig,
                                      register)

ZAMBA2_1P2B = register(ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    block_kind="mamba2",
    hybrid_attn_every=6,          # shared attn+MLP block applied every 6 mamba layers
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_width=4, chunk_size=64),
    max_seq_len=4096,
    draft=DraftConfig(kind="hydra++", n_heads=4, n_mlp_layers=4,
                      prefix_attention=False),  # chain speculation
))
