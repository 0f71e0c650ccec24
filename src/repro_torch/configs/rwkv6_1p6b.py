"""RWKV6 'Finch' 1.6B: attention-free, data-dependent decay [arXiv:2404.05892].

Chain speculation (the candidate tree degenerates to a path): a recurrent
state rolls back by selecting a per-token candidate, not by masking.
"""
from repro_torch.configs.base import (DraftConfig, ModelConfig, SSMConfig,
                                      register)

RWKV6_1P6B = register(ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    source="arXiv:2404.05892",
    n_layers=24,
    d_model=2048,
    n_heads=32,                  # wkv heads = d_model / rwkv_head_dim
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    block_kind="rwkv6",
    ssm=SSMConfig(d_state=64, rwkv_head_dim=64, chunk_size=64),
    max_seq_len=4096,
    draft=DraftConfig(kind="hydra++", n_heads=4, n_mlp_layers=4,
                      prefix_attention=False),
))
