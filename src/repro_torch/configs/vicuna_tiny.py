"""Tiny Vicuna/LLaMA-style base model — the paper's own experimental substrate
at container scale. Used by the functional benchmarks (Fig 2/3/4, Table 1)
where we train base + heads from scratch on the synthetic conversation corpus.
"""
from repro_torch.configs.base import DraftConfig, ModelConfig, register

VICUNA_TINY = register(ModelConfig(
    name="vicuna-tiny",
    arch_type="dense",
    source="paper §5 (Vicuna family), container-scale stand-in",
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=64,
    d_ff=1024,
    vocab_size=2048,
    max_seq_len=1024,
    draft=DraftConfig(kind="hydra", n_heads=4, n_mlp_layers=1,
                      prefix_attention=False, tree_size=16),
))
