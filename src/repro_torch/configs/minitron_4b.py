"""Minitron-4B — width/depth-pruned Nemotron [arXiv:2407.14679]."""
from repro_torch.configs.base import DraftConfig, ModelConfig, register

MINITRON_4B = register(ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    source="arXiv:2407.14679",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    rope_theta=10000.0,
    max_seq_len=4096,
    draft=DraftConfig(kind="hydra++", n_heads=4, n_mlp_layers=4,
                      prefix_attention=True),
))
