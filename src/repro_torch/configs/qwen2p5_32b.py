"""Qwen2.5-32B — dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""
from repro_torch.configs.base import DraftConfig, ModelConfig, register

QWEN2P5_32B = register(ModelConfig(
    name="qwen2.5-32b",
    arch_type="dense",
    source="hf:Qwen/Qwen2.5-0.5B",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    max_seq_len=32768,
    draft=DraftConfig(kind="hydra++", n_heads=4, n_mlp_layers=4,
                      prefix_attention=True),
))
