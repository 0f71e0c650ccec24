"""Gemma3-1B — 5:1 local(512-window):global attention, 128k-capable
[hf:google/gemma-3-1b-pt]."""
from repro_torch.configs.base import DraftConfig, ModelConfig, register

GEMMA3_1B = register(ModelConfig(
    name="gemma3-1b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    rope_theta=1000000.0,
    window_pattern=(512, 512, 512, 512, 512, 0),   # 5 local : 1 global
    tie_embeddings=True,
    max_seq_len=131072,
    draft=DraftConfig(kind="hydra++", n_heads=4, n_mlp_layers=4,
                      prefix_attention=True),
))
