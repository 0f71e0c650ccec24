"""StarCoder2-7B — dense GQA + RoPE [arXiv:2402.19173]."""
from repro_torch.configs.base import DraftConfig, ModelConfig, register

STARCODER2_7B = register(ModelConfig(
    name="starcoder2-7b",
    arch_type="dense",
    source="arXiv:2402.19173",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    rope_theta=1000000.0,
    max_seq_len=16384,
    draft=DraftConfig(kind="hydra++", n_heads=4, n_mlp_layers=4,
                      prefix_attention=True),
))
