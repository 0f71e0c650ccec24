"""DeepSeekMoE-16B — 2 shared + 64 routed top-6 fine-grained experts
[arXiv:2401.06066].

As the JAX config declares it (``repro/configs/deepseek_moe_16b.py``):
the dense first layer's FFN is ``d_ff`` = 1408 wide, not the 10944 of
the published checkpoint."""
from repro_torch.configs.base import DraftConfig, MoEConfig, ModelConfig, register

DEEPSEEK_MOE_16B = register(ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    source="arXiv:2401.06066",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert=1408,
                  n_dense_layers=1),
    max_seq_len=16384,
    draft=DraftConfig(kind="hydra++", n_heads=4, n_mlp_layers=4,
                      prefix_attention=True),
))
