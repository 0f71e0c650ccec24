"""DeepSeek-V2-Lite (16B) — MLA kv_lora=512, 2 shared + 64 routed top-6
fine-grained MoE [arXiv:2405.04434].

As the JAX config declares it (``repro/configs/deepseek_v2_lite_16b.py``):
the dense first layer's FFN is ``d_ff`` = 1408 wide, not the 10944 of
the published checkpoint, and the Hydra++ prefix layer is GQA (16 query
over 16 kv heads at head dim 128)."""
from repro_torch.configs.base import (DraftConfig, MLAConfig, MoEConfig,
                                      ModelConfig, register)

DEEPSEEK_V2_LITE_16B = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    source="arXiv:2405.04434",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert=1408,
                  n_dense_layers=1),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_rope_dim=64,
                  qk_nope_dim=128, v_head_dim=128),
    max_seq_len=32768,
    draft=DraftConfig(kind="hydra++", n_heads=4, n_mlp_layers=4,
                      prefix_attention=True),
))
