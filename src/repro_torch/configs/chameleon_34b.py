"""Chameleon-34B — early-fusion VLM, VQ image tokens [arXiv:2405.09818].

Early fusion means the decoder is a plain token LM over a joint text+image
vocab; the VQ-VAE image tokenizer is a STUB — the port, like the JAX
package, feeds token ids.
"""
from repro_torch.configs.base import DraftConfig, ModelConfig, register

CHAMELEON_34B = register(ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    source="arXiv:2405.09818",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    modality="vlm",
    max_seq_len=8192,
    draft=DraftConfig(kind="hydra++", n_heads=4, n_mlp_layers=4,
                      prefix_attention=True),
))
