"""HuBERT-XLarge — encoder-only audio transformer [arXiv:2106.07447].

The conv/mel frontend is a STUB: ``forward`` takes precomputed frame
embeddings (B, S, d_model). Encoder-only => no decode shapes, no
speculative decoding: no cache, no engine, no ``generate``.
"""
from repro_torch.configs.base import DraftConfig, ModelConfig, register

HUBERT_XLARGE = register(ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    source="arXiv:2106.07447",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,               # k-means cluster targets
    encoder_only=True,
    modality="audio",
    max_seq_len=4096,
    draft=DraftConfig(kind="medusa", n_heads=0),  # inapplicable
))
