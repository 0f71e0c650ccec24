"""Config system for the PyTorch port of the Hydra reproduction.

A copy of ``repro/configs/base.py`` (the port imports nothing of the JAX
package): the same frozen dataclasses, so a config prints and hashes the
same on both sides and the parity tests can hand one object to both.
``reduced()`` returns the CPU smoke-test variant of the same family
(<=2 layers, d_model<=512, <=4 experts).  The registry holds the
architectures of ``ARCH_MODULES``: all of the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN config (DeepSeek-style shared+routed)."""

    n_routed: int = 64
    n_shared: int = 2
    top_k: int = 6
    d_expert: int = 1408
    # layers whose FFN is dense instead of MoE (DeepSeek: first layer dense)
    n_dense_layers: int = 1
    router_aux_coef: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 => full-rank q projection (V2-Lite)
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """State-space / linear-attention config (Mamba2 SSD and RWKV6)."""

    d_state: int = 64
    expand: int = 2
    head_dim: int = 64            # SSD head dim
    conv_width: int = 4
    chunk_size: int = 64          # chunked-scan block length
    # rwkv6 only
    rwkv_head_dim: int = 64


@dataclass(frozen=True)
class DraftConfig:
    """Draft-head (Medusa/Hydra/Hydra++) config — the paper's §3/§3.1."""

    kind: str = "hydra"           # 'medusa' | 'hydra' | 'hydra++'
    n_heads: int = 4              # speculation length K
    n_mlp_layers: int = 1         # hydra++ uses 4
    prefix_attention: bool = False  # hydra++: extra decoder layer
    tie_unembed: bool = True      # share the base lm_head for head logits
    tree_size: int = 16           # nodes in the static candidate tree
    max_children: int = 4


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"      # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""              # citation

    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0             # 0 => d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    rope_theta: float = 10000.0
    qkv_bias: bool = False
    rms_eps: float = 1e-5
    tie_embeddings: bool = False

    # OPTIMIZED-variant knob (§Perf): pad q-heads up to a multiple of the
    # tensor-parallel axis so GSPMD shards at head boundaries (checkpoint
    # conversion zero-pads wo rows => function-identical). 0 = off.
    pad_q_heads_to: int = 0

    # sliding-window attention: per-layer window; 0 => full attention.
    # pattern repeats: e.g. gemma3 (512,512,512,512,512,0) = 5 local : 1 global
    window_pattern: Tuple[int, ...] = (0,)
    max_seq_len: int = 8192

    # encoder-only (hubert): bidirectional attention, no cache/decode
    encoder_only: bool = False
    # modality frontend stub: 'text' | 'audio' | 'vlm'
    modality: str = "text"

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # hybrid (zamba2): ssm backbone with a SHARED attention block invoked
    # every `hybrid_attn_every` layers (weights reused, distinct KV cache slot)
    hybrid_attn_every: int = 0

    # block kinds per layer for ssm/hybrid: 'attn' | 'mamba2' | 'rwkv6'
    block_kind: str = "attn"

    draft: DraftConfig = field(default_factory=DraftConfig)
    dtype: str = "bfloat16"

    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def n_heads_padded(self) -> int:
        if not self.pad_q_heads_to:
            return self.n_heads
        m = self.pad_q_heads_to
        return -(-self.n_heads // m) * m

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def window_for_layer(self, i: int) -> int:
        return self.window_pattern[i % len(self.window_pattern)]

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch legally supports the 500k decode shape."""
        if self.block_kind in ("mamba2", "rwkv6"):
            return True
        if self.hybrid_attn_every:
            return True
        return any(w > 0 for w in self.window_pattern)

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    @property
    def n_params(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS=6ND)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.block_kind == "rwkv6":
            per_layer = 4 * d * d + 2 * d * self.d_ff + 10 * d  # timemix + chanmix
        elif self.block_kind == "mamba2":
            s = self.ssm
            d_in = s.expand * d
            per_layer = d * (2 * d_in + 2 * self.n_heads * 0 + 2 * s.d_state * 2) + d_in * d
            per_layer += 2 * d * self.d_ff if self.d_ff else 0
        else:
            qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
            o = self.n_heads * hd * d
            if self.mla:
                m = self.mla
                qkv = d * (m.kv_lora_rank + m.qk_rope_dim) + d * self.n_heads * (
                    m.qk_nope_dim + m.qk_rope_dim
                ) + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                o = self.n_heads * m.v_head_dim * d
            per_layer = qkv + o
            if self.moe:
                mo = self.moe
                dense = 3 * d * self.d_ff * mo.n_dense_layers
                shared = 3 * d * mo.d_expert * mo.n_shared
                routed = 3 * d * mo.d_expert * mo.n_routed
                per_layer += (dense + (shared + routed) * (L - mo.n_dense_layers)) // L
            else:
                per_layer += 3 * d * self.d_ff
        return emb + L * per_layer

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: shared + top_k experts only)."""
        if not self.moe:
            return self.n_params
        d, L = self.d_model, self.n_layers
        mo = self.moe
        full_routed = 3 * d * mo.d_expert * mo.n_routed * (L - mo.n_dense_layers)
        act_routed = 3 * d * mo.d_expert * mo.top_k * (L - mo.n_dense_layers)
        return self.n_params - full_routed + act_routed

    # ---- smoke-test variant -------------------------------------------------
    def reduced(self) -> "ModelConfig":
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=64,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            max_seq_len=512,
            draft=replace(self.draft, tree_size=min(self.draft.tree_size, 8)),
        )
        if self.n_kv_heads == self.n_heads:
            kw["n_kv_heads"] = kw["n_heads"]
        if self.moe:
            kw["moe"] = replace(
                self.moe, n_routed=4, n_shared=1, top_k=2, d_expert=128,
                n_dense_layers=min(self.moe.n_dense_layers, 1),
            )
        if self.mla:
            kw["mla"] = replace(
                self.mla, kv_lora_rank=64, qk_rope_dim=16, qk_nope_dim=32,
                v_head_dim=32,
            )
        if self.ssm:
            kw["ssm"] = replace(self.ssm, d_state=16, chunk_size=16)
        if self.hybrid_attn_every:
            kw["hybrid_attn_every"] = 1
        if len(self.window_pattern) > 1:
            kw["window_pattern"] = (64, 0)
        elif self.window_pattern != (0,):
            kw["window_pattern"] = (64,)
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


# dense GQA stacks (full-attention or sliding-window, with or without QKV
# bias; chameleon-34b's early-fusion VLM is one over token ids), GQA and
# MLA under the MoE FFN, the RWKV6 recurrent stack, zamba2's hybrid
# (Mamba2 layers with a shared attention block) and the encoder-only
# hubert (a bidirectional stack over frame embeddings): the whole registry
ARCH_MODULES = ["chameleon_34b", "deepseek_moe_16b", "deepseek_v2_lite_16b",
                "gemma3_1b", "hubert_xlarge", "minitron_4b", "qwen2p5_32b",
                "rwkv6_1p6b", "starcoder2_7b", "vicuna_tiny", "zamba2_1p2b"]


def _load_all() -> None:
    import importlib

    for m in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def head_preserving(cfg: ModelConfig) -> ModelConfig:
    """``cfg.reduced()`` with the published head counts and tree kept: 2
    layers, d_model 256, head_dim 64, small FFN, experts and vocabulary,
    but ``n_heads``/``n_kv_heads`` as published (``reduced()`` caps them
    at 4/2) and the draft's ``tree_size``, so a verify step has the G*T
    query rows per kv head the full model has (144 at starcoder2-7b's 36
    over 4 heads and T = 16).  Uses only ``dataclasses.replace``, so it
    narrows the JAX package's config objects alike."""
    r = cfg.reduced()
    return replace(r, name=cfg.name + "-narrow", n_heads=cfg.n_heads,
                   n_kv_heads=cfg.n_kv_heads,
                   draft=replace(r.draft, tree_size=cfg.draft.tree_size))


def tree_for(cfg: ModelConfig):
    """The static candidate tree a config decodes with (copy of
    ``repro/launch/specs.py::tree_for``): chain speculation for the
    recurrent families, the default tree otherwise; None for
    encoder-only models."""
    from repro_torch.core.trees import chain_tree, default_tree

    if not cfg.supports_decode:
        return None
    if cfg.block_kind in ("mamba2", "rwkv6"):
        return chain_tree(cfg.draft.n_heads)
    return default_tree(cfg.draft.tree_size, cfg.draft.max_children,
                        cfg.draft.n_heads)
