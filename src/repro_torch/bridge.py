"""Parameters from the JAX package, as nested dicts/lists of numpy arrays.

The parity tests initialise params in JAX and hand them over with
``jax.tree_util.tree_map(np.asarray, params)``; this module turns such a
tree into the port's params, so the bridge itself needs no JAX.  The port
keeps the JAX layout, so conversion is leaf by leaf, with checks of the
parts whose layout matters:

* ``groups``: one entry per group of ``group_program`` (an MoE config has
  a dense group and then an MoE group, whose routed experts are
  ``(L, E, ...)`` leaves; an RWKV6 config one ``rwkv_stack`` group of
  ``{norm1, norm2, rwkv}`` layers; zamba2 ``mamba_stack`` groups of
  ``{norm, mamba}`` layers, every Mamba2 leaf present, between empty
  ``shared_attn`` entries), every leaf stacked on a leading ``(L, ...)``
  layer axis.  A GQA layer's projections (under a dense or an MoE FFN)
  are checked against the config's heads: ``wq (L, d, Hq*D)``,
  ``wk``/``wv (L, d, Hkv*D)``, ``wo (L, Hq*D, d)``, and the QKV biases
  ``bq (L, Hq*D)``, ``bk``/``bv (L, Hkv*D)`` present exactly when
  ``cfg.qkv_bias`` (qwen2.5-32b);
* ``shared_attn`` (zamba2): the one shared attention + MLP layer, checked
  as a GQA layer with no layer axis, present exactly when the program has
  ``shared_attn`` groups;
* ``lm_head``: stored as ``(d, V)`` (JAX inits it as ``embed_init(...).T``),
  and the fp32 unembedding the port derives from it at load;
* ``mask_embed (d,)``: the masked-prediction embedding of an audio config
  (hubert-xlarge), present exactly when ``cfg.modality == "audio"``;
* draft params: a list of per-head dicts (``w_in``, ``out_norm``,
  ``w_res{m}`` for the deeper Hydra++ MLPs, ``unembed`` when untied) and
  the Hydra++ ``prefix`` layer, a GQA layer checked as the groups' are;
* EAGLE params: ``fc (2d, d)``, one decoder layer ``prefix`` (a GQA layer
  and its MLP) and ``out_norm (d,)``.

Every leaf keeps its own float type: bf16 stays bf16 and fp32 stays
fp32, so the MoE router, RWKV6's ``w0``, ``u_bonus``, ``gn_gamma`` and
``gn_beta``, and Mamba2's ``a_log``, ``d_skip`` and ``dt_bias``, which
JAX keeps in fp32 in a bf16 model, are not rounded.

``to_numpy`` is the way back (for round-trip checks): the derived fp32
unembedding is left out.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import add_unembed_f32, group_program
from repro_torch.models.ssm import mamba2_dims


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    a = np.asarray(tree)
    dtype = getattr(torch, a.dtype.name, None)   # "bfloat16", "float32", ..
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"param leaf of type {a.dtype} is not a float")
    # bf16 arrives as ml_dtypes.bfloat16, which torch cannot wrap: go
    # through fp32, which holds every bf16 value exactly.  torch.tensor
    # copies, so the params never alias the caller's (read-only) buffers
    return torch.tensor(a.astype(np.float32), dtype=dtype, device=device)


def _expect(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"JAX params do not match the config: {what}")


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    """Base-model params from the JAX pytree (numpy leaves)."""
    dev = resolve_device(device)
    prog = group_program(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    params = _convert(np_tree, dev)
    _expect(params["embed"].shape == (V, d), "embed must be (V, d)")
    if not cfg.tie_embeddings:
        _expect(params["lm_head"].shape == (d, V), "lm_head must be (d, V)")
    audio = cfg.modality == "audio"
    _expect(("mask_embed" in params) == audio,
            f"params['mask_embed'] {'missing' if audio else 'present'}: "
            f"the config's modality is {cfg.modality}")
    if audio:
        _expect(tuple(params["mask_embed"].shape) == (d,),
                f"mask_embed must be ({d},)")
    _expect(len(params["groups"]) == len(prog),
            f"{len(prog)} groups {[kind for kind, _ in prog]}")

    def check_stacked(t, kind, n):
        if isinstance(t, dict):
            for v in t.values():
                check_stacked(v, kind, n)
        else:
            _expect(t.shape[0] == n, f"{kind} leaves stacked on ({n}, ...)")

    for (kind, n), g in zip(prog, params["groups"]):
        if kind == "shared_attn":
            _expect(g == {}, "a shared_attn group holds no weights of its "
                    f"own (they are params['shared_attn']), got {sorted(g)}")
            continue
        _expect(("rwkv" in g) == (kind == "rwkv_stack"),
                f"{kind} {'has' if 'rwkv' in g else 'lacks'} RWKV6 layers")
        _expect(("mamba" in g) == (kind == "mamba_stack"),
                f"{kind} {'has' if 'mamba' in g else 'lacks'} Mamba2 layers")
        _expect(("moe" in g) == (kind == "attn_stack_moe"),
                f"{kind} has {'an MoE' if 'moe' in g else 'a dense'} FFN")
        check_stacked(g, kind, n)
        if "attn" in g and not cfg.mla:
            _check_gqa(g["attn"], cfg, kind, (n,))
        if kind == "mamba_stack":
            _check_mamba2(g["mamba"], cfg, (n,))
    shared = any(kind == "shared_attn" for kind, _ in prog)
    _expect(("shared_attn" in params) == shared,
            f"params['shared_attn'] {'missing' if shared else 'present'}: "
            f"the program has {'' if shared else 'no '}shared_attn groups")
    if shared:
        sp = params["shared_attn"]
        _expect(sorted(sp) == ["attn", "mlp", "norm1", "norm2"],
                f"shared_attn is one attention + MLP layer, got {sorted(sp)}")
        _expect(tuple(sp["norm1"].shape) == (d,),
                f"shared_attn is one layer, not stacked: norm1 must be "
                f"({d},), got {tuple(sp['norm1'].shape)}")
        _check_gqa(sp["attn"], cfg, "shared_attn", ())
    return add_unembed_f32(params, cfg)


def _check_mamba2(p, cfg: ModelConfig, lead: tuple) -> None:
    """A Mamba2 layer's leaves (behind ``lead``) against the config."""
    s, d = cfg.ssm, cfg.d_model
    d_in, H, conv_ch = mamba2_dims(cfg)
    want = {"w_in": (d, 2 * d_in + 2 * s.d_state + H),
            "conv_w": (s.conv_width, conv_ch), "conv_b": (conv_ch,),
            "a_log": (H,), "d_skip": (H,), "dt_bias": (H,),
            "norm": (d_in,), "w_out": (d_in, d)}
    _expect(sorted(p) == sorted(want),
            f"mamba_stack layers have {sorted(want)}, got {sorted(p)}")
    for key, shape in want.items():
        _expect(tuple(p[key].shape) == lead + shape,
                f"mamba_stack {key} must be {lead + shape}, got "
                f"{tuple(p[key].shape)}")


def _check_gqa(p, cfg: ModelConfig, kind: str, lead: tuple) -> None:
    """GQA projections and QKV biases (behind ``lead``: ``(L,)`` for a
    stacked group, ``()`` for the prefix layer) against the config's head
    counts."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv = cfg.n_heads_padded * hd, cfg.n_kv_heads * hd
    want = {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d)}
    if cfg.qkv_bias:
        want.update(bq=(q,), bk=(kv,), bv=(kv,))
    want = {k: lead + shape for k, shape in want.items()}
    _expect(sorted(p) == sorted(want),
            f"{kind} attention has {sorted(want)}, got {sorted(p)}")
    for key, shape in want.items():
        _expect(tuple(p[key].shape) == shape,
                f"{kind} {key} must be {shape}, got {tuple(p[key].shape)}")


def draft_params_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    """Draft-head params (Medusa / Hydra / Hydra++) from the JAX pytree."""
    dev = resolve_device(device)
    dc = cfg.draft
    dp = _convert(np_tree, dev)
    _expect(len(dp["heads"]) == dc.n_heads, f"{dc.n_heads} heads")
    for i, hp in enumerate(dp["heads"]):
        in_dim = cfg.d_model * (1 if dc.kind == "medusa" else i + 2)
        _expect(hp["w_in"].shape == (in_dim, cfg.d_model),
                f"head {i} w_in is ({in_dim}, d)")
        res = sorted(k for k in hp if k.startswith("w_res"))
        _expect(res == sorted(f"w_res{m}" for m in range(dc.n_mlp_layers - 1)),
                f"head {i} has {dc.n_mlp_layers - 1} residual blocks")
        _expect(("unembed" in hp) != dc.tie_unembed,
                f"head {i} unembedding tied={dc.tie_unembed}")
    _expect(("prefix" in dp) == dc.prefix_attention,
            f"prefix layer present={dc.prefix_attention}")
    if dc.prefix_attention:
        _check_gqa(dp["prefix"]["attn"], cfg, "prefix", ())
    return dp


def eagle_params_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    """EAGLE draft params (``fc``, the ``prefix`` decoder layer,
    ``out_norm``) from the JAX pytree."""
    dev = resolve_device(device)
    d = cfg.d_model
    ep = _convert(np_tree, dev)
    _expect(sorted(ep) == ["fc", "out_norm", "prefix"],
            f"EAGLE params are fc, prefix and out_norm, got {sorted(ep)}")
    _expect(tuple(ep["fc"].shape) == (2 * d, d),
            f"EAGLE fc must be ({2 * d}, {d}), got {tuple(ep['fc'].shape)}")
    _expect(tuple(ep["out_norm"].shape) == (d,),
            f"EAGLE out_norm must be ({d},)")
    p = ep["prefix"]
    _expect(sorted(p) == ["attn", "mlp", "norm1", "norm2"],
            f"the EAGLE layer is one attention + MLP layer, got {sorted(p)}")
    for key in ("norm1", "norm2"):
        _expect(tuple(p[key].shape) == (d,), f"EAGLE {key} must be ({d},)")
    _check_gqa(p["attn"], cfg, "EAGLE", ())
    f = cfg.d_ff
    for key, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                       ("w_down", (f, d))):
        _expect(tuple(p["mlp"][key].shape) == shape,
                f"EAGLE mlp {key} must be {shape}")
    return ep


def to_numpy(tree):
    """The port's params as nested dicts/lists of fp32 numpy arrays, in
    the JAX layout (the derived ``unembed_f32`` is dropped)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()
                if k != "unembed_f32"}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return tree.detach().float().cpu().numpy()
