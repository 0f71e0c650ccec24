"""Parameters from the JAX package, as nested dicts/lists of numpy arrays.

The parity tests initialise params in JAX and hand them over with
``jax.tree_util.tree_map(np.asarray, params)``; this module turns such a
tree into the port's params, so the bridge itself needs no JAX.  The port
keeps the JAX layout, so conversion is leaf by leaf, with checks of the
parts whose layout matters:

* ``groups``: one dense attention group, every leaf stacked on a leading
  ``(L, ...)`` layer axis;
* ``lm_head``: stored as ``(d, V)`` (JAX inits it as ``embed_init(...).T``),
  and the fp32 unembedding the port derives from it at load;
* draft params: a list of per-head dicts (``w_in``, ``out_norm``,
  ``w_res{m}`` for the deeper Hydra++ MLPs, ``unembed`` when untied) and
  the Hydra++ ``prefix`` layer.

``to_numpy`` is the way back (for round-trip checks): the derived fp32
unembedding is left out.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.model import add_unembed_f32, group_program


def _convert(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _convert(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, dtype, device) for v in tree]
    # bf16 arrives as ml_dtypes.bfloat16, which torch cannot wrap: go
    # through fp32, which holds every bf16 value exactly.  torch.tensor
    # copies, so the params never alias the caller's (read-only) buffers
    return torch.tensor(np.asarray(tree, dtype=np.float32), dtype=dtype,
                        device=device)


def _expect(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"JAX params do not match the config: {what}")


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    """Base-model params from the JAX pytree (numpy leaves)."""
    dev = resolve_device(device)
    (_, n_layers), = group_program(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    params = _convert(np_tree, torch_dtype(cfg.dtype), dev)
    _expect(params["embed"].shape == (V, d), "embed must be (V, d)")
    if not cfg.tie_embeddings:
        _expect(params["lm_head"].shape == (d, V), "lm_head must be (d, V)")
    _expect(len(params["groups"]) == 1, "one dense attention group")

    def check_stacked(t):
        if isinstance(t, dict):
            for v in t.values():
                check_stacked(v)
        else:
            _expect(t.shape[0] == n_layers,
                    f"group leaves stacked on ({n_layers}, ...)")

    check_stacked(params["groups"][0])
    return add_unembed_f32(params, cfg)


def draft_params_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    """Draft-head params (Medusa / Hydra / Hydra++) from the JAX pytree."""
    dev = resolve_device(device)
    dc = cfg.draft
    dp = _convert(np_tree, torch_dtype(cfg.dtype), dev)
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
    return dp


def to_numpy(tree):
    """The port's params as nested dicts/lists of fp32 numpy arrays, in
    the JAX layout (the derived ``unembed_f32`` is dropped)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()
                if k != "unembed_f32"}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return tree.detach().float().cpu().numpy()
