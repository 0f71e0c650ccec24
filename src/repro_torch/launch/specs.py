"""Step functions and their ``meta`` arguments for every (architecture x
input-shape) pair (port of ``repro/launch/specs.py``), read by
``launch/dryrun.py``.

Nothing is allocated here: params, optimizer state, caches and batches are
tensors on the ``meta`` device, made by the real init functions
(``device="meta"``: shapes and dtypes, nothing drawn), as JAX's come from
``jax.eval_shape``.  The step functions are the ones the launchers run
(``launch/train.py::make_train_step``, ``core/speculative.py::
spec_decode_step``); on ``meta`` each kernel wrapper charges the op
counter instead of launching.

The port's decode state has no ``rng`` leaf (its sampling draws from a
``torch.Generator`` the caller holds; a greedy step draws nothing) and
keeps ``last_token`` as int64, the index type of its gathers.  JAX's
``REPRO_OPT_RAGGED_ATTN`` environment read is the keyword
``replicate_ragged_attn`` of ``build_step_spec``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, tree_for
from repro_torch.core.heads import init_draft_params, init_prefix_cache
from repro_torch.core.speculative import (DecodeState, StepResult,
                                          spec_decode_step)
from repro_torch.core.trees import device_arrays
from repro_torch.device import torch_dtype
from repro_torch.distributed.sharding import (batch_axes, batch_spec_axis,
                                              cache_shardings,
                                              mesh_axis_size,
                                              params_shardings, replicated,
                                              spec, tokens_sharding)
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.train import make_train_step
from repro_torch.models.model import (forward, init_cache, init_params,
                                      unembedding)
from repro_torch.training.optim import AdamWState, init_adamw

META = torch.device("meta")


class StepSpec(NamedTuple):
    fn: Any                      # the step function
    args: tuple                  # its meta arguments
    specs: list                  # their specs, one spec tree an argument
    out_specs: Any               # the outputs' (a leaf without: replicated)
    note: str


def structs(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def skip_reason(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    shp = INPUT_SHAPES[shape_name]
    if shp.kind == "decode" and not cfg.supports_decode:
        return "encoder-only: no autoregressive decode"
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return "full-attention arch: long_500k requires sub-quadratic"
    return None


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, max_len: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        x = batch.get("tokens", batch.get("features"))
        B, T = x.shape[:2]
        pos = torch.arange(T, device=x.device).expand(B, T)
        cache = (init_cache(cfg, B, max_len, x.device)
                 if cfg.supports_decode else None)
        out = forward(params, cfg, x, pos, mode="full", cache=cache,
                      want_logits=False)
        last_logits = out.hidden[:, -1].float() @ unembedding(params, cfg)
        return out.cache, last_logits

    return prefill_step


def make_serve_step(cfg: ModelConfig, tree):
    def serve_step(params, draft_params, state: DecodeState) -> StepResult:
        return spec_decode_step(params, draft_params, cfg, tree, state,
                                criterion="greedy")
    return serve_step


# ---------------------------------------------------------------------------
# structure builders (all on meta)
# ---------------------------------------------------------------------------


def param_structs(cfg: ModelConfig):
    return init_params(cfg, device=META)


def draft_param_structs(cfg: ModelConfig):
    return init_draft_params(cfg, device=META)


def decode_state_structs(cfg: ModelConfig, B: int, max_len: int,
                         with_prefix: bool) -> DecodeState:
    pk = pv = None
    if with_prefix:
        pc = init_prefix_cache(cfg, B, max_len, META)
        pk, pv = pc["k"], pc["v"]
    return DecodeState(
        cache=init_cache(cfg, B, max_len, META),
        cache_len=structs((B,), torch.int32),
        last_token=structs((B,), torch.long),
        last_hidden=structs((B, cfg.d_model), torch_dtype(cfg.dtype)),
        prefix_k=pk, prefix_v=pv)


def batch_structs(cfg: ModelConfig, B: int, S: int) -> dict:
    if cfg.modality == "audio":
        return {"features": structs((B, S, cfg.d_model),
                                    torch_dtype(cfg.dtype)),
                "targets": structs((B, S), torch.int32),
                "mask": structs((B, S), torch.bool)}
    return {"tokens": structs((B, S), torch.int32)}


def batch_shardings(cfg: ModelConfig, mesh: Mesh, B: int) -> dict:
    ts = tokens_sharding(mesh, B)
    if cfg.modality == "audio":
        bax = batch_spec_axis(mesh, B)
        return {"features": spec(bax, None, None), "targets": ts,
                "mask": ts}
    return {"tokens": ts}


def decode_state_shardings(cfg: ModelConfig, mesh: Mesh,
                           state: DecodeState, B: int) -> DecodeState:
    bax = batch_spec_axis(mesh, B)
    seq_ax = None if bax is not None else (batch_axes(mesh) or None)
    vec = spec(bax)
    mp = mesh_axis_size(mesh, "model")
    pk_sh = pv_sh = None
    if state.prefix_k is not None:
        h_ax = "model" if state.prefix_k.shape[2] % mp == 0 else None
        pk_sh = pv_sh = spec(bax, seq_ax, h_ax, None)
    return DecodeState(
        cache=cache_shardings(state.cache, mesh, B), cache_len=vec,
        last_token=vec, last_hidden=spec(bax, None),
        prefix_k=pk_sh, prefix_v=pv_sh)


# ---------------------------------------------------------------------------
# top-level: everything the dry run needs for one (arch, shape, mesh)
# ---------------------------------------------------------------------------


def build_step_spec(cfg: ModelConfig, shape_name: str, mesh: Mesh,
                    replicate_ragged_attn: bool = False) -> StepSpec:
    """The step, its meta arguments and their specs.
    ``replicate_ragged_attn`` replicates ALL ragged-head attention
    projections of an inference step (JAX's refuted ``REPRO_OPT_RAGGED_
    ATTN=1``, kept for the record); ragged KV projections replicate
    always."""
    reason = skip_reason(cfg, shape_name)
    if reason:
        raise ValueError(f"SKIP {cfg.name} x {shape_name}: {reason}")
    shp = INPUT_SHAPES[shape_name]
    B, S = shp.global_batch, shp.seq_len
    pstructs = param_structs(cfg)
    ragged = replicate_ragged_attn and shp.kind != "train"
    psh = params_shardings(pstructs, mesh, head_dim=cfg.resolved_head_dim,
                           replicate_ragged_attn=ragged)

    if shp.kind == "train":
        opt = init_adamw(pstructs)
        opt_sh = AdamWState(step=replicated(mesh),
                            mu=params_shardings(opt.mu, mesh),
                            nu=params_shardings(opt.nu, mesh))
        return StepSpec(
            fn=make_train_step(cfg),
            args=(pstructs, opt, batch_structs(cfg, B, S)),
            specs=[psh, opt_sh, batch_shardings(cfg, mesh, B)],
            out_specs=[psh, opt_sh, {}],
            note=f"train_step B={B} S={S}")

    bax = batch_spec_axis(mesh, B)
    if shp.kind == "prefill":
        max_len = S + 64
        cache_sh = (cache_shardings(init_cache(cfg, B, max_len, META), mesh,
                                    B) if cfg.supports_decode else None)
        return StepSpec(
            fn=make_prefill_step(cfg, max_len),
            args=(pstructs, batch_structs(cfg, B, S)),
            specs=[psh, batch_shardings(cfg, mesh, B)],
            out_specs=[cache_sh, spec(bax, None)],
            note=f"prefill B={B} S={S}")

    # decode: one speculative step against a seq_len cache
    tree = tree_for(cfg)
    # the tree's index arrays are made once a process (as a server makes
    # them before its first step): made here, the counted step reads them
    device_arrays(tree, META)
    max_len = S + 64
    dstructs = draft_param_structs(cfg)
    dsh = params_shardings(dstructs, mesh, head_dim=cfg.resolved_head_dim,
                           replicate_ragged_attn=ragged)
    state = decode_state_structs(cfg, B, max_len,
                                 with_prefix="prefix" in dstructs)
    ssh = decode_state_shardings(cfg, mesh, state, B)
    return StepSpec(
        fn=make_serve_step(cfg, tree),
        args=(pstructs, dstructs, state),
        specs=[psh, dsh, ssh],
        out_specs=StepResult(state=ssh, emitted=spec(bax, None),
                             n_emitted=spec(bax)),
        note=f"spec_decode_step B={B} cache={S} tree={tree.size}")
