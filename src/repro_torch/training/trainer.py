"""Training loops (port of ``repro/training/trainer.py``): base-model
pretraining and frozen-base draft-head training (paper §5: heads train
with the base frozen; Hydra/Medusa 1 epoch, Hydra++ longer, cosine LR,
AdamW).

A step differentiates its loss with ``torch.autograd.grad`` over the
trained tree's leaves (``value_and_grad``): they require a gradient for
the call only, and no ``.grad`` is written anywhere, so a frozen base
holds no gradient and serving after training builds no graph.  Params and
moments are updated in place (``training/optim.py``); a base step then
refreshes the fp32 unembedding the serving path reads
(``models/model.py::refresh_unembed_f32``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distill import head_train_loss, lm_loss
from repro_torch.models.model import refresh_unembed_f32
from repro_torch.training.optim import (adamw_update, clip_by_global_norm,
                                        cosine_schedule, init_adamw)
from repro_torch.training.pytree import tree_leaves, tree_unflatten


@dataclass
class TrainConfig:
    peak_lr: float = 1e-3
    warmup: int = 50
    total_steps: int = 500
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    log_every: int = 50


def value_and_grad(loss_fn, params):
    """``loss_fn(params)`` -> (loss, metrics), and the gradient of the loss
    with respect to every leaf of ``params`` (a tree of the same layout;
    zeros for a leaf the loss does not reach).  Returns (loss, metrics,
    grads), all detached."""
    leaves = tree_leaves(params)
    flags = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = loss_fn(params)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p, flag in zip(leaves, flags):
            p.requires_grad_(flag)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def apply_update(grads, opt_state, params, tc: TrainConfig):
    """Clip, schedule and AdamW-update ``params`` in place (JAX's step
    body after its ``value_and_grad``); returns (params, opt_state,
    {"grad_norm", "lr"})."""
    grads, gn = clip_by_global_norm(grads, tc.clip_norm)
    lr = cosine_schedule(opt_state.step, peak_lr=tc.peak_lr,
                         warmup=tc.warmup, total=tc.total_steps)
    params, opt_state = adamw_update(grads, opt_state, params, lr, b1=tc.b1,
                                     b2=tc.b2, weight_decay=tc.weight_decay)
    return params, opt_state, {"grad_norm": gn, "lr": lr}


def make_base_train_step(cfg: ModelConfig, tc: TrainConfig):
    def step(params, opt_state, batch):
        _, metrics, grads = value_and_grad(
            lambda p: lm_loss(p, cfg, batch), params)
        params, opt_state, extra = apply_update(grads, opt_state, params, tc)
        refresh_unembed_f32(params, cfg)
        return params, opt_state, dict(metrics, **extra)
    return step


def make_head_train_step(cfg: ModelConfig, tc: TrainConfig, *,
                         objective: str = "data",
                         noise_alpha: float = 0.0):
    """The step takes (draft_params, base_params, opt_state, batch,
    generator=None): NEFTune noise is drawn from ``generator`` (JAX passes
    a key)."""
    def step(draft_params, base_params, opt_state, batch, generator=None):
        _, metrics, grads = value_and_grad(
            lambda dp: head_train_loss(dp, base_params, cfg, batch,
                                       objective=objective,
                                       noise_alpha=noise_alpha,
                                       generator=generator),
            draft_params)
        draft_params, opt_state, extra = apply_update(grads, opt_state,
                                                      draft_params, tc)
        return draft_params, opt_state, dict(metrics, **extra)
    return step


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def train_base(params, cfg: ModelConfig, tc: TrainConfig, batches,
               *, log: Optional[Callable] = print):
    """Trains ``params`` in place over ``batches`` ((B, S) int arrays);
    returns (params, the last step's metrics)."""
    step_fn = make_base_train_step(cfg, tc)
    opt = init_adamw(params)
    dev = _device(params)
    t0 = time.time()
    metrics = {}
    for i, batch in enumerate(batches):
        params, opt, metrics = step_fn(params, opt,
                                       torch.as_tensor(batch, device=dev))
        if log and (i % tc.log_every == 0 or i == tc.total_steps - 1):
            log(f"[base {i:5d}] loss={float(metrics['loss']):.4f} "
                f"acc={float(metrics['acc']):.3f} "
                f"({time.time()-t0:.1f}s)")
    return params, metrics


def train_heads(draft_params, base_params, cfg: ModelConfig,
                tc: TrainConfig, batches, *, objective: str = "data",
                noise_alpha: float = 0.0,
                generator: Optional[torch.Generator] = None,
                log: Optional[Callable] = print):
    """Trains ``draft_params`` in place with the base frozen; returns
    (draft_params, the last step's metrics).  NEFTune noise is drawn from
    ``generator`` (default: one on the params' device seeded 0)."""
    step_fn = make_head_train_step(cfg, tc, objective=objective,
                                   noise_alpha=noise_alpha)
    opt = init_adamw(draft_params)
    dev = _device(draft_params)
    if generator is None and noise_alpha > 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    t0 = time.time()
    metrics = {}
    for i, batch in enumerate(batches):
        draft_params, opt, metrics = step_fn(
            draft_params, base_params, opt,
            torch.as_tensor(batch, device=dev), generator)
        if log and (i % tc.log_every == 0 or i == tc.total_steps - 1):
            hk = [k for k in metrics if k.endswith("_acc")]
            accs = " ".join(f"{k}={float(metrics[k]):.3f}" for k in
                            sorted(hk))
            log(f"[heads {i:5d}] loss={float(metrics['loss']):.4f} {accs} "
                f"({time.time()-t0:.1f}s)")
    return draft_params, metrics
