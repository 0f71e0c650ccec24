"""Training objectives (port of ``repro/core/distill.py``; paper §5, §3.1,
Appendix A).

* data loss      — CE against the corpus next-tokens (Medusa's objective)
* teacher loss   — self-distillation: CE against the FROZEN base model's
                   next-token distribution (Hydra++/DistillSpec; App. A.1)
* NEFTune noise  — optional uniform noise on the base hidden states,
                   scale alpha/sqrt(S·d) (the App. A ablation)
* ``lm_loss``    — next-token CE for base-model pretraining
* ``masked_prediction_loss`` — HuBERT-style masked cluster prediction

Head alignment (0-based head j): at position t it receives h_t and the
embeddings of x_{t+1..t+j+1}, and predicts x_{t+j+2}; the teacher
distribution for that target is the base model's logits at position t+j+1.

In head training the base model is frozen: it runs under
``torch.no_grad()``, the port's ``stop_gradient``, and only the draft
params (the Hydra++ prefix layer among them) are on the autograd graph.
Each function returns (a 0-d fp32 loss, a dict of 0-d metrics); the
caller differentiates the loss (``training/trainer.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.heads import head_logits, prefix_forward
from repro_torch.models.model import forward, unembed_param


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device).expand(B, S)


def neftune_noise(shape, generator: torch.Generator, device):
    """Uniform noise on [-1, 1), fp32, from ``generator`` (JAX draws
    ``jax.random.uniform(rng, shape, f32, -1, 1)``)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u * 2.0 - 1.0


def head_train_loss(draft_params, base_params, cfg: ModelConfig, tokens,
                    *, objective: str = "data", noise_alpha: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None):
    """tokens: (B, S).  Returns (scalar loss, metrics dict).  With
    ``noise_alpha`` > 0, NEFTune noise (h's shape, uniform on [-1, 1)) is
    ``noise`` or a draw from ``generator``."""
    if objective not in ("data", "distill"):
        raise ValueError(f"objective must be 'data' or 'distill': "
                         f"{objective}")
    B, S = tokens.shape
    K = cfg.draft.n_heads
    pos = _positions(B, S, tokens.device)
    tokens = tokens.long()

    with torch.no_grad():                                  # frozen base
        base_out = forward(base_params, cfg, tokens, pos, mode="full",
                           want_logits=(objective == "distill"))
        h = base_out.hidden
        if noise_alpha > 0.0:
            if noise is None:
                if generator is None:
                    raise ValueError("NEFTune noise needs a generator or "
                                     "noise")
                noise = neftune_noise(h.shape, generator, h.device)
            scale = noise_alpha / torch.sqrt(
                torch.tensor(float(S * cfg.d_model), device=h.device))
            h = h + scale.to(h.dtype) * noise.to(h.dtype)
        E = base_params["embed"][tokens]
    if "prefix" in draft_params:                           # trainable
        h, _, _ = prefix_forward(draft_params, cfg, h, pos)

    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    metrics = {}
    for j in range(K):
        Lmax = S - (j + 2)
        h_in = h[:, :Lmax]
        path = torch.stack([E[:, 1 + m:1 + m + Lmax] for m in range(j + 1)],
                           dim=2)
        lg = head_logits(draft_params, cfg, base_params, j, h_in, path)
        logp = torch.log_softmax(lg, dim=-1)
        if objective == "data":
            tgt = tokens[:, j + 2:j + 2 + Lmax]
            nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
            loss_j = nll.mean()
            acc_j = (torch.argmax(lg, -1) == tgt).float().mean()
        else:
            teacher = base_out.logits[:, j + 1:j + 1 + Lmax]
            tprob = torch.softmax(teacher, dim=-1)
            loss_j = -(tprob * logp).sum(-1).mean()
            acc_j = (torch.argmax(lg, -1)
                     == torch.argmax(teacher, -1)).float().mean()
        total = total + loss_j
        metrics[f"head{j}_loss"] = loss_j
        metrics[f"head{j}_acc"] = acc_j
    loss = total / K
    metrics["loss"] = loss
    return loss, metrics


def _ce_chunk(hc, unembed, tc, vc):
    """One chunk of ``lm_loss``: (masked NLL sum, masked hit count)."""
    lg = hc.float() @ unembed                              # (B, c, V)
    lp = torch.log_softmax(lg, dim=-1)
    nll = -torch.gather(lp, -1, tc[..., None])[..., 0]
    hit = torch.argmax(lg, -1) == tc
    return (torch.where(vc, nll, 0.0).sum(),
            torch.where(vc, hit, False).sum())


def lm_loss(params, cfg: ModelConfig, tokens, *, logit_chunk: int = 256):
    """Next-token CE for base-model pretraining; returns (loss, metrics).
    The loss adds the MoE router's load-balance loss (``forward``'s
    ``aux_loss``, zero without MoE layers), reported as ``aux``.

    The CE is computed in sequence chunks of ``logit_chunk`` (the whole
    sequence where it does not divide S), each under
    ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` scan), so the full
    (B, S, V) logits are never held.  The unembedding is read from
    ``embed``/``lm_head`` directly, so its gradient reaches them."""
    B, S = tokens.shape
    tokens = tokens.long()
    pos = _positions(B, S, tokens.device)
    out = forward(params, cfg, tokens, pos, mode="full", want_logits=False,
                  want_aux=True)
    h = out.hidden                                         # (B, S, d)
    unembed = unembed_param(params, cfg).float()
    # targets: next token; last position masked out
    tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    valid = (torch.arange(S, device=tokens.device) < S - 1)[None, :]

    c = logit_chunk if S % logit_chunk == 0 else S
    nll_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    hit_sum = torch.zeros((), dtype=torch.int64, device=tokens.device)
    for i in range(0, S, c):
        nll, hit = checkpoint(_ce_chunk, h[:, i:i + c], unembed,
                              tgt[:, i:i + c], valid[:, i:i + c],
                              use_reentrant=False)
        nll_sum = nll_sum + nll
        hit_sum = hit_sum + hit
    denom = B * (S - 1)
    nll_mean = nll_sum / denom
    loss = nll_mean + out.aux_loss
    acc = hit_sum.float() / denom
    return loss, {"loss": loss, "nll": nll_mean, "acc": acc,
                  "aux": out.aux_loss}


def masked_prediction_loss(params, cfg: ModelConfig, features, targets,
                           mask):
    """HuBERT-style masked cluster prediction for the encoder-only arch.

    features: (B, S, d) frame embeddings (frontend stub); targets: (B, S)
    cluster ids; mask: (B, S) bool — positions replaced by the learned mask
    embedding and scored."""
    B, S, _ = features.shape
    pos = _positions(B, S, features.device)
    dtype = params["mask_embed"].dtype
    x = torch.where(mask[..., None], params["mask_embed"][None, None, :],
                    features.to(dtype))
    out = forward(params, cfg, x, pos, mode="full")
    targets = targets.long()
    logp = torch.log_softmax(out.logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    denom = torch.clamp_min(mask.sum(), 1)
    loss = torch.where(mask, nll, 0.0).sum() / denom
    acc = (torch.where(mask, torch.argmax(out.logits, -1) == targets, False)
           .sum() / denom)
    return loss, {"loss": loss, "acc": acc}
