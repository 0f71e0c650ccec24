"""The container-scale substrate of the examples (port of
``benchmarks/common.py``'s ``DRAFT_VARIANTS``, ``base_setup``,
``draft_setup``, ``eval_prompts`` and ``timed_generate``).

Trains once, and checkpoints under ``CKPT_DIR``, the Vicuna stand-in base
model (``vicuna-tiny``, fp32) on the synthetic conversation corpus, and
each of the three draft-model variants the paper compares (§5, §6):

  medusa   sequentially-independent heads, 1-layer MLP, data loss
  hydra    sequentially-dependent heads, 1-layer MLP, data loss     (§3)
  hydra++  sequentially-dependent, 4-layer MLP, teacher distillation,
           PrefixAttention                                           (§3.1)

Checkpoints are written in the JAX package's format
(``training/checkpoint.py``); a later call restores them instead of
training.  Everything runs on CUDA unless it is given ``device="cpu"``;
without a card it raises.
"""
from __future__ import annotations

import dataclasses
import os
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import DraftConfig
from repro_torch.core.heads import init_draft_params
from repro_torch.data.synthetic import DataPipeline, MarkovSpec
from repro_torch.device import resolve_device
from repro_torch.models.model import add_unembed_f32, init_params
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.trainer import TrainConfig, train_base, train_heads

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "results", "ckpt_torch")

BASE_STEPS = 150
HEAD_STEPS = 200

DRAFT_VARIANTS = {
    "medusa": (DraftConfig(kind="medusa", n_heads=4, n_mlp_layers=1),
               "data"),
    "hydra": (DraftConfig(kind="hydra", n_heads=4, n_mlp_layers=1),
              "data"),
    "hydra++": (DraftConfig(kind="hydra", n_heads=4, n_mlp_layers=4,
                            prefix_attention=True), "distill"),
}


def _restored(path: str) -> bool:
    return os.path.exists(os.path.join(path, "arrays.npz"))


def base_setup(device="cuda"):
    """Returns (cfg, params, pipe): the trained base model, restored from
    ``CKPT_DIR/base_tiny`` where it was saved before."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(get_config("vicuna-tiny"), dtype="float32")
    spec = MarkovSpec(vocab_size=cfg.vocab_size, branch=4, peak=0.7, seed=0)
    pipe = DataPipeline(spec, seq_len=128, batch_size=16, n_train=256,
                        n_eval=32)
    params = init_params(cfg, seed=0, device=dev)
    path = os.path.join(CKPT_DIR, "base_tiny")
    if _restored(path):
        params = add_unembed_f32(load_checkpoint(path, params), cfg)
        print("base_tiny: restored from checkpoint")
    else:
        tc = TrainConfig(total_steps=BASE_STEPS, warmup=30, log_every=100)
        params, _ = train_base(params, cfg, tc,
                               pipe.train_batches(BASE_STEPS))
        save_checkpoint(path, params)
    return cfg, params, pipe


def draft_setup(variant: str, *, steps: int | None = None,
                objective: str | None = None, noise_alpha: float = 0.0,
                tag: str | None = None, device="cuda"):
    """Returns (cfg_with_draft, draft_params): ``variant``'s heads on the
    base of ``base_setup``, trained and checkpointed (or restored)."""
    dev = resolve_device(device)
    cfg, params, pipe = base_setup(dev)
    dc, obj = DRAFT_VARIANTS[variant]
    objective = objective or obj
    steps = steps or HEAD_STEPS
    c2 = dataclasses.replace(cfg, draft=dc)
    dp = init_draft_params(c2, seed=7, device=dev)
    tag = tag or f"{variant}_{objective}" + (
        f"_noise{noise_alpha:g}" if noise_alpha else "")
    path = os.path.join(CKPT_DIR, f"heads_{tag}")
    if _restored(path):
        dp = load_checkpoint(path, dp)
        print(f"heads_{tag}: restored from checkpoint")
    else:
        tc = TrainConfig(total_steps=steps, warmup=30, log_every=100)
        gen = (torch.Generator(device=dev).manual_seed(7) if noise_alpha
               else None)
        dp, _ = train_heads(dp, params, c2, tc, pipe.train_batches(steps),
                            objective=objective, noise_alpha=noise_alpha,
                            generator=gen)
        save_checkpoint(path, dp)
    return c2, dp


def eval_prompts(n: int, length: int = 32, device="cuda"):
    """(n, length) held-out prompts of the corpus, on ``device``."""
    dev = resolve_device(device)
    pipe = base_setup(dev)[2]
    return torch.as_tensor(pipe.eval_batch(n)[:, :length], device=dev).long()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_generate(params, dp, cfg, tree, prompts, *, max_new_tokens=48,
                   criterion="greedy", use_speculative=True, **kw):
    """Returns (tokens/s wall, tokens/step acceptance, steps, tokens): one
    warm-up ``generate()`` of 4 tokens, then a timed one (the card waited
    for at both ends)."""
    from repro_torch.core.speculative import generate

    generate(params, dp, cfg, tree, prompts, max_new_tokens=4, max_len=512,
             criterion=criterion, use_speculative=use_speculative, **kw)
    _sync(prompts.device)
    t0 = time.perf_counter()
    toks, steps, acc = generate(params, dp, cfg, tree, prompts,
                                max_new_tokens=max_new_tokens, max_len=512,
                                criterion=criterion,
                                use_speculative=use_speculative, **kw)
    _sync(prompts.device)
    wall = time.perf_counter() - t0
    B = prompts.shape[0]
    n_tokens = float(acc.sum()) if use_speculative else steps * B
    return n_tokens / wall, float(acc.mean()), steps, toks
