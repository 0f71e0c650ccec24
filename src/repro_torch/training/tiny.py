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

``train_tiny`` is the paper's container-scale experiment (the port of
``scripts/train_tiny.py``; its CLI is ``scripts/torch_train_tiny.py``): a
300-step base, Medusa and Hydra heads 300 steps each, their acceptance
lengths.  It writes the base to ``CKPT_DIR/base_tiny``, the very
checkpoint ``base_setup`` restores, so after it has run ``base_setup``
returns its 300-step base instead of training 150 steps of its own (as
JAX's ``benchmarks/common.py`` does after JAX's script).  Its heads go to
``heads_{medusa,hydra}_tiny``, apart from ``draft_setup``'s
``heads_{tag}``.
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

# train_tiny's recipe, value for value JAX's scripts/train_tiny.py
TINY_STEPS = 300
TINY_KINDS = ("medusa", "hydra")
TINY_TREE = (16, 4, 4)            # default_tree(size, max_children, depth)
TINY_PROMPTS = (4, 32)            # eval_batch(4)[:, :32]
TINY_NEW = 48
TINY_MAX_LEN = 512

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
    ``CKPT_DIR/base_tiny`` where it was saved before (by this function or
    by ``train_tiny``)."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(get_config("vicuna-tiny"), dtype="float32")
    pipe = tiny_pipeline(cfg)
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


@dataclasses.dataclass
class TinyRun:
    """What ``train_tiny`` trained: ``accept`` is ``{kind: (mean accepted
    length, decode steps)}``, ``seconds`` the wall time of each training
    (``"base"``, then each kind's heads), ``params`` the base and
    ``drafts`` ``{kind: draft params}`` as checkpointed."""
    cfg: object
    params: dict
    drafts: dict
    accept: dict
    seconds: dict


def tiny_pipeline(cfg) -> DataPipeline:
    """The synthetic conversation corpus every vicuna-tiny run trains on
    and takes its held-out prompts from."""
    spec = MarkovSpec(vocab_size=cfg.vocab_size, branch=4, peak=0.7, seed=0)
    return DataPipeline(spec, seq_len=128, batch_size=16, n_train=256,
                        n_eval=32)


def train_tiny(steps: int = TINY_STEPS, *, ckpt_dir: str | None = None,
               device="cuda", log=print) -> TinyRun:
    """JAX's ``scripts/train_tiny.py``: vicuna-tiny in fp32 trained
    ``steps`` steps (base seed 0), saved to ``<ckpt_dir>/base_tiny``; then
    Medusa and Hydra heads (4 heads, 1-layer MLPs, seed 1, the data
    objective) trained ``steps`` steps each on it, saved to
    ``heads_<kind>_tiny``, and each one's mean accepted length on the
    first 4 held-out prompts of 32 tokens, 48 new tokens, greedy,
    ``default_tree(16, 4, 4)``.  ``ckpt_dir`` defaults to ``CKPT_DIR``;
    ``log`` takes the training logs and the result lines."""
    from repro_torch.core.speculative import generate
    from repro_torch.core.trees import default_tree

    dev = resolve_device(device)
    ckpt_dir = CKPT_DIR if ckpt_dir is None else ckpt_dir
    cfg = dataclasses.replace(get_config("vicuna-tiny"), dtype="float32")
    pipe = tiny_pipeline(cfg)
    tc = TrainConfig(total_steps=steps, warmup=30, log_every=100)
    seconds = {}
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    params, _ = train_base(params, cfg, tc, pipe.train_batches(steps),
                           log=log)
    _sync(dev)
    seconds["base"] = time.perf_counter() - t0
    save_checkpoint(os.path.join(ckpt_dir, "base_tiny"), params)
    log("base saved")
    tree = default_tree(*TINY_TREE)
    B, P = TINY_PROMPTS
    prompts = torch.as_tensor(pipe.eval_batch(B)[:, :P], device=dev).long()
    drafts, accept = {}, {}
    for kind in TINY_KINDS:
        dc, objective = DRAFT_VARIANTS[kind]
        c2 = dataclasses.replace(cfg, draft=dc)
        t0 = time.perf_counter()
        dp = init_draft_params(c2, seed=1, device=dev)
        dp, _ = train_heads(dp, params, c2, tc, pipe.train_batches(steps),
                            objective=objective, log=log)
        _sync(dev)
        seconds[kind] = time.perf_counter() - t0
        save_checkpoint(os.path.join(ckpt_dir, f"heads_{kind}_tiny"), dp)
        _, n_steps, acc = generate(params, dp, c2, tree, prompts,
                                   max_new_tokens=TINY_NEW,
                                   max_len=TINY_MAX_LEN)
        drafts[kind] = dp
        accept[kind] = (float(acc.mean()), int(n_steps))
        log(f"{kind}: acceptance length = {accept[kind][0]:.3f} "
            f"(steps {n_steps})")
    return TinyRun(cfg, params, drafts, accept, seconds)
