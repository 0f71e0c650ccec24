"""Quickstart on the PyTorch port: train a tiny base model + Hydra heads
on the synthetic conversation corpus, then decode speculatively and
compare against autoregressive decoding.  The port of
``examples/quickstart.py``; it imports nothing of JAX.

  PYTHONPATH=src python examples/torch_quickstart.py [--steps 150] \\
      [--device cpu]

Runs on CUDA unless ``--device cpu``; without a card it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.heads import init_draft_params
from repro_torch.core.speculative import PAD_TOKEN, generate
from repro_torch.core.trees import default_tree
from repro_torch.data.synthetic import DataPipeline, MarkovSpec
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.training.trainer import TrainConfig, train_base, train_heads


def _timed(dev, fn):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def main(argv=None) -> dict:
    """Runs the example; returns the mean accepted length, the
    speculative and autoregressive step counts and whether the first 40
    greedy tokens of the two agree."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(get_config("vicuna-tiny"), dtype="float32")
    spec = MarkovSpec(vocab_size=cfg.vocab_size, branch=4, peak=0.7, seed=0)
    pipe = DataPipeline(spec, seq_len=128, batch_size=16, n_train=256,
                        n_eval=32)

    print("== 1. pretrain the base model (frozen afterwards, paper §5)")
    params = init_params(cfg, seed=0, device=dev)
    tc = TrainConfig(total_steps=args.steps, warmup=20, log_every=50)
    params, _ = train_base(params, cfg, tc, pipe.train_batches(args.steps))

    print("== 2. train Hydra heads on the frozen base (§3)")
    dp = init_draft_params(cfg, seed=1, device=dev)
    dp, _ = train_heads(dp, params, cfg, tc, pipe.train_batches(args.steps))

    print("== 3. speculative vs autoregressive decoding")
    tree = default_tree(16, 4, 4)
    prompts = torch.as_tensor(pipe.eval_batch(2)[:, :32], device=dev).long()
    (toks_s, steps_s, acc), t_spec = _timed(dev, lambda: generate(
        params, dp, cfg, tree, prompts, max_new_tokens=48, max_len=512))
    (toks_a, steps_a, _), t_ar = _timed(dev, lambda: generate(
        params, None, cfg, tree, prompts, max_new_tokens=48, max_len=512,
        use_speculative=False))
    accept_len = float(acc.mean())
    print(f"speculative: {steps_s} steps, accept_len={accept_len:.2f}, "
          f"{t_spec:.1f}s")
    print(f"autoregressive: {steps_a} steps, {t_ar:.1f}s")
    print(f"steps saved: {steps_a - steps_s} "
          f"({steps_a / max(steps_s, 1):.2f}x fewer)")
    stream = lambda row: [int(t) for t in row if t != PAD_TOKEN][:40]
    same = stream(toks_s[0].tolist()) == stream(toks_a[0].tolist())
    print(f"greedy outputs identical: {same}")
    return {"accept_len": accept_len, "spec_steps": int(steps_s),
            "ar_steps": int(steps_a), "same": same}


if __name__ == "__main__":
    main()
