"""End-to-end training script on the PyTorch port: pretrain a ~10M base
model a few hundred steps, train all three draft variants (Medusa and
Hydra heads on the corpus, Hydra++ by self-distillation), and report the
paper's Fig. 2 comparison, with checkpointing and resumable state.  The
port of ``examples/train_hydra_pp.py``; it imports nothing of JAX.

  PYTHONPATH=src python examples/torch_train_hydra_pp.py --base-steps 300 \\
      --head-steps 300 [--device cpu]

Runs on CUDA unless ``--device cpu``; without a card it raises.
Checkpoints go to ``CKPT`` in the JAX example's format
(``training/checkpoint.py``); a second run restores them instead of
training.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import DraftConfig
from repro_torch.core.heads import init_draft_params
from repro_torch.core.speculative import generate
from repro_torch.core.trees import default_tree
from repro_torch.data.synthetic import DataPipeline, MarkovSpec
from repro_torch.device import resolve_device
from repro_torch.models.model import add_unembed_f32, init_params
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.trainer import TrainConfig, train_base, train_heads

CKPT = "results/ckpt_example_torch"

VARIANTS = {
    "medusa": (DraftConfig(kind="medusa", n_heads=4), "data"),
    "hydra": (DraftConfig(kind="hydra", n_heads=4), "data"),
    "hydra++": (DraftConfig(kind="hydra", n_heads=4, n_mlp_layers=4,
                            prefix_attention=True), "distill"),
}


def _restored(path: str) -> bool:
    return os.path.exists(os.path.join(path, "arrays.npz"))


def main(argv=None) -> dict:
    """Runs the example; returns ``{variant: (mean accepted length,
    decode steps)}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-steps", type=int, default=300)
    ap.add_argument("--head-steps", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(get_config("vicuna-tiny"), dtype="float32")
    spec = MarkovSpec(vocab_size=cfg.vocab_size, branch=4, peak=0.7, seed=0)
    pipe = DataPipeline(spec, seq_len=128, batch_size=16, n_train=256,
                        n_eval=32)

    base_path = os.path.join(CKPT, "base")
    params = init_params(cfg, seed=0, device=dev)
    if _restored(base_path):
        params = add_unembed_f32(load_checkpoint(base_path, params), cfg)
        print("base: restored from checkpoint")
    else:
        tc = TrainConfig(total_steps=args.base_steps, warmup=30,
                         log_every=100)
        params, _ = train_base(params, cfg, tc,
                               pipe.train_batches(args.base_steps))
        save_checkpoint(base_path, params)

    tree = default_tree(16, 4, 4)
    prompts = torch.as_tensor(pipe.eval_batch(4)[:, :32], device=dev).long()

    rows = {}
    print(f"{'variant':10s} {'accept_len':>10s} {'steps':>6s}")
    for name, (dc, obj) in VARIANTS.items():
        c2 = dataclasses.replace(cfg, draft=dc)
        dp = init_draft_params(c2, seed=1, device=dev)
        path = os.path.join(CKPT, f"heads_{name}")
        if _restored(path):
            dp = load_checkpoint(path, dp)
        else:
            tc = TrainConfig(total_steps=args.head_steps, warmup=30,
                             log_every=100)
            dp, _ = train_heads(dp, params, c2, tc,
                                pipe.train_batches(args.head_steps),
                                objective=obj)
            save_checkpoint(path, dp)
        _, steps, acc = generate(params, dp, c2, tree, prompts,
                                 max_new_tokens=48, max_len=512)
        rows[name] = (float(acc.mean()), int(steps))
        print(f"{name:10s} {rows[name][0]:10.3f} {rows[name][1]:6d}")
    return rows


if __name__ == "__main__":
    main()
