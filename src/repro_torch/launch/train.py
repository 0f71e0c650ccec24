"""Training launcher (port of ``repro/launch/train.py``, with
``make_train_step`` from ``repro/launch/specs.py``): a few base-model
training steps for an arch, on one device.

    python -m repro_torch.launch.train --arch vicuna-tiny --steps 3 \\
        [--batch 4] [--seq-len 128] [--full-config] [--device cpu]

Without ``--full-config`` the config is the reduced one in fp32, as in
JAX; with it the published config in its own dtype.  Token archs train on
the synthetic corpus (``data/synthetic.py``) through ``lm_loss``; the
audio arch (hubert-xlarge) on a random masked-prediction batch through
``masked_prediction_loss``.  Every arch of the registry trains; an MoE
arch's loss adds its router's load-balance loss.  ``--full-config`` at
the MoE archs' full depth does not fit one card (16B params and their
fp32 AdamW moments): it needs a real cluster.

Every K3 and K6 call of a step runs through its autograd wrapper
(``kernels/flash_attention/ops.py::FlashAttention``,
``kernels/linear_attn_chunk/ops.py::LinearAttnChunk``); Mamba2's SSD is
plain PyTorch.  Runs on CUDA unless ``--device cpu``; without a card it
raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.distill import lm_loss, masked_prediction_loss
from repro_torch.data.synthetic import MarkovSpec, sample_corpus
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params, refresh_unembed_f32
from repro_torch.training.optim import init_adamw
from repro_torch.training.trainer import (TrainConfig, apply_update,
                                          value_and_grad)

# the step's recipe (``repro/launch/specs.py::make_train_step``)
STEP_RECIPE = TrainConfig(peak_lr=1e-3, warmup=100, total_steps=10000,
                          clip_norm=1.0)


def make_train_step(cfg: ModelConfig):
    """A step (params, opt_state, batch) -> (params, opt_state, metrics)
    over a batch ``{"tokens"}`` or, for an audio config, ``{"features",
    "targets", "mask"}``; params are updated in place."""
    if cfg.modality == "audio":
        def loss_fn(p, batch):
            return masked_prediction_loss(p, cfg, batch["features"],
                                          batch["targets"], batch["mask"])
    else:
        def loss_fn(p, batch):
            return lm_loss(p, cfg, batch["tokens"])

    def train_step(params, opt_state, batch):
        _, metrics, grads = value_and_grad(lambda p: loss_fn(p, batch),
                                           params)
        params, opt_state, extra = apply_update(grads, opt_state, params,
                                                STEP_RECIPE)
        refresh_unembed_f32(params, cfg)
        return params, opt_state, dict(metrics, **extra)

    return train_step


def make_batches(cfg: ModelConfig, batch: int, seq_len: int, steps: int,
                 device) -> list:
    """JAX's launcher's batches: one random masked-prediction batch
    repeated (audio), or consecutive slices of the synthetic corpus."""
    if cfg.modality == "audio":
        feats = np.random.RandomState(0).randn(
            batch, seq_len, cfg.d_model).astype(np.float32)
        b = {"features": torch.as_tensor(feats, device=device),
             "targets": torch.as_tensor(np.random.RandomState(1).randint(
                 0, cfg.vocab_size, (batch, seq_len)), device=device),
             "mask": torch.as_tensor(np.random.RandomState(2).rand(
                 batch, seq_len) < 0.3, device=device)}
        return [b] * steps
    spec = MarkovSpec(vocab_size=cfg.vocab_size, seed=0)
    data = sample_corpus(spec, batch * steps, seq_len)
    return [{"tokens": torch.as_tensor(data[i * batch:(i + 1) * batch],
                                       device=device)}
            for i in range(steps)]


def main(argv=None) -> list:
    """Runs the launcher; returns each step's (loss, seconds)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--full-config", action="store_true",
                    help="use the production config (needs a real "
                    "cluster at the MoE archs' full depth)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    dev = resolve_device(args.device)
    print(f"[train] arch={cfg.name} devices=1 ({dev})")

    params = init_params(cfg, seed=0, device=dev)
    opt = init_adamw(params)
    step = make_train_step(cfg)
    batches = make_batches(cfg, args.batch, args.seq_len, args.steps, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    history = []
    t0 = time.time()
    for i, batch in enumerate(batches):
        ts = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        loss = float(metrics["loss"])                  # waits for the step
        history.append((loss, time.perf_counter() - ts))
        if i % 5 == 0 or i == args.steps - 1:
            print(f"[train {i:4d}] loss={loss:.4f} "
                  f"({time.time()-t0:.1f}s)")
    later = [s for _, s in history[1:]] or [history[0][1]]
    mean_s = sum(later) / len(later)
    peak = (f", peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
            f" GiB allocated" if dev.type == "cuda" else "")
    print(f"[train] {len(history)} steps of {args.batch}x{args.seq_len} "
          f"tokens: {mean_s * 1e3:.1f} ms a step after the first, "
          f"{args.batch * args.seq_len / mean_s:.0f} tokens/s{peak}")
    print("[train] done")
    return history


if __name__ == "__main__":
    main()
