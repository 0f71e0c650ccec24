"""The paper's container-scale experiment on the PyTorch port (the port of
``scripts/train_tiny.py``): vicuna-tiny in fp32, a 300-step base, Medusa
and Hydra heads 300 steps each on the data objective, checkpoints
``base_tiny`` and ``heads_{medusa,hydra}_tiny`` in the JAX package's
format, and each variant's acceptance length on 4 prompts of 32 tokens,
48 new tokens, ``default_tree(16, 4, 4)``.  The recipe is
``repro_torch.training.tiny.train_tiny``.

    python3 scripts/torch_train_tiny.py [--steps 300] [--device cuda]
        [--ckpt-dir results/ckpt_torch]

Runs on the card unless ``--device cpu``; without a card it raises.  The
base it writes is the one ``training/tiny.py::base_setup`` (the examples'
substrate) restores afterwards.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.training import tiny  # noqa: E402


def main(argv=None) -> dict:
    """Runs the recipe; returns ``{kind: (mean accepted length, steps)}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=tiny.TINY_STEPS,
                    help="base steps, and head steps for each variant")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help=f"default {tiny.CKPT_DIR}")
    args = ap.parse_args(argv)
    run = tiny.train_tiny(args.steps, ckpt_dir=args.ckpt_dir,
                          device=args.device,
                          log=lambda s: print(s, flush=True))
    print("wall seconds: " + ", ".join(f"{k} {v:.1f}"
                                       for k, v in run.seconds.items()),
          flush=True)
    return run.accept


if __name__ == "__main__":
    main()
