"""Paper §4 end-to-end on the PyTorch port: measure head rank-acceptance
statistics on a sample corpus, greedily grow proposal trees T_1..T_N,
and pick the throughput-optimal tree for this machine.  The port of
``examples/tree_search.py``; it imports nothing of JAX.

  PYTHONPATH=src python examples/torch_tree_search.py [--device cpu]

Uses the checkpoints of ``repro_torch.training.tiny`` (trains them on
first run).  Runs on CUDA unless ``--device cpu``; without a card it
raises.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.tree_search import (expected_accept_length,
                                          grow_trees, measure_rank_acc)
from repro_torch.device import resolve_device
from repro_torch.training.tiny import (base_setup, draft_setup, eval_prompts,
                                       timed_generate)


def main(argv=None) -> dict:
    """Runs the example; returns ``{"tok_s": {tree size: tokens/s},
    "accept": {tree size: accepted length}, "selected": tree size}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, params, pipe = base_setup(dev)
    c2, dp = draft_setup("hydra", device=dev)
    eval_toks = torch.as_tensor(pipe.eval_batch(8)[:, :96],
                                device=dev).long()

    print("== stage 1: measured rank-acceptance statistics acc[d, r]")
    acc = measure_rank_acc(params, dp, c2, eval_toks, max_rank=8)
    for d in range(acc.shape[0]):
        print(f"  head {d + 1}: " + " ".join(f"{a:.3f}" for a in acc[d]))

    print("== stage 2: greedy proposal-tree growth")
    trees = grow_trees(acc, n_max=32, max_children=8)
    for t in trees[::8] + [trees[-1]]:
        print(f"  T={t.size:3d} depth={t.max_depth} "
              f"E[accept]={expected_accept_length(t, acc):.3f}")

    print("== stage 3: throughput sweep on this machine")
    prompts = eval_prompts(1, device=dev)
    best = (None, -1.0)
    tok_s, accept = {}, {}
    for t in [trees[3], trees[7], trees[15], trees[-1]]:
        tps, al, _, _ = timed_generate(params, dp, c2, t, prompts,
                                       max_new_tokens=24)
        tok_s[t.size], accept[t.size] = tps, al
        star = ""
        if tps > best[1]:
            best = (t.size, tps)
            star = "  <-- best so far"
        print(f"  T={t.size:3d}: {tps:6.1f} tok/s, accept={al:.2f}{star}")
    print(f"selected tree size: {best[0]}")
    return {"tok_s": tok_s, "accept": accept, "selected": best[0]}


if __name__ == "__main__":
    main()
