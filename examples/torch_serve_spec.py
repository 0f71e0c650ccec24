"""Batched speculative serving (paper §6.2) on the PyTorch port: run the
continuous-batching engines over a ragged request stream, Hydra vs
Medusa vs autoregressive, with the bucketed static scheduler as the
baseline.  The port of ``examples/serve_spec.py``; it imports nothing of
JAX.

  PYTHONPATH=src python examples/torch_serve_spec.py [--batch 4] \\
      [--device cpu]

Uses the checkpoints of ``repro_torch.training.tiny`` (trains them on
first run).  Runs on CUDA unless ``--device cpu``; without a card it
raises.  Under greedy decoding the three engines of a mode deliver the
same streams, which the last line of each mode says.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.trees import default_tree
from repro_torch.device import resolve_device
from repro_torch.serving.engine import (BucketedEngine,
                                        PagedSpeculativeEngine, Request,
                                        SpeculativeEngine)
from repro_torch.training.tiny import base_setup, draft_setup

MODES = ("autoregressive", "medusa", "hydra", "hydra++")
ENGINES = ("continuous", "paged", "bucketed")


def main(argv=None) -> dict:
    """Runs the example; returns ``{(mode, engine): (EngineStats, the
    requests' outputs)}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4,
                    help="slot-pool size (max_batch)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, params, pipe = base_setup(dev)
    tree = default_tree(16, 4, 4)
    rng = np.random.RandomState(0)

    def make_requests():
        # ragged stream: mixed prompt lengths AND budgets
        toks = pipe.eval_batch(args.requests)
        return [Request(prompt=np.asarray(toks[i, :rng.randint(16, 33)]),
                        max_new_tokens=rng.randint(
                            args.max_new_tokens // 2, args.max_new_tokens + 1))
                for i in range(args.requests)]

    results = {}
    for mode in MODES:
        if mode == "autoregressive":
            c2, dp, spec = cfg, None, False
        else:
            c2, dp = draft_setup(mode, device=dev)
            spec = True
        # paged: a block pool reserving 25% of the dense footprint
        paged_kw = {"block_size": 16,
                    "num_blocks": 1 + (args.batch * 512 // 4) // 16}
        for name, engine_cls, ekw in (
                ("continuous", SpeculativeEngine, {}),
                ("paged", PagedSpeculativeEngine, paged_kw),
                ("bucketed", BucketedEngine, {})):
            eng = engine_cls(params, dp, c2, tree, max_len=512,
                             use_speculative=spec, device=dev, **ekw)
            rng.seed(0)  # identical workload for every engine/mode pair
            reqs = make_requests()
            stats = eng.serve(reqs, max_batch=args.batch)
            results[(mode, name)] = (stats, [list(r.output) for r in reqs])
            mem = (f" kv_pool={stats.pool_tokens}tok"
                   f" peak_blocks={stats.peak_blocks_in_use}"
                   if stats.pool_tokens else "")
            print(f"{mode:16s} {name:10s} steps={stats.steps:4d} "
                  f"tokens={stats.tokens:5d} "
                  f"tok/step={stats.tokens_per_step:5.2f} "
                  f"tok/s={stats.tokens_per_s:7.1f} "
                  f"util={stats.slot_utilization:.3f} "
                  f"mean_lat={stats.mean_latency_s * 1e3:7.1f}ms "
                  f"host_stall={stats.host_stall_s * 1e3:6.1f}ms{mem}")
        same = all(results[(mode, e)][1] == results[(mode, "continuous")][1]
                   for e in ENGINES)
        print(f"{mode:16s} greedy streams equal across engines: {same}")
    return results


if __name__ == "__main__":
    main()
