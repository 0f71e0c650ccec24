"""Serving launcher for the port: one speculative-decoding service per arch.

    python -m repro_torch.launch.serve --arch minitron-4b --full-config \\
        --engine paged

Any arch of the port's registry serves: the full-attention stacks
(``minitron-4b``, ``vicuna-tiny``, ``starcoder2-7b``, ``qwen2.5-32b``
with its QKV bias, ``chameleon-34b`` over token ids), the sliding-window
one (``gemma3-1b``), the MoE ones (``deepseek-v2-lite-16b`` under MLA,
``deepseek-moe-16b`` under GQA), the recurrent one (``rwkv6-1.6b``) and
the hybrid one (``zamba2-1.2b``: Mamba2 layers and a shared attention
block), the last two with chain speculation; the encoder-only
``hubert-xlarge`` is refused (no decode service).  Without
``--full-config`` the reduced config runs in fp32 (a smoke run); with it,
the published widths in ``cfg.dtype``.
Weights are random, drawn on the device from a seeded
``torch.Generator``.  The engine runs on CUDA unless ``--device cpu`` is
given.  ``--prefill-chunk N`` prefills in chunks of N tokens beside the
decode steps (``--prefill-budget``: prompt tokens per step, default one
chunk; continuous and paged engines); ``--engine bucketed`` runs the
static baseline.  The continuous and paged engines run the async loop
(two steps in flight) with the decode step captured as one CUDA graph;
``--sync`` runs the synchronous loop (``inflight=1``), ``--eager`` the
step without the graph, and ``--stream`` submits half the requests up
front and feeds the rest through a generator source (the live queue).
``--long-prompts`` makes every 4th request 4x ``--prompt-len`` long,
the head-of-line workload chunked prefill is for.  Prints the same
``[serve]`` lines as ``repro/launch/serve.py`` where the port has the
fields.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=2,
                    help="slot-pool size (max_batch)")
    ap.add_argument("--requests", type=int, default=0,
                    help="number of requests (default: --batch)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--ragged", action="store_true",
                    help="vary prompt lengths in [prompt-len/2, prompt-len]")
    ap.add_argument("--long-prompts", action="store_true",
                    help="make every 4th request a long prompt (4x "
                         "prompt-len): the head-of-line workload chunked "
                         "prefill is for")
    ap.add_argument("--max-new-tokens", type=int, default=24)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: split every prompt into "
                         "fixed-size chunks the scheduler interleaves "
                         "with decode steps (0 = whole-prompt join; "
                         "continuous/paged engines only)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="max prompt tokens co-scheduled per decode step "
                         "(default: one chunk)")
    ap.add_argument("--engine", choices=("continuous", "paged", "bucketed"),
                    default="continuous")
    ap.add_argument("--sync", action="store_true",
                    help="disable the double-buffered host loop "
                         "(inflight=1; continuous/paged engines only)")
    ap.add_argument("--stream", action="store_true",
                    help="feed requests through the live-queue API "
                         "(submit() + a generator source) instead of a "
                         "pre-collected list")
    ap.add_argument("--eager", action="store_true",
                    help="run the decode step eagerly instead of as one "
                         "captured CUDA graph (continuous/paged engines)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged engine: tokens per KV block")
    ap.add_argument("--pool-frac", type=float, default=0.5,
                    help="paged engine: block-pool size as a fraction of "
                         "the dense max_batch x max_len footprint")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve call with torch.profiler and "
                         "print device busy time, the top kernels and the "
                         "prefill kernels' launches per chunk")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, tree_for
    from repro_torch.core.heads import init_draft_params
    from repro_torch.device import resolve_device
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import (BucketedEngine,
                                            PagedSpeculativeEngine, Request,
                                            SpeculativeEngine)

    cfg = get_config(args.arch)
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode service "
                         "(DESIGN.md §4)")
    device = resolve_device(args.device)
    if device.type == "cuda":
        # build every kernel before the clock starts: the engine's warm-up
        # step does not reach the prefill kernels (K3, K6), whose first
        # build would otherwise land in the first request's TTFT
        from repro_torch.kernels import build
        build.build()
    if not args.full_config:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")

    params = init_params(cfg, seed=0, device=device)
    dp = init_draft_params(cfg, seed=1, device=device)
    tree = tree_for(cfg)
    print(f"[serve] arch={cfg.name} tree={tree.size} "
          f"(chain={tree.max_depth + 1 == tree.size}) device={device}")

    max_len = 512
    engine_kw = {"inflight": 1 if args.sync else 2,
                "capture_step": not args.eager}
    if args.prefill_chunk and args.engine != "bucketed":
        engine_kw.update(prefill_chunk=args.prefill_chunk,
                        prefill_budget=args.prefill_budget or None)
    if args.engine == "paged":
        usable = max(int(args.pool_frac * args.batch * max_len)
                     // args.block_size, 4)
        eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=max_len,
                                     block_size=args.block_size,
                                     num_blocks=usable + 1, device=device,
                                     **engine_kw)
    elif args.engine == "continuous":
        eng = SpeculativeEngine(params, dp, cfg, tree, max_len=max_len,
                                device=device, **engine_kw)
    else:
        eng = BucketedEngine(params, dp, cfg, tree, max_len=max_len,
                             device=device)
    rs = np.random.RandomState(0)
    n_requests = args.requests or args.batch
    reqs = []
    for i in range(n_requests):
        plen = (rs.randint(max(args.prompt_len // 2, 1), args.prompt_len + 1)
                if args.ragged else args.prompt_len)
        if args.long_prompts and i % 4 == 0:
            plen = 4 * args.prompt_len
        reqs.append(Request(
            prompt=rs.randint(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=args.max_new_tokens))
    if args.profile:
        stats = _profiled_serve(eng, reqs, args.batch)
    elif args.stream and args.engine != "bucketed":
        # the live queue: half the traffic submitted up front, the rest
        # arriving through a generator source as slots free up
        split = max(n_requests // 2, 1)
        for r in reqs[:split]:
            eng.submit(r)
        stats = eng.serve(source=iter(reqs[split:]), max_batch=args.batch)
    else:
        stats = eng.serve(reqs, max_batch=args.batch)
    print(f"[serve] engine={args.engine} steps={stats.steps} "
          f"tokens={stats.tokens} tok/step={stats.tokens_per_step:.2f} "
          f"tok/s={stats.tokens_per_s:.1f} "
          f"util={stats.slot_utilization:.3f} "
          f"mean_lat={stats.mean_latency_s * 1e3:.1f}ms "
          f"p99_lat={stats.p99_latency_s * 1e3:.1f}ms "
          f"ttft={stats.mean_ttft_s * 1e3:.1f}ms "
          f"p99_itl={stats.p99_itl_s * 1e3:.1f}ms "
          f"host_stall={stats.host_stall_s * 1e3:.1f}ms "
          f"({stats.host_stall_frac:.0%} of wall) "
          f"read_wait={stats.read_wait_s * 1e3:.1f}ms "
          f"inflight_peak={stats.steps_in_flight} "
          f"step={stats.mean_step_s * 1e3:.1f}ms")
    if getattr(eng, "captured", None) is not None:
        print(f"[serve] captured step: one CUDA graph, "
              f"{eng.captured.replays} replays, launches per replay "
              f"{ {k: n for k, n in eng.captured.launches.items() if n} }")
    if eng.prefill_chunk:
        print(f"[serve] chunked prefill: chunk={eng.prefill_chunk} "
              f"budget={eng.prefill_budget} "
              f"prefill_chunks={stats.prefill_chunks} "
              f"prefill_tokens={stats.prefill_tokens}")
    if stats.pool_tokens:
        print(f"[serve] paged KV: pool={stats.pool_tokens} tok "
              f"(dense equivalent {stats.dense_equiv_tokens} tok, "
              f"{1.0 / stats.kv_pool_frac:.1f}x oversubscribed) "
              f"peak_blocks={stats.peak_blocks_in_use}/"
              f"{stats.num_blocks - 1} preemptions={stats.preemptions}")


def _profiled_serve(eng, reqs, max_batch: int):
    """Serve under torch.profiler and print the device time per decode
    step (warm-up step included) against the traced step time, the
    operators that took the most device time, and each of the port's
    kernels' launches and share of device time.  Serving numbers from a
    traced run carry the tracing overhead; compare busy time with an
    untraced run's step time to estimate the idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import ops as k3
    from repro_torch.kernels.linear_attn_chunk import ops as k6

    acts = [ProfilerActivity.CPU]
    if eng.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    k3.launches = k3.chunk_launches = k6.launches = 0
    with profile(activities=acts) as prof:
        stats = eng.serve(reqs, max_batch=max_batch)
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
    # one stream: device work never overlaps, so the kernels' durations
    # add up to the busy time; one pass over the events (a serve traces
    # millions of them)
    busy_us, port = 0.0, {name: [] for name in PORT_KERNELS}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy_us += us
        name = next((k for k in PORT_KERNELS if k in e.name), None)
        if name is not None:
            port[name].append(us)
    n = stats.steps + stats.warmup_steps
    per_step = busy_us / 1e3 / max(n, 1)
    print(f"[profile] device busy {busy_us / 1e3:.1f}ms over {n} steps: "
          f"{per_step:.2f}ms/step against a traced step of "
          f"{stats.mean_step_s * 1e3:.1f}ms "
          f"({per_step / max(stats.mean_step_s * 1e3, 1e-9):.1%} busy)")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15))
    for name, us in port.items():
        if us:
            print(f"[profile] {name}: {len(us)} launches, "
                  f"{sum(us) / 1e3:.1f}ms ({sum(us) / max(busy_us, 1e-9):.1%} "
                  f"of device time), {sum(us) / len(us):.1f}us each")
    if stats.prefill_chunks:
        n = stats.prefill_chunks
        print(f"[profile] prefill chunks: {n}; K3 launches per chunk "
              f"{k3.launches / n:.2f} ({k3.chunk_launches} in the chunk "
              f"form of {k3.launches}); K6 launches per chunk "
              f"{k6.launches / n:.2f}")
    return stats


# the port's hand-written kernels, as the profiler names them
PORT_KERNELS = ("tree_attention_split_kernel", "tree_attention_merge_kernel",
                "flash_attention_kernel", "mla_attention_split_kernel",
                "mla_attention_merge_kernel", "linear_attn_chunk_kernel",
                "linear_attn_scan_kernel")


if __name__ == "__main__":
    # run as a script (python src/repro_torch/launch/serve.py): put src/
    # on the path; `python -m repro_torch.launch.serve` needs PYTHONPATH=src
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    main()
