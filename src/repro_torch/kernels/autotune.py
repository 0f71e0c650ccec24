"""Block-size autotuner of the port's kernels (port of
``repro/kernels/autotune.py``).

Times each candidate of a kernel's tunable at the shapes the registry
serves on the card and records the winners in ``results/autotune.cuda.json``,
which the wrappers consult through ``repro_torch.kernels.
tuned_block_sizes``.  The port has one tunable, not Pallas's:

* ``flash`` (K3's bf16 builds): ``key_tile``, the keys a stage of the
  TMA-fed K/V ring, where the build's ring and accumulators fit
  (``flash_attention/kernel.py::KEY_TILES``).  Key
  ``flash|dqk=..|dv=..|hq=..|hkv=..|causal=..``: each config is timed at
  its own heads.  The query tile stays at 64, fixed by the body's one
  consumer warpgroup; the fp32 builds are not tuned.

JAX's other tunables have no counterpart.  The tree-verify kernels' pad
of the tree axis (K1, K2, K4) and K5's split length were swept on the
card (pads 8/16/32 at every tree key of the registry, splits 64-512 at
deepseek-v2-lite-16b): the constants ``T_PAD`` and ``split.py::
plan_mla_split_len`` won or tied every key, so they stay constants.  K6
has no tunable, as in JAX.

CLI:

    python -m repro_torch.kernels.autotune sweep [--out FILE] [--keys K ...]
    python -m repro_torch.kernels.autotune check [--cache FILE]

``sweep`` (on the card only: it raises without CUDA) holds every
candidate of every required key against its plain version, raising on a
wrong one, times the candidates in turns over several rounds with CUDA
events and writes the winners, each with ``sweep_us`` per candidate (the
median of the rounds), beside the card's name and power limit and the
torch and CUDA versions.  ``check`` reads a cache file (on any machine)
and exits non-zero if it misses a key of ``required_keys``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.kernels import autotune_cache_path, block_size_key
from repro_torch.kernels.flash_attention import kernel as flash_kernel

# the candidate grid, cut to each build's KEY_TILES
CANDIDATES = {"flash": [{"key_tile": n}
                        for n in flash_kernel.TILE_CANDIDATES]}

PREFILL_S = 1536               # the served prefill (chip_smoke.py phase 3)
TOL = 2e-2                     # bf16, phase 3's tolerance
ROUNDS, CALLS, SETS = 7, 10, 8


def candidates(variant: str, shape: dict) -> list:
    """The candidates of ``variant`` that can run at ``shape``."""
    tiles = flash_kernel.KEY_TILES[(shape["dqk"], shape["dv"])]
    return [c for c in CANDIDATES[variant] if c["key_tile"] in tiles]


# ---------------------------------------------------------------------------
# required keys: what the registry resolves at full width on the card
# ---------------------------------------------------------------------------


def calls_for(cfg) -> list:
    """``(variant, shape)`` of every tuned call ``cfg`` makes at full
    width on the card, by the wrapper's own key function: the bf16
    prefill (K3; MLA's at its own widths, and the Hydra++ prefix layer's
    GQA one).  At widths without a bf16 build, as a reduced config's, K3
    has no tunable."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    if cfg.block_kind != "attn" and not cfg.hybrid_attn_every:
        return []                  # pure recurrent stacks: K6 only
    hq, hkv, hd = cfg.n_heads_padded, cfg.n_kv_heads, cfg.resolved_head_dim
    gqa = flash_ops.tuning_shape(hd, hd, hq, hkv, not cfg.encoder_only)
    if cfg.mla is None:
        shapes = [gqa]
    else:
        m = cfg.mla
        shapes = [flash_ops.tuning_shape(m.qk_nope_dim + m.qk_rope_dim,
                                         m.v_head_dim, cfg.n_heads,
                                         cfg.n_heads, True)]
        if cfg.draft.prefix_attention:
            shapes.append(gqa)
    return [("flash", s) for s in shapes
            if (s["dqk"], s["dv"]) in flash_kernel.DIMS]


def resolve_calls(cfg) -> dict:
    """``{key: resolved key tile}`` for each tuned call of ``cfg``,
    through the wrapper's own resolve function (what a CUDA call of that
    shape launches with)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    return {block_size_key(variant, shape): flash_ops.resolve_key_tile(
        *(shape[n] for n in ("dqk", "dv", "hq", "hkv")),
        bool(shape["causal"])) for variant, shape in calls_for(cfg)}


def required_keys() -> dict:
    """``{key: (variant, shape)}`` for every key the registry resolves at
    full width on the card (``calls_for`` of each config)."""
    from repro_torch.configs import get_config, list_configs

    return dict(sorted((block_size_key(variant, shape), (variant, shape))
                       for name in list_configs()
                       for variant, shape in calls_for(get_config(name))))


# ---------------------------------------------------------------------------
# the candidates' calls, checks and timing
# ---------------------------------------------------------------------------


def _flash_bench(shape: dict, dev) -> tuple:
    """(run(cand, operands), check(cand, what), operand sets): K3's whole
    prefill at S = 1536 (B = 1) held against its plain version, and,
    causal, a chunk of 256 rows at 1024 over the first 1280 keys bitwise
    equal to the whole prefill's rows."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd

    dqk, dv, hq, hkv = shape["dqk"], shape["dv"], shape["hq"], shape["hkv"]
    causal = bool(shape["causal"])
    S = PREFILL_S

    def operands(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        r = lambda h, d: torch.randn((1, S, h, d), generator=g,
                                     device=dev).to(torch.bfloat16)
        return r(hq, dqk), r(hkv, dqk), r(hkv, dv)

    sets = [operands(seed) for seed in range(SETS)]

    def run(cand, args):
        return flash_attention_bshd(*args, causal=causal,
                                    key_tile=cand["key_tile"])

    def check(cand, what):
        q, k, v = sets[0]
        whole = run(cand, sets[0])
        _close(whole, flash_attention_plain(q, k, v, causal=causal), what)
        if causal:
            lo, C = 1024, 256
            chunk = flash_attention_bshd(
                q[:, lo:lo + C].contiguous(), k, v, causal=True, q_off=lo,
                kv_valid_len=torch.full((1,), lo + C, dtype=torch.int32,
                                        device=dev),
                key_tile=cand["key_tile"])
            if not torch.equal(chunk, whole[:, lo:lo + C]):
                raise AssertionError(f"{what}: a chunk's rows differ from "
                                     "the whole prefill's")

    return run, check, sets


BENCHES = {"flash": _flash_bench}


def _close(out, ref, what: str) -> None:
    """``out`` finite and within phase 3's bf16 tolerance of ``ref``."""
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: output not finite")
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL,
                               msg=lambda m: f"{what}: {m}")


def _device_us(fns: list, rounds: int = ROUNDS, calls: int = CALLS) -> list:
    """Median device µs a call of each of ``fns``, timed in turns: each
    round times every function (in an order rotated round by round) over
    ``calls`` back-to-back calls queued behind a sleep kernel, so the
    CUDA events around them time the device alone."""
    for fn in fns:                                 # warm up, time enqueue
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fn in fns:
        for _ in range(calls):
            fn()
    enqueue_s = (time.perf_counter() - t0) / len(fns)
    torch.cuda.synchronize()
    sleep = int(2e9 * max(2e-3, 2 * enqueue_s))   # clock64 ticks <= 2 GHz
    per = [[] for _ in fns]
    for rnd in range(rounds):
        order = [(i + rnd) % len(fns) for i in range(len(fns))]
        for i in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(sleep)
            start.record()
            for _ in range(calls):
                fns[i]()
            end.record()
            end.synchronize()
            per[i].append(start.elapsed_time(end) * 1e3 / calls)
    return [statistics.median(p) for p in per]


def label(cand: dict) -> str:
    return "x".join(str(v) for v in cand.values())


def sweep_entry(variant: str, shape: dict) -> dict:
    """Hold every candidate of one key against its plain version (a wrong
    one raises), time them, and return the winner entry: the winning
    tunables and ``sweep_us``, µs a call per candidate.  Needs the card."""
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")
    key = block_size_key(variant, shape)
    run, check, sets = BENCHES[variant](shape, dev)
    cands = candidates(variant, shape)
    with torch.no_grad():
        for cand in cands:
            check(cand, f"autotune {key} {label(cand)}")

        def timed(cand):
            turn = iter(range(10 ** 9))
            return lambda: run(cand, sets[next(turn) % len(sets)])

        us = _device_us([timed(c) for c in cands])
    entry = dict(cands[us.index(min(us))])
    entry["sweep_us"] = {label(c): round(t, 2) for c, t in zip(cands, us)}
    return entry


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def sweep(keys=None, log=print) -> dict:
    """Sweep every required key (or those of ``keys``); returns the cache
    payload.  Needs the card."""
    from repro_torch.device import resolve_device

    resolve_device("cuda")
    req = required_keys()
    unknown = sorted(set(keys or ()) - set(req))
    if unknown:
        raise ValueError(f"not required keys: {unknown}")
    entries = {}
    for key, (variant, shape) in req.items():
        if keys and key not in keys:
            continue
        entries[key] = sweep_entry(variant, shape)
        winner = {k: v for k, v in entries[key].items() if k != "sweep_us"}
        log(f"{key}: winner {winner} us {entries[key]['sweep_us']}")
    return {"format": 1, "backend": "cuda", "card": card(),
            "device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "entries": entries}


def missing_keys(path: str) -> list:
    """The required keys ``path`` lacks (raises if it cannot be read)."""
    with open(path) as f:
        entries = json.load(f).get("entries", {})
    return [k for k in required_keys() if k not in entries]


def _sweep_main(args) -> int:
    path = args.out or autotune_cache_path()
    payload = sweep(args.keys)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(payload['entries'])} entries -> {path}")
    return 0


def _check_main(args) -> int:
    path = args.cache or autotune_cache_path()
    try:
        missing = missing_keys(path)
    except (OSError, ValueError) as e:
        print(f"FAIL: cannot read winner cache {path}: {e}")
        return 1
    if missing:
        print(f"FAIL: {path} is missing {len(missing)} required winner "
              "entries (those calls would fall through to the defaults):")
        for key in missing:
            print(f"  {key}")
        return 1
    print(f"OK: {path} covers all {len(required_keys())} required keys")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("sweep", help="time candidates on the card, write "
                        "the winner cache")
    sp.add_argument("--out", help="output path (default: the committed "
                    "cache)")
    sp.add_argument("--keys", nargs="*", help="restrict to these keys")
    cp = sub.add_parser("check", help="fail if the cache misses a required "
                        "key")
    cp.add_argument("--cache", help="cache to check (default: the "
                    "committed cache)")
    args = ap.parse_args(argv)
    return _sweep_main(args) if args.cmd == "sweep" else _check_main(args)


if __name__ == "__main__":
    sys.exit(main())
