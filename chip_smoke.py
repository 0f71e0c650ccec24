#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel of the port from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, started together);
3. hold the paged tree-verify kernel against its plain PyTorch version at
   minitron-4b head shapes (B=4, Hq=24, Hkv=8, D=128, block 16, T=16 and
   T=5): ragged lengths (0 and a partial last block), NULL holes below
   ``cache_len``, block 0 poisoned with 0, +-1e4, NaN and inf (outputs
   must be bitwise equal), fp32 with TF32 off (atol = rtol = 1e-4) and
   bf16 (atol = rtol = 2e-2); time the kernel, its plain version and
   ``scaled_dot_product_attention`` on the gathered view (a yardstick the
   port never calls), beside the least time the card needs;
4. tiny fp32 parity: ``minitron-4b.reduced()`` Hydra++ served through the
   paged engine (the kernel) equals the port's dense ``generate()``;
5. full width: ``minitron-4b`` in bf16, random weights drawn on the card
   from a seeded ``torch.Generator``; one verify step paged (the kernel)
   against dense (plain attention); then the paged engine serves 8
   requests (prompts 64-256, 32 new tokens, max_batch 4, block 16,
   max_len 512, pool half the dense footprint) and the kernel's launch
   count must equal 33 per decode step (32 layers + the prefix layer),
   the warm-up step included;
6. a JSON line with each kernel's numbers, then the result line.

The script stands alone: it puts ``src/`` on ``sys.path`` itself, and it
fails (without a result line) where CUDA is missing or the package is not
beside it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around
    ``iters`` calls after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: the paged tree-verify kernel against its plain version
# ---------------------------------------------------------------------------

B, HQ, HKV, D, BS, M = 4, 24, 8, 128, 16, 32        # minitron-4b, max_len 512
LENS = (0, 37, 144, 300)                            # empty, partial, exact
HOLES = ((2, 3), (3, 0))                            # NULL below cache_len


def _k1_inputs(T: int, dtype, seed: int, poison: float = 0.0):
    """One set of K1 operands on the card (model layout)."""
    import torch
    from repro_torch.core.trees import default_tree

    table = torch.zeros((B, M), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(LENS):
        need = -(-(n + T) // BS)
        table[b, :need] = torch.arange(nxt, nxt + need, dtype=torch.int32)
        nxt += need
    for b, j in HOLES:
        table[b, j] = 0
    N = nxt
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    pool_k, pool_v = r(N, BS, HKV, D), r(N, BS, HKV, D)
    pool_k[0] = poison
    pool_v[0] = poison
    return (r(B, T, HQ, D), pool_k, pool_v, r(B, T, HKV, D), r(B, T, HKV, D),
            torch.as_tensor(default_tree(T, 4, 4).ancestor_mask,
                            device="cuda"),
            torch.tensor(LENS, dtype=torch.int32, device="cuda"),
            table.cuda())


def _k1_bound_ms(T: int, dtype_name: str, table) -> tuple:
    """Least time for one call: bytes it must move (each input read
    once, the output written once; cache positions counted only where
    this run's table holds a real block below cache_len) over HBM rate,
    against its operations over the peak rate for the type."""
    elt = 2 if dtype_name != "float32" else 4
    tbl = table.cpu()
    keys = []
    for b, n in enumerate(LENS):
        keys.append(sum(min(BS, n - j * BS) for j in range(-(-n // BS))
                        if int(tbl[b, j]) != 0))
    kv_bytes = sum(keys) * HKV * D * 2 * elt
    io_bytes = (2 * B * T * HQ * D + 2 * B * T * HKV * D) * elt
    small = B * M * 4 + B * 4 + T * T
    nbytes = kv_bytes + io_bytes + small
    flops = sum(4 * HQ * T * D * (k + T) for k in keys)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sdpa_args(args):
    """The gathered view + boolean mask SDPA takes (built outside the
    timed call)."""
    import torch

    q, pool_k, pool_v, tk, tv, tm, lens, table = args
    T = q.shape[1]
    S = M * BS
    t = table.long()
    ck = pool_k[t].reshape(B, S, HKV, D)
    cv = pool_v[t].reshape(B, S, HKV, D)
    pos = torch.arange(S, device="cuda")
    valid = (t != 0).repeat_interleave(BS, 1) & (pos[None] < lens[:, None])
    G = HQ // HKV
    k = torch.cat([ck, tk], 1).transpose(1, 2).repeat_interleave(G, 1)
    v = torch.cat([cv, tv], 1).transpose(1, 2).repeat_interleave(G, 1)
    # NULL holes hold garbage: zero them so masked-out NaN cannot leak
    keep = torch.cat([valid, torch.ones(B, T, dtype=torch.bool,
                                        device="cuda")], 1)
    k = torch.where(keep[:, None, :, None], k, 0)
    v = torch.where(keep[:, None, :, None], v, 0)
    mask = torch.cat([valid[:, None, :].expand(B, T, S),
                      tm[None].expand(B, T, T)], 2)[:, None]
    return q.transpose(1, 2).contiguous(), k, v, mask


def check_k1() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.tree_attention import ops
    from repro_torch.kernels.tree_attention.kernel import (
        tree_attention_paged_plain)

    record = {}
    for dtype_name, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        dtype = getattr(torch, dtype_name)
        for T in (16, 5):
            outs = []
            for poison in (0.0, 1e4, -1e4, math.nan, math.inf):
                args = _k1_inputs(T, dtype, seed=T, poison=poison)
                outs.append(ops.tree_attention_paged_bshd(*args))
            torch.cuda.synchronize()
            for o in outs[1:]:
                if not torch.equal(o, outs[0]):
                    raise AssertionError(f"K1 {dtype_name} T={T}: a poisoned "
                                         "NULL block changed the output")
            ref = tree_attention_paged_plain(*args)
            err = (outs[0].float() - ref.float()).abs().max().item()
            torch.testing.assert_close(outs[0].float(), ref.float(),
                                       atol=tol, rtol=tol)
            if not torch.isfinite(outs[0]).all():
                raise AssertionError("K1 output not finite")

            # timing: 32 operand sets (> the 50 MB L2 for bf16), cycled,
            # as the 33 layers of a step cycle through their pools
            sets = [_k1_inputs(T, dtype, seed=100 + i) for i in range(32)]
            it = iter(range(10 ** 9))
            pick = lambda: sets[next(it) % len(sets)]
            ms = time_ms(lambda: ops.tree_attention_paged_bshd(*pick()))
            plain_ms = time_ms(lambda: tree_attention_paged_plain(*pick()),
                               iters=10)
            sd = [_sdpa_args(s) for s in sets[:8]]
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                *sd[next(it) % len(sd)][:3],
                attn_mask=sd[0][3]), iters=50)
            bound_ms, bound_by = _k1_bound_ms(T, dtype_name, args[-1])
            record[(dtype_name, T)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)
            log(f"[k1] {dtype_name} T={T}: max_abs_err={err:.3e} "
                f"kernel={ms * 1e3:.1f}us bound={bound_ms * 1e3:.2f}us "
                f"({bound_by}) plain={plain_ms * 1e3:.1f}us "
                f"sdpa={lib_ms * 1e3:.1f}us")
            del sets, sd
    return record


# ---------------------------------------------------------------------------
# phase 4: tiny fp32 parity, paged engine (kernel) == dense generate()
# ---------------------------------------------------------------------------


def check_tiny_parity() -> None:
    import numpy as np
    import torch
    from repro_torch.configs import get_config, tree_for
    from repro_torch.core.heads import init_draft_params
    from repro_torch.core.speculative import PAD_TOKEN, generate
    from repro_torch.kernels.tree_attention import ops
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import PagedSpeculativeEngine, Request

    base = dataclasses.replace(get_config("minitron-4b").reduced(),
                               dtype="float32")
    # the reduced vocabulary, and 16 tokens so random heads get accepted
    for cfg in (base, dataclasses.replace(base, vocab_size=16)):
        params = init_params(cfg, seed=0, device="cuda")
        dp = init_draft_params(cfg, seed=1, device="cuda")
        tree = tree_for(cfg)
        rs = np.random.RandomState(0)
        reqs, refs = [], []
        for n, budget in zip((16, 23, 32, 9, 40, 12), (12, 14, 8, 10, 13, 9)):
            prompt = rs.randint(0, cfg.vocab_size, n).astype(np.int32)
            t, _, _ = generate(params, dp, cfg, tree,
                               torch.as_tensor(prompt, device="cuda")[None]
                               .long(), max_new_tokens=budget, max_len=128)
            row = [int(x) for x in t[0].tolist() if x != PAD_TOKEN]
            refs.append(row[:budget])
            reqs.append(Request(prompt=prompt, max_new_tokens=budget))
        before = ops.launches
        eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=128,
                                     block_size=16, num_blocks=6)
        st = eng.serve(reqs, max_batch=4)
        for r, ref in zip(reqs, refs):
            if r.output != ref:
                raise AssertionError(f"tiny parity (V={cfg.vocab_size}): "
                                     f"paged {r.output} != dense {ref}")
        if ops.launches == before:
            raise AssertionError("tiny parity never launched the kernel")
        log(f"[tiny] V={cfg.vocab_size}: paged engine == dense generate() "
            f"for {len(reqs)} requests; steps={st.steps} "
            f"tok/step={st.tokens_per_step:.2f} "
            f"preemptions={st.preemptions}")


# ---------------------------------------------------------------------------
# phase 5: full-width minitron-4b Hydra++ through the paged engine
# ---------------------------------------------------------------------------


def check_full_verify(params, dp, cfg) -> None:
    """One full-width verify forward, paged (kernel) against dense (plain
    attention), from the same prefill."""
    import torch
    from repro_torch.configs import tree_for
    from repro_torch.core.heads import draft_tree_tokens
    from repro_torch.core.speculative import init_decode_state
    from repro_torch.core.trees import device_arrays
    from repro_torch.models.model import forward

    tree = tree_for(cfg)
    g = torch.Generator(device="cuda").manual_seed(5)
    P, S = 100, 256
    prompt = torch.randint(0, cfg.vocab_size, (1, P), generator=g,
                           device="cuda")
    st = init_decode_state(params, dp, cfg, prompt, S)
    tokens, _ = draft_tree_tokens(dp, cfg, params, tree, st.last_hidden,
                                  st.last_token)
    ta = device_arrays(tree, prompt.device)
    pos = st.cache_len[:, None] + ta["depth"][None]
    table = torch.arange(1, S // 16 + 1, dtype=torch.int32,
                         device="cuda")[None]
    pools = [{k: torch.zeros((cfg.n_layers, S // 16 + 1, 16) + v.shape[3:],
                             dtype=v.dtype, device="cuda")
              for k, v in st.cache[0].items()}]
    for k in ("k", "v"):
        pools[0][k][:, 1:] = st.cache[0][k][:, 0].reshape(
            cfg.n_layers, S // 16, 16, *st.cache[0][k].shape[3:])
    dense = forward(params, cfg, tokens, pos, mode="verify", cache=st.cache,
                    cache_len=st.cache_len, tree_mask=ta["mask"])
    paged = forward(params, cfg, tokens, pos, mode="verify", cache=pools,
                    cache_len=st.cache_len, tree_mask=ta["mask"],
                    block_table=table)
    if not torch.isfinite(paged.logits).all():
        raise AssertionError("full-width paged logits not finite")
    rel = ((paged.logits - dense.logits).abs().max()
           / dense.logits.abs().max()).item()
    agree = (paged.logits.argmax(-1) == dense.logits.argmax(-1)).float()
    log(f"[full] verify paged vs dense: max rel logit diff={rel:.3e} "
        f"argmax agreement={agree.mean().item():.3f}")
    if rel > 0.1:
        raise AssertionError(f"paged and dense verify disagree: rel {rel}")


def serve_full_width() -> int:
    import numpy as np
    import torch
    from repro_torch.configs import get_config, tree_for
    from repro_torch.core.heads import init_draft_params
    from repro_torch.kernels.tree_attention import ops
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import PagedSpeculativeEngine, Request

    cfg = get_config("minitron-4b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    dp = init_draft_params(cfg, seed=1, device="cuda")
    torch.cuda.synchronize()
    log(f"[full] {cfg.name}: {cfg.n_params / 1e9:.2f}B params ({cfg.dtype}) "
        f"initialised on the card in {time.perf_counter() - t0:.1f}s; fp32 "
        f"unembedding {params['unembed_f32'].numel() * 4 / 1e9:.2f} GB")
    check_full_verify(params, dp, cfg)

    tree = tree_for(cfg)
    max_batch, max_len, bs, budget = 4, 512, 16, 32
    usable = int(0.5 * max_batch * max_len) // bs
    eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=max_len,
                                 block_size=bs, num_blocks=usable + 1)
    rs = np.random.RandomState(0)
    reqs = [Request(prompt=rs.randint(0, cfg.vocab_size,
                                      rs.randint(64, 257)).astype(np.int32),
                    max_new_tokens=budget) for _ in range(8)]
    per_step = cfg.n_layers + (1 if "prefix" in dp else 0)
    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0                      # count the main path only
    st = eng.serve(reqs, max_batch=max_batch)
    torch.cuda.synchronize()
    launches = ops.launches
    for r in reqs:
        if len(r.output) != budget or not all(0 <= t < cfg.vocab_size
                                              for t in r.output):
            raise AssertionError(f"bad output: {len(r.output)} tokens")
    expect = per_step * (st.steps + st.warmup_steps)
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != {per_step} x "
                             f"{st.steps + st.warmup_steps} steps")
    log(f"[full] served {len(reqs)} requests x {budget} tokens: "
        f"steps={st.steps} (+{st.warmup_steps} warm-up) "
        f"tok/step={st.tokens_per_step:.3f} tok/s={st.tokens_per_s:.1f} "
        f"step={st.mean_step_s * 1e3:.1f}ms ttft={st.mean_ttft_s * 1e3:.1f}ms "
        f"p99_itl={st.p99_itl_s * 1e3:.1f}ms "
        f"host_stall={st.host_stall_s * 1e3:.1f}ms wall={st.wall_s:.2f}s "
        f"preemptions={st.preemptions} peak_blocks={st.peak_blocks_in_use}/"
        f"{st.num_blocks - 1} max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}GiB "
        f"launches={launches} ({per_step}/step)")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package at {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    log(f"[build] {sorted(built) or 'nothing to build'} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, (secs, ptxas) in built.items():
        log(f"[build] {name}: {secs:.1f}s\n{ptxas}")

    k1 = check_k1()
    check_tiny_parity()
    launches = serve_full_width()

    main_case = k1[("bfloat16", 16)]
    kernels = [{
        "name": "tree_attention_paged",
        "route": "cuda",
        "source": "src/repro_torch/csrc/tree_attention_paged.cu",
        "replaces": "src/repro/kernels/tree_attention/kernel.py:63",
        "launches": launches,
        "max_abs_err": max(k1[("bfloat16", T)]["max_abs_err"]
                           for T in (16, 5)),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
