#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel of the port from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, started together) and print, for each
   instantiation, the registers and spills ``ptxas -v`` reports; fail on
   a spill in any head-dim-256 build, and unless the bf16 builds the
   main path runs (the tree-verify split kernel at head dims 128 and 256
   in its paged, windowed and dense forms and its merge, K3 at (128,
   128), (256, 256) and (192, 128), K5's split sweep over bf16 pools at
   (512, 64) and its merge, K6's bf16 chunk kernel and scan at chunk 64)
   are each found in the report and show no spill; then fail unless
   ``cuobjdump -sass`` finds tensor-core instructions (``HMMA`` or
   ``HGMMA``) in every bf16 build of K3, of the tree-verify split
   kernel, of K5's split sweep and of K6's two kernels;
3. hold each kernel against its plain PyTorch version on the card, fp32
   with TF32 off (atol = rtol = 1e-4) and bf16 (atol = rtol = 2e-2), and
   time the kernel, its plain version and ``scaled_dot_product_attention``
   (a yardstick the port never calls) beside the least time the card
   needs for the same work (kernel and SDPA: device time of calls queued
   back to back behind a sleep kernel, ``device_ms``; the kernel's wrapper
   call with its host work and the plain version: CUDA events around
   back-to-back calls, ``time_ms``):
   a. K1, paged tree verify, at minitron-4b head shapes (B=4, Hq=24,
      Hkv=8, D=128, block 16, T=16 and T=5): ragged lengths, NULL holes
      below ``cache_len``, block 0 poisoned with 0, +-1e4, NaN and inf
      (outputs must be bitwise equal);
   b. K1 at gemma3-1b head shapes (Hq=4, Hkv=1, D=256; the prefix layer);
   c. K4, windowed paged verify, at gemma3-1b head shapes (B=4, block 16,
      T=16 and T=5, lens 0/37/700/1500, NULL holes, windows 0 and 512):
      outputs bitwise equal with block 0 poisoned and with every pool
      position at or behind ``cache_len - 512`` poisoned, and K4 at
      window 0 bitwise equal to K1;
   c'. the tree-verify kernel's split: K1 (minitron-4b heads), K4
      (gemma3-1b heads, window 512) and K2 (minitron-4b heads) with the
      split forced to one split over the capacity, to the planner's and
      to 16, against their plain versions, and two identical calls
      bitwise equal (the merge uses no atomics); K1 over a pool of
      128-position blocks bitwise equal to K2 over the same keys (one
      split rule for every block size);
   d. K3, prefill attention, at gemma3-1b and minitron-4b head shapes,
      S in {37, 300, 1536}, windows 0 and 512; and at deepseek-v2-lite's
      MLA prefill (16 heads over 16, q/k 192 and v 128 at their own
      widths, scale 1/sqrt(192), S=1536) against ``blocked_attention``,
      timed unpadded;
   e. K5, absorbed-MLA paged verify (split sweep + merge), at
      deepseek-v2-lite shapes (B=4, 16 heads, latent 512, rope 64, block
      16, T=16, lens 0/37/700/1500, NULL holes): fp32 throughout, then
      bf16 pools, with block 0 poisoned (outputs bitwise equal), the
      split forced to one split, the planner's and 16 (two identical
      calls bitwise equal at each); SDPA on the gathered view (Dk 576,
      Dv 512, a boolean mask) as the yardstick;
   f. K6, chunked decay linear attention, at rwkv6-1.6b shapes (B=1,
      32 heads, dk = dv = 64, chunk 64): S in {37, 300, 1536}, with and
      without an initial state, strong-decay cases (log-decay down to
      -20 a step; S=300 and 1536) and a B=2 case; output and final
      state; one chunk launch and one scan launch a call; a
      length-masked pad tail
      (k = 0, w = 0 past the real length) bitwise equal to the
      exact-length call; no PyTorch call computes it (no yardstick);
   g. K2, dense tree verify, at minitron-4b shapes (B=4, 24 q over 8 kv
      heads, D=128, dense S=512, lens 0/37/144/300, T=16 and T=5) and at
      gemma3-1b's global-layer shapes (4 over 1, D=256, S=1536, lens
      0/37/700/1500): cache positions at or past ``cache_len`` poisoned
      with 0, +-1e4, NaN and inf (outputs bitwise equal); SDPA on the
      dense cache with a boolean mask as the yardstick;
   h. K1 at deepseek-v2-lite's prefix-layer shapes (B=4, 16 q over 16 kv
      heads, D=128, T=5, lens 0/37/700/1500), timed;
4. tiny fp32 parity: ``minitron-4b.reduced()``, a reduced gemma3-1b
   whose 16-token window binds, ``deepseek-v2-lite-16b.reduced()`` and
   ``rwkv6-1.6b.reduced()``, Hydra++ served through the paged engine
   (K1, K4, K5, K3; K6 on every bucket-padded prefill of rwkv6, with a
   preemption), equal the port's dense ``generate()`` (which runs K2 on
   the window-0 GQA layers: so paged == dense holds K1 against K2);
5. full width, bf16, random weights drawn on the card from a seeded
   ``torch.Generator``; for each model one verify step paged against
   dense from the same prefill (prefill through K3, then through K3's
   plain version; with K3, argmax must agree on at least 14 of the 16
   tree positions), then the paged engine serves 8 requests with every kernel
   launch counted (each tree-verify or K5 call also launches its merge,
   each K6 call its scan, counted apart, printed, and required equal to
   the first launches):
   - minitron-4b: prompts 64-256, 32 new tokens, max_batch 4, block 16,
     max_len 512, pool half the dense footprint; 33 K1 launches per
     decode step (32 layers + the prefix layer) and 33 K3 launches per
     prefill;
   - gemma3-1b: prompts 600-1500 (every context passes the 512 window),
     32 new tokens, max_batch 4, block 16, max_len 2048, pool half the
     dense footprint; 26 K4 + 1 K1 launches per decode step and 27 K3
     launches per prefill, re-prefills after a preemption included;
   - minitron-4b again through the continuous (dense) engine: 33 K2
     launches per decode step and 33 K3 per prefill;
   - the dense verify of the paged-vs-dense pair check launches K2 once
     per window-0 GQA layer: 32 at minitron-4b, 4 at gemma3-1b;
   - rwkv6-1.6b (24 layers, d 2048, 32 wkv heads of 64, ~1.38B
     parameters): one prefill through K6 and one through its plain
     version from the same prompt; every layer's K6 call held against
     the plain version on the same operands (final state to a relative
     1e-3, output to a relative norm 3e-3 and within 2e-2; each must
     fail a K6 whose output or state is 1% off), then the two runs'
     final wkv states,
     first tokens and one chain verify step's logits printed (an argmax
     may differ only in a near tie); then the gemma3-1b traffic through
     the paged engine, 24 K6 launches per prefill (re-prefills
     included) and no kernel launch in a decode step;
   - deepseek-v2-lite-16b (MLA + MoE, ~15.7B parameters; the earlier
     models are freed first): the same traffic as gemma3-1b; 27 K5 + 1
     K1 launches per decode step and 28 K3 launches per prefill.  Top-k
     routing amplifies rounding layer by layer, so its verify step is
     held at full width with depth cut (fp32 at 5 layers: relative
     logit difference 1e-4 and every argmax; bf16 at 2 layers: 0.01 and
     14 of 16; each must fail a K5 whose output is 1% off) and printed
     as a reading at full depth;
6. a JSON line with each kernel's numbers, then the result line.

The script stands alone: it puts ``src/`` on ``sys.path`` itself, and it
fails (without a result line) where CUDA is missing or the package is not
beside it.
"""
from __future__ import annotations

import dataclasses
import gc
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
TOLS = (("float32", 1e-4), ("bfloat16", 2e-2))
POISONS = (0.0, 1e4, -1e4, math.nan, math.inf)


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


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` in ms, without the host's time between
    launches: a sleep kernel holds the stream while ``iters`` calls are
    queued behind it (the sleep lasts at least twice their measured
    enqueue time), so the CUDA events around them time the device running
    them back to back.  ``fn`` must not synchronise with the host."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # clock64 ticks at <= 2 GHz on an H100: 2e9 cycles a second at least
    torch.cuda._sleep(int(2e9 * max(2e-3, 2 * enqueue_s)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cycle(sets):
    """A function returning the operand sets in turn."""
    it = iter(range(10 ** 9))
    return lambda: sets[next(it) % len(sets)]


def bound(nbytes: float, flops: float, dtype_name: str) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the type's peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# each kernel template's parameter names, in order, as the lines of
# ``ptxas_lines`` and ``sass_tensor_cores`` print them: a type prints as
# "bf16" or "f32" (after the name, if any), an int as "name=value", a bool
# as its name where true
KERNEL_PARAMS = {
    "tree_attention_split_kernel": ("", "D", "windowed", "dense"),
    "tree_attention_merge_kernel": ("", "dense"),
    "flash_attention_kernel": ("", "DQK", "DV"),
    "mla_attention_split_kernel": ("kv", "DL", "DR"),
    "mla_attention_merge_kernel": ("DL",),
    "linear_attn_chunk_kernel": ("", "C"),
    "linear_attn_scan_kernel": ("", "C"),
}


def kernel_name(symbol: str):
    """A kernel instantiation's readable name from its mangled symbol
    (``tree_attention_split_kernel<bf16, D=256, windowed>``), or None."""
    import re

    m = re.search(r"\d+([a-z_]+_kernel)I", symbol)
    if not m or m.group(1) not in KERNEL_PARAMS:
        return None
    rest, args = symbol[m.end():], []
    for pname in KERNEL_PARAMS[m.group(1)]:
        t = re.match(r"13__nv_bfloat16|f|Li(-?\d+)E|Lb([01])E", rest)
        if not t:
            return None
        rest = rest[t.end():]
        if t.group(0) in ("f", "13__nv_bfloat16"):
            dt = "f32" if t.group(0) == "f" else "bf16"
            args.append(f"{pname} {dt}" if pname else dt)
        elif t.group(1) is not None:
            args.append(f"{pname}={t.group(1)}")
        elif t.group(2) == "1":
            args.append(pname)
    return f"{m.group(1)}<{', '.join(args)}>"


def ptxas_lines(report: str) -> list:
    """One line per kernel instantiation of a ``ptxas -v`` report: its
    name (``kernel_name``), registers, stack frame and spills."""
    out, name, frame = [], None, ""
    for ln in report.splitlines():
        if "Function properties for" in ln:
            name = kernel_name(ln.split("Function properties for", 1)[1])
        elif name and "stack frame" in ln:
            frame = ln.strip()
        elif name and "registers" in ln:
            regs = ln.split("Used", 1)[1].split(",")[0].strip()
            out.append(f"{name}: {regs}; {frame}")
            name = None
    return out


def sass_tensor_cores(lib_path) -> dict:
    """{kernel name: whether its SASS holds a tensor-core instruction
    (HMMA or HGMMA)}, from ``cuobjdump -sass`` of a built library."""
    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    found, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = kernel_name(ln.split("Function :", 1)[1].strip())
            if name:
                found[name] = False
        elif name and ("HMMA" in ln or "HGMMA" in ln):
            found[name] = True
    return found


def assert_bitwise(outs, what: str) -> None:
    import torch

    torch.cuda.synchronize()
    for o in outs[1:]:
        if not torch.equal(o, outs[0]):
            raise AssertionError(f"{what}: outputs are not bitwise equal")


def compare(out, ref, tol: float, what: str) -> float:
    """Max abs error of the kernel against its plain version; raises past
    the tolerance or on a non-finite output."""
    import torch

    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: output not finite")
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{what}: {m}")
    return (out.float() - ref.float()).abs().max().item()


# ---------------------------------------------------------------------------
# phase 3a-c: paged verify kernels K1 and K4 against their plain versions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PagedCase:
    """Head shapes, slot lengths, NULL holes and table width of a run."""
    hq: int
    hkv: int
    d: int
    lens: tuple
    holes: tuple          # (slot, logical block) entries punched to NULL
    m: int                # table entries per slot
    bs: int = 16


# minitron-4b heads, max_len 512; gemma3-1b heads, max_len 1536
MINITRON = PagedCase(24, 8, 128, (0, 37, 144, 300), ((2, 3), (3, 0)), 32)
GEMMA3 = PagedCase(4, 1, 256, (0, 37, 700, 1500),
                   ((2, 20), (3, 70), (3, 0)), 96)
WINDOW = 512
# the full-width paged-vs-dense verify check: at most 2 of the 16 tree
# positions may take another argmax (random weights give near ties)
MIN_ARGMAX_AGREEMENT = 14 / 16
# the bf16 builds the main path runs, as ``kernel_name`` names them; each
# must be found in the ptxas report without a spill.  The tree-verify
# split kernel: minitron-4b's K1 and K2 (D=128) and deepseek's prefix K1,
# gemma3-1b's K4 and prefix K1 (D=256) and its dense verify's K2; K3 at
# minitron-4b's, gemma3-1b's and deepseek's MLA widths
TREE_VERIFY_BUILDS = frozenset({
    "tree_attention_split_kernel<bf16, D=128>",
    "tree_attention_split_kernel<bf16, D=256>",
    "tree_attention_split_kernel<bf16, D=256, windowed>",
    "tree_attention_split_kernel<bf16, D=128, dense>",
    "tree_attention_split_kernel<bf16, D=256, dense>",
    "tree_attention_merge_kernel<bf16>",
    "tree_attention_merge_kernel<bf16, dense>"})
K3_BUILDS = frozenset(
    f"flash_attention_kernel<bf16, DQK={a}, DV={b}>"
    for a, b in ((128, 128), (256, 256), (192, 128)))
# K5's split sweep over bf16 pools at deepseek-v2-lite's widths and its
# merge; K6's chunk kernel and scan in bf16 at rwkv6-1.6b's chunk of 64
MLA_BUILDS = frozenset({
    "mla_attention_split_kernel<kv bf16, DL=512, DR=64>",
    "mla_attention_merge_kernel<DL=512>"})
K6_BUILDS = frozenset({"linear_attn_chunk_kernel<bf16, C=64>",
                       "linear_attn_scan_kernel<bf16, C=64>"})
MAIN_PATH_BUILDS = TREE_VERIFY_BUILDS | K3_BUILDS | MLA_BUILDS | K6_BUILDS
# the bf16 builds that must run on the tensor cores (SASS check): every
# build whose name starts so, and at least one of each
TENSOR_CORE_KERNELS = ("tree_attention_split_kernel<bf16",
                       "flash_attention_kernel<bf16",
                       "mla_attention_split_kernel<kv bf16",
                       "linear_attn_chunk_kernel<bf16",
                       "linear_attn_scan_kernel<bf16")
# the wrappers' second counters: each call of a two-launch kernel also
# launches its merge (tree verify, K5) or its scan (K6)
SECOND_COUNTERS = ("merge_launches", "scan_launches")


def paged_inputs(c: PagedCase, T: int, dtype, seed: int,
                 poison: float = 0.0):
    """K1 operands on the card (model layout) and the verify positions
    ``cache_len + depth`` K4 takes besides."""
    import torch
    from repro_torch.core.trees import default_tree

    B = len(c.lens)
    table = torch.zeros((B, c.m), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(c.lens):
        need = -(-(n + T) // c.bs)
        table[b, :need] = torch.arange(nxt, nxt + need, dtype=torch.int32)
        nxt += need
    for b, j in c.holes:
        table[b, j] = 0
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    pool_k, pool_v = r(nxt, c.bs, c.hkv, c.d), r(nxt, c.bs, c.hkv, c.d)
    pool_k[0] = poison
    pool_v[0] = poison
    tree = default_tree(T, 4, 4)
    lens = torch.tensor(c.lens, dtype=torch.int32, device="cuda")
    q_pos = lens[:, None] + torch.as_tensor(tree.depth, device="cuda")[None]
    return (r(B, T, c.hq, c.d), pool_k, pool_v, r(B, T, c.hkv, c.d),
            r(B, T, c.hkv, c.d),
            torch.as_tensor(tree.ancestor_mask, device="cuda"), lens,
            table.cuda()), q_pos.to(torch.int32)


def poison_behind_window(args, window: int, fill: float):
    """A copy of the operands with every pool position at or behind
    ``cache_len - window`` of each slot set to ``fill``."""
    q, pool_k, pool_v, tk, tv, tm, lens, table = args
    pool_k, pool_v = pool_k.clone(), pool_v.clone()
    bs = pool_k.shape[1]
    tbl = table.cpu()
    for b, n in enumerate(lens.tolist()):
        for p in range(0, n - window + 1):
            blk = int(tbl[b, p // bs])
            if blk != 0:
                pool_k[blk, p % bs] = fill
                pool_v[blk, p % bs] = fill
    return (q, pool_k, pool_v, tk, tv, tm, lens, table)


def paged_bound(c: PagedCase, T: int, dtype_name: str, table,
                window: int = 0) -> tuple:
    """Least time for one call: the cache positions this run's data needs
    (below cache_len, in a real block and, with a window, within reach of
    the root row at cache_len), each read once, plus q, tree K/V and the
    output, against the operations on those keys."""
    elt = 2 if dtype_name != "float32" else 4
    tbl = table.cpu()
    keys = []
    for b, n in enumerate(c.lens):
        lo = max(0, n - window + 1) if window > 0 else 0
        keys.append(sum(1 for p in range(lo, n)
                        if int(tbl[b, p // c.bs]) != 0))
    B = len(c.lens)
    kv_bytes = sum(keys) * c.hkv * c.d * 2 * elt
    io_bytes = (2 * B * T * c.hq * c.d + 2 * B * T * c.hkv * c.d) * elt
    small = B * c.m * 4 + B * 4 + T * T + (B * T * 4 if window else 0)
    flops = sum(4 * c.hq * T * c.d * (k + T) for k in keys)
    return bound(kv_bytes + io_bytes + small, flops, dtype_name)


def paged_sdpa_args(c: PagedCase, args, q_pos=None, window: int = 0):
    """The gathered view + boolean mask SDPA takes (built outside the
    timed call), with the window folded into the mask."""
    import torch

    q, pool_k, pool_v, tk, tv, tm, lens, table = args
    B, T = q.shape[:2]
    S = c.m * c.bs
    t = table.long()
    ck = pool_k[t].reshape(B, S, c.hkv, c.d)
    cv = pool_v[t].reshape(B, S, c.hkv, c.d)
    pos = torch.arange(S, device="cuda")
    valid = (t != 0).repeat_interleave(c.bs, 1) & (pos[None] < lens[:, None])
    G = c.hq // c.hkv
    k = torch.cat([ck, tk], 1).transpose(1, 2).repeat_interleave(G, 1)
    v = torch.cat([cv, tv], 1).transpose(1, 2).repeat_interleave(G, 1)
    # NULL holes hold garbage: zero them so masked-out NaN cannot leak
    keep = torch.cat([valid, torch.ones(B, T, dtype=torch.bool,
                                        device="cuda")], 1)
    k = torch.where(keep[:, None, :, None], k, 0)
    v = torch.where(keep[:, None, :, None], v, 0)
    mask = torch.cat([valid[:, None, :].expand(B, T, S),
                      tm[None].expand(B, T, T)], 2)
    if window > 0:
        abs_kv = torch.cat([pos[None].expand(B, S),
                            lens[:, None] + torch.arange(T, device="cuda")],
                           1)
        mask = mask & (q_pos[:, :, None] - abs_kv[:, None, :] < window)
    return q.transpose(1, 2).contiguous(), k, v, mask[:, None]


def _time_paged(c, T, dtype, dtype_name, kernel, plain, window=0) -> dict:
    """Kernel (split sweep + merge) and SDPA device times, the plain
    version's time and the wrapper call's time with its host work
    (``call_ms``), over 32 operand sets (more than the 50 MB L2 holds, as
    a step's layers cycle through their pools)."""
    import torch.nn.functional as F

    sets = [paged_inputs(c, T, dtype, seed=100 + i) for i in range(32)]
    pick = cycle(sets)
    ms = device_ms(lambda: kernel(*pick()))
    call_ms = time_ms(lambda: kernel(*pick()))
    plain_ms = time_ms(lambda: plain(*pick()), iters=5)
    sd = cycle([paged_sdpa_args(c, a, qp, window) for a, qp in sets[:8]])

    def sdpa():
        q, k, v, mask = sd()
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    lib_ms = device_ms(sdpa)
    bound_ms, bound_by = paged_bound(c, T, dtype_name, sets[0][0][-1], window)
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)


def check_k1(c: PagedCase, tag: str) -> dict:
    """K1 against its plain version at the head shapes of ``c``."""
    import torch
    from repro_torch.kernels.tree_attention import ops
    from repro_torch.kernels.tree_attention.kernel import (
        tree_attention_paged_plain)

    record = {}
    for dtype_name, tol in TOLS:
        dtype = getattr(torch, dtype_name)
        for T in (16, 5):
            outs = []
            for poison in POISONS:
                args, _ = paged_inputs(c, T, dtype, seed=T, poison=poison)
                outs.append(ops.tree_attention_paged_bshd(*args))
            assert_bitwise(outs, f"K1 {tag} {dtype_name} T={T}: poisoned "
                                 "NULL block")
            err = compare(outs[0], tree_attention_paged_plain(*args), tol,
                          f"K1 {tag} {dtype_name} T={T}")
            rec = dict(max_abs_err=err, **_time_paged(
                c, T, dtype, dtype_name,
                lambda *a: ops.tree_attention_paged_bshd(*a[0]),
                lambda *a: tree_attention_paged_plain(*a[0])))
            record[(dtype_name, T)] = rec
            log(f"[k1 {tag}] {dtype_name} T={T}: max_abs_err={err:.3e} "
                f"kernel={rec['ms'] * 1e3:.1f}us "
                f"(call {rec['call_ms'] * 1e3:.1f}us) "
                f"bound={rec['bound_ms'] * 1e3:.2f}us ({rec['bound_by']}) "
                f"plain={rec['plain_ms'] * 1e3:.1f}us "
                f"sdpa={rec['library_ms'] * 1e3:.1f}us")
    return record


def check_k4(c: PagedCase = GEMMA3) -> dict:
    """K4 against its plain version, its poisoning invariants and its
    bitwise identity with K1 at window 0."""
    import torch
    from repro_torch.kernels.attention_template import ops as wops
    from repro_torch.kernels.attention_template.ref import (
        tree_attention_paged_windowed_plain)
    from repro_torch.kernels.tree_attention import ops

    record = {}
    for dtype_name, tol in TOLS:
        dtype = getattr(torch, dtype_name)
        for T in (16, 5):
            for w in (WINDOW, 0):
                what = f"K4 {dtype_name} T={T} window={w}"
                outs = []
                for poison in POISONS:
                    args, q_pos = paged_inputs(c, T, dtype, seed=T,
                                               poison=poison)
                    outs.append(wops.tree_attention_paged_windowed_bshd(
                        *args, q_pos, w))
                assert_bitwise(outs, f"{what}: poisoned NULL block")
                if w > 0:
                    far = [wops.tree_attention_paged_windowed_bshd(
                        *poison_behind_window(args, w, f), q_pos, w)
                        for f in (math.nan, math.inf, -1e4)]
                    assert_bitwise([outs[0]] + far,
                                   f"{what}: poison behind the window")
                else:
                    assert_bitwise([outs[0],
                                    ops.tree_attention_paged_bshd(*args)],
                                   f"{what}: K4 against K1")
                err = compare(outs[0], tree_attention_paged_windowed_plain(
                    *args, q_pos, w), tol, what)
                rec = dict(max_abs_err=err, **_time_paged(
                    c, T, dtype, dtype_name,
                    lambda a, qp: wops.tree_attention_paged_windowed_bshd(
                        *a, qp, w),
                    lambda a, qp: tree_attention_paged_windowed_plain(
                        *a, qp, w), window=w))
                record[(dtype_name, T, w)] = rec
                log(f"[k4] {dtype_name} T={T} window={w}: "
                    f"max_abs_err={err:.3e} kernel={rec['ms'] * 1e3:.1f}us "
                    f"(call {rec['call_ms'] * 1e3:.1f}us) "
                    f"bound={rec['bound_ms'] * 1e3:.2f}us "
                    f"({rec['bound_by']}) "
                    f"plain={rec['plain_ms'] * 1e3:.1f}us "
                    f"sdpa={rec['library_ms'] * 1e3:.1f}us")
    log("[k4] poisoned NULL block and poison behind the window: bitwise "
        "equal; K4 at window 0 == K1 bitwise")
    return record


def check_splits() -> None:
    """The tree-verify kernel with its split forced to one split over the
    capacity, to the planner's and to 16: K1 at minitron-4b heads, K4 at
    gemma3-1b heads (window 512), K2 at minitron-4b heads, each against
    its plain version; and two identical calls bitwise equal."""
    import torch
    from repro_torch.kernels.attention_template import ops as wops
    from repro_torch.kernels.attention_template.ref import (
        tree_attention_paged_windowed_plain)
    from repro_torch.kernels.tree_attention import dense_ops, ops
    from repro_torch.kernels.tree_attention.kernel import (
        tree_attention_dense_plain, tree_attention_paged_plain)
    from repro_torch.kernels.tree_attention.split import plan_split_len

    c2 = K2_CASES["minitron"]
    for dtype_name, tol in TOLS:
        dtype = getattr(torch, dtype_name)
        a1, _ = paged_inputs(MINITRON, 16, dtype, seed=7, poison=math.nan)
        a4, qp = paged_inputs(GEMMA3, 16, dtype, seed=8, poison=math.nan)
        a2 = dense_inputs(c2, 16, dtype, seed=9, poison=math.nan)
        cases = (
            ("K1 minitron", MINITRON.m * MINITRON.bs,
             plan_split_len(len(MINITRON.lens), MINITRON.hkv),
             lambda n: ops.tree_attention_paged_bshd(*a1, split_len=n),
             tree_attention_paged_plain(*a1)),
            ("K4 gemma3 window 512", GEMMA3.m * GEMMA3.bs,
             plan_split_len(len(GEMMA3.lens), GEMMA3.hkv),
             lambda n: wops.tree_attention_paged_windowed_bshd(
                 *a4, qp, WINDOW, split_len=n),
             tree_attention_paged_windowed_plain(*a4, qp, WINDOW)),
            ("K2 minitron", c2.s, plan_split_len(len(c2.lens), c2.hkv),
             lambda n: dense_ops.tree_attention_bshd(*a2, split_len=n),
             # masked_attention multiplies masked weights by the values:
             # it is held on the unpoisoned operands
             tree_attention_dense_plain(*dense_inputs(c2, 16, dtype,
                                                      seed=9))),
        )
        for what, cap, planned, run, ref in cases:
            errs = []
            for n in (-(-cap // 16) * 16, planned, 16):
                outs = [run(n), run(n)]
                assert_bitwise(outs, f"{what} {dtype_name} split {n}: two "
                                     "identical calls")
                errs.append(compare(outs[0], ref, tol,
                                    f"{what} {dtype_name} split {n}"))
            log(f"[split] {what} {dtype_name}: splits (capacity, planner "
                f"{planned}, 16) max_abs_err "
                + " / ".join(f"{e:.3e}" for e in errs)
                + "; two identical calls bitwise equal")
        # one split rule for every block size: K1 over 128-position pool
        # blocks splits at the planner's 64, inside the blocks, as K2 over
        # the same keys as a dense cache does, so the two fold alike
        c128 = dataclasses.replace(MINITRON, holes=(), m=4, bs=128)
        a128, _ = paged_inputs(c128, 16, dtype, seed=10, poison=math.nan)
        q, pool_k, pool_v, tk, tv, tm, lens, table = a128
        view = lambda pool: pool[table.long()].reshape(
            len(c128.lens), c128.m * c128.bs, c128.hkv, c128.d).contiguous()
        paged = ops.tree_attention_paged_bshd(*a128)
        dense = dense_ops.tree_attention_bshd(q, view(pool_k), view(pool_v),
                                              tk, tv, tm, lens)
        assert_bitwise([paged, dense], f"K1 block 128 against K2 "
                                       f"{dtype_name}")
        log(f"[split] K1 at block 128 == K2 over the same keys, "
            f"{dtype_name}, minitron heads, T=16: bitwise equal")


# ---------------------------------------------------------------------------
# phase 3d: the prefill kernel K3 against its plain version
# ---------------------------------------------------------------------------

K3_HEADS = {"gemma3-1b": (4, 1, 256), "minitron-4b": (24, 8, 128)}


def _k3_pairs(S: int, window: int) -> int:
    """Admitted (query, key) pairs of a causal S x S run."""
    if window <= 0:
        return S * (S + 1) // 2
    return sum(min(i + 1, window) for i in range(S))


def check_k3() -> dict:
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)

    record = {}
    for model, (hq, hkv, d) in K3_HEADS.items():
        for dtype_name, tol in TOLS:
            dtype = getattr(torch, dtype_name)
            for S in (37, 300, 1536):
                for w in (WINDOW, 0):
                    g = torch.Generator(device="cuda").manual_seed(S + w)
                    mk = lambda h: torch.randn(
                        (1, S, h, d), generator=g, device="cuda").to(dtype)
                    q, k, v = mk(hq), mk(hkv), mk(hkv)
                    out = ops.flash_attention_bshd(q, k, v, window=w)
                    what = f"K3 {model} {dtype_name} S={S} window={w}"
                    err = compare(out, flash_attention_plain(
                        q, k, v, window=w), tol, what)
                    rec = dict(max_abs_err=err)
                    if S == 1536 or (model == "minitron-4b" and S == 300):
                        rec.update(_time_k3(q, k, v, w, dtype_name))
                    record[(model, dtype_name, S, w)] = rec
                    log(f"[k3] {model} {dtype_name} S={S} window={w}: "
                        f"max_abs_err={err:.3e}" + (
                            f" kernel={rec['ms'] * 1e3:.1f}us "
                            f"(call {rec['call_ms'] * 1e3:.1f}us) "
                            f"bound={rec['bound_ms'] * 1e3:.2f}us "
                            f"({rec['bound_by']}) "
                            f"plain={rec['plain_ms'] * 1e3:.1f}us "
                            f"sdpa={rec['library_ms'] * 1e3:.1f}us"
                            if "ms" in rec else ""))
    return record


def _time_k3(q, k, v, w: int, dtype_name: str) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)

    B, S, hq, d = q.shape
    hkv = k.shape[2]
    ms = device_ms(lambda: ops.flash_attention_bshd(q, k, v, window=w))
    call_ms = time_ms(lambda: ops.flash_attention_bshd(q, k, v, window=w))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, window=w),
                         iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if w > 0:
        i = torch.arange(S, device="cuda")
        diff = i[:, None] - i[None, :]
        mask = (diff >= 0) & (diff < w)
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_ms = device_ms(lib)
    elt = 2 if dtype_name != "float32" else 4
    nbytes = (2 * B * S * hq * d + 2 * B * S * hkv * d) * elt
    flops = 4 * d * hq * B * _k3_pairs(S, w)
    bound_ms, bound_by = bound(nbytes, flops, dtype_name)
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)


# deepseek-v2-lite-16b's MLA widths: 16 heads, nope 128 + rope 64 for q/k,
# 128 for v, latent rank 512
MLA_HEADS, MLA_NOPE, MLA_ROPE, MLA_V, MLA_LAT = 16, 128, 64, 128, 512
MLA_SCALE = 1.0 / math.sqrt(MLA_NOPE + MLA_ROPE)


def check_k3_mla(S: int = 1536) -> dict:
    """K3 at deepseek's MLA prefill: q/k (192) and v (128) at their own
    widths, 16 heads over 16 kv heads (G = 1), scale 1/sqrt(192), through
    the port's prefill helper, against ``blocked_attention``; then the K3
    call timed unpadded (bf16 runs the (192, 128) build; fp32 pads to the
    CUDA-core body's one head dim inside the wrapper)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)
    from repro_torch.models import attention
    from repro_torch.models.layers import blocked_attention

    record = {}
    H, dk, dv = MLA_HEADS, MLA_NOPE + MLA_ROPE, MLA_V
    pos = torch.arange(S, device="cuda")
    ai = attention.AttnInputs(q_pos=pos[None], cache_k=None, cache_v=None,
                              cache_len=None, tree_mask=None, window=0,
                              causal=True)
    for dtype_name, tol in TOLS:
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device="cuda").manual_seed(S)
        mk = lambda d: torch.randn((1, S, H, d), generator=g,
                                   device="cuda").to(dtype)
        q, k, v = mk(dk), mk(dk), mk(dv)
        out = attention._mla_prefill_attention(q, k, v, ai, MLA_SCALE)
        what = f"K3 MLA prefill {dtype_name} S={S}"
        err = compare(out, blocked_attention(q, k, v, pos[None], pos,
                                             scale=MLA_SCALE), tol, what)
        ms = device_ms(lambda: ops.flash_attention_bshd(
            q, k, v, scale=MLA_SCALE))
        call_ms = time_ms(lambda: ops.flash_attention_bshd(
            q, k, v, scale=MLA_SCALE))
        plain_ms = time_ms(lambda: flash_attention_plain(
            q, k, v, scale=MLA_SCALE), iters=5)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=MLA_SCALE))
        elt = 2 if dtype_name != "float32" else 4
        nbytes = S * H * (2 * dk + 2 * dv) * elt
        flops = 2 * (dk + dv) * H * _k3_pairs(S, 0)
        bound_ms, bound_by = bound(nbytes, flops, dtype_name)
        rec = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        record[dtype_name] = rec
        how = ("unpadded" if dtype_name == "bfloat16"
               else "padded to 256 in the wrapper")
        log(f"[k3 mla] {dtype_name} S={S} heads={H} D={dk}/{dv} {how}: "
            f"max_abs_err={err:.3e} kernel={ms * 1e3:.1f}us "
            f"(call {call_ms * 1e3:.1f}us) bound={bound_ms * 1e3:.2f}us "
            f"({bound_by}) plain={plain_ms * 1e3:.1f}us "
            f"sdpa={lib_ms * 1e3:.1f}us")
    return record


# ---------------------------------------------------------------------------
# phase 3e: the absorbed-MLA paged verify kernel K5 against its plain version
# ---------------------------------------------------------------------------

# deepseek-v2-lite heads, 4 slots, max_len 1536, NULL holes below cache_len
MLA_CASE = PagedCase(MLA_HEADS, 1, MLA_LAT + MLA_ROPE, (0, 37, 700, 1500),
                     ((2, 20), (3, 70), (3, 0)), 96)


def mla_inputs(c: PagedCase, T: int, dtype, seed: int, poison: float = 0.0):
    """K5 operands on the card (model layout): q fp32, pools and tree
    latents in ``dtype``."""
    import torch
    from repro_torch.core.trees import default_tree

    B = len(c.lens)
    table = torch.zeros((B, c.m), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(c.lens):
        need = -(-(n + T) // c.bs)
        table[b, :need] = torch.arange(nxt, nxt + need, dtype=torch.int32)
        nxt += need
    for b, j in c.holes:
        table[b, j] = 0
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device="cuda")
    pool_lat = r(nxt, c.bs, MLA_LAT).to(dtype)
    pool_rope = r(nxt, c.bs, MLA_ROPE).to(dtype)
    pool_lat[0] = poison
    pool_rope[0] = poison
    tree = default_tree(T, 4, 4)
    return (r(B, T, c.hq, MLA_LAT), r(B, T, c.hq, MLA_ROPE), pool_lat,
            pool_rope, r(B, T, MLA_LAT).to(dtype), r(B, T, MLA_ROPE).to(dtype),
            torch.as_tensor(tree.ancestor_mask, device="cuda"),
            torch.tensor(c.lens, dtype=torch.int32, device="cuda"),
            table.cuda())


def mla_bound(c: PagedCase, T: int, dtype_name: str, table) -> tuple:
    """Least time for one K5 call: the cache positions this run's data
    needs (below cache_len, in a real block), each read once, plus q, the
    tree latents and the output, against (r + rd) + r multiply-adds per
    admitted (head, row, key), the T tree keys included."""
    elt = 2 if dtype_name != "float32" else 4
    tbl = table.cpu()
    keys = [sum(1 for p in range(n) if int(tbl[b, p // c.bs]) != 0)
            for b, n in enumerate(c.lens)]
    B, dk = len(c.lens), MLA_LAT + MLA_ROPE
    nbytes = (sum(keys) * dk * elt + B * T * c.hq * dk * 4
              + B * T * dk * elt + B * T * c.hq * MLA_LAT * 4
              + B * c.m * 4 + B * 4 + T * T)
    flops = sum(2 * c.hq * T * (k + T) * (dk + MLA_LAT) for k in keys)
    return bound(nbytes, flops, dtype_name)


def mla_sdpa_args(c: PagedCase, args):
    """The gathered view SDPA takes (K = [latent || rope], V = latent, one
    kv head, a boolean mask), built outside the timed call, in the pools'
    type."""
    import torch

    ql, qr, pl, pr, tl, trp, tm, lens, table = args
    B, T = ql.shape[:2]
    S = c.m * c.bs
    t = table.long()
    pos = torch.arange(S, device="cuda")
    valid = (t != 0).repeat_interleave(c.bs, 1) & (pos[None] < lens[:, None])
    keep = torch.cat([valid, torch.ones(B, T, dtype=torch.bool,
                                        device="cuda")], 1)[:, :, None]
    lat = torch.where(keep, torch.cat([pl[t].reshape(B, S, -1), tl], 1), 0)
    rope = torch.where(keep, torch.cat([pr[t].reshape(B, S, -1), trp], 1), 0)
    k = torch.cat([lat, rope], -1)[:, None]                 # (B,1,S+T,576)
    q = torch.cat([ql, qr], -1).transpose(1, 2).to(pl.dtype).contiguous()
    mask = torch.cat([valid[:, None, :].expand(B, T, S),
                      tm[None].expand(B, T, T)], 2)[:, None]
    return q, k, lat[:, None].contiguous(), mask


def check_k5(c: PagedCase = MLA_CASE, T: int = 16) -> dict:
    """K5 against its plain version: fp32 and bf16 pools, block 0
    poisoned (bitwise equal outputs); the split forced to one split over
    the capacity, to the planner's and to 16, each against the plain
    version and two identical calls bitwise equal; then kernel, plain
    and SDPA times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.mla_attention import ops
    from repro_torch.kernels.mla_attention.ref import (
        mla_attention_paged_plain)
    from repro_torch.kernels.tree_attention.split import plan_mla_split_len

    kernel = lambda *a, **kw: ops.mla_attention_paged_bshd(
        *a, scale=MLA_SCALE, **kw)
    plain = lambda *a: mla_attention_paged_plain(*a, scale=MLA_SCALE)
    planned = plan_mla_split_len(len(c.lens), c.hq, T, MLA_LAT, MLA_ROPE)
    record = {}
    for dtype_name, tol in TOLS:
        dtype = getattr(torch, dtype_name)
        what = f"K5 {dtype_name} T={T}"
        outs = []
        for poison in POISONS:
            args = mla_inputs(c, T, dtype, seed=T, poison=poison)
            outs.append(kernel(*args))
        assert_bitwise(outs, f"{what}: poisoned NULL block")
        ref = plain(*args)
        err = compare(outs[0], ref, tol, what)
        errs = []
        for n in (-(-c.m * c.bs // 16) * 16, planned, 16):
            pair = [kernel(*args, split_len=n), kernel(*args, split_len=n)]
            assert_bitwise(pair, f"{what} split {n}: two identical calls")
            errs.append(compare(pair[0], ref, tol, f"{what} split {n}"))
        log(f"[k5] {what}: splits (capacity, planner {planned}, 16) "
            f"max_abs_err " + " / ".join(f"{e:.3e}" for e in errs)
            + "; two identical calls bitwise equal")
        err = max([err] + errs)
        sets = [mla_inputs(c, T, dtype, seed=100 + i) for i in range(32)]
        pick = cycle(sets)
        ms = device_ms(lambda: kernel(*pick()))
        plain_ms = time_ms(lambda: plain(*pick()), iters=5)
        sd = cycle([mla_sdpa_args(c, a) for a in sets[:8]])

        def sdpa():
            q, k, v, mask = sd()
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=MLA_SCALE, enable_gqa=True)

        lib_ms = device_ms(sdpa)
        bound_ms, bound_by = mla_bound(c, T, dtype_name, sets[0][-1])
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
        record[(dtype_name, T)] = rec
        log(f"[k5] {dtype_name} T={T}: max_abs_err={err:.3e} "
            f"kernel={ms * 1e3:.1f}us bound={bound_ms * 1e3:.2f}us "
            f"({bound_by}) plain={plain_ms * 1e3:.1f}us "
            f"sdpa={lib_ms * 1e3:.1f}us")
    log("[k5] poisoned NULL block: bitwise equal")
    return record


# ---------------------------------------------------------------------------
# phase 3f: the chunked decay linear attention kernel K6
# ---------------------------------------------------------------------------

# rwkv6-1.6b's wkv heads and chunk
K6_HEADS, K6_DIM, K6_CHUNK = 32, 64, 64
# the real lengths of the pad-tail check and the bucket each is padded to
K6_PAD_TAILS = ((37, 64), (37, 128), (300, 320), (1500, 1536))


def k6_inputs(S: int, dtype, seed: int, *, init: bool, strong: bool = False,
              B: int = 1):
    """K6 operands on the card at rwkv6-1.6b shapes (B=1 unless given):
    r, k, v in ``dtype``; log-decay, bonus and initial state fp32.
    ``strong`` draws log-decays down to -20 a step (tests/test_kernels.py's
    strong-decay regime)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B, S, K6_HEADS, K6_DIM)
    r = lambda *s_: torch.randn(s_, generator=g, device="cuda")
    w = torch.clamp_min(-torch.exp(r(*shape) * 1.5 + 1.0), -20.0) if strong \
        else -torch.exp(r(*shape) * 0.5)
    s0 = r(B, K6_HEADS, K6_DIM, K6_DIM) * 0.1 if init else None
    return (r(*shape).to(dtype), r(*shape).to(dtype), r(*shape).to(dtype), w,
            r(K6_HEADS, K6_DIM) * 0.1, s0)


def k6_flops(S: int, c: int) -> int:
    """fp32 operations of one K6 call at B=1 in the pairwise chunked form
    with chunk ``c`` (c = 1 is the sequential recurrence), per head: the
    state read-out r S and the state update k v^T at 2 per multiply-add
    (4 dk dv a token), the state's decay once a chunk (dk dv), the strict
    lower pairs of each chunk at 5 per channel (difference, exponential,
    two products, sum) plus 2 per column of A v, and per token the decay's
    exponential and the u-bonus (4 dk + 2 dv)."""
    d = K6_DIM
    full, rest = divmod(S, c)
    pairs = full * c * (c - 1) // 2 + rest * (rest - 1) // 2
    per_head = (4 * S * d * d + -(-S // c) * d * d + pairs * (5 * d + 2 * d)
                + S * (4 * d + 2 * d))
    return K6_HEADS * per_head


# the H100's special-function units: 16 a clock per SM (Hopper white
# paper: 4 per SM sub-partition), 132 SMs, 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9


def k6_bound(S: int, elt: int) -> tuple:
    """Least time for one K6 call at B=1: r, k, v read and o written in
    their type, the log-decay, both states and u in fp32, each once.

    fp32 (the CUDA-core build): against the least fp32 operations over
    the exact forms, the chunked form at every chunk length 1..64
    (``k6_flops``; least at chunk 4), on the CUDA cores' fp32 peak.
    bf16: the kernel runs its products on the tensor cores, so the
    least time for its operations is the larger of the exponentials the
    function needs on the SFUs (one per token and channel: every decay
    factor is a product of exp(w)) and its least products (the state
    read-out and update, 4 dk dv a token) at the tensor cores' rate."""
    H, d = K6_HEADS, K6_DIM
    nbytes = (4 * S * H * d * elt + S * H * d * 4 + 2 * H * d * d * 4
              + H * d * 4)
    if elt == 4:
        return bound(nbytes, min(k6_flops(S, c) for c in range(1, 65)),
                     "float32")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(S * H * d / SFU_PER_S,
                4 * S * H * d * d / PEAK_FLOPS["bfloat16"]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k6() -> dict:
    """K6 against its plain version: output and final state, fp32 and
    bf16, with and without an initial state, strong decay, two sequences
    (the engines prefill one at a time; ``generate()`` takes a batch),
    the pad tail bitwise; then kernel and plain times at S=1536."""
    import torch
    from repro_torch.kernels.linear_attn_chunk import ops
    from repro_torch.kernels.linear_attn_chunk.ref import (
        decay_attention_chunked)

    record = {}
    for dtype_name, tol in TOLS:
        dtype = getattr(torch, dtype_name)
        cases = [(S, init, False, 1) for S in (37, 300, 1536)
                 for init in (False, True)] + [(300, True, True, 1),
                                               (1536, True, True, 1),
                                               (300, True, False, 2)]
        for S, init, strong, B in cases:
            what = (f"K6 {dtype_name} B={B} S={S} init={init}"
                    f"{' strong decay' if strong else ''}")
            args = k6_inputs(S, dtype, seed=S + 7 * strong + B, init=init,
                             strong=strong, B=B)
            before = (ops.launches, ops.scan_launches)
            o, st = ops.linear_attn_bshd(*args, chunk=K6_CHUNK)
            if (ops.launches - before[0], ops.scan_launches - before[1]) \
                    != (1, 1):
                raise AssertionError(f"{what}: not one chunk launch and "
                                     "one scan")
            ref_o, ref_st = decay_attention_chunked(*args, chunk=K6_CHUNK)
            err = max(compare(o, ref_o, tol, what + " output"),
                      compare(st, ref_st, tol, what + " final state"))
            record[(dtype_name, S, init, strong, B)] = dict(max_abs_err=err)
            log(f"[k6] {what}: max_abs_err={err:.3e}")
        for n, padded in K6_PAD_TAILS:
            r, k, v, w, u, s0 = k6_inputs(padded, dtype, seed=n, init=True)
            real = [t[:, :n].contiguous() for t in (r, k, v, w)]
            o, st = ops.linear_attn_bshd(*real, u, s0, chunk=K6_CHUNK)
            tail = torch.arange(padded, device="cuda")[None, :, None,
                                                       None] < n
            o_m, st_m = ops.linear_attn_bshd(
                r, torch.where(tail, k, 0.0), v, torch.where(tail, w, 0.0),
                u, s0, chunk=K6_CHUNK)
            torch.cuda.synchronize()
            if not (torch.equal(o_m[:, :n], o) and torch.equal(st_m, st)):
                raise AssertionError(f"K6 {dtype_name}: a masked pad tail "
                                     f"{n} -> {padded} changes the result")
        log(f"[k6] {dtype_name}: masked pad tails "
            f"{[f'{n}->{p}' for n, p in K6_PAD_TAILS]}: bitwise equal")
        sets = [k6_inputs(1536, dtype, seed=200 + i, init=True)
                for i in range(4)]
        pick = cycle(sets)
        ms = device_ms(lambda: ops.linear_attn_bshd(*pick(), chunk=K6_CHUNK))
        plain_ms = time_ms(lambda: decay_attention_chunked(
            *pick(), chunk=K6_CHUNK), iters=5)
        bound_ms, bound_by = k6_bound(1536, 2 if dtype_name != "float32"
                                      else 4)
        rec = record[(dtype_name, 1536, True, False, 1)]
        rec.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=bound_ms, bound_by=bound_by)
        log(f"[k6] {dtype_name} S=1536: kernel={ms * 1e3:.1f}us "
            f"bound={bound_ms * 1e3:.2f}us ({bound_by}) "
            f"plain={plain_ms * 1e3:.1f}us (no library call)")
    return record


# ---------------------------------------------------------------------------
# phase 3g: the dense tree-verify kernel K2; 3h: K1 at deepseek's prefix
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DenseCase:
    """Head shapes, slot lengths and cache length of a K2 run."""
    hq: int
    hkv: int
    d: int
    lens: tuple
    s: int


K2_CASES = {"minitron": DenseCase(24, 8, 128, (0, 37, 144, 300), 512),
            "gemma3": DenseCase(4, 1, 256, (0, 37, 700, 1500), 1536)}


def dense_inputs(c: DenseCase, T: int, dtype, seed: int,
                 poison: float = 0.0):
    """K2 operands on the card (model layout); every cache position at or
    past ``cache_len`` holds ``poison``."""
    import torch
    from repro_torch.core.trees import default_tree

    B = len(c.lens)
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s_: torch.randn(s_, generator=g, device="cuda").to(dtype)
    ck, cv = r(B, c.s, c.hkv, c.d), r(B, c.s, c.hkv, c.d)
    lens = torch.tensor(c.lens, dtype=torch.int32, device="cuda")
    past = (torch.arange(c.s, device="cuda")[None] >= lens[:, None])
    ck[past] = poison
    cv[past] = poison
    tree = default_tree(T, 4, 4)
    return (r(B, T, c.hq, c.d), ck, cv, r(B, T, c.hkv, c.d),
            r(B, T, c.hkv, c.d),
            torch.as_tensor(tree.ancestor_mask, device="cuda"), lens)


def dense_bound(c: DenseCase, T: int, dtype_name: str) -> tuple:
    """Least time for one K2 call: each slot's keys below cache_len read
    once, plus q, the tree K/V and the output, against the operations on
    those keys and the tree."""
    elt = 2 if dtype_name != "float32" else 4
    B = len(c.lens)
    kv_bytes = sum(c.lens) * c.hkv * c.d * 2 * elt
    io_bytes = (2 * B * T * c.hq * c.d + 2 * B * T * c.hkv * c.d) * elt
    flops = sum(4 * c.hq * T * c.d * (n + T) for n in c.lens)
    return bound(kv_bytes + io_bytes + B * 4 + T * T, flops, dtype_name)


def dense_sdpa_args(c: DenseCase, args):
    """The dense cache with the tree written in at [cache_len, cache_len +
    T), as the serving path holds it, and the verify mask, for SDPA
    (built outside the timed call)."""
    import torch

    q, ck, cv, tk, tv, tm, lens = args
    B, T = q.shape[:2]
    ck, cv = ck.clone(), cv.clone()
    pos = torch.arange(c.s, device="cuda")
    for b, n in enumerate(c.lens):
        ck[b, n:n + T] = tk[b]
        cv[b, n:n + T] = tv[b]
    j = pos[None] - lens[:, None].long()
    in_tree = (j >= 0) & (j < T)
    tree_bit = tm[:, j.clamp(0, T - 1)].permute(1, 0, 2)
    mask = (j < 0)[:, None, :] | (in_tree[:, None, :] & tree_bit)
    return (q.transpose(1, 2).contiguous(), ck.transpose(1, 2).contiguous(),
            cv.transpose(1, 2).contiguous(), mask[:, None])


def check_k2() -> dict:
    """K2 against its plain version (``masked_attention`` under the
    verify mask), bitwise invariance under poison at or past cache_len,
    then kernel, plain and SDPA times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.tree_attention import dense_ops
    from repro_torch.kernels.tree_attention.kernel import (
        tree_attention_dense_plain)

    record = {}
    for tag, c in K2_CASES.items():
        for dtype_name, tol in TOLS:
            dtype = getattr(torch, dtype_name)
            for T in (16, 5):
                what = f"K2 {tag} D={c.d} {dtype_name} T={T}"
                outs = [dense_ops.tree_attention_bshd(
                    *dense_inputs(c, T, dtype, seed=T, poison=f))
                    for f in POISONS]
                assert_bitwise(outs, f"{what}: poison at or past cache_len")
                # masked_attention multiplies masked weights by the values:
                # it is held on the unpoisoned (zero) operands
                err = compare(outs[0], tree_attention_dense_plain(
                    *dense_inputs(c, T, dtype, seed=T)), tol, what)
                sets = [dense_inputs(c, T, dtype, seed=100 + i)
                        for i in range(32)]
                pick = cycle(sets)
                ms = device_ms(
                    lambda: dense_ops.tree_attention_bshd(*pick()))
                call_ms = time_ms(
                    lambda: dense_ops.tree_attention_bshd(*pick()))
                plain_ms = time_ms(
                    lambda: tree_attention_dense_plain(*pick()), iters=5)
                sd = cycle([dense_sdpa_args(c, a) for a in sets[:8]])

                def sdpa():
                    q, k, v, mask = sd()
                    return F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, enable_gqa=True)

                lib_ms = device_ms(sdpa)
                bound_ms, bound_by = dense_bound(c, T, dtype_name)
                rec = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
                record[(tag, dtype_name, T)] = rec
                log(f"[k2] {tag} D={c.d} {dtype_name} T={T}: "
                    f"max_abs_err={err:.3e} kernel={ms * 1e3:.1f}us "
                    f"(call {call_ms * 1e3:.1f}us) "
                    f"bound={bound_ms * 1e3:.2f}us ({bound_by}) "
                    f"plain={plain_ms * 1e3:.1f}us "
                    f"sdpa={lib_ms * 1e3:.1f}us")
    log("[k2] poison at or past cache_len: bitwise equal")
    return record


# deepseek-v2-lite's Hydra++ prefix layer: GQA 16 over 16, D=128, T=5
DEEPSEEK_PREFIX = PagedCase(16, 16, 128, (0, 37, 700, 1500), (), 96)


def check_k1_prefix(c: PagedCase = DEEPSEEK_PREFIX, T: int = 5) -> dict:
    """K1 at deepseek's prefix-layer shapes, bf16: held against its plain
    version, then timed beside its bound and SDPA."""
    import torch
    from repro_torch.kernels.tree_attention import ops
    from repro_torch.kernels.tree_attention.kernel import (
        tree_attention_paged_plain)

    args, _ = paged_inputs(c, T, torch.bfloat16, seed=T)
    err = compare(ops.tree_attention_paged_bshd(*args),
                  tree_attention_paged_plain(*args), 2e-2,
                  "K1 deepseek prefix bf16")
    rec = dict(max_abs_err=err, **_time_paged(
        c, T, torch.bfloat16, "bfloat16",
        lambda *a: ops.tree_attention_paged_bshd(*a[0]),
        lambda *a: tree_attention_paged_plain(*a[0])))
    log(f"[k1 deepseek prefix] bfloat16 T={T}: max_abs_err={err:.3e} "
        f"kernel={rec['ms'] * 1e3:.1f}us "
        f"(call {rec['call_ms'] * 1e3:.1f}us) "
        f"bound={rec['bound_ms'] * 1e3:.2f}us ({rec['bound_by']}) "
        f"plain={rec['plain_ms'] * 1e3:.1f}us "
        f"sdpa={rec['library_ms'] * 1e3:.1f}us")
    return rec


# ---------------------------------------------------------------------------
# phase 4: tiny fp32 parity, paged engine (kernels) == dense generate()
# ---------------------------------------------------------------------------


def kernel_counters():
    """The launch counters of every kernel wrapper, by kernel name."""
    from repro_torch.kernels.attention_template import ops as k4
    from repro_torch.kernels.flash_attention import ops as k3
    from repro_torch.kernels.linear_attn_chunk import ops as k6
    from repro_torch.kernels.mla_attention import ops as k5
    from repro_torch.kernels.tree_attention import dense_ops as k2
    from repro_torch.kernels.tree_attention import ops as k1

    return {"tree_attention_paged": k1, "tree_attention_dense": k2,
            "tree_attention_paged_windowed": k4, "flash_attention": k3,
            "mla_attention_paged": k5, "linear_attn_chunk": k6}


def check_tiny_parity(base, lens, budgets=(12, 14, 8, 10, 13, 9),
                      num_blocks: int = 6) -> None:
    import numpy as np
    import torch
    from repro_torch.configs import tree_for
    from repro_torch.core.heads import init_draft_params
    from repro_torch.core.speculative import PAD_TOKEN, generate
    from repro_torch.models.model import group_has_window, init_params
    from repro_torch.serving.engine import PagedSpeculativeEngine, Request

    counters = kernel_counters()
    # the kernels of the paged engine, and of the dense generate() it is
    # held against: K2 on the window-0 GQA layers (the Hydra++ prefix
    # layer at least) of an attention model; an RWKV6 model launches K6
    # on every prefill and no kernel in a decode step
    if base.block_kind == "rwkv6":
        used, dense_used = ("linear_attn_chunk",), ("linear_attn_chunk",)
    else:
        dense_used = ("tree_attention_dense", "flash_attention")
        if base.mla:       # K5 on the base layers, K1 on the prefix layer
            used = ("mla_attention_paged", "tree_attention_paged")
        elif group_has_window(base, 0, base.n_layers):
            used = ("tree_attention_paged_windowed",)
        else:
            used = ("tree_attention_paged",)
        used = (*used, "flash_attention")
    # the reduced vocabulary, and 16 tokens so random heads get accepted
    for cfg in (base, dataclasses.replace(base, vocab_size=16)):
        params = init_params(cfg, seed=0, device="cuda")
        dp = init_draft_params(cfg, seed=1, device="cuda")
        tree = tree_for(cfg)
        rs = np.random.RandomState(0)
        reqs, refs = [], []
        for mod in counters.values():
            mod.launches = 0
        for n, budget in zip(lens, budgets):
            prompt = rs.randint(0, cfg.vocab_size, n).astype(np.int32)
            t, _, _ = generate(params, dp, cfg, tree,
                               torch.as_tensor(prompt, device="cuda")[None]
                               .long(), max_new_tokens=budget, max_len=128)
            row = [int(x) for x in t[0].tolist() if x != PAD_TOKEN]
            refs.append(row[:budget])
            reqs.append(Request(prompt=prompt, max_new_tokens=budget))
        dense_counts = {k: m.launches for k, m in counters.items()}
        for name in dense_used:
            if dense_counts[name] == 0:
                raise AssertionError(f"tiny parity {cfg.name}: dense "
                                     f"generate() never launched {name}")
        for mod in counters.values():
            mod.launches = 0
        eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=128,
                                     block_size=16, num_blocks=num_blocks)
        st = eng.serve(reqs, max_batch=4)
        for r, ref in zip(reqs, refs):
            if r.output != ref:
                raise AssertionError(f"tiny parity {cfg.name} "
                                     f"(V={cfg.vocab_size}): paged "
                                     f"{r.output} != dense {ref}")
        counts = {k: m.launches for k, m in counters.items()}
        for name in used:
            if counts[name] == 0:
                raise AssertionError(f"tiny parity {cfg.name} never "
                                     f"launched {name}")
        if base.block_kind == "rwkv6" and st.preemptions == 0:
            raise AssertionError(f"tiny parity {cfg.name}: the pool forced "
                                 "no preemption (no re-prefill was held)")
        log(f"[tiny] {cfg.name} V={cfg.vocab_size}: paged engine == dense "
            f"generate() for {len(reqs)} requests; steps={st.steps} "
            f"tok/step={st.tokens_per_step:.2f} "
            f"preemptions={st.preemptions} launches={counts}; dense "
            f"generate() launches={dense_counts}")


# ---------------------------------------------------------------------------
# phase 5: full width, through the paged engine
# ---------------------------------------------------------------------------


def _verify_pair(params, dp, cfg, P: int, S: int):
    """Paged and dense verify logits of one full-width verify forward,
    from the same prefill of P tokens into a cache of S, and the K2
    launches of the dense one."""
    import torch
    from repro_torch.configs import tree_for
    from repro_torch.core.heads import draft_tree_tokens
    from repro_torch.core.speculative import init_decode_state
    from repro_torch.core.trees import device_arrays
    from repro_torch.kernels.tree_attention import dense_ops
    from repro_torch.models.model import forward

    tree = tree_for(cfg)
    g = torch.Generator(device="cuda").manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (1, P), generator=g,
                           device="cuda")
    st = init_decode_state(params, dp, cfg, prompt, S)
    tokens, _ = draft_tree_tokens(dp, cfg, params, tree, st.last_hidden,
                                  st.last_token)
    ta = device_arrays(tree, prompt.device)
    pos = st.cache_len[:, None] + ta["depth"][None]
    nb = S // 16
    table = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")[None]
    pools = []
    for group in st.cache:                 # (L, 1, S, tail...) per array
        pool = {}
        for k, v in group.items():
            pool[k] = torch.zeros((v.shape[0], nb + 1, 16) + v.shape[3:],
                                  dtype=v.dtype, device="cuda")
            pool[k][:, 1:] = v[:, 0].reshape(v.shape[0], nb, 16,
                                             *v.shape[3:])
        pools.append(pool)
    k2_before = dense_ops.launches
    dense = forward(params, cfg, tokens, pos, mode="verify", cache=st.cache,
                    cache_len=st.cache_len, tree_mask=ta["mask"])
    k2 = dense_ops.launches - k2_before
    paged = forward(params, cfg, tokens, pos, mode="verify", cache=pools,
                    cache_len=st.cache_len, tree_mask=ta["mask"],
                    block_table=table)
    return paged.logits[0], dense.logits[0], k2


def _paged_vs_dense(paged, dense) -> tuple:
    """(max relative logit difference, argmax agreement, margins).  At a
    position where the argmax differs, its margin is dense's lead of its
    choice over paged's, in units of that position's largest paged-vs-dense
    logit difference: below 1, the two choices are a near tie that the
    difference can flip."""
    diff = (paged - dense).abs()
    rel = (diff.max() / dense.abs().max()).item()
    pa, da = paged.argmax(-1), dense.argmax(-1)
    agree = (pa == da).float().mean().item()
    lead = dense.gather(-1, da[:, None]) - dense.gather(-1, pa[:, None])
    margins = [round(m, 3) for m in
               (lead[:, 0] / diff.max(-1).values)[pa != da].tolist()]
    return rel, agree, margins


def check_full_verify(params, dp, cfg, P: int, S: int) -> None:
    """One full-width verify forward, paged (K1/K4) against dense (K2 on
    the window-0 layers, plain windowed attention on the others), from the
    same prefill: first through K3 (the serving path, held to
    ``MIN_ARGMAX_AGREEMENT``), then through K3's plain version, logged
    only, which shows whether K3's cache moves the agreement.  The dense
    forward must launch K2 once per window-0 layer."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain
    from repro_torch.models import attention

    k2_expected = sum(cfg.window_for_layer(i) == 0
                      for i in range(cfg.n_layers))
    for prefill in ("K3", "plain"):
        kernel_fn = attention.flash_attention_bshd
        if prefill == "plain":
            attention.flash_attention_bshd = flash_attention_plain
        try:
            paged, dense, k2 = _verify_pair(params, dp, cfg, P, S)
        finally:
            attention.flash_attention_bshd = kernel_fn
        if k2 != k2_expected:
            raise AssertionError(f"{cfg.name}: the dense verify launched K2 "
                                 f"{k2} times, not {k2_expected}")
        if not torch.isfinite(paged).all():
            raise AssertionError(f"{cfg.name}: full-width paged logits not "
                                 "finite")
        rel, agree, margins = _paged_vs_dense(paged, dense)
        log(f"[full] {cfg.name} verify paged vs dense (prompt {P}, prefill "
            f"through {prefill}; dense K2 launches {k2}): max rel logit "
            f"diff={rel:.3e} argmax agreement={agree:.3f} margins={margins}")
        if rel > 0.1:
            raise AssertionError(f"paged and dense verify disagree: rel {rel}")
        if prefill == "K3" and agree < MIN_ARGMAX_AGREEMENT:
            raise AssertionError(f"paged and dense verify argmax agree on "
                                 f"{agree:.3f} of the tree only")


# (dtype, layers, max relative logit difference, least argmax agreement)
# of the depth-cut paged-vs-dense verify checks of an MoE model.  The bf16
# bound sits between the clean reading (7.2e-3-7.3e-3) and what a K5 1%
# off gives without a routing flip (1.4e-2), so the planted fault fails
# it whether or not a flip amplifies it
MOE_VERIFY_CHECKS = (("float32", 5, 1e-4, 1.0),
                     ("bfloat16", 2, 0.01, MIN_ARGMAX_AGREEMENT))
# each check must also fail a K5 whose output is off by this factor
K5_OFF = 0.99


def check_moe_verify(arch: str, P: int, S: int) -> None:
    """Paged (K5, K1) against dense verify of an MoE model at full width,
    depth cut as ``MOE_VERIFY_CHECKS`` says.  Top-k routing with a
    capacity is discontinuous: a rounding difference of the attention
    output can flip an expert choice or which token overflows, and each
    layer adds such flips, so at full depth in bf16 the difference
    outgrows what a wrong K5 gives at shallow depth.  At 2 layers (the
    dense layer and one MoE layer) the bf16 serving path (bf16 latent
    pools, bf16 K5) is held tightly; in fp32 at 5 layers the two paths
    must agree to rounding.  Each check is run again with K5's output
    scaled by ``K5_OFF`` and must then fail its bound."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.heads import init_draft_params
    from repro_torch.models import attention
    from repro_torch.models.model import init_params

    k5 = attention.mla_attention_paged_bshd
    for dtype, n_layers, max_rel, min_agree in MOE_VERIFY_CHECKS:
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                                  dtype=dtype)
        params = init_params(cfg, seed=0, device="cuda")
        dp = init_draft_params(cfg, seed=1, device="cuda")
        paged, dense, _ = _verify_pair(params, dp, cfg, P, S)
        finite = bool(torch.isfinite(paged).all())
        rel, agree, margins = _paged_vs_dense(paged, dense)
        attention.mla_attention_paged_bshd = \
            lambda *a, **kw: k5(*a, **kw) * K5_OFF
        try:
            rel_off = _paged_vs_dense(
                *_verify_pair(params, dp, cfg, P, S)[:2])[0]
        finally:
            attention.mla_attention_paged_bshd = k5
        log(f"[full] {cfg.name} {dtype}, {n_layers} layers, verify paged vs "
            f"dense (prompt {P}): max rel logit diff={rel:.3e} argmax "
            f"agreement={agree:.3f} margins={margins}; with K5's output "
            f"x{K5_OFF}: {rel_off:.3e}")
        del params, dp, paged, dense
        gc.collect()
        torch.cuda.empty_cache()
        if not (finite and rel <= max_rel and agree >= min_agree):
            raise AssertionError(f"{cfg.name} {dtype}, {n_layers} layers: "
                                 f"paged and dense verify disagree: rel "
                                 f"{rel} (bound {max_rel}), agreement "
                                 f"{agree} (least {min_agree}), finite "
                                 f"{finite}")
        if rel_off <= max_rel:
            raise AssertionError(f"{cfg.name} {dtype}, {n_layers} layers: "
                                 f"a K5 {K5_OFF}x off reads {rel_off}, "
                                 f"within the bound {max_rel}")


def log_moe_verify(params, dp, cfg, P: int, S: int) -> None:
    """The full-depth bf16 paged-vs-dense verify step of an MoE model,
    printed as a reading (agreement and near-tie leads); only a logit
    that is not finite fails it.  ``check_moe_verify`` holds the path."""
    import torch

    paged, dense, _ = _verify_pair(params, dp, cfg, P, S)
    if not torch.isfinite(paged).all():
        raise AssertionError(f"{cfg.name}: full-width paged logits not "
                             "finite")
    rel, agree, margins = _paged_vs_dense(paged, dense)
    log(f"[full] {cfg.name} verify paged vs dense (prompt {P}, prefill "
        f"through K3; a reading): max rel logit diff={rel:.3e} argmax "
        f"agreement={agree:.3f} margins={margins}")


# a full-width prefill's K6 calls against the plain version on the same
# operands: final state max |diff| / max |ref|, output ||diff|| / ||ref||
K6_LAYER_STATE_REL, K6_LAYER_OUT_REL = 1e-3, 3e-3
# the per-layer check must fail a K6 whose output or state is off by this
K6_OFF = 0.99


def _k6_layers(params, dp, cfg, prompt, P: int, off_o: float = 1.0,
               off_state: float = 1.0) -> tuple:
    """Prefill ``prompt`` through K6, each layer's K6 call repeated by the
    plain version on the same operands (the layer's real activations).
    ``off_o``/``off_state`` scale K6's outputs, a planted fault.  Returns
    (the decode state, per layer (state rel, output rel, whether the
    output is finite and within bf16's elementwise 2e-2))."""
    from repro_torch.core.speculative import init_decode_state
    from repro_torch.kernels.linear_attn_chunk.ref import (
        decay_attention_chunked)
    from repro_torch.models import ssm

    kernel_fn = ssm.linear_attn_bshd
    errs = []

    def both(*args, **kw):
        o, st = kernel_fn(*args, **kw)
        if off_o != 1.0 or off_state != 1.0:
            o, st = o * off_o, st * off_state
        ref_o, ref_st = decay_attention_chunked(*args, **kw)
        ref_o, diff = ref_o.float(), o.float() - ref_o.float()
        close = bool((diff.abs() <= 2e-2 + 2e-2 * ref_o.abs()).all())
        rel = lambda a, b: (a / b).nan_to_num(math.inf).item()
        errs.append((rel((st - ref_st).abs().max(), ref_st.abs().max()),
                     rel(diff.norm(), ref_o.norm()), close))
        return o, st

    ssm.linear_attn_bshd = both
    try:
        state = init_decode_state(params, dp, cfg, prompt, P + 8)
    finally:
        ssm.linear_attn_bshd = kernel_fn
    return state, errs


def _k6_layers_hold(errs, n_layers: int) -> bool:
    return (len(errs) == n_layers and all(close for *_, close in errs)
            and max(e[0] for e in errs) <= K6_LAYER_STATE_REL
            and max(e[1] for e in errs) <= K6_LAYER_OUT_REL)


def check_rwkv_prefill(params, dp, cfg, P: int) -> None:
    """One full-width RWKV6 prefill of P tokens through K6 and one
    through its plain version, from the same prompt.

    Held: on the K6 run, every layer's K6 call is repeated by the plain
    version on the same operands (the layer's real activations), and
    the two must agree: the final state to a relative
    ``K6_LAYER_STATE_REL`` (max), the output to ``K6_LAYER_OUT_REL``
    (norm) and within bf16's elementwise 2e-2.  Two control runs scale
    K6's output, then its final state, by ``K6_OFF``; each must fail
    that check.  Read, printed: the two runs' final wkv states layer by
    layer, their first tokens and one chain verify step's logits, where
    bf16 rounding differences of each layer's output feed the next layer
    and grow with depth (random weights); these fail only if not finite,
    or if an argmax differs beyond a near tie (a lead of 1 or more in
    units of that position's largest logit difference)."""
    import torch
    from repro_torch.configs import tree_for
    from repro_torch.core.heads import draft_tree_tokens
    from repro_torch.core.speculative import init_decode_state
    from repro_torch.core.trees import device_arrays
    from repro_torch.kernels.linear_attn_chunk.ref import (
        decay_attention_chunked)
    from repro_torch.models import ssm
    from repro_torch.models.model import forward

    tree = tree_for(cfg)
    ta = device_arrays(tree, "cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (1, P), generator=g,
                           device="cuda")
    states = {}
    states["K6"], errs = _k6_layers(params, dp, cfg, prompt, P)
    worst = [max(e[i] for e in errs) for i in (0, 1)]
    n_close = sum(e[2] for e in errs)
    off = {f"{what} x{K6_OFF}": _k6_layers(params, dp, cfg, prompt, P,
                                             **{kw: K6_OFF})[1]
           for what, kw in (("output", "off_o"), ("state", "off_state"))}
    log(f"[full] {cfg.name} prefill of {P}: K6 against its plain version on "
        f"each layer's own inputs ({len(errs)} layers): final state max rel "
        f"diff {worst[0]:.3e} (bound {K6_LAYER_STATE_REL}), output rel "
        f"norm diff {worst[1]:.3e} (bound {K6_LAYER_OUT_REL}), {n_close} "
        f"layers' outputs within 2e-2; with K6's "
        + "; ".join(f"{what}: {max(e[0] for e in es):.3e} / "
                    f"{max(e[1] for e in es):.3e}"
                    for what, es in off.items()))
    if not _k6_layers_hold(errs, cfg.n_layers):
        raise AssertionError(f"{cfg.name}: K6 and its plain version disagree "
                             f"on a layer's inputs: {errs}")
    for what, es in off.items():
        if _k6_layers_hold(es, cfg.n_layers):
            raise AssertionError(f"{cfg.name}: a K6 with its {what} passes "
                                 "the per-layer check")
    ssm_fn = ssm.linear_attn_bshd
    ssm.linear_attn_bshd = decay_attention_chunked
    try:
        states["plain"] = init_decode_state(params, dp, cfg, prompt, P + 8)
    finally:
        ssm.linear_attn_bshd = ssm_fn

    k6, plain = states["K6"], states["plain"]
    wk, wp = k6.cache[0]["wkv_state"], plain.cache[0]["wkv_state"]
    layer_rel = [((a - b).abs().max() / b.abs().max()).item()
                 for a, b in zip(wk, wp)]
    first = [(st.last_hidden.float() @ params["unembed_f32"])[0]
             for st in (k6, plain)]
    tokens, _ = draft_tree_tokens(dp, cfg, params, tree, k6.last_hidden,
                                  k6.last_token)
    pos = k6.cache_len[:, None] + ta["depth"][None]
    verify = [forward(params, cfg, tokens, pos, mode="verify",
                      cache=st.cache, cache_len=st.cache_len,
                      tree_mask=ta["mask"]).logits[0]
              for st in (k6, plain)]
    _, _, margins0 = _paged_vs_dense(first[0][None], first[1][None])
    rel, agree, margins = _paged_vs_dense(*verify)
    log(f"[full] {cfg.name} prefill of {P} through K6 vs through its plain "
        f"version (a reading): final wkv state rel diff by layer "
        f"{[round(r, 4) for r in layer_rel]}; first token "
        f"{int(k6.last_token[0])} vs {int(plain.last_token[0])} (margins "
        f"{margins0}); chain verify (T={tree.size}) max rel logit diff "
        f"{rel:.3e} argmax agreement {agree:.3f} margins {margins}")
    if not all(torch.isfinite(t).all() for t in (wk, *verify)):
        raise AssertionError(f"{cfg.name}: prefill states or logits not "
                             "finite")
    if any(m >= 1 for m in margins0 + margins):
        raise AssertionError(f"{cfg.name}: an argmax differs beyond a near "
                             f"tie: {margins0} / {margins}")


@dataclasses.dataclass(frozen=True)
class Workload:
    arch: str
    prompts: tuple        # prompt length range [lo, hi]
    max_len: int
    verify: dict          # engine -> {kernel name: launches per decode step}
    prefill: dict         # kernel name -> launches per prefill
    check_prompt: int     # the full-width check's prompt


WORKLOADS = (
    Workload("minitron-4b", (64, 256), 512,
             {"paged": {"tree_attention_paged": 33},
              "continuous": {"tree_attention_dense": 33}},
             {"flash_attention": 33}, 100),
    Workload("gemma3-1b", (600, 1500), 2048,
             {"paged": {"tree_attention_paged_windowed": 26,
                        "tree_attention_paged": 1}},
             {"flash_attention": 27}, 1000),
    Workload("rwkv6-1.6b", (600, 1500), 2048, {"paged": {}},
             {"linear_attn_chunk": 24}, 1000),
    Workload("deepseek-v2-lite-16b", (600, 1500), 2048,
             {"paged": {"mla_attention_paged": 27,
                        "tree_attention_paged": 1}},
             {"flash_attention": 28}, 1000),
)


def serve_full_width(wl: Workload) -> dict:
    """Serve 8 requests of ``wl`` at full width through each of its
    engines; returns the kernels' launch counts of these runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.heads import init_draft_params
    from repro_torch.models.model import init_params

    cfg = get_config(wl.arch)
    gc.collect()                           # the previous model's tensors
    torch.cuda.empty_cache()
    S_check = -(-(wl.check_prompt + 64) // 256) * 256
    if cfg.moe:
        check_moe_verify(wl.arch, wl.check_prompt, S_check)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    dp = init_draft_params(cfg, seed=1, device="cuda")
    torch.cuda.synchronize()
    log(f"[full] {cfg.name}: {cfg.n_params / 1e9:.2f}B params ({cfg.dtype}) "
        f"initialised on the card in {time.perf_counter() - t0:.1f}s; fp32 "
        f"unembedding {params['unembed_f32'].numel() * 4 / 1e9:.2f} GB")
    if cfg.moe:
        log_moe_verify(params, dp, cfg, wl.check_prompt, S_check)
    elif cfg.block_kind == "rwkv6":
        check_rwkv_prefill(params, dp, cfg, wl.check_prompt)
    else:
        check_full_verify(params, dp, cfg, wl.check_prompt, S_check)
    launches = {}
    for engine in wl.verify:
        for k, n in serve_engine(wl, cfg, params, dp, engine).items():
            launches[k] = launches.get(k, 0) + n
    del params, dp
    torch.cuda.empty_cache()
    return launches


def serve_engine(wl: Workload, cfg, params, dp, engine: str) -> dict:
    """Serve 8 requests of ``wl`` through ``engine`` ("paged" or
    "continuous"), counting every kernel launch of the run."""
    import numpy as np
    import torch
    from repro_torch.configs import tree_for
    from repro_torch.serving.engine import (PagedSpeculativeEngine, Request,
                                            SpeculativeEngine)

    tree = tree_for(cfg)
    max_batch, bs, budget = 4, 16, 32
    usable = int(0.5 * max_batch * wl.max_len) // bs
    if engine == "paged":
        eng = PagedSpeculativeEngine(params, dp, cfg, tree,
                                     max_len=wl.max_len, block_size=bs,
                                     num_blocks=usable + 1)
    else:
        eng = SpeculativeEngine(params, dp, cfg, tree, max_len=wl.max_len)
    rs = np.random.RandomState(0)
    lo, hi = wl.prompts
    reqs = [Request(prompt=rs.randint(0, cfg.vocab_size,
                                      rs.randint(lo, hi + 1)).astype(np.int32),
                    max_new_tokens=budget) for _ in range(8)]
    counters = kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in counters.values():          # count the main path only
        mod.launches = 0
        for attr in SECOND_COUNTERS:
            if hasattr(mod, attr):
                setattr(mod, attr, 0)
    st = eng.serve(reqs, max_batch=max_batch)
    torch.cuda.synchronize()
    counts = {k: m.launches for k, m in counters.items()}
    # each tree-verify or K5 call launches its split sweep (counted) and a
    # merge, each K6 call its chunk kernel (counted) and a scan
    merges = {f"{k} {attr}": getattr(m, attr) for k, m in counters.items()
              for attr in SECOND_COUNTERS if hasattr(m, attr)}
    if any(n != counts[k.split()[0]] for k, n in merges.items()):
        raise AssertionError(f"{cfg.name}: second launches {merges} != "
                             f"first launches {counts}")
    for r in reqs:
        if len(r.output) != budget or not all(0 <= t < cfg.vocab_size
                                              for t in r.output):
            raise AssertionError(f"bad output: {len(r.output)} tokens")
    steps = st.steps + st.warmup_steps
    prefills = len(reqs) + st.preemptions
    expect = {k: 0 for k in counters}
    for k, n in wl.verify[engine].items():
        expect[k] += n * steps
    for k, n in wl.prefill.items():
        expect[k] += n * prefills
    if counts != expect:
        raise AssertionError(f"{cfg.name}: kernel launches {counts} != "
                             f"{expect} ({steps} steps, {prefills} "
                             "prefills)")
    log(f"[full] {cfg.name} {engine} engine served {len(reqs)} requests x "
        f"{budget} tokens (prompts {lo}-{hi}): steps={st.steps} "
        f"(+{st.warmup_steps} "
        f"warm-up) tok/step={st.tokens_per_step:.3f} "
        f"tok/s={st.tokens_per_s:.1f} step={st.mean_step_s * 1e3:.1f}ms "
        f"ttft={st.mean_ttft_s * 1e3:.1f}ms "
        f"p99_itl={st.p99_itl_s * 1e3:.1f}ms "
        f"host_stall={st.host_stall_s * 1e3:.1f}ms wall={st.wall_s:.2f}s "
        f"preemptions={st.preemptions} prefills={prefills} "
        + (f"peak_blocks={st.peak_blocks_in_use}/{st.num_blocks - 1} "
           if engine == "paged" else "") +
        f"max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}GiB "
        f"launches={counts} (per step {wl.verify[engine]}, per prefill "
        f"{wl.prefill}) second launches={merges}")
    del eng
    return counts


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
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    log(f"[build] {sorted(built) or 'nothing to build'} in "
        f"{time.perf_counter() - t0:.1f}s")
    parsed = set()
    for name in sorted(build.SOURCES):
        if name in built:
            log(f"[build] {name}: {built[name][0]:.1f}s")
        for line in ptxas_lines(build.ptxas_report(name)):
            log(f"[ptxas] {line}")
            # the builds the main path runs, and every head-dim-256 build,
            # keep their accumulators in registers
            inst = line.split(":")[0]
            parsed.add(inst)
            if (inst in MAIN_PATH_BUILDS or "=256" in inst) \
                    and "0 bytes spill stores, 0 bytes spill loads" \
                    not in line:
                raise AssertionError(f"a checked build spills: {line}")
    missing = sorted(MAIN_PATH_BUILDS - parsed)
    if missing:
        raise AssertionError(f"no ptxas line parsed for {missing}: the "
                             "spill check could not run")
    tensor_cores = {}
    for name in ("tree_attention_paged", "flash_attention",
                 "mla_attention_paged", "linear_attn_chunk"):
        tensor_cores.update(sass_tensor_cores(build.library_path(name)))
    checked = sorted(k for k in tensor_cores
                     if k.startswith(TENSOR_CORE_KERNELS))
    without = [k for k in checked if not tensor_cores[k]]
    unseen = [p for p in TENSOR_CORE_KERNELS
              if not any(k.startswith(p) for k in checked)]
    if len(checked) < 8 or without or unseen:
        raise AssertionError(f"SASS: bf16 builds without HMMA/HGMMA: "
                             f"{without}; no build of {unseen}; checked "
                             f"{checked}")
    log(f"[sass] HMMA/HGMMA in every bf16 build of K3, the tree-verify "
        f"split kernel, K5's split sweep and K6's two kernels: {checked}")

    k1 = check_k1(MINITRON, "minitron D=128")
    check_k1(GEMMA3, "gemma3 D=256")
    k4 = check_k4()
    check_splits()
    k3 = check_k3()
    k3_mla = check_k3_mla()
    k5 = check_k5()
    k6 = check_k6()
    k2 = check_k2()
    check_k1_prefix()
    log(f"[time] kernel checks done at {time.perf_counter() - t_start:.0f}s")

    check_tiny_parity(dataclasses.replace(
        get_config("minitron-4b").reduced(), dtype="float32"),
        (16, 23, 32, 9, 40, 12))
    check_tiny_parity(dataclasses.replace(
        get_config("gemma3-1b").reduced(), dtype="float32",
        window_pattern=(16, 0)), (17, 23, 30, 19, 40, 21))
    check_tiny_parity(dataclasses.replace(
        get_config("deepseek-v2-lite-16b").reduced(), dtype="float32"),
        (17, 23, 30, 19, 40, 21))
    # a chain of 5 writes less scratch than a tree of 16: longer budgets
    # over a pool of 7 blocks make the slots' growth preempt
    check_tiny_parity(dataclasses.replace(
        get_config("rwkv6-1.6b").reduced(), dtype="float32"),
        (16, 23, 32, 9, 40, 12), budgets=(30,) * 6, num_blocks=8)
    launches = {}
    for wl in WORKLOADS:
        for k, n in serve_full_width(wl).items():
            launches[k] = launches.get(k, 0) + n
        log(f"[time] {wl.arch} done at {time.perf_counter() - t_start:.0f}s")

    def entry(name, source, replaces, rec, err):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"]}

    kernels = [
        entry("tree_attention_paged",
              "src/repro_torch/csrc/tree_attention_paged.cu",
              "src/repro/kernels/tree_attention/kernel.py:63",
              k1[("bfloat16", 16)],
              max(k1[("bfloat16", T)]["max_abs_err"] for T in (16, 5))),
        entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:23",
              k3[("gemma3-1b", "bfloat16", 1536, WINDOW)],
              max([r["max_abs_err"] for key, r in k3.items()
                   if key[1] == "bfloat16"]
                  + [k3_mla["bfloat16"]["max_abs_err"]])),
        entry("tree_attention_paged_windowed",
              "src/repro_torch/csrc/tree_attention_paged.cu",
              "src/repro/kernels/attention_template/ops.py:37",
              k4[("bfloat16", 16, WINDOW)],
              max(r["max_abs_err"] for key, r in k4.items()
                  if key[0] == "bfloat16")),
        entry("mla_attention_paged",
              "src/repro_torch/csrc/mla_attention_paged.cu",
              "src/repro/kernels/attention_template/ops.py:70",
              k5[("bfloat16", 16)], k5[("bfloat16", 16)]["max_abs_err"]),
        entry("tree_attention_dense",
              "src/repro_torch/csrc/tree_attention_paged.cu",
              "src/repro/kernels/tree_attention/kernel.py:47",
              k2[("minitron", "bfloat16", 16)],
              max(r["max_abs_err"] for key, r in k2.items()
                  if key[1] == "bfloat16")),
        entry("linear_attn_chunk", "src/repro_torch/csrc/linear_attn_chunk.cu",
              "src/repro/kernels/linear_attn_chunk/kernel.py:74",
              k6[("bfloat16", 1536, True, False, 1)],
              max(r["max_abs_err"] for key, r in k6.items()
                  if key[0] == "bfloat16")),
    ]
    log(json.dumps({"kernels": kernels}))
    log(f"[time] total {time.perf_counter() - t_start:.0f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
