"""Where the paged tree-verify kernel spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.tree_attention.phases

At minitron-4b head shapes (Hq=24, Hkv=8, D=128, block 16, bf16) it
prints, and writes as one JSON object to ``--out``:

* ``ptxas``: registers, stack and spills of each build (plain, phase
  clocks, accumulator sized for 48 rows);
* ``phases``: clock64() cycles per phase (prologue, K/V load, scores,
  softmax, accumulate, epilogue) summed over key tiles, for each
  ``cache_len`` of the ragged batch (lens 0/37/144/300 with two NULL
  holes, as in ``chip_smoke.py``), from the ``-DK1_PHASE_CLOCKS`` build;
* ``length_scan``: kernel time against a uniform ``cache_len`` (B=4), so
  the slope is the cost of one 16-key tile on one block's serial chain;
* ``batch_scan``: kernel time against B at ``cache_len`` 300, so the
  grid grows from 8 to 256 blocks on 132 SMs;
* ``rows48``: the smoke case with the accumulator sized for the 48 rows
  minitron-4b uses (``-DK1_MAX_ROWS=48``) against the plain build.

Times are CUDA-event means over back-to-back launches, cycling through
operand sets larger than L2.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.core.trees import default_tree
from repro_torch.kernels import build
from repro_torch.kernels.tree_attention import kernel as _k

HQ, HKV, D, BS = 24, 8, 128, 16
PHASES = ("prologue", "load", "score", "softmax", "accumulate", "epilogue")
VARIANTS = {"plain": (), "clocks": ("K1_PHASE_CLOCKS",),
            "rows48": ("K1_MAX_ROWS=48",)}


def inputs(lens, T=16, holes=(), seed=0, dtype=torch.bfloat16):
    """K1 operands on the card: one slot per entry of ``lens``, each with
    its own blocks; ``holes`` are (b, j) table entries set NULL."""
    B = len(lens)
    M = max(1, max(-(-(n + T) // BS) for n in lens))
    table = torch.zeros((B, M), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(lens):
        need = -(-(n + T) // BS)
        table[b, :need] = torch.arange(nxt, nxt + need, dtype=torch.int32)
        nxt += need
    for b, j in holes:
        table[b, j] = 0
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    mask = torch.as_tensor(default_tree(T, 4, 4).ancestor_mask, device="cuda")
    return (r(B, T, HQ, D), r(nxt, BS, HKV, D), r(nxt, BS, HKV, D),
            r(B, T, HKV, D), r(B, T, HKV, D), mask,
            torch.tensor(lens, dtype=torch.int32, device="cuda"),
            table.cuda())


def kernel_ms(fn, sets, iters=50) -> float:
    """Mean device time of one launch of ``fn`` over ``sets``, cycled."""
    outs = [torch.empty_like(s[0]) for s in sets]

    def call(i):
        rc = _k.launch(*sets[i % len(sets)], outs[i % len(sets)], fn=fn)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    for i in range(3):
        call(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        call(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_clocks(fn, lib, args):
    """Per thread block: cycles per phase and tiles, from one launch."""
    out = torch.empty_like(args[0])
    if _k.launch(*args, out, fn=fn) != 0:
        raise RuntimeError("clocked launch failed")
    torch.cuda.synchronize()
    blocks = args[0].shape[0] * HKV
    buf = (ctypes.c_longlong * (blocks * (len(PHASES) + 1)))()
    if lib.k1_phase_clocks(buf, blocks) != 0:
        raise RuntimeError("reading the phase clocks failed")
    return torch.tensor(list(buf)).reshape(blocks, len(PHASES) + 1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the JSON here")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("phases: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    res = {"card": card.strip().splitlines()[0], "torch": torch.__version__}
    print("[phases] card:", res["card"], flush=True)

    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = dict(zip(VARIANTS, ex.map(
            lambda d: build.build(["tree_attention_paged"], d),
            VARIANTS.values())))
    res["ptxas"] = {
        v: [ln.split(":", 1)[-1].strip() for ln in
            b.get("tree_attention_paged", (0, ""))[1].splitlines()
            if "registers" in ln or "spill" in ln]
        for v, b in built.items()}
    for v, lines in res["ptxas"].items():
        print(f"[phases] ptxas {v}: {lines}", flush=True)
    fns = {v: _k.kernel_fn(d) for v, d in VARIANTS.items()}
    clk_lib = build.load("tree_attention_paged", VARIANTS["clocks"])
    clk_lib.k1_phase_clocks.restype = ctypes.c_int
    clk_lib.k1_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]

    lens, holes = (0, 37, 144, 300), ((2, 3), (3, 0))
    smoke = [inputs(lens, holes=holes, seed=s) for s in range(32)]

    # phase clocks, one launch, per cache_len (mean over its kv heads)
    clk = phase_clocks(fns["clocks"], clk_lib, smoke[0]).double()
    clocked_ms = kernel_ms(fns["clocks"], smoke)
    plain_ms = kernel_ms(fns["plain"], smoke)
    total = clk[:, :len(PHASES)].sum(1)
    res["phases"] = {
        "kernel_ms_plain": plain_ms, "kernel_ms_clocked": clocked_ms,
        "max_block_cycles": float(total.max()),
        "cycles_per_us_implied": float(total.max()) / (clocked_ms * 1e3),
        "by_len": {}}
    for b, n in enumerate(lens):
        rows = clk[b * HKV:(b + 1) * HKV].mean(0)
        tiles = float(rows[len(PHASES)])
        entry = {p: float(rows[i]) for i, p in enumerate(PHASES)}
        entry["tiles"] = tiles
        entry["total"] = float(rows[:len(PHASES)].sum())
        res["phases"]["by_len"][str(n)] = entry
        per_tile = {p: round(entry[p] / max(tiles, 1)) for p in PHASES[1:5]}
        print(f"[phases] len {n}: {tiles:.0f} tiles, {entry['total']:.0f} "
              f"cycles, per tile {per_tile}", flush=True)
    print(f"[phases] kernel {plain_ms * 1e3:.1f} us plain, "
          f"{clocked_ms * 1e3:.1f} us clocked, longest block "
          f"{res['phases']['max_block_cycles']:.0f} cycles", flush=True)

    res["rows48"] = {"plain_ms": plain_ms,
                     "rows48_ms": kernel_ms(fns["rows48"], smoke)}
    print(f"[phases] rows48: {res['rows48']['rows48_ms'] * 1e3:.1f} us vs "
          f"plain {plain_ms * 1e3:.1f} us", flush=True)
    del smoke

    res["length_scan"] = {}
    for n in (0, 16, 48, 96, 144, 192, 240, 300, 400, 496):
        sets = [inputs((n,) * 4, seed=s) for s in range(16)]
        ms = kernel_ms(fns["plain"], sets)
        res["length_scan"][n] = ms
        print(f"[phases] len {n} (B=4): {ms * 1e3:.1f} us", flush=True)

    res["batch_scan"] = {}
    for B in (1, 4, 8, 16, 17, 24, 32):
        sets = [inputs((300,) * B, seed=s) for s in range(8)]
        ms = kernel_ms(fns["plain"], sets)
        res["batch_scan"][B] = ms
        print(f"[phases] B {B} ({B * HKV} blocks), len 300: "
              f"{ms * 1e3:.1f} us", flush=True)

    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
