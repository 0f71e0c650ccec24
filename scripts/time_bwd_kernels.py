"""Time K3's kernels (the fp32 and bf16 forward at phase 3's cases, the
backward at phase 3m's), K6's (forward and backward), the tree-verify
kernel (K1, K2, K4) and K5 (with its windowed form), each launch on its
own, on one NVIDIA card.

    PYTHONPATH=src python scripts/time_bwd_kernels.py \
        [--cases all|k3|k6|tree|k5] \
        [--old DIR [--set NAME=VALUE ...] [--label LABEL]] [--steps] \
        [--out build/k3_times.json]

For each case it prints the device time of one call
(``chip_smoke.device_ms``) and each launch's mean device time and blocks,
read from a ``torch.profiler`` trace (``chip_smoke.launch_split``),
together with the registers and spills ``ptxas -v`` reports for K3's two
libraries.  Forward cases: gemma3-1b (4 over 1 heads of 256) at windows 0
and 512, zamba2-1.2b (32 over 32 of 64), deepseek-v2-lite's MLA prefill
(16 heads, q/k 192, v 128), minitron-4b (24 over 8 of 128) at S = 1536 and
300, hubert-xlarge (16 over 16 of 80, bidirectional), S = 1536 unless
named, fp32 and bf16.  Backward cases: ``chip_smoke.K3_BWD_CASES``.

``--old DIR``: DIR holds another copy of ``src/repro_torch/csrc`` (for
example the parent commit's, unpacked with ``git archive`` into an
ignored directory).  Its K3 sources (``flash_attention.cu``,
``flash_attention_bwd.cu``) are built as second libraries under
``build/old_kernels/`` and called through their C entry points, whose
argument lists are this version's.  Where the old fp32 build takes one
head dim of 64, 128 or 256 (the first fp32 bodies: the old source has no
``flash_tf32``), the operands are zero-padded to it and the outputs
sliced back, as that version's wrapper did; the pads are part of the old
time.  An old source with the 3xTF32 bodies takes every width as it is.  Each K3 case then runs old,
new, new, old, and the line gives both times and the old time over the
new; each old output is also held against the new one (max abs
difference, relative L2), so that a comparison of two different
functions shows.

``--steps`` (with ``--old``): two fp32 runs through the model, under the
old and the new K3 in turns (old, new, new, old; the launches the
wrapper makes patched to the old library): gemma3-1b's fp32 Hydra++ head
step of phase 5e(iii) (``head_train_loss`` and its gradient, B = 1, S =
512: K3's forward at every layer and, at the prefix layer, its backward)
and zamba2-1.2b's fp32 whole prefill of phase 5b (38 layers, 1000
tokens, 7 K3 calls), each the mean wall time of synchronised calls.

The tree-verify cases (``--cases tree``): the fp32 table's K1 (minitron-4b
24 over 8 heads of 128; gemma3-1b 4 over 1 of 256), K2 (the same heads
over dense caches) and K4 (gemma3-1b, window 512) at T = 16, and
vicuna-tiny's K1 and K2 (B = 4, 4 over 4 heads of 64, T = 16, block 16,
lens 32/48/64/80 and 0/37/300/500), fp32 and bf16, each over 32 operand
sets (``chip_smoke.py``'s inputs).  With ``--old``, DIR's
``tree_attention_paged.cu`` is built as a second library (its C entry
points take this version's arguments) and each case runs old, new, new,
old; the old output on the same operands is held against the new one
(bf16 must come out bit for bit the same).  ``--set NAME=VALUE`` first
sets ``constexpr int NAME = ...;`` in a copy of DIR's tree-verify source
to VALUE (with ``--old src/repro_torch/csrc``: a variant of this
version's constant, such as ``kF32SliceWarps``, timed against it);
``--label`` names the second library in the lines.  With ``--steps``,
also vicuna-tiny's captured decode step in the paged engine (fp32,
trained Hydra heads from ``training/tiny.py``'s recipe, checkpoints under
``build/``, ``default_tree(16, 4, 4)``, 4 prompts of 32 tokens, 48 new
tokens) under each library in turns: a fresh engine serves once (the
capture), then once under ``torch.profiler``; the line gives device
busy a step and the tree-verify split and merge kernels' µs a step.

K6's cases (``--cases k6``): the forward at rwkv6-1.6b's 32 heads of 64,
S = 1536, chunk 64, with an initial state and u, fp32 and bf16, over 4
operand sets (``chip_smoke.check_k6``'s), and the backward at
``chip_smoke.K6_BWD_CASES`` (phase 3m's operands, the states from this
version's forward).  With ``--old``, DIR's ``linear_attn_chunk.cu`` and
``linear_attn_chunk_bwd.cu`` are built as second libraries (their C
entry points take this version's arguments, and stand in for the whole
of each library) and each case runs old, new, new, old; the old outputs
(forward: output and final state; backward: every gradient) are held
against the new ones, and a bf16 case whose bits differ fails the run.
With ``--steps``, also the wall time of phase 5g(iv)'s fp32 gradient
check (rwkv6-1.6b at full width, 2 layers, B = 1, S = 500: ``lm_loss``
and its gradient, through K6 in each layer) under each library in turns.

K5's cases (``--cases k5``): phase 3e's (``chip_smoke.MLA_CASE``:
deepseek-v2-lite's 16 heads, latent 512 + rope 64, B = 4, block 16, lens
0/37/700/1500, NULL holes, T = 16) over 32 operand sets, fp32 and bf16
pools, at the planner's split; then the windowed form at windows 512 and
1 (``chip_smoke.MLA_WINDOWS``, ``q_pos = cache_len + depth``).  With
``--old``, DIR's ``mla_attention_paged.cu`` is built as a second library
(its C entry point takes this version's arguments) and each unwindowed
case runs old, new, new, old; the old output on the same operands is held
against the new one, and a bf16 case whose bits differ fails the run.
The windowed form runs under the new library alone (an older source may
have no windowed entry point).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

OLD_DIR = ROOT / "build" / "old_kernels"
# K3's C entry points: (symbol, pointer arguments, int arguments); both
# take a trailing float (the scale) and the stream
K3_ABI = {"flash_attention": ("flash_attention", 7, 11),
          "flash_attention_bwd": ("flash_attention_bwd", 11, 10)}
# the tree-verify library and K6's two: their wrappers find their entry
# points through ``build.load``, so an old library stands in for the whole
# of it
TREE_LIB = "tree_attention_paged"
K6_LIBS = ("linear_attn_chunk", "linear_attn_chunk_bwd")
MLA_LIB = "mla_attention_paged"
SWAPPED = (TREE_LIB, *K6_LIBS, MLA_LIB)
LABEL = "old"                  # the second library's name in the lines
# the old fp32 bodies' head dims: operands are padded to the least that
# holds both widths, where the old source's fp32 builds take one head dim
# (the first fp32 bodies: no ``flash_tf32`` in it; ``main`` sets
# OLD_PADS from the source)
OLD_F32_DIMS = (64, 128, 256)
OLD_PADS = True
# forward cases: (name, Hq, Hkv, Dqk, Dv, S, window, causal, scale)
FWD_CASES = (
    ("gemma3-1b window 0", 4, 1, 256, 256, 1536, 0, True, None),
    ("gemma3-1b window 512", 4, 1, 256, 256, 1536, 512, True, None),
    ("zamba2-1.2b", 32, 32, 64, 64, 1536, 0, True, None),
    ("deepseek MLA", 16, 16, 192, 128, 1536, 0, True, cs.MLA_SCALE),
    ("minitron-4b", 24, 8, 128, 128, 1536, 0, True, None),
    ("minitron-4b S=300", 24, 8, 128, 128, 300, 0, True, None),
    ("hubert-xlarge", 16, 16, 80, 80, 1536, 0, False, None),
)


def set_constants(text: str, sets: dict) -> str:
    """``text`` with each ``constexpr int NAME = N;`` of ``sets`` (NAME ->
    VALUE) set to VALUE; raises unless each occurs exactly once."""
    import re

    for name, value in sets.items():
        pat = rf"constexpr int {name} = -?\d+;"
        if len(re.findall(pat, text)) != 1:
            raise ValueError(f"constexpr int {name} not found once")
        text = re.sub(pat, f"constexpr int {name} = {int(value)};", text)
    return text


def build_old(src_dir: Path, names, sets: dict = None) -> dict:
    """Build ``names``'s sources of ``src_dir`` into ``OLD_DIR``, all nvcc
    processes at once: {library: ctypes library}.  ``sets``: constants of
    the tree-verify source to change first (``set_constants``), in a copy
    of ``src_dir`` beside its headers."""
    import shutil

    from repro_torch.kernels import build

    OLD_DIR.mkdir(parents=True, exist_ok=True)
    if sets:
        copy = OLD_DIR / "csrc"
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(src_dir, copy)
        src = copy / build.SOURCES[TREE_LIB]
        src.write_text(set_constants(src.read_text(), sets))
        src_dir = copy
    procs = {}
    for name in names:
        out = OLD_DIR / f"lib{name}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
               str(src_dir / build.SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the old {name}:\n{log}")
        for line in cs.ptxas_lines(log):
            if "f32" in line:
                cs.log(f"[ptxas old] {line}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def k3_fn(lib, name: str):
    """K3's C entry point ``name`` of ``lib`` with its argument types."""
    sym, n_ptr, n_int = K3_ABI[name]
    fn = getattr(lib, sym)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _padded(dqk: int, dv: int, dtype):
    """The head dim the old fp32 body ran (dqk, dv) at, or None (bf16, or
    a width of its own)."""
    import torch

    if dtype != torch.float32 or not OLD_PADS:
        return None
    D = min(d for d in OLD_F32_DIMS if d >= max(dqk, dv))
    return None if dqk == dv == D else D


def old_launch(fn):
    """``flash_attention/kernel.py::launch``'s signature, launching the
    old forward (fp32 padded to its one head dim, as its wrapper did)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as k3k

    def launch(q, k, v, out, *, causal, window, scale=None, q_off=None,
               kv_valid_len=None, key_tile=0, lse=None):
        D = _padded(q.shape[-1], v.shape[-1], q.dtype)
        dst = out
        if D is not None:
            q, k, v = (F.pad(t, (0, D - t.shape[-1])) for t in (q, k, v))
            dst = out.new_empty((*out.shape[:3], D))
        ptr = lambda t: None if t is None else t.data_ptr()
        B, Sq, Hq, Dqk = q.shape
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dst.data_ptr(),
                ptr(lse), ptr(q_off), ptr(kv_valid_len), B, Sq, k.shape[1],
                Hq, k.shape[2], Dqk, v.shape[3], int(causal), int(window),
                k3k.DTYPE_CODES[q.dtype], int(key_tile),
                1.0 / math.sqrt(Dqk) if scale is None else float(scale),
                torch.cuda.current_stream().cuda_stream)
        if D is not None:
            out.copy_(dst[..., :out.shape[-1]])
        return rc

    return launch


def old_launch_bwd(fn):
    """``flash_attention/kernel.py::launch_bwd``'s signature, launching
    the old backward with this version's scratch and split (its rules are
    unchanged), but a first fp32 body (``OLD_PADS``): padded to its one
    head dim without a split or partials, as that version ran it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as k3k

    def launch_bwd(q, k, v, out, lse, do, dq, dk, dv, *, causal, window,
                   scale):
        B, S, Hq, dqk = q.shape
        Hkv, dv_ = k.shape[2], v.shape[3]
        D = _padded(dqk, dv_, q.dtype)
        grads = (dq, dk, dv)
        if D is not None:
            q, k, v, out, do = (F.pad(t, (0, D - t.shape[-1]))
                                for t in (q, k, v, out, do))
            grads = tuple(torch.empty_like(t) for t in (q, k, v))
        if q.dtype == torch.float32 and OLD_PADS:
            delta = torch.empty((B, Hq, S), dtype=torch.float32,
                                device=q.device)
            part, split = None, 1
        else:
            delta, part = k3k.bwd_scratch(B, S, Hq, Hkv, dqk, dv_, q.dtype,
                                          q.device)
            split = k3k.bwd_split(B, S, Hq, dqk, dv_, q.dtype)
        Dqk, Dv = q.shape[-1], v.shape[-1]
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                *(g.data_ptr() for g in grads),
                None if part is None else part.data_ptr(), B, S, Hq, Hkv,
                Dqk, Dv, int(causal), int(window), k3k.DTYPE_CODES[q.dtype],
                split, float(scale), torch.cuda.current_stream().cuda_stream)
        if D is not None:
            for g, p in zip((dq, dk, dv), grads):
                g.copy_(p[..., :g.shape[-1]])
        return rc

    return launch_bwd


class Patched:
    """Within the block, K3's wrapper, the tree-verify wrappers and K6's
    launch the old libraries (those of them that were built)."""

    def __init__(self, old_libs: dict):
        self.old = old_libs

    def __enter__(self):
        from repro_torch.kernels import build
        from repro_torch.kernels.flash_attention import kernel as k3k

        self.saved = (k3k.launch, k3k.launch_bwd,
                      {n: build._loaded.get(n) for n in SWAPPED})
        if "flash_attention" in self.old:
            k3k.launch = old_launch(k3_fn(self.old["flash_attention"],
                                          "flash_attention"))
            k3k.launch_bwd = old_launch_bwd(k3_fn(
                self.old["flash_attention_bwd"], "flash_attention_bwd"))
        for name in SWAPPED:
            if name in self.old:
                build._loaded[name] = self.old[name]

    def __exit__(self, *exc):
        from repro_torch.kernels import build
        from repro_torch.kernels.flash_attention import kernel as k3k

        k3k.launch, k3k.launch_bwd, libs = self.saved
        for name, lib in libs.items():
            if lib is None:
                build._loaded.pop(name, None)
            else:
                build._loaded[name] = lib


def fwd_cases():
    """(name, library, call) of each forward case."""
    import torch
    from repro_torch.kernels.flash_attention import ops as k3

    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for name, hq, hkv, dqk, dv, S, w, causal, scale in FWD_CASES:
            g = torch.Generator(device="cuda").manual_seed(S + w + dqk)
            mk = lambda h, d: torch.randn((1, S, h, d), generator=g,
                                          device="cuda").to(dtype)
            q, k, v = mk(hq, dqk), mk(hkv, dqk), mk(hkv, dv)
            kw = dict(window=w, causal=causal, scale=scale)
            yield (f"K3 forward {dtype_name} {name} ({hq}/{hkv}, "
                   f"{dqk}/{dv}) S={S}", "flash_attention",
                   lambda a=(q, k, v), kw=kw: k3.flash_attention_bshd(*a,
                                                                     **kw))


def bwd_cases():
    """(name, library, call) of each K3 backward case, on operands made
    as ``check_backward`` makes them."""
    import torch
    from repro_torch.kernels.flash_attention import ops as k3

    for model, dtype_name, hq, hkv, dqk, dv, w, causal, scale in \
            cs.K3_BWD_CASES:
        dtype = getattr(torch, dtype_name)
        S = cs.K3_BWD_S if dtype == torch.bfloat16 else 512
        g = torch.Generator(device="cuda").manual_seed(S + dqk + w)
        mk = lambda h, d: torch.randn((1, S, h, d), generator=g,
                                      device="cuda").to(dtype)
        q, k, v, do = mk(hq, dqk), mk(hkv, dqk), mk(hkv, dv), mk(hq, dv)
        kw = dict(causal=causal, window=w, scale=scale)
        lse = torch.empty((1, hq, S), device="cuda")
        out = k3._forward(q, k, v, lse=lse, **kw)
        yield (f"K3 backward {model} {dtype_name} {hq}/{hkv} {dqk}/{dv} "
               f"S={S} window={w} {'causal' if causal else 'bidirectional'}",
               "flash_attention_bwd",
               lambda a=(q, k, v, out, lse, do), kw=kw:
               k3._backward(*a, **kw))


def k6_cases():
    """(name, library, call, same) of each K6 case: the forward over 4
    operand sets in turn (``same``: the first), the backward on phase
    3m's operands and this version's states."""
    import torch
    from repro_torch.kernels.linear_attn_chunk import ops as k6

    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        sets = [cs.k6_inputs(1536, dtype, seed=200 + i, init=True)
                for i in range(4)]
        pick = cs.cycle(sets)
        yield (f"K6 forward {dtype_name} 32 heads of 64, S=1536, chunk "
               f"{cs.K6_CHUNK}, u, initial state", K6_LIBS[0],
               lambda p=pick: k6.linear_attn_bshd(*p(), chunk=cs.K6_CHUNK),
               lambda a=sets[0]: k6.linear_attn_bshd(*a, chunk=cs.K6_CHUNK))
    for dtype_name, S in cs.K6_BWD_CASES:
        dtype = getattr(torch, dtype_name)
        r, k, v, w, u, _ = cs.k6_inputs(S, dtype, seed=S + 11, init=False)
        do = torch.randn(v.shape, generator=torch.Generator(
            device="cuda").manual_seed(S), device="cuda").to(dtype)
        args = (r, k, v, w, u, None)
        _, _, states = k6._forward(*args, cs.K6_CHUNK, states=True)
        run = (lambda a=args, st=states, d=do:
               k6._backward(*a, st, d, None, cs.K6_CHUNK))
        yield (f"K6 backward {dtype_name} 32 heads of 64, S={S}, chunk "
               f"{cs.K6_CHUNK}, u", K6_LIBS[1], run, run)


def k6_grad_check(old_libs: dict) -> list:
    """Phase 5g(iv)'s fp32 gradient check (rwkv6-1.6b, 2 layers, B = 1, S
    = 500: ``lm_loss`` and its gradient, K6 and its backward in each
    layer) under the old and the new K6 libraries in turns: mean wall
    ms of synchronised calls."""
    import gc

    import torch

    cfg, params, fn = cs.k6_grad_setup()
    what = (f"5g(iv) {cfg.name} fp32 lm_loss and its gradient, "
            f"{cfg.n_layers} layers, B=1 S={cs.K6_GRAD_S}")
    records = []
    for key in ("old", "new", "new", "old"):
        with Patched(old_libs) if key == "old" else _Nothing():
            ms = _wall_ms(fn)
        records.append({"run": what, "kernels": LABEL if key == "old"
                        else "new", "card": cs.CARD, "wall_ms": ms})
        cs.log(f"[k6 step] {what}, {records[-1]['kernels']} K6 "
               f"({cs.CARD}): {ms:.2f} ms")
    del params, fn
    gc.collect()
    torch.cuda.empty_cache()
    return records


# vicuna-tiny's verify: B = 4, 4 over 4 heads of 64, T = 16, block 16, at
# short and at mixed lengths (a table of 40 blocks: 640 positions)
VICUNA = {lens: cs.PagedCase(4, 4, 64, lens, (), 40)
          for lens in ((32, 48, 64, 80), (0, 37, 300, 500))}


def tree_cases():
    """(name, library, call, same) of each tree-verify case: ``call``
    cycles over 32 operand sets, ``same`` runs the first set (the old and
    new outputs are compared on it)."""
    import torch
    from repro_torch.kernels.attention_template import ops as wops
    from repro_torch.kernels.tree_attention import dense_ops, ops

    paged = {"minitron-4b 24/8 D=128": cs.MINITRON,
             "gemma3-1b 4/1 D=256": cs.GEMMA3,
             **{f"vicuna-tiny 4/4 D=64 lens {'/'.join(map(str, lens))}": c
                for lens, c in VICUNA.items()}}
    dense = {"minitron-4b 24/8 D=128 S=512": cs.K2_CASES["minitron"],
             "gemma3-1b 4/1 D=256 S=1536": cs.K2_CASES["gemma3"],
             **{f"vicuna-tiny 4/4 D=64 S=640 lens "
                f"{'/'.join(map(str, lens))}":
                cs.DenseCase(4, 4, 64, lens, 640) for lens in VICUNA}}
    T = 16
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for name, c in paged.items():
            sets = [cs.paged_inputs(c, T, dtype, seed=100 + i)[0]
                    for i in range(32)]
            pick = cs.cycle(sets)
            yield (f"K1 {dtype_name} {name} T={T}", TREE_LIB,
                   lambda p=pick: ops.tree_attention_paged_bshd(*p()),
                   lambda a=sets[0]: ops.tree_attention_paged_bshd(*a))
        for name, c in dense.items():
            sets = [cs.dense_inputs(c, T, dtype, seed=100 + i)
                    for i in range(32)]
            pick = cs.cycle(sets)
            yield (f"K2 {dtype_name} {name} T={T}", TREE_LIB,
                   lambda p=pick: dense_ops.tree_attention_bshd(*p()),
                   lambda a=sets[0]: dense_ops.tree_attention_bshd(*a))
        sets = [cs.paged_inputs(cs.GEMMA3, T, dtype, seed=100 + i)
                for i in range(32)]
        pick = cs.cycle(sets)
        w = cs.WINDOW
        yield (f"K4 {dtype_name} gemma3-1b 4/1 D=256 T={T} window {w}",
               TREE_LIB,
               lambda p=pick: wops.tree_attention_paged_windowed_bshd(
                   *_windowed(p), w),
               lambda a=sets[0]: wops.tree_attention_paged_windowed_bshd(
                   *a[0], a[1], w))


def k5_cases():
    """(name, library, call, same) of each K5 case: ``call`` cycles over
    32 operand sets, ``same`` runs the first set; the windowed form's
    library is named apart, so it runs under the new library alone."""
    import torch
    from repro_torch.kernels.mla_attention import ops

    c, T = cs.MLA_CASE, 16
    q_pos = cs.mla_q_pos(c, T)
    run = lambda a, **kw: ops.mla_attention_paged_bshd(*a, scale=cs.MLA_SCALE,
                                                       **kw)
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        sets = [cs.mla_inputs(c, T, dtype, seed=100 + i) for i in range(32)]
        pick = cs.cycle(sets)
        what = (f"K5 {dtype_name} deepseek-v2-lite 16 heads (512, 64) T={T} "
                f"lens {'/'.join(map(str, c.lens))}")
        yield (what, MLA_LIB, lambda p=pick: run(p()),
               lambda a=sets[0]: run(a))
        for w in cs.MLA_WINDOWS:
            yield (f"{what} window {w}", f"{MLA_LIB} windowed",
                   lambda p=pick, w=w: run(p(), q_pos=q_pos, window=w),
                   lambda a=sets[0], w=w: run(a, q_pos=q_pos, window=w))


def _windowed(pick):
    """One operand set of ``paged_inputs`` as K4's arguments."""
    args, q_pos = pick()
    return (*args, q_pos)


def _agree(a, b) -> tuple:
    """(max abs difference, largest relative L2) of two outputs or two
    tuples of gradients."""
    if not isinstance(a, tuple):
        a, b = (a,), (b,)
    pairs = [(x, y) for x, y in zip(a, b) if x is not None]
    return (max((x.float() - y.float()).abs().max().item() for x, y in pairs),
            max(cs.rel_l2(x, y) for x, y in pairs))


def time_case(what, lib, call, old_fns, same=None) -> dict:
    """``call`` under the new library and, where ``lib`` was built from
    ``--old``, under the old one, in turns; ``same`` (default ``call``)
    gives the outputs the two are compared on.  A bf16 K6 case whose old
    and new outputs differ in a bit raises."""
    same = same or call
    rec = {"case": what, "card": cs.CARD, "old_label": LABEL}
    runs = {"new": call}
    if lib in old_fns:
        def old(c=call):
            with Patched(old_fns):
                return c()

        def old_same(c=same):
            with Patched(old_fns):
                return c()
        runs["old"] = old
        a, b = same(), old_same()
        rec["max_abs_old_vs_new"], rec["rel_l2_old_vs_new"] = _agree(a, b)
        rec["bitwise_old_vs_new"] = all(
            torch_equal(x, y) for x, y in zip(
                a if isinstance(a, tuple) else (a,),
                b if isinstance(b, tuple) else (b,)) if x is not None)
        if lib in (*K6_LIBS, MLA_LIB) and "bfloat16" in what \
                and not rec["bitwise_old_vs_new"]:
            raise AssertionError(f"{what}: the bf16 build's bits changed "
                                 f"({LABEL} vs new max abs "
                                 f"{rec['max_abs_old_vs_new']:.3e})")
    order = ("old", "new", "new", "old") if "old" in runs else ("new",)
    for key in order:
        rec.setdefault(f"{key}_us", []).append(1e3 * cs.device_ms(runs[key]))
    for key, fn in runs.items():
        rec[f"{key}_split"] = cs.launch_split(fn, 1e-3 * min(rec[f"{key}_us"]))
    tag = {TREE_LIB: "tree", **dict.fromkeys(K6_LIBS, "k6")}.get(
        lib, "k5" if lib.startswith(MLA_LIB) else "k3")
    line = (f"[{tag}] {what} ({cs.CARD}): new "
            f"{', '.join(f'{x:.1f}' for x in rec['new_us'])}us "
            f"[{cs.split_text(rec['new_split'])}]")
    if "old" in runs:
        ratio = sum(rec["old_us"]) / sum(rec["new_us"])
        line += (f"; {LABEL} "
                 f"{', '.join(f'{x:.1f}' for x in rec['old_us'])}us "
                 f"[{cs.split_text(rec['old_split'])}]; {LABEL}/new "
                 f"{ratio:.2f}x; {LABEL} vs new max abs "
                 f"{rec['max_abs_old_vs_new']:.2e}, rel L2 "
                 f"{rec['rel_l2_old_vs_new']:.2e}"
                 + (", bitwise" if rec["bitwise_old_vs_new"] else ""))
    cs.log(line)
    return rec


def torch_equal(x, y) -> bool:
    import torch

    return bool(torch.equal(x, y))


def _wall_ms(fn, reps: int = 3) -> float:
    """Mean wall ms of ``reps`` synchronised calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def steps(old_fns: dict) -> list:
    """5e(iii)'s fp32 head step at gemma3-1b and 5b's fp32 zamba2 prefill
    under the old and the new K3, in turns."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.distill import head_train_loss
    from repro_torch.core.heads import init_draft_params
    from repro_torch.data.synthetic import MarkovSpec, sample_corpus
    from repro_torch.models.model import forward, init_params
    from repro_torch.training import trainer

    records = []

    def turns(what, fn):
        for key in ("old", "new", "new", "old"):
            if key == "old":
                with Patched(old_fns):
                    ms = _wall_ms(fn)
            else:
                ms = _wall_ms(fn)
            records.append({"run": what, "kernels": key, "card": cs.CARD,
                            "wall_ms": ms})
            cs.log(f"[step] {what}, {key} K3 ({cs.CARD}): {ms:.2f} ms")

    cfg = dataclasses.replace(get_config(cs.TRAIN_ARCH), dtype="float32")
    base = init_params(cfg, seed=0, device="cuda")
    dp = init_draft_params(cfg, seed=1, device="cuda")
    toks = torch.as_tensor(sample_corpus(
        MarkovSpec(vocab_size=cfg.vocab_size, seed=0), 1, cs.GRAD_CHECK_S,
        seed=2), device="cuda")
    turns(f"5e(iii) {cfg.name} fp32 head_train_loss and its gradient, B=1 "
          f"S={cs.GRAD_CHECK_S}",
          lambda: trainer.value_and_grad(lambda d: head_train_loss(
              d, base, cfg, toks, objective="distill"), dp))
    del base, dp
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(cs.ZAMBA2), dtype="float32")
    params = init_params(cfg, seed=0, device="cuda")
    P = 1000
    tokens = torch.randint(0, cfg.vocab_size, (1, P), generator=torch.Generator(
        device="cuda").manual_seed(P + 1), device="cuda")
    pos = torch.arange(P, device="cuda")[None]

    @torch.no_grad()
    def prefill():
        return forward(params, cfg, tokens, pos, mode="full",
                       want_logits=False)

    turns(f"5b {cfg.name} fp32 whole prefill, {cfg.n_layers} layers, {P} "
          "tokens", prefill)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return records


def tiny_steps(old_libs: dict) -> list:
    """vicuna-tiny's captured decode step in the paged engine under the
    old and the new tree-verify library, in turns: device busy a step and
    the split and merge kernels' µs a step from a traced serve."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.trees import default_tree
    from repro_torch.serving.engine import PagedSpeculativeEngine, Request
    from repro_torch.training import tiny

    tiny.CKPT_DIR = str(ROOT / "build" / "ckpt_tree_steps")
    c2, dp = tiny.draft_setup("hydra")
    cfg, params, pipe = tiny.base_setup()
    prompts = pipe.eval_batch(4)[:, :32]
    tree = default_tree(16, 4, 4)
    records = []
    for key in ("old", "new", "new", "old"):
        ctx = Patched(old_libs) if key == "old" else _Nothing()
        with ctx:
            eng = PagedSpeculativeEngine(params, dp, c2, tree, max_len=512)
            reqs = lambda: [Request(prompt=np.asarray(p, np.int32),
                                    max_new_tokens=48) for p in prompts]
            eng.serve(reqs(), max_batch=4)           # the capture
            st = eng.stats
            steps0, wall0 = st.steps, st.wall_s
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                eng.serve(reqs(), max_batch=4)
                torch.cuda.synchronize()
            n = st.steps - steps0
            busy = split = merge = 0
            for e in prof.profiler.kineto_results.events():
                if e.device_type() != DeviceType.CUDA:
                    continue
                busy += e.duration_ns()
                if "tree_attention_split_kernel" in e.name():
                    split += e.duration_ns()
                elif "tree_attention_merge_kernel" in e.name():
                    merge += e.duration_ns()
            rec = {"run": "vicuna-tiny fp32 captured paged decode step",
                   "kernels": key if key == "new" else LABEL,
                   "card": cs.CARD, "steps": n,
                   "busy_us_a_step": busy / 1e3 / n,
                   "split_us_a_step": split / 1e3 / n,
                   "merge_us_a_step": merge / 1e3 / n,
                   "wall_ms_a_step": 1e3 * (st.wall_s - wall0) / n,
                   "captures": st.captures}
            records.append(rec)
            cs.log(f"[tree step] {rec['run']} (4 prompts of 32, 48 new "
                   f"tokens, default_tree(16, 4, 4)), {rec['kernels']} "
                   f"library ({cs.CARD}): {n} steps, device busy "
                   f"{rec['busy_us_a_step']:.1f} us a step, tree-verify "
                   f"split {rec['split_us_a_step']:.1f} + merge "
                   f"{rec['merge_us_a_step']:.1f} us a step "
                   f"({100 * (split + merge) / busy:.1f}%), wall "
                   f"{rec['wall_ms_a_step']:.2f} ms a step")
            del eng
            gc.collect()
    return records


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def main() -> int:
    import torch

    global LABEL, OLD_PADS
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="a directory holding another copy of csrc/")
    ap.add_argument("--cases", choices=("all", "k3", "k6", "tree", "k5"),
                    default="all",
                    help="K3's cases, K6's, the tree-verify ones, K5's, "
                         "or all")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="with --old: a constexpr int of the tree-verify "
                         "source set to VALUE in the copy built")
    ap.add_argument("--label", default="old",
                    help="the second library's name in the lines")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "k3_times.json")
    ap.add_argument("--steps", action="store_true",
                    help="with --old: 5e(iii)'s fp32 head step and 5b's "
                         "zamba2 fp32 prefill under each K3, (tree "
                         "cases) vicuna-tiny's captured decode step under "
                         "each tree-verify library and (K6 cases) 5g(iv)'s "
                         "fp32 gradient check under each K6, in turns")
    args = ap.parse_args()
    LABEL = args.label
    if not torch.cuda.is_available():
        print("time_bwd_kernels: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(cs.CARD)
    from repro_torch.kernels import build

    k3 = args.cases in ("all", "k3")
    k6 = args.cases in ("all", "k6")
    tree = args.cases in ("all", "tree")
    k5 = args.cases in ("all", "k5")
    libs = ([*K3_ABI] if k3 else []) + ([TREE_LIB] if tree else []) \
        + (list(K6_LIBS) if k6 else []) + ([MLA_LIB] if k5 else [])
    sets = dict(a.split("=", 1) for a in args.set)
    t0 = time.perf_counter()
    build.build(libs)
    old_libs = build_old(args.old, libs, sets) if args.old else {}
    if args.old and k3:
        OLD_PADS = "flash_tf32" not in (
            args.old / build.SOURCES["flash_attention"]).read_text()
    cs.log(f"[build] {time.perf_counter() - t0:.1f}s")
    for name in libs:
        for line in cs.ptxas_lines(build.ptxas_report(name)):
            cs.log(f"[ptxas] {line}")
    records = []
    for cases in ((fwd_cases, bwd_cases) if k3 else ()):
        for what, lib, call in cases():
            records.append(time_case(what, lib, call, old_libs))
    if tree:
        for what, lib, call, same in tree_cases():
            records.append(time_case(what, lib, call, old_libs, same))
    if k6:
        for what, lib, call, same in k6_cases():
            records.append(time_case(what, lib, call, old_libs, same))
    if k5:
        for what, lib, call, same in k5_cases():
            records.append(time_case(what, lib, call, old_libs, same))
    if args.steps and old_libs:
        if k3:
            records += steps(old_libs)
        if tree:
            records += tiny_steps(old_libs)
        if k6:
            records += k6_grad_check(old_libs)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(records, indent=1))
    cs.log(f"[time] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
