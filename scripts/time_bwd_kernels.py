"""Time K3's and K6's backward kernels at phase 3m's cases of
``chip_smoke.py``, each launch on its own, on one NVIDIA card.

    PYTHONPATH=src python scripts/time_bwd_kernels.py \
        [--old DIR] [--steps] [--out build/bwd_times.json]

For each case (K6 at rwkv6-1.6b's (1, S), 32 heads of 64; K3 at the
training builds, ``chip_smoke.K3_BWD_CASES``) it prints the whole
backward's device time (``chip_smoke.device_ms``) and each launch's mean
device time and blocks, read from a ``torch.profiler`` trace
(``chip_smoke.launch_split``), together with the registers and spills
``ptxas -v`` reports for every backward kernel.

``--old DIR``: DIR holds another copy of ``src/repro_torch/csrc`` (for
example the parent commit's, unpacked with ``git archive`` into an
ignored directory).  Its two backward sources are built as second
libraries under ``build/old_kernels/`` and called through their C
entry points with the argument lists of that version (``OLD_ABI``);
each case then runs old, new, new, old, and the line gives both times
and the old time over the new.  Each old gradient is also held against
the new one (relative L2), so that a comparison of two different
functions shows.  With ``--steps`` it then times a base training step at
(1, 1024) of gemma3-1b and of rwkv6-1.6b (``chip_smoke.step_numbers``:
the backward kernels' device ms in a traced step, the untraced step's
wall time) under the old and the new backward kernels in turns.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

OLD_DIR = ROOT / "build" / "old_kernels"
# the C entry points of the backward libraries before the Hopper redesign:
# (library, symbol, pointer arguments, int arguments, trailing float)
OLD_ABI = {"flash_attention_bwd": ("flash_attention_bwd", 10, 9, True),
           "linear_attn_chunk_bwd": ("linear_attn_chunk_bwd", 16, 5, False)}


def build_old(src_dir: Path) -> dict:
    """Build the backward sources of ``src_dir`` into ``OLD_DIR``, both
    nvcc processes at once: {library: ctypes function}."""
    from repro_torch.kernels import build

    OLD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in OLD_ABI:
        out = OLD_DIR / f"lib{name}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
               str(src_dir / build.SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    fns = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the old {name}:\n{log}")
        for line in cs.ptxas_lines(log):
            cs.log(f"[ptxas old] {line}")
        sym, n_ptr, n_int, has_float = OLD_ABI[name]
        fn = getattr(ctypes.CDLL(str(out)), sym)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * has_float + [ctypes.c_void_p])
        fns[name] = fn
    return fns


def old_k6_launch(fn):
    """``linear_attn_chunk/kernel.py::launch_bwd``'s signature, launching
    the old K6 backward (its C entry's argument list and scratch)."""
    import torch

    def launch_bwd(r, k, v, w_log, u, states, do, d_state, dr, dk, dv, dw,
                   du, d_s0, *, chunk):
        B, S, H, D = k.shape
        nc = -(-S // chunk)
        f = lambda *s: torch.empty(s, dtype=torch.float32, device=k.device)
        ds_out = f(B, H, nc, D, D)
        du_part = None if u is None else f(B, H, nc, D)
        ptr = lambda t: None if t is None else t.data_ptr()
        return fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
                  ptr(u), states.data_ptr(), do.data_ptr(), ptr(d_state),
                  dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                  ptr(du), d_s0.data_ptr(), ds_out.data_ptr(), ptr(du_part),
                  B, S, H, chunk, 0 if k.dtype == torch.float32 else 1,
                  torch.cuda.current_stream().cuda_stream)

    return launch_bwd


def old_k3_launch(fn):
    """``flash_attention/kernel.py::launch_bwd``'s signature, launching
    the old K3 backward (its C entry's argument list and scratch)."""
    import torch

    def launch_bwd(q, k, v, out, lse, do, dq, dk, dv, *, causal, window,
                   scale):
        B, S, Hq, Dqk = q.shape
        Hkv, Dv = k.shape[2], v.shape[3]
        delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
        return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, Hq, Hkv,
                  Dqk, Dv, int(causal), int(window),
                  0 if q.dtype == torch.float32 else 1, float(scale),
                  torch.cuda.current_stream().cuda_stream)

    return launch_bwd


def old_k6(fn, r, k, v, w, u, states, do, chunk):
    """The old K6 backward's gradients."""
    import torch

    B, S, H, D = k.shape
    grads = (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
             torch.empty_like(w), torch.empty_like(u),
             torch.empty((B, H, D, D), dtype=torch.float32, device="cuda"))
    rc = old_k6_launch(fn)(r, k, v, w, u, states, do, None, *grads,
                           chunk=chunk)
    if rc != 0:
        raise RuntimeError(f"old K6 backward: CUDA error {rc}")
    return grads


def old_k3(fn, q, k, v, out, lse, do, causal, window, scale):
    """The old K3 backward's gradients."""
    import math

    import torch

    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    rc = old_k3_launch(fn)(
        q, k, v, out, lse, do, *grads, causal=causal, window=window,
        scale=1.0 / math.sqrt(q.shape[-1]) if scale is None else scale)
    if rc != 0:
        raise RuntimeError(f"old K3 backward: CUDA error {rc}")
    return grads


def steps(old_fns: dict) -> list:
    """A base training step at (1, 1024) of gemma3-1b (K3) and rwkv6-1.6b
    (K6), full configs, through ``chip_smoke.step_numbers``: old, new,
    new, old, the old backward launched in place of the new one by
    patching the launch the wrapper calls.  Returns one record a step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as k3k
    from repro_torch.kernels.linear_attn_chunk import kernel as k6k

    records = []
    for arch, mod, lib, make in (
            ("gemma3-1b", k3k, "flash_attention_bwd", old_k3_launch),
            ("rwkv6-1.6b", k6k, "linear_attn_chunk_bwd", old_k6_launch)):
        cfg = get_config(arch)
        new = mod.launch_bwd
        for key in ("old", "new", "new", "old"):
            mod.launch_bwd = make(old_fns[lib]) if key == "old" else new
            try:
                n = cs.step_numbers(cfg)
            finally:
                mod.launch_bwd = new
            records.append({"arch": arch, "kernels": key, "card": cs.CARD,
                            **n})
            cs.log(f"[step] {arch} {key} backward kernels "
                   f"({cs.CARD}): {n['bwd_kernels_ms']:.2f} ms of "
                   f"{n['busy_ms']:.1f} ms device busy; untraced step "
                   f"{n['untraced_ms']:.1f} ms; the wrapper's backward "
                   f"calls {n['wrapper_bwd_ms']:.1f} ms wall")
    return records


def cases():
    """(name, new backward, old backward or None given the old library)
    for phase 3m's cases, on operands made as ``check_backward`` makes
    them; K3's fp32 cases run at padded head dims only in the wrapper, so
    the old one is not called there."""
    import torch
    from repro_torch.kernels.flash_attention import ops as k3
    from repro_torch.kernels.linear_attn_chunk import ops as k6

    for dtype_name, S in cs.K6_BWD_CASES:
        dtype = getattr(torch, dtype_name)
        r, k, v, w, u, _ = cs.k6_inputs(S, dtype, seed=S + 11, init=False)
        do = torch.randn(v.shape, generator=torch.Generator(
            device="cuda").manual_seed(S), device="cuda").to(dtype)
        args = (r, k, v, w, u, None)
        _, _, states = k6._forward(*args, cs.K6_CHUNK, states=True)
        new = (lambda a=args, st=states, d=do:
               k6._backward(*a, st, d, None, cs.K6_CHUNK))
        old = (lambda fn, r=r, k=k, v=v, w=w, u=u, st=states, d=do:
               old_k6(fn, r, k, v, w, u, st, d, cs.K6_CHUNK))
        yield f"K6 {dtype_name} S={S}", "linear_attn_chunk_bwd", new, old
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
        new = (lambda a=(q, k, v, out, lse, do), kw=kw:
               k3._backward(*a, **kw))
        old = None
        if dtype == torch.bfloat16:
            old = (lambda fn, a=(q, k, v, out, lse, do), kw=kw:
                   old_k3(fn, *a, kw["causal"], kw["window"], kw["scale"]))
        yield (f"K3 {model} {dtype_name} {hq}/{hkv} {dqk}/{dv} S={S} "
               f"window={w} {'causal' if causal else 'bidirectional'}",
               "flash_attention_bwd", new, old)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="a directory holding another copy of csrc/")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "bwd_times.json")
    ap.add_argument("--steps", action="store_true",
                    help="with --old: also a training step of gemma3-1b "
                         "and rwkv6-1.6b under each backward, in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_bwd_kernels: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(cs.CARD)
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build(["flash_attention", "linear_attn_chunk", *OLD_ABI])
    old_fns = build_old(args.old) if args.old else {}
    cs.log(f"[build] {time.perf_counter() - t0:.1f}s")
    for name in OLD_ABI:
        for line in cs.ptxas_lines(build.ptxas_report(name)):
            cs.log(f"[ptxas] {line}")
    records = []
    for what, lib, new, old in cases():
        rec = {"case": what, "card": cs.CARD}
        runs = {"new": new}
        if old is not None and lib in old_fns:
            runs["old"] = lambda o=old, fn=old_fns[lib]: o(fn)
            a, b = runs["new"](), runs["old"]()
            rec["rel_l2_old_vs_new"] = max(
                cs.rel_l2(x, y) for x, y in zip(a, b) if x is not None)
        order = ("old", "new", "new", "old") if "old" in runs else ("new",)
        for key in order:
            rec.setdefault(f"{key}_us", []).append(
                1e3 * cs.device_ms(runs[key]))
        for key, fn in runs.items():
            rec[f"{key}_split"] = cs.launch_split(
                fn, 1e-3 * min(rec[f"{key}_us"]))
        records.append(rec)
        line = (f"[bwd] {what} ({cs.CARD}): new "
                f"{', '.join(f'{x:.1f}' for x in rec['new_us'])}us "
                f"[{cs.split_text(rec['new_split'])}]")
        if "old" in runs:
            ratio = sum(rec["old_us"]) / sum(rec["new_us"])
            line += (f"; old {', '.join(f'{x:.1f}' for x in rec['old_us'])}"
                     f"us [{cs.split_text(rec['old_split'])}]; old/new "
                     f"{ratio:.2f}x; rel L2 old vs new "
                     f"{rec['rel_l2_old_vs_new']:.2e}")
        cs.log(line)
    if args.steps and old_fns:
        records += steps(old_fns)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(records, indent=1))
    cs.log(f"[bwd] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
