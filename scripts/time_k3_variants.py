"""Time variants of K3's bf16 body on one NVIDIA card: copies of
``src/repro_torch/csrc`` with a piece of ``flash_attention.cu`` cut or a
constant changed, each built as a library of its own and called through
its C entry point, in turns, at the bf16 cases of
``scripts/time_bwd_kernels.py`` (and qwen2.5-32b's 40 over 8 heads).

    PYTHONPATH=src python scripts/time_k3_variants.py \
        [--variants base,onewg,...] [--tiles 32,64,128] \
        [--out build/k3_variants.json]

Variants (``VARIANTS``): ``base`` (the source as it is), ``onewg`` (one
consumer warpgroup a block at every build), ``stages3`` (a ring of three
stages; a build whose ring no longer fits refuses the key tile, and the
line says so), ``nomma`` (no wgmma issued), ``nosoftmax`` (the unmasked tiles'
softmax cut), ``noload`` (no K/V TMA copy: the producer arrives on the
barriers itself), ``nostore`` (no output written), ``empty`` (no key
tile walked: the blocks' fixed costs).  A variant that cuts work gives
wrong outputs by construction; each line prints every variant's device
µs (``chip_smoke.device_ms``) and its max abs error against the plain
version, so a variant meant to be exact (``onewg``, ``stages3``) shows
whether it is.  Every anchor must be found in the source, or the script
raises: a variant is a text substitution, and a source that changed
under it must not be timed as something else.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

OUT_DIR = ROOT / "build" / "k3_variants"
_NO_MMA = [("wg::rs_t1<DV>(o,", "if (p.window == -7) wg::rs_t1<DV>(o,"),
           ("wg::ss_t0<KN>(", "if (p.window == -7) wg::ss_t0<KN>(")]
_NO_LOAD = [("tma_load(s0 + L::oK", "if (p.window == -7) tma_load(s0 + L::oK"),
            ("mbar_expect_tx(full_k + 8 * sg, L::kQb * L::kKBlk);",
             "mbar_arrive(full_k + 8 * sg);"),
            ("tma_load(s0 + L::oV", "if (p.window == -7) tma_load(s0 + L::oV"),
            ("mbar_expect_tx(full_v + 8 * sg, L::kVb * L::kKBlk);",
             "mbar_arrive(full_v + 8 * sg);")]
_NO_STORE = [("  for (int c = wtid; c < kMmaRows * kCh; c += 128) {",
              "  for (int c = wtid; p.window == -7; c += 128) {")]
# name -> [(anchor in flash_attention.cu, replacement)]; the cases pass
# window 0 or 512, never -7, so a guard on it cuts its statement
VARIANTS = {
    "base": [],
    "onewg": [("constexpr int kMaxWarpgroups = 2;",
               "constexpr int kMaxWarpgroups = 1;")],
    "stages3": [("constexpr int kStages = 2;",
                 "constexpr int kStages = 3;")],
    "nomma": _NO_MMA,
    "nosoftmax": [("      softmax(t, corr, std::false_type{});",
                   "      corr[0] = corr[1] = 1.f;")],
    "noload": _NO_LOAD,
    "nostore": _NO_STORE,
    "empty": [("const int ntiles = has_rows && k_end > k_begin",
               "const int ntiles = p.window == -7 && k_end > k_begin"),
              ("const int n_u = ke_u > kb_u ?",
               "const int n_u = p.window == -7 ?")],
}
# (name, Hq, Hkv, Dqk, Dv, S, window, causal)
CASES = (("gemma3-1b", 4, 1, 256, 256, 1536, 0, True),
         ("gemma3-1b window 512", 4, 1, 256, 256, 1536, 512, True),
         ("zamba2-1.2b", 32, 32, 64, 64, 1536, 0, True),
         ("deepseek MLA", 16, 16, 192, 128, 1536, 0, True),
         ("minitron-4b", 24, 8, 128, 128, 1536, 0, True),
         ("hubert-xlarge", 16, 16, 80, 80, 1536, 0, False),
         ("qwen2.5-32b", 40, 8, 128, 128, 1536, 0, True))


def build_variants(names) -> dict:
    """{name: C entry point} of each variant, all nvcc processes at once."""
    from repro_torch.kernels import build

    src = ROOT / "src" / "repro_torch" / "csrc"
    procs = {}
    for name in names:
        d = OUT_DIR / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        f = d / "flash_attention.cu"
        text = f.read_text()
        for anchor, repl in VARIANTS[name]:
            if text.count(anchor) != 1:
                raise ValueError(f"{name}: anchor not found once: {anchor}")
            text = text.replace(anchor, repl)
        f.write_text(text)
        lib = d / "libflash_attention.so"
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(f)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        fn = ctypes.CDLL(str(lib)).flash_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_void_p])
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    from repro_torch.kernels.flash_attention import kernel as k3k

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--tiles", default="32,64,128")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "k3_variants.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_k3_variants: no CUDA device", file=sys.stderr)
        return 1
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(cs.CARD)
    fns = build_variants(args.variants.split(","))
    tiles = [int(t) for t in args.tiles.split(",")]
    records = []
    for name, hq, hkv, dqk, dv, S, w, causal in CASES:
        g = torch.Generator(device="cuda").manual_seed(S + w + dqk)
        mk = lambda h, d: torch.randn((1, S, h, d), generator=g,
                                      device="cuda").to(torch.bfloat16)
        q, k, v = mk(hq, dqk), mk(hkv, dqk), mk(hkv, dv)
        out = torch.empty((1, S, hq, dv), dtype=torch.bfloat16,
                          device="cuda")
        ref = k3k.flash_attention_plain(q, k, v, causal=causal,
                                        window=w).float()
        for kn in (t for t in tiles if t in k3k.KEY_TILES[(dqk, dv)]):
            rec = {"case": name, "key_tile": kn, "card": cs.CARD}
            for var, fn in fns.items():
                def call(fn=fn):
                    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), None, None, None, 1, S, S, hq,
                              hkv, dqk, dv, int(causal), w, 1, kn,
                              1.0 / math.sqrt(dqk),
                              torch.cuda.current_stream().cuda_stream)
                rc = call()
                torch.cuda.synchronize()
                if rc:
                    rec[var] = {"refused": rc}
                    continue
                err = (out.float() - ref).abs().max().item()
                rec[var] = {"us": 1e3 * cs.device_ms(call), "err": err}
            records.append(rec)
            cs.log(f"[variants] {name} ({hq}/{hkv}, {dqk}/{dv}) S={S} "
                   f"KN={kn} ({cs.CARD}): " + ", ".join(
                       f"{var} refused (CUDA {r['refused']})"
                       if "refused" in r else
                       f"{var} {r['us']:.1f}us (err {r['err']:.1e})"
                       for var, r in rec.items() if isinstance(r, dict)))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
