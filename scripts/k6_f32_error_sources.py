"""Where K6's fp32 forward error comes from, on the CPU.

Runs the model of the fp32 kernels' arithmetic
(``tests/test_torch_k6_f32_rules.py``: the chunk decomposition with each
product as ``Arith`` says) at the shapes of ``chip_smoke.py``'s phase 3f
(rwkv6-1.6b's 32 heads of 64, chunk 64; r, k, v from N(0, 1), log-decay
-exp(0.5 n) or, strong, max(-exp(1.5 n + 1), -20), u and the initial
state 0.1 n; numpy draws, so not 3f's own operands) in several forms of
the arithmetic:

  kernel      the kernels' 3xTF32: truncating split, lo hi + hi lo + hi hi
  rna         the split rounding to nearest (cvt.rna) instead
  lo.lo       a fourth product, lo lo
  fp32        no split: each product an fp32 matmul (the decomposition's
              own error)
  rz-acc      the kernels' split, each mma.sync k-step rounded toward zero
              into its accumulator (an approximation of the tensor cores)
  rz-acc rna  the same with the rounding split and lo lo

and prints, for each against the plain fp32 version (``ref.py::
decay_attention_chunked``, what 3f compares with) and against the token
recurrence in fp64: the max abs error over the output and the final
state, and the worst ratio err / (atol + rtol |ref|) at atol = rtol =
1e-4 (``torch.testing.assert_close`` passes at <= 1).

    PYTHONPATH=src python scripts/k6_f32_error_sources.py [--heads 32]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(0, str(REPO / "src"))

from repro_torch.kernels.linear_attn_chunk.ref import (  # noqa: E402
    decay_attention_chunked)
from test_torch_k6_f32_rules import Arith, model_forward  # noqa: E402

FORMS = {"kernel": Arith(), "rna": Arith(rounding="rna"),
         "lo.lo": Arith(passes=4), "fp32": Arith(rounding="none"),
         "rz-acc": Arith(accumulate="rz"),
         "rz-acc rna lo.lo": Arith(passes=4, rounding="rna",
                                   accumulate="rz")}
# phase 3f's fp32 cases: (S, initial state, strong decay, B)
CASES = [(S, init, False, 1) for S in (37, 300, 1536)
         for init in (False, True)] + [(300, True, True, 1),
                                       (1536, True, True, 1),
                                       (300, True, False, 2)]


def operands(S, init, strong, B, H, seed):
    rs = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(rs.standard_normal(s, dtype=np.float32))
    shape = (B, S, H, 64)
    r, k, v = n(*shape), n(*shape), n(*shape)
    w = torch.clamp_min(-torch.exp(n(*shape) * 1.5 + 1.0), -20.0) if strong \
        else -torch.exp(n(*shape) * 0.5)
    return r, k, v, w, n(H, 64) * 0.1, n(B, H, 64, 64) * 0.1 if init else None


def recurrence_fp64(r, k, v, w, u, s0):
    """o_t = r_t S + (r_t . u k_t) v_t, S <- diag(exp w_t) S + k_t v_t^T."""
    r, k, v, w, u = (t.double() for t in (r, k, v, w, u))
    B, S, H, d = k.shape
    state = torch.zeros((B, H, d, d), dtype=torch.float64) if s0 is None \
        else s0.double()
    outs = []
    for i in range(S):
        o = torch.einsum("bhd,bhde->bhe", r[:, i], state)
        outs.append(o + (r[:, i] * u * k[:, i]).sum(-1, keepdim=True)
                    * v[:, i])
        state = state * torch.exp(w[:, i])[..., None] + \
            k[:, i, :, :, None] * v[:, i, :, None, :]
    return torch.stack(outs, 1), state


def errors(o, st, ref_o, ref_st):
    """(max abs error, worst err / (1e-4 + 1e-4 |ref|))."""
    err, ratio = 0.0, 0.0
    for a, b in ((o, ref_o), (st, ref_st)):
        d = (a.double() - b.double()).abs()
        err = max(err, d.max().item())
        ratio = max(ratio, (d / (1e-4 + 1e-4 * b.double().abs())).max()
                    .item())
    return err, ratio


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--heads", type=int, default=32)
    args = ap.parse_args()
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    worst = {}
    for S, init, strong, B in CASES:
        x = operands(S, init, strong, B, args.heads, S + 7 * strong + B)
        plain = decay_attention_chunked(*x, chunk=64)
        exact = recurrence_fp64(*x)
        p_err, p_ratio = errors(*plain, *exact)
        print(f"B={B} S={S} init={init}{' strong decay' if strong else ''}"
              f" ({args.heads} heads): plain fp32 against fp64 "
              f"{p_err:.3e} (ratio {p_ratio:.3f})")
        for name, ar in FORMS.items():
            o, st, _ = model_forward(*x, 64, ar)
            e, ratio = errors(o, st, *plain)
            e64, ratio64 = errors(o, st, *exact)
            w = worst.setdefault(name, [0.0, 0.0, 0.0, 0.0])
            for i, val in enumerate((e, ratio, e64, ratio64)):
                w[i] = max(w[i], val)
            print(f"  {name:17s} against plain {e:.3e} (ratio {ratio:.3f})"
                  f", against fp64 {e64:.3e} (ratio {ratio64:.3f})")
    print("worst over the cases (against plain: abs, ratio; against fp64:"
          " abs, ratio):")
    for name, (e, ratio, e64, ratio64) in worst.items():
        print(f"  {name:17s} {e:.3e} {ratio:.3f} {e64:.3e} {ratio64:.3f}")
    print(f"{time.perf_counter() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
