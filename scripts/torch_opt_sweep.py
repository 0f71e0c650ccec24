"""The ``pad_q_heads_to=16`` dry-run sweep on the PyTorch port (the port
of ``scripts/opt_sweep.py``): one step of every registry arch but
vicuna-tiny at every ``INPUT_SHAPES`` entry on the ``pod16x16`` mesh,
through ``repro_torch.launch.dryrun.run_one`` on the ``meta`` device
(no card, nothing allocated), with the query heads of the ragged-head
dense, VLM, audio and MoE archs that are not MLA padded to a multiple of
16 (``opt_config``: JAX's rule, copied).  Records go to
``results/dryrun_torch_opt/``; a pair whose record there is ``ok`` or
``skip`` is not run again.  Render them with
``python -m repro_torch.launch.roofline_table --markdown --dir
results/dryrun_torch_opt``.

    python3 scripts/torch_opt_sweep.py [--arch gemma3-1b ...] [--jobs 4]
        [--out-dir results/dryrun_torch_opt] [--against DIR]

``--against DIR`` then prints, for each padded pair, its argument bytes
and ``useful_flops_ratio`` beside the unpadded record's in ``DIR`` (the
baseline sweep on the same mesh: ``python -m repro_torch.launch.dryrun
--all --jobs 4 --out-dir DIR``).

What the records can show.  Padding exists so that ``wq``/``wo`` shard at
head boundaries on the model axis (``distributed/sharding.py``'s
ragged-head guard); in JAX it removes the mid-head all-reduce of the
attention scores.  The port counts no collective
(``collective_bytes_per_dev`` is null: no step runs across devices), and
on a pod mesh its roofline terms are the analytic ones, so its opt
records show only the cost side of padding: larger argument bytes and a
lower ``useful_flops_ratio`` (``model_flops`` counts the unpadded heads,
as JAX's ``hlo_analysis.py`` does).  An unpadded arch's record equals its
``results/dryrun_torch/`` one but for the times.  JAX's XLA host-device
flag has no counterpart: nothing is sharded for real.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro_torch.configs import INPUT_SHAPES, get_config, list_configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

OUT = str(REPO / "results" / "dryrun_torch_opt")
MESH = "pod16x16"
PAD_TO = 16                      # the model axis of pod16x16


def opt_config(cfg):
    """``cfg`` with ``pad_q_heads_to=16`` where JAX's sweep pads it: a
    dense, VLM, audio or MoE arch whose head count 16 does not divide and
    that is not MLA; otherwise ``cfg`` itself."""
    if cfg.arch_type in ("dense", "vlm", "audio") or cfg.moe:
        if cfg.n_heads % PAD_TO and not cfg.mla:
            return dataclasses.replace(cfg, pad_q_heads_to=PAD_TO)
    return cfg


def sweep_archs() -> list:
    return [a for a in list_configs() if a != "vicuna-tiny"]


def padded_archs() -> list:
    """The archs ``opt_config`` pads."""
    return [a for a in sweep_archs()
            if opt_config(get_config(a)).pad_q_heads_to]


def _run_pair(job: tuple) -> dict:
    arch, shape, out_dir = job
    return dryrun.run_one(arch, shape, MESH, out_dir=out_dir,
                          cfg=opt_config(get_config(arch)))


def against(out_dir: str, base_dir: str) -> list:
    """One line per padded ``ok`` pair: argument bytes per device and
    ``useful_flops_ratio``, padded against the unpadded record of
    ``base_dir``."""
    lines = []
    for arch in padded_archs():
        cfg = opt_config(get_config(arch))
        for shape in INPUT_SHAPES:
            recs = []
            for d in (out_dir, base_dir):
                with open(os.path.join(
                        d, f"{arch}__{shape}__{MESH}.json")) as fh:
                    recs.append(json.load(fh))
            opt, base = recs
            if opt["status"] != "ok":
                continue
            lines.append(
                f"{arch} ({cfg.n_heads} -> {cfg.n_heads_padded} q heads over "
                f"{cfg.n_kv_heads}) x {shape} [{MESH}]: argument bytes "
                f"{opt['argument_bytes']} vs {base['argument_bytes']} "
                f"(x{opt['argument_bytes'] / base['argument_bytes']:.4f}), "
                f"useful_flops_ratio {opt['useful_flops_ratio']:.4f} vs "
                f"{base['useful_flops_ratio']:.4f}")
    return lines


def main(argv=None) -> dict:
    """Runs the sweep; returns ``{status: count}`` of the pairs run (a
    pair skipped by the resume rule is not counted); exits 1 on an
    ``error`` record."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", default=None,
                    choices=sweep_archs(),
                    help="repeatable; default every arch but vicuna-tiny")
    ap.add_argument("--jobs", type=int, default=1,
                    help="pairs run at once, each in a process of its own")
    ap.add_argument("--out-dir", default=OUT)
    ap.add_argument("--against", default=None, metavar="DIR",
                    help="baseline records to set the padded pairs beside")
    args = ap.parse_args(argv)
    jobs = [(arch, shape, args.out_dir) for arch in args.arch or sweep_archs()
            for shape in INPUT_SHAPES
            if not dryrun.recorded(args.out_dir, arch, shape, MESH)]
    t0 = time.time()
    recs = dryrun.run_jobs(_run_pair, jobs, args.jobs)
    n = {s: sum(r["status"] == s for r in recs)
         for s in ("ok", "skip", "error")}
    print(f"[opt_sweep] done: {n['ok']} ok, {n['skip']} skip, {n['error']} "
          f"error in {time.time() - t0:.1f}s (padded: "
          f"{', '.join(padded_archs())})", flush=True)
    if n["error"]:
        raise SystemExit(1)
    if args.against:
        print("\n".join(against(args.out_dir, args.against)), flush=True)
    return n


if __name__ == "__main__":
    main()
