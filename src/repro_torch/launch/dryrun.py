"""Dry run: one step of every (architecture x input-shape) pair run on the
``meta`` device under the op counter, its memory and cost, and its
roofline terms (port of ``repro/launch/dryrun.py``).  It needs no card:
nothing is allocated and no kernel runs.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k --host
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --host [--jobs 4]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Records go to results/dryrun_torch/<arch>__<shape>__<mesh>.json, with
JAX's field names where they mean the same thing.  Deliberate differences
from JAX's records:

  * on the host mesh (one H100, 1 x 1) the counted flops, bytes and peak
    live bytes are the device's (``"scope": "device"``), and the roofline
    terms come from them;
  * on a pod mesh they are the whole step's (``"scope": "global"``): the
    step is not run sharded, so nothing is counted per device; the
    roofline's per-device terms are then the analytic ones (model flops
    over the devices at the bf16 peak, ``analytic_min_bytes`` over HBM);
    argument and output bytes are per device on every mesh, from the
    specs' shard shapes;
  * ``collective_bytes_per_dev`` is null (``launch/roofline.py``).

``scripts/torch_opt_sweep.py`` runs the same ``run_one`` on pod16x16
with the ragged-head archs' query heads padded to 16 (JAX's opt sweep),
into ``results/dryrun_torch_opt/``; ``launch/roofline_table.py`` renders
either directory as JAX's table.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import INPUT_SHAPES, get_config, list_configs
from repro_torch.distributed.sharding import sharded_bytes
from repro_torch.launch.mesh import (PEAK_FLOPS_BF16, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.op_cost import OpCounter
from repro_torch.launch.roofline import (analytic_min_bytes, model_flops,
                                         roofline_terms)
from repro_torch.launch.specs import build_step_spec, skip_reason

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
COLLECTIVE_NOTE = ("not counted: the port runs no step across devices "
                   "(no DTensor execution), so it has no collective to count")


def mesh_for(name: str):
    if name == "host1x1":
        return make_host_mesh()
    return make_production_mesh(multi_pod=name == "pod2x16x16")


def mesh_name(*, host: bool = False, multi_pod: bool = False) -> str:
    return "host1x1" if host else ("pod2x16x16" if multi_pod else "pod16x16")


def run_one(arch: str, shape_name: str, mesh: str = "host1x1",
            out_dir: str = RESULTS_DIR, verbose: bool = True,
            cfg=None) -> dict:
    """Count one step of ``arch`` at ``shape_name`` on ``mesh``
    ("host1x1", "pod16x16" or "pod2x16x16"); save and return its
    record."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh, "status": "?"}
    reason = skip_reason(cfg, shape_name)
    if reason:
        rec.update(status="skip", reason=reason)
        _save(rec, out_dir)
        if verbose:
            print(f"[dryrun] SKIP {arch} x {shape_name}: {reason}")
        return rec

    t0 = time.time()
    try:
        m = mesh_for(mesh)
        n_chips = m.size
        spec = build_step_spec(cfg, shape_name, m)
        t_build = time.time() - t0
        with OpCounter() as oc:
            out = spec.fn(*spec.args)
        t_run = time.time() - t0 - t_build
        arg_bytes = sum(sharded_bytes(a, s, m)
                        for a, s in zip(spec.args, spec.specs))
        out_bytes = sharded_bytes(out, spec.out_specs, m)
        del out
        mf = model_flops(cfg, shape)
        mp = m.shape.get("model", 1)
        min_bytes = analytic_min_bytes(cfg, shape, n_chips, mp)
        counted_flops = sum(oc.flops.values())
        if n_chips == 1:
            scope = "device"
            terms = roofline_terms(oc.compute_s, oc.bytes)
            compute_ideal = oc.compute_s
        else:
            scope = "global"
            compute_ideal = mf / n_chips / PEAK_FLOPS_BF16
            terms = roofline_terms(compute_ideal, min_bytes)
        terms_min = roofline_terms(compute_ideal, min_bytes)
        rec.update(
            status="ok", note=spec.note, n_chips=n_chips, scope=scope,
            build_s=round(t_build, 1), run_s=round(t_run, 1),
            # per device, from the specs' shard shapes
            argument_bytes=arg_bytes, output_bytes=out_bytes,
            temp_bytes=oc.peak_live_bytes,
            peak_bytes=(arg_bytes + oc.peak_live_bytes
                        if n_chips == 1 else None),
            # the op counter (scope above)
            flops_by_dtype=dict(oc.flops), counted_flops=counted_flops,
            counted_bytes=oc.bytes, peak_live_bytes=oc.peak_live_bytes,
            counted_compute_s=oc.compute_s, n_ops=oc.n_ops,
            kernels=oc.kernel_summary(),
            collective_bytes_per_dev=None, collective_note=COLLECTIVE_NOTE,
            model_flops_global=mf,
            useful_flops_ratio=mf / counted_flops if counted_flops else None,
            analytic_min_bytes_per_dev=min_bytes,
            memory_s_ideal=terms_min["memory_s"],
            bottleneck_ideal=terms_min["bottleneck"],
            **terms,
        )
        if verbose:
            print(line(rec), flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[dryrun] ERROR {arch} x {shape_name} [{mesh}]: "
                  f"{type(e).__name__}: {e}", flush=True)
    _save(rec, out_dir)
    return rec


def _gib(x) -> str:
    return f"{x / 2 ** 30:.2f}GiB" if x is not None else "?"


def line(rec: dict) -> str:
    """One line of a record: flops by dtype, bytes, argument and peak
    live GiB, the compute and memory terms and the bottleneck."""
    if rec["status"] != "ok":
        return (f"[dryrun] {rec['status'].upper()} {rec['arch']} x "
                f"{rec['shape']} [{rec['mesh']}]: "
                f"{rec.get('reason') or rec.get('error')}")
    flops = " ".join(f"{k}={v:.3e}" for k, v in
                     sorted(rec["flops_by_dtype"].items()))
    return (f"[dryrun] OK {rec['arch']} x {rec['shape']} [{rec['mesh']}] "
            f"({rec['note']}; {rec['scope']}) flops {flops} bytes "
            f"{rec['counted_bytes']:.3e} args {_gib(rec['argument_bytes'])} "
            f"peak live {_gib(rec['peak_live_bytes'])} compute "
            f"{rec['compute_s']:.3e}s memory {rec['memory_s']:.3e}s -> "
            f"{rec['bottleneck']} (run {rec['run_s']}s, {rec['n_ops']} ops)")


def _save(rec: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def recorded(out_dir: str, arch: str, shape: str, mesh: str) -> bool:
    """The pair's record in ``out_dir`` is ``ok`` or ``skip`` (JAX's
    resume rule: such a pair is not run again)."""
    f = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
    if not os.path.exists(f):
        return False
    with open(f) as fh:
        return json.load(fh).get("status") in ("ok", "skip")


def _longest_first(job: tuple) -> int:
    kind = INPUT_SHAPES[job[1]].kind
    if kind == "prefill" and get_config(job[0]).block_kind == "mamba2":
        return 0
    return 1 if kind == "train" else 2


def _run_pair(job: tuple) -> dict:
    arch, shape, mesh, out_dir = job
    return run_one(arch, shape, mesh, out_dir)


def run_jobs(fn, jobs: list, n_jobs: int) -> list:
    """``[fn(job) for job in jobs]`` (each job an (arch, shape, ...)
    tuple), in ``n_jobs`` spawned processes when it is above 1, the
    longest pairs first: a Mamba2 prefill (its SSD runs a Python loop
    over chunks of 64: 1.6M meta ops at prefill_32k), then the training
    steps (every layer's forward and backward ops)."""
    if n_jobs <= 1:
        return [fn(j) for j in jobs]
    import multiprocessing

    jobs = sorted(jobs, key=_longest_first)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(n_jobs) as pool:
        return pool.map(fn, jobs, chunksize=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    where = ap.add_mutually_exclusive_group()
    where.add_argument("--multi-pod", action="store_true")
    where.add_argument("--host", action="store_true",
                       help="the one-card mesh (1 x 1): counted per device")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip pairs with an existing ok/skip record")
    ap.add_argument("--jobs", type=int, default=1,
                    help="pairs run at once, each in a process of its own")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else [a for a in list_configs()
                                           if a != "vicuna-tiny"]
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    if not (args.all or args.arch):
        ap.error("pass --arch or --all")

    mesh = mesh_name(host=args.host, multi_pod=args.multi_pod)
    jobs = [(arch, shape, mesh, args.out_dir) for arch in archs
            for shape in shapes if not (
                args.skip_done and recorded(args.out_dir, arch, shape, mesh))]
    t0 = time.time()
    recs = run_jobs(_run_pair, jobs, args.jobs)
    n = {s: sum(r["status"] == s for r in recs)
         for s in ("ok", "skip", "error")}
    print(f"[dryrun] done: {n['ok']} ok, {n['skip']} skip, {n['error']} "
          f"error in {time.time() - t0:.1f}s")
    if n["error"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
