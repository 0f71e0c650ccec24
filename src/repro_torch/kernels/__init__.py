"""The port's hand-written kernels: one package per TPU kernel it
replaces, each with a wrapper (``ops``), its launch (``kernel``) and a
plain PyTorch version (``ref``); the CUDA sources are in ``csrc/``.

Each wrapper counts its launches in module-level counters (``launches``,
and ``merge_launches``/``scan_launches``/``chunk_launches`` where a call
launches a second kernel or a second form).  A launch recorded into a
CUDA graph counts once, at capture; its replays are counted by the
graph's owner (``serving/graph.py::CapturedStep.replays``).

Two wrappers have a backward: K3's whole prefill (``flash_attention/
ops.py::FlashAttention``) and K6 (``linear_attn_chunk/ops.py::
LinearAttnChunk``); each counts its calls under autograd in
``grad_launches`` and, on CUDA, its backward's calls in
``bwd_launches`` (each call launches all of the backward's kernels; K6
counts its du reduction, launched only with u, in ``bwd_du_launches``).
Every other wrapper (K1, K2, K4, K5 and K3's chunk
form) refuses autograd: with grad mode on and an operand requiring a
gradient it raises (``refuse_grad``) instead of returning a result
detached from the graph.

This module is also the tile lookup of the CUDA wrappers (port of
``repro/kernels/__init__.py``'s winner cache): ``tuned_block_sizes``
reads the winners of ``results/autotune.cuda.json`` (committed;
``kernels/autotune.py`` is the sweep that writes it).  The one tunable is
K3's bf16 key tile, keyed by the build and the heads of a call
(``flash_attention/ops.py::resolve_key_tile``).  The tree-verify
kernels' pad of the tree axis and K5's split length stay constants: a
sweep on the card found no key where another value won.  The
``REPRO_TORCH_AUTOTUNE`` environment variable sets the mode:

  - unset / ``on``: consult the committed cache; a missing key logs a
    one-line warning (once per key) and the built-in defaults apply;
  - ``off``: ignore the cache, use the built-in defaults;
  - ``sweep``: time a missing key on its first use and use its winner
    (in this process only; the committed file is not rewritten).  A
    sweep cannot run while a CUDA graph is being captured: it raises.

The defaults are the constants the wrappers computed before the cache
existed, so without a cache every wrapper computes what it did, bit for
bit.  The lookup is a dict read on the host (the file is read once): no
device sync, so it runs inside a graph capture.  The wrappers' CPU path
(the plain versions, which have no tiles) consults nothing."""
from __future__ import annotations

import json
import logging
import os
from functools import lru_cache
from pathlib import Path

import torch

AUTOTUNE_ENV = "REPRO_TORCH_AUTOTUNE"
AUTOTUNE_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
BACKEND = "cuda"               # the cache's name: results/autotune.cuda.json
RESULTS_DIR = Path(__file__).resolve().parents[3] / "results"

_log = logging.getLogger("repro_torch.kernels")

# the counters a wrapper may keep beside ``launches``
SECOND_COUNTERS = ("merge_launches", "scan_launches", "chunk_launches",
                   "grad_launches", "bwd_launches", "bwd_du_launches")


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if autograd would need a backward of ``kernel``, which has
    none: grad mode is on and one of ``tensors`` (None skipped) requires a
    gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: call it under torch.no_grad(), or "
            "with operands that require no gradient")


def counter_modules() -> dict:
    """The wrapper module of every kernel, by kernel name."""
    from repro_torch.kernels.attention_template import ops as k4
    from repro_torch.kernels.flash_attention import ops as k3
    from repro_torch.kernels.linear_attn_chunk import ops as k6
    from repro_torch.kernels.mla_attention import ops as k5
    from repro_torch.kernels.tree_attention import dense_ops as k2
    from repro_torch.kernels.tree_attention import ops as k1

    return {"tree_attention_paged": k1, "tree_attention_dense": k2,
            "tree_attention_paged_windowed": k4, "flash_attention": k3,
            "mla_attention_paged": k5, "linear_attn_chunk": k6}


def launch_counts() -> dict:
    """Every launch counter now: ``{name: launches}`` and ``{"name
    counter": n}`` for each second counter a wrapper keeps."""
    out = {}
    for name, mod in counter_modules().items():
        out[name] = mod.launches
        for attr in SECOND_COUNTERS:
            if hasattr(mod, attr):
                out[f"{name} {attr}"] = getattr(mod, attr)
    return out


def reset_counts() -> None:
    """Set every launch counter to 0."""
    for mod in counter_modules().values():
        mod.launches = 0
        for attr in SECOND_COUNTERS:
            if hasattr(mod, attr):
                setattr(mod, attr, 0)


# ---------------------------------------------------------------------------
# the autotuner's winner cache
# ---------------------------------------------------------------------------


def autotune_cache_path(backend: str = BACKEND) -> str:
    """Path of the winner cache the wrappers consult; the
    ``REPRO_TORCH_AUTOTUNE_CACHE`` environment variable overrides it."""
    override = os.environ.get(AUTOTUNE_CACHE_ENV)
    if override:
        return override
    return str(RESULTS_DIR / f"autotune.{backend}.json")


def block_size_key(variant: str, shape: dict) -> str:
    """The cache key of a call: the variant, then ``name=value`` for each
    entry of ``shape`` in order (``flash|dqk=128|dv=128|hq=24|hkv=8|
    causal=1``)."""
    return "|".join([variant] + [f"{k}={int(v)}" for k, v in shape.items()])


@lru_cache(maxsize=None)
def _load_winner_cache(path: str) -> dict:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError) as e:
        _log.warning("autotune: could not read winner cache %s (%s); "
                     "built-in defaults apply", path, e)
        return {}
    return data.get("entries", {})


_warned_keys: set = set()
_swept_keys: dict = {}


def tuned_block_sizes(variant: str, shape: dict, *,
                      defaults: dict) -> dict:
    """The tunables a wrapper launches its kernel with: ``defaults``'s
    keys, each the cache's winner for ``block_size_key(variant, shape)``
    where the cache has one.  A miss logs one warning per key and returns
    ``defaults``: tuning is an optimisation, never a correctness gate.
    ``shape`` holds all a sweep on a miss needs (mode ``sweep``)."""
    mode = os.environ.get(AUTOTUNE_ENV, "on").lower()
    if mode == "off":
        return dict(defaults)
    key = block_size_key(variant, shape)
    entry = _load_winner_cache(autotune_cache_path()).get(key)
    if entry is None and mode == "sweep":
        entry = _swept_keys.get(key)
        if entry is None:
            if torch.cuda.is_available() \
                    and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"autotune: cannot sweep {key!r} while a CUDA graph is "
                    "being captured; resolve it in an eager call first")
            from repro_torch.kernels import autotune
            entry = autotune.sweep_entry(variant, shape)
            _swept_keys[key] = entry
    if entry is None:
        if key not in _warned_keys:
            _warned_keys.add(key)
            _log.warning("autotune: no winner for key %r in %s; using "
                         "defaults %s", key, autotune_cache_path(),
                         dict(defaults))
        return dict(defaults)
    out = dict(defaults)
    out.update({k: int(v) for k, v in entry.items() if k in defaults})
    return out
