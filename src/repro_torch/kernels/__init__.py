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
``grad_launches``.  Every other wrapper (K1, K2, K4, K5 and K3's chunk
form) refuses autograd: with grad mode on and an operand requiring a
gradient it raises (``refuse_grad``) instead of returning a result
detached from the graph."""
from __future__ import annotations

import torch

# the counters a wrapper may keep beside ``launches``
SECOND_COUNTERS = ("merge_launches", "scan_launches", "chunk_launches",
                   "grad_launches")


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
