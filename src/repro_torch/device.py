"""Device and dtype resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  CUDA is the default and is
    never swapped for the CPU behind the caller's back: without a card,
    only an explicit ``device="cpu"`` runs."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def seeded_generator(device: torch.device, seed: int):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; None on
    the ``meta`` device, where an init draws nothing and only gives
    shapes and dtypes (``torch.randn`` on ``meta`` takes no generator)."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def torch_dtype(name: str) -> torch.dtype:
    """``cfg.dtype`` ("bfloat16", "float32", ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
