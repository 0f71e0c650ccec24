"""Mesh descriptions and the card's roofline constants (port of
``repro/launch/mesh.py``).

A mesh here is a description only, axis names and sizes, with no device
state (JAX's ``AbstractMesh``): the sharding rules
(``distributed/sharding.py``) and the dry run (``launch/dryrun.py``) read
nothing else from it.  Running a model across GPUs over such a mesh
(DTensor over a ``DeviceMesh``) is not ported: every configuration here
runs on one card.

The constants are one NVIDIA H100 SXM5's (NVIDIA's H100 Tensor Core GPU
datasheet: dense rates without sparsity, at the 700 W power limit; the
special-function units from NVIDIA's Hopper architecture white paper).
They are the one source the roofline (``launch/roofline.py``), the op
counter's kernel charges (``launch/op_cost.py``) and ``chip_smoke.py``'s
bounds read.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple


class Mesh(NamedTuple):
    """Axis names and sizes, in order (a device-free mesh)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as JAX's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_abstract_mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """The one H100: 1 data x 1 model."""
    return make_abstract_mesh((1, 1), ("data", "model"))


def make_abstract_mesh(shape, axes) -> Mesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} does not match axes "
                         f"{tuple(axes)}")
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


# H100 SXM5 per card (FLOP/s by operand dtype; bytes/s)
PEAK_FLOPS_BF16 = 989e12           # tensor cores, bf16 and fp16
PEAK_FLOPS_FP32 = 67e12            # CUDA cores, fp32 (TF32 off)
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float16": PEAK_FLOPS_BF16,
              "float32": PEAK_FLOPS_FP32}
HBM_BW = 3.35e12                   # HBM3
NVLINK_BW = 18 * 25e9              # NVLink 4: 18 links x 25 GB/s a direction
# special-function units: 16 a clock per SM (4 per sub-partition), 132
# SMs, 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9
