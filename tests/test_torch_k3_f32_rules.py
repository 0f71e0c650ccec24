"""K3's fp32 builds (3xTF32 on the tensor cores): the host-side rules the
wrappers keep for the CUDA sources, on the CPU.

``kernels/flash_attention/kernel.py`` mirrors constants of
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``: the query
tile (64 rows, in bf16 and fp32: the granularity at which a chunk's rows
equal the whole prefill's bit for bit), the fp32 key tiles whose ring
fits shared memory, the fp32 backward kernels' rows a block and its split
rule (two blocks a tile where one per (query head, tile) would leave the
card's 132 SMs idle), and the scratch the backward's launch allocates.
Each is held here against the sources' own text or against numbers
worked by hand, so that a change on one side shows.  The builds the
sources dispatch are read from their entry points and must equal
``DIMS`` (bf16) and ``F32_DIMS`` (fp32).
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as k3  # noqa: E402

CSRC = Path(k3.__file__).resolve().parents[2] / "csrc"
FWD = (CSRC / "flash_attention.cu").read_text()
BWD = (CSRC / "flash_attention_bwd.cu").read_text()


def _constexpr(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_query_tile_is_the_sources_and_the_chunk_granularity():
    """The forward's query tile is 64 rows in both dtypes (the first fp32
    body's was 16): chunks at multiples of it keep the whole prefill's
    bits, as the wrapper's docstring states."""
    from repro_torch.kernels.flash_attention import ops

    assert _constexpr(FWD, "kMmaRows") == k3.MMA_ROWS == 64
    assert _constexpr(FWD, "kF32Threads") == 256   # 4 pairs of warps
    assert "kQTile" not in FWD and "flash_f32" not in FWD
    assert "multiple of 64 (the query" in ops.flash_attention_bshd.__doc__


def test_f32_backward_rows_and_step_are_the_sources():
    m = re.search(r"constexpr int f32_rows\(\) \{\s*return DQK >= (\d+) \? "
                  r"(\d+) : (\d+);", BWD)
    assert m, "f32_rows not found in flash_attention_bwd.cu"
    at, wide, narrow = map(int, m.groups())
    for dqk, _ in k3.F32_DIMS:
        assert k3.f32_rows(dqk) == (wide if dqk >= at else narrow)
    assert _constexpr(BWD, "kF32Step") == 32


def _dispatched(src: str, pattern: str) -> set:
    return {(int(a), int(b)) for a, b in re.findall(pattern, src)}


def test_sources_dispatch_exactly_the_builds():
    entry = FWD[FWD.index("int launch_dims("):]
    both = _dispatched(entry[:entry.index("if constexpr")],
                       r"Dqk == (\d+) && Dv == (\d+)\)")
    f32_only = _dispatched(entry[entry.index("if constexpr"):],
                           r"Dqk == (\d+) && Dv == (\d+)\)")
    assert both == set(k3.DIMS)
    assert both | f32_only == set(k3.F32_DIMS)
    bwd = BWD[BWD.index('extern "C" int flash_attention_bwd('):]
    assert _dispatched(bwd, r"launch_bf16<(\d+), (\d+)>") == set(k3.DIMS)
    assert _dispatched(bwd, r"launch_f32<(\d+), (\d+)>") == set(k3.F32_DIMS)


# (dims, key tile, bytes): q's 64 rows and two K and two V tiles in fp32,
# rows padded by 4 floats, then 4 pairs' P (16 rows of kn + 8) and 8
# warps' 16 row maxima, worked by hand
F32_SMEM = [((256, 256), 32, 210_432), ((192, 128), 64, 237_056),
            ((192, 128), 32, 144_896), ((128, 128), 64, 187_904),
            ((128, 128), 32, 112_128), ((80, 80), 64, 126_464),
            ((64, 64), 64, 105_984), ((48, 32), 64, 77_312),
            ((256, 256), 64, 351_744)]


@pytest.mark.parametrize("dims,kn,nbytes", F32_SMEM)
def test_f32_ring_bytes_and_key_tile(dims, kn, nbytes):
    """Each fp32 build's one key tile is the widest whose ring fits, at
    most 64 (the keep mask holds one bit a score of a thread): 32 at (256,
    256) and (192, 128), 64 elsewhere, as the .cu's ``launch_build``
    picks it."""
    assert k3.mma_smem_bytes(*dims, kn, torch.float32) == nbytes
    fits = nbytes <= k3.MAX_SMEM
    assert (k3.F32_KEY_TILE[dims] == kn) == (fits and (kn == 64 or dims in (
        (256, 256), (192, 128))))
    assert "constexpr int kn = mma_fits<T, DQK, DV, 64>() ? 64 : 32;" in FWD


# (B, S, Hq, dqk, dv, fp32 split, bf16 split)
SPLITS = [
    (1, 512, 4, 256, 256, 2, 2),     # gemma3-1b's fp32 check: 64 blocks
    (1, 1024, 4, 256, 256, 2, 2),    # 128 blocks of 32 keys (fp32)
    (1, 2048, 4, 256, 256, 1, 2),    # 256 blocks (fp32); 128 (bf16)
    (1, 4096, 4, 256, 256, 1, 1),
    (1, 512, 4, 64, 64, 2, 2),       # 32 blocks of 64
    (1, 512, 32, 64, 64, 1, 1),      # zamba2's 32 heads: 256 blocks
    (1, 200, 4, 80, 80, 2, 1),       # bf16 (80, 80) has no split
    (2, 1000, 16, 192, 128, 1, 1),
    (1, 300, 16, 48, 32, 2, 1),      # 80 blocks; no bf16 build
    (4, 1024, 4, 128, 128, 1, 1),    # 256 blocks: the card fills
]


@pytest.mark.parametrize("B,S,Hq,dqk,dv,f32,b16", SPLITS)
def test_bwd_split_rule(B, S, Hq, dqk, dv, f32, b16):
    assert k3.bwd_split(B, S, Hq, dqk, dv, torch.float32) == f32
    assert k3.bwd_split(B, S, Hq, dqk, dv, torch.bfloat16) == b16
    rows = k3.f32_rows(dqk)
    assert (f32 == 2) == (B * Hq * -(-S // rows) < k3.SMS)


# (B, S, Hq, Hkv, dqk, dv, dtype, floats of `part` or None)
SCRATCH = [
    # G = 4, split 2, dQ's shares too (fp32 at every build)
    (1, 512, 4, 1, 256, 256, torch.float32, 512 * 4 * 2 * (256 * 3)),
    # bf16 (256, 256): its dQ runs on mma.sync, without shares
    (1, 512, 4, 1, 256, 256, torch.bfloat16, 512 * 4 * 2 * 512),
    # G = 1 and no split: no partials in either dtype
    (1, 512, 32, 32, 64, 64, torch.float32, None),
    (1, 512, 32, 32, 64, 64, torch.bfloat16, None),
    # G = 1, split 2 in fp32 only: (80, 80) has no bf16 split
    (1, 200, 4, 4, 80, 80, torch.float32, 200 * 4 * 2 * 240),
    (1, 200, 4, 4, 80, 80, torch.bfloat16, None),
    # G = 3, no split
    (2, 2000, 6, 2, 128, 128, torch.float32, 2 * 2000 * 6 * 256),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,dqk,dv,dtype,floats", SCRATCH)
def test_bwd_scratch(B, S, Hq, Hkv, dqk, dv, dtype, floats):
    delta, part = k3.bwd_scratch(B, S, Hq, Hkv, dqk, dv, dtype, "meta")
    assert delta.shape == (B, Hq, S) and delta.dtype == torch.float32
    if floats is None:
        assert part is None
    else:
        assert part.shape == (floats,) and part.dtype == torch.float32


def test_no_separate_delta_launch_in_fp32():
    """fp32's dQ kernel writes delta, as bf16's does: the first version's
    delta kernel is gone."""
    assert "flash_bwd_delta_kernel" not in BWD
    assert "p.delta[row0 + r] = x" in BWD[BWD.index(
        "flash_bwd_q_f32_kernel(Args p)"):]
