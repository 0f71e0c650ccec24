"""The tree-verify kernel's fp32 build (K1 paged, K4 windowed, K2 dense;
3xTF32 on the tensor cores): the host-side rules the wrapper module keeps
for the CUDA source, on the CPU.

``kernels/tree_attention/kernel.py`` mirrors constants of
``csrc/tree_attention_paged.cu``: the rows a split block holds and its
four 16-row slices, the fp32 build's warps a slice and threads a block,
its keys a tile at each head dim and the shared memory a block takes.
Each is held here against the source's own text or against numbers
worked by hand, so that a change on one side shows; so are the builds
the entry points dispatch (D in {64, 128, 256} x paged / windowed /
dense x fp32 / bf16), the first fp32 body's removal (``split_f32`` on the
CUDA cores and ``online_softmax.cuh``), the wrappers' fp32 launch
counters, and the plain versions' fp64 mode (the reference
``chip_smoke.py`` reports the fp32 kernel's difference from).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.tree_attention import kernel as tk  # noqa: E402

CSRC = Path(tk.__file__).resolve().parents[2] / "csrc"
SRC = (CSRC / "tree_attention_paged.cu").read_text()
TF32 = (CSRC / "tf32_mma.cuh").read_text()


def _constexpr(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_blocks_are_the_sources():
    """64 rows a block in four 16-row slices; bf16 a warp a slice (128
    threads), fp32 ``F32_SLICE_WARPS`` warps a slice sharing each key
    tile (``tf::Slice``, whose block holds the same four slices)."""
    assert _constexpr(SRC, "kGroupRows") == tk.GROUP_ROWS == 64
    assert _constexpr(SRC, "kMmaThreads") == tk.BF16_THREADS == 128
    assert _constexpr(SRC, "kF32SliceWarps") == tk.F32_SLICE_WARPS
    assert "constexpr int kSlices = kGroupRows / tc::kWarpRows;" in SRC
    assert tk.SLICES == tk.GROUP_ROWS // 16 == 4
    assert "static constexpr int kSlices = 4;" in TF32
    assert ("constexpr int kF32Threads = kSlices * kF32SliceWarps * 32;"
            in SRC)
    assert tk.F32_THREADS == tk.SLICES * tk.F32_SLICE_WARPS * 32 <= 1024
    assert _constexpr(TF32, "kPad") == tk.F32_PAD
    assert _constexpr(TF32, "kPadP") == tk.F32_PAD_P
    assert "constexpr size_t kMaxSmem = 227 * 1024;" in SRC
    assert tk.MAX_SMEM == 227 * 1024


@pytest.mark.parametrize("D", tk.HEAD_DIMS)
def test_f32_keys_a_tile(D):
    """64 keys a tile, 32 at D = 256; each warp of a slice takes whole
    8-key steps of the scores and whole 8-column tiles of P V."""
    m = re.search(r"constexpr int f32_keys\(\) \{\s*return D >= (\d+) \? "
                  r"(\d+) : (\d+);", SRC)
    assert m, "f32_keys not found in tree_attention_paged.cu"
    at, wide, narrow = map(int, m.groups())
    assert tk.f32_keys(D) == (wide if D >= at else narrow)
    assert tk.f32_keys(D) == (32 if D == 256 else 64)
    assert tk.f32_keys(D) % (8 * tk.F32_SLICE_WARPS) == 0
    assert D // tk.F32_SLICE_WARPS % 8 == 0


# (D, bytes): q's 64 rows and two K and two V tiles of f32_keys(D) keys at
# a row stride of D + 4 floats, each slice's P (16 rows of keys + 8
# floats), 8 warps' 16 row values, then 2 tiles of key flags and 64 row
# positions (int), worked by hand
F32_SMEM = [(64, 4 * ((64 + 256) * 68 + 64 * 72 + 128) + 4 * 192),
            (128, 4 * ((64 + 256) * 132 + 64 * 72 + 128) + 4 * 192),
            (256, 4 * ((64 + 128) * 260 + 64 * 40 + 128) + 4 * 128)]


@pytest.mark.parametrize("D,nbytes", F32_SMEM)
def test_f32_smem_bytes(D, nbytes):
    """The bytes a block takes fit the 227 KB a block may opt into, and
    are the ones the source's header states."""
    assert tk.F32_SLICE_WARPS == 2, "the hand-worked bytes count 8 warps"
    assert tk.f32_smem_bytes(D) == nbytes <= tk.MAX_SMEM
    assert f"{nbytes:,}" in SRC


def test_a_64_key_ring_would_not_fit_at_256():
    """Why D = 256 takes 32 keys a tile: a 64-key ring there needs 344 KB."""
    floats = (64 + 4 * 64) * 260 + 64 * 72 + 128
    assert 4 * floats + 4 * (2 * 64 + 64) > tk.MAX_SMEM


def test_sources_dispatch_exactly_the_builds():
    """Each entry point dispatches fp32 (code 0) and bf16 (code 1) at each
    of ``HEAD_DIMS``: K1 paged, K4 windowed, K2 dense, 18 split
    instantiations; fp32 runs the 3xTF32 body, bf16 the mma.sync body."""
    dims = {int(d) for d in re.findall(
        r"case (\d+): return launch<T, \1, kWindowed, kDense>", SRC)}
    assert dims == set(tk.HEAD_DIMS) == {64, 128, 256}
    types = re.findall(r"case (\d): return launch_dim<(\w+), kWindowed, "
                       r"kDense>", SRC)
    assert types == [("0", "float"), ("1", "__nv_bfloat16")]
    assert tk.DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1}
    entries = re.findall(r'extern "C" int (\w+)\(.*?return dispatch<(\w+), '
                         r'(\w+)>', SRC, re.S)
    assert entries == [("tree_attention_paged", "false", "false"),
                       ("tree_attention_paged_windowed", "true", "false"),
                       ("tree_attention_dense", "false", "true")]
    assert "split_tf32<D, kWindowed, kDense>(p, smem_raw);" in SRC
    assert "split_mma<D, kWindowed, kDense>(p, smem_raw);" in SRC
    assert "kF32 ? kF32Threads : kMmaThreads" in SRC
    assert "kF32 ? f32_smem_bytes<D>() : mma_smem_bytes<D>()" in SRC


def test_the_first_fp32_body_is_gone():
    """No CUDA-core fp32 body is left to fall back to: both products run
    in 3xTF32 through ``tf32_mma.cuh``."""
    assert "split_f32" not in SRC
    assert "online_softmax" not in SRC
    assert not (CSRC / "online_softmax.cuh").exists()
    assert '#include "tf32_mma.cuh"' in SRC
    body = SRC[SRC.index("__device__ void split_tf32("):]
    body = body[:body.index("\n}\n")]
    assert body.count("tf::tile_slice<D, D, KN, NK>(") == 1   # one call site
    assert "cp_async16" in body and "key_row(" in body


def test_k3_pairs_are_slices_of_two():
    """K3's fp32 forward keeps its pairs of warps: two-warp slices of the
    tile the tree-verify build shares (``tf::tile_slice``)."""
    k3 = (CSRC / "flash_attention.cu").read_text()
    assert "const tf::Slice<2> pr{" in k3
    assert "tf::tile_slice<DQK, DV, KN, 2>(" in k3
    assert "tile_pair" not in TF32 + k3 and "Pair" not in TF32


def test_f32_counters_outlive_reset_counts():
    """Each tree-verify wrapper counts its fp32 calls in ``f32_launches``,
    which ``kernels.reset_counts`` leaves alone (as K3's)."""
    from repro_torch import kernels
    from repro_torch.kernels.attention_template import ops as k4
    from repro_torch.kernels.tree_attention import dense_ops, ops

    mods = (ops, k4, dense_ops)
    saved = [m.f32_launches for m in mods]
    try:
        for m in mods:
            m.f32_launches = 7
        kernels.reset_counts()
        assert [m.f32_launches for m in mods] == [7, 7, 7]
        assert all(m.launches == 0 for m in mods)
    finally:
        for m, n in zip(mods, saved):
            m.f32_launches = n


def _operands(seed, lens, T, Hq, Hkv, D, bs=16):
    rs = np.random.default_rng(seed)
    r = lambda *s: torch.from_numpy(rs.standard_normal(s, dtype=np.float32))
    B = len(lens)
    need = [-(-(n + T) // bs) for n in lens]
    M = max(need) + 1
    table = torch.zeros((B, M), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(need):
        table[b, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += n
    from repro_torch.core.trees import default_tree

    tree = default_tree(T, 2, 3)
    cache_len = torch.tensor(lens, dtype=torch.int32)
    q_pos = cache_len[:, None] + torch.as_tensor(tree.depth)[None]
    return (r(B, T, Hq, D), r(nxt, bs, Hkv, D), r(nxt, bs, Hkv, D),
            r(B, T, Hkv, D), r(B, T, Hkv, D),
            torch.as_tensor(tree.ancestor_mask), cache_len, table), q_pos


def _dense(args):
    q, pk, pv, tk_, tv, tm, lens, table = args
    B, M = table.shape
    view = lambda p: p[table.long()].reshape(B, M * p.shape[1],
                                             *p.shape[2:])
    return q, view(pk), view(pv), tk_, tv, tm, lens


def _as64(args):
    return tuple(a.double() if a.dtype == torch.float32 else a for a in args)


@pytest.mark.parametrize("form", ["K1", "K4", "K2"])
def test_plain_versions_compute_in_fp64_for_fp64_operands(form):
    """The plain versions keep fp64 operands in fp64 (an fp64 reference
    for the fp32 kernels on the card) and agree with their fp32 runs to
    fp32's rounding; fp32 operands are computed in fp32 as before."""
    from repro_torch.kernels.attention_template.ref import (
        tree_attention_paged_windowed_plain)

    args, q_pos = _operands(3, [0, 37, 100], 16, 4, 2, 64)
    run = {"K1": tk.tree_attention_paged_plain,
           "K4": lambda *a: tree_attention_paged_windowed_plain(*a, q_pos,
                                                                24),
           "K2": lambda *a: tk.tree_attention_dense_plain(*_dense(a))}[form]
    out32, out64 = run(*args), run(*_as64(args))
    assert out32.dtype == torch.float32 and out64.dtype == torch.float64
    assert torch.isfinite(out64).all()
    err = (out32.double() - out64).abs().max().item()
    assert 0 < err < 1e-5
