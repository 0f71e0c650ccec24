"""K5's fp32 build (3xTF32 on the tensor cores) and its windowed form: the
host-side rules the wrapper module keeps for the CUDA source, on the CPU.

``kernels/mla_attention/kernel.py`` mirrors constants of
``csrc/mla_attention_paged.cu``: the rows a split block holds, its warps,
the keys a tile, and the shared memory an fp32 block takes, with the
chunk permutations that keep its shared loads conflict-free.
Each is held here against the source's own text or against numbers worked
by hand, so that a change on one side shows; so are the builds the entry
points dispatch ((512, 64) and (64, 16) x fp32 / bf16 x windowed or not),
the first fp32 body's removal (``split_f32``, ``tile_update`` and
``load_keys`` on the CUDA cores), the wrapper's fp32 launch counter, the
windowed entry point's argument list, and the plain version's fp64 mode
(the reference ``chip_smoke.py`` reports the fp32 kernel's difference
from).
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mla_attention import kernel as mk  # noqa: E402

CSRC = Path(mk.__file__).resolve().parents[2] / "csrc"
SRC = (CSRC / "mla_attention_paged.cu").read_text()
TF32 = (CSRC / "tf32_mma.cuh").read_text()


def _constexpr(src: str, name: str, kind: str = "int") -> int:
    return int(re.search(rf"constexpr {kind} {name} = (\d+);", src).group(1))


def test_blocks_are_the_sources():
    """64 rows a block in four 16-row tiles by four quarters (16 warps,
    512 threads) and 16 keys a tile, in both bodies."""
    assert _constexpr(SRC, "kGroupRows") == mk.GROUP_ROWS == 64
    assert _constexpr(SRC, "kMmaThreads") == mk.THREADS == 512
    assert mk.THREADS // 32 == 16 == (mk.GROUP_ROWS // 16) * 4
    assert _constexpr(SRC, "kKeys") == mk.KEYS == 16
    assert "constexpr int KN = kKeys;" in SRC
    assert _constexpr(SRC, "kMaxSmem", "size_t") == mk.MAX_SMEM == 232448
    # one launch shape for both bodies: the grid's rows and the threads
    assert "(R + kGroupRows - 1) / kGroupRows, a.B)" in SRC
    assert "kMmaThreads, smem, stream>>>(a);" in SRC
    assert "__launch_bounds__(kMmaThreads)" in SRC


# (r, rd, bytes): q's 64 rows and two 16-key tiles of f32_row(r + rd)
# floats (576, or 96 for 80), one n8 block of 16 warps' 16 x 8 partial
# scores, then 3 tiles' key rows (int), worked by hand
F32_SMEM = [(512, 64, 4 * ((64 + 32) * 576 + 16 * 4 * 32) + 4 * 48),
            (64, 16, 4 * ((64 + 32) * 96 + 16 * 4 * 32) + 4 * 48)]


@pytest.mark.parametrize("r,rd,nbytes", F32_SMEM)
def test_f32_smem_bytes(r, rd, nbytes):
    """The bytes an fp32 block takes fit the 232,448 a block may opt into,
    and are the ones the source's header and static_assert state."""
    assert (r, rd) in mk.WIDTHS
    assert mk.f32_row(r + rd) % 32 == 0
    assert mk.f32_smem_bytes(r, rd) == nbytes <= mk.MAX_SMEM
    assert f"{nbytes:,}" in SRC
    assert f"f32_smem_bytes<{r}, {rd}>() == {nbytes}" in SRC


def test_padded_rows_would_not_fit():
    """Why the fp32 rows are unpadded and the exchange passes one n8 block
    at a time: with the 4-float padding of the other fp32 bodies, 64 q
    rows, a ring of two 16-key tiles and both blocks' partial scores
    take 239,104 bytes, past the opt-in limit; unpadded with both blocks
    still 237,760."""
    padded = 4 * ((64 + 32) * 580 + 16 * 8 * 32) + 4 * 32
    assert padded == 239104 + 128 and padded - 128 > mk.MAX_SMEM
    assert 4 * ((64 + 32) * 576 + 16 * 8 * 32) + 4 * 48 > mk.MAX_SMEM
    assert "148,480 + 74,240 +" in SRC and "16,384 = 239,104" in SRC


@pytest.mark.parametrize("r,rd", [(512, 64), (64, 16)])
def test_swizzles_are_conflict_free(r, rd):
    """The chunk permutations keep every shared load of the fp32 body on
    32 distinct banks: the 16-byte q and key loads of a quarter-warp
    (rows g, g + 1 of a pair, chunks 4c + t) and the word loads of V's
    rows 2t (or 2t + 1) at columns 8n + g.  Rows are a multiple of 32
    floats, so a row starts on bank 0."""
    def key_swz(kk):
        return (kk & 6) ^ ((kk & 1) << 2)

    def q_swz(row):
        return (row & 1) << 2

    assert "return (kk & 6) ^ ((kk & 1) << 2);" in SRC
    assert "return (r & 1) << 2;" in SRC
    rs = mk.f32_row(r + rd)
    for c in range((r + rd) // 16):
        for pair in range(4):                      # 8-lane phases
            for swz in (key_swz, q_swz):
                banks = []
                for g in (2 * pair, 2 * pair + 1):
                    for t in range(4):
                        ch = (4 * c + t) ^ swz(g)
                        assert ch < rs // 4
                        banks += [(g * rs + 4 * ch + i) % 32
                                  for i in range(4)]
                assert len(set(banks)) == 32
    for n in range(r // 8):
        for odd in (0, 1):
            banks = set()
            for t in range(4):
                kk = 2 * t + odd
                for g in range(8):
                    col = 8 * n + g
                    banks.add((kk * rs + 4 * ((col >> 2) ^ key_swz(kk))
                               + (col & 3)) % 32)
            assert len(banks) == 32


def test_quarters_take_the_contraction():
    """At (512, 64) each quarter sums 9 k16-chunks (18 k8-steps); at (64,
    16) the 5 chunks fall 2, 1, 1, 1 on the quarters, as the header
    says."""
    for (r, rd), want in (((512, 64), [9] * 4), ((64, 16), [2, 1, 1, 1])):
        kc = (r + rd) // 16
        assert [len(range(q, kc, 4)) for q in range(4)] == want
    assert "(10 k8-steps) fall 2, 1, 1, 1 on the quarters" in SRC
    assert "c, c + 4, ...: 9 of the 36 at (512, 64)" in SRC


def test_sources_dispatch_exactly_the_builds():
    """Two entry points (K5, windowed) x fp32 (code 0) and bf16 (code 1) x
    the two widths: eight split instantiations; fp32 runs the 3xTF32 body,
    bf16 the mma.sync one."""
    widths = re.findall(r"if \(r == (\d+) && rd == (\d+)\) return "
                        r"launch<TKV, \1, \2, kWindowed>", SRC)
    assert {(int(a), int(b)) for a, b in widths} == set(mk.WIDTHS)
    types = re.findall(r"case (\d): return launch_widths<(\w+), kWindowed>",
                       SRC)
    assert types == [("0", "float"), ("1", "__nv_bfloat16")]
    assert mk.KV_DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1}
    entries = re.findall(r'extern "C" int (\w+)\(.*?return dispatch<(\w+)>',
                         SRC, re.S)
    assert entries == [("mla_attention_paged", "false"),
                       ("mla_attention_paged_windowed", "true")]
    assert "split_tf32<DL, DR, kWindowed>(p, smem_raw);" in SRC
    assert "split_mma<DL, DR, kWindowed>(p, smem_raw);" in SRC
    assert ("kF32 ? f32_smem_bytes<DL, DR>() : mma_smem_bytes<DL, DR>()"
            in SRC)


def test_windowed_entry_point_arguments():
    """The windowed entry point takes q_pos after the block table and the
    window after M: 13 pointers, 11 ints, the scale and the stream, as
    ``kernel_fn(windowed=True)`` declares them."""
    m = re.search(r'extern "C" int mla_attention_paged_windowed\((.*?)\)',
                  SRC, re.S)
    params = [a.strip() for a in m.group(1).split(",")]
    kinds = ["ptr" if "*" in a else a.split()[0] for a in params]
    assert kinds == ["ptr"] * 13 + ["int"] * 11 + ["float", "ptr"]
    names = [a.split()[-1].lstrip("*") for a in params]
    assert names.index("q_pos") == 9 and names.index("window") == 20
    plain = re.search(r'extern "C" int mla_attention_paged\((.*?)\)',
                      SRC, re.S).group(1).split(",")
    assert len(plain) == 12 + 10 + 2


def test_the_first_fp32_body_is_gone():
    """No CUDA-core fp32 body is left: the fp32 build runs both products
    in 3xTF32 through ``tf32_mma.cuh``, and its tiles come in through
    cp.async."""
    for name in ("split_f32", "tile_update", "load_keys", "kF32Rows",
                 "kF32Threads", "row_stride", "kCols"):
        assert name not in SRC
    assert "tf::zero" in SRC
    assert '#include "tf32_mma.cuh"' in SRC
    assert "mla_attention_paged.cu" in TF32.split("#pragma once")[0]
    body = SRC[SRC.index("__device__ void split_tf32("):]
    body = body[:body.index("\n}\n")]
    assert "tf::mma3(sm[j], bg[j], fa, fb);" in body
    assert "tf::mma3(pv, pa[j], fb);" in body
    assert "cp_async16" in body and "key_swizzle(kk)" in body


def _chip_smoke():
    import importlib.util
    import sys

    path = Path(mk.__file__).resolve().parents[4] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_k5", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # its dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_checks_every_instance():
    """The spill check names every K5 instance (both dtypes and widths,
    windowed or not, and the merges) and the tensor-core check every
    split instance, as ``ptxas_lines`` prints a mangled symbol."""
    cs = _chip_smoke()
    want = {f"mla_attention_split_kernel<kv {dt}, DL={r}, DR={rd}{w}>"
            for dt in ("bf16", "f32") for r, rd in mk.WIDTHS
            for w in ("", ", windowed")}
    assert want | {f"mla_attention_merge_kernel<DL={r}>"
                   for r, _ in mk.WIDTHS} == set(cs.MLA_BUILDS)
    assert {"mla_attention_split_kernel<kv bf16",
            "mla_attention_split_kernel<kv f32"} <= set(cs.TENSOR_CORE_KERNELS)
    assert cs.KERNEL_PARAMS["mla_attention_split_kernel"] == (
        "kv", "DL", "DR", "windowed")
    sym = ("_ZN12_GLOBAL__N_126mla_attention_split_kernelIfLi512ELi64ELb1EEEv"
           "NS_4ArgsE")
    assert cs.kernel_name(sym) == \
        "mla_attention_split_kernel<kv f32, DL=512, DR=64, windowed>"
    sym = ("_ZN12_GLOBAL__N_126mla_attention_split_kernelI13__nv_bfloat16"
           "Li512ELi64ELb0EEEvNS_4ArgsE")
    assert cs.kernel_name(sym) == \
        "mla_attention_split_kernel<kv bf16, DL=512, DR=64>"
    assert cs.MLA_WINDOWS == (512, 1)


def test_chip_smoke_checks_the_reduced_build_at_its_shapes():
    """Phase 3e's second K5 case is the call phase 4's fp32 parity makes:
    reduced deepseek-v2-lite-16b's heads, widths, tree and scale."""
    import math

    from repro_torch.configs import get_config, tree_for

    cs = _chip_smoke()
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    c = cs.MLA_REDUCED_CASE
    assert cs.MLA_REDUCED_WIDTHS == (cfg.mla.kv_lora_rank,
                                     cfg.mla.qk_rope_dim)
    assert cs.MLA_REDUCED_WIDTHS in mk.WIDTHS
    assert (c.hq, c.hkv, c.d) == (cfg.n_heads, 1, sum(cs.MLA_REDUCED_WIDTHS))
    assert cs.MLA_REDUCED_T == tree_for(cfg).size == 8
    assert cs.MLA_REDUCED_SCALE == 1.0 / math.sqrt(cfg.mla.qk_nope_dim
                                                   + cfg.mla.qk_rope_dim)
    assert (c.lens, c.holes, c.m, c.bs) == (
        cs.MLA_CASE.lens, cs.MLA_CASE.holes, cs.MLA_CASE.m, cs.MLA_CASE.bs)


def test_f32_counter_outlives_reset_counts():
    """K5's wrapper counts its fp32 calls in ``f32_launches``, which
    ``kernels.reset_counts`` leaves alone (as the tree-verify wrappers')."""
    from repro_torch import kernels
    from repro_torch.kernels.mla_attention import ops

    saved = ops.f32_launches
    try:
        ops.f32_launches = 7
        kernels.reset_counts()
        assert ops.f32_launches == 7 and ops.launches == 0
    finally:
        ops.f32_launches = saved


def _operands(seed, lens, T=16, H=4, r=64, rd=16, bs=16):
    from repro_torch.core.trees import default_tree

    rs = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rs.standard_normal(s, dtype=np.float32))
    B = len(lens)
    need = [-(-(n + T) // bs) for n in lens]
    table = torch.zeros((B, max(need) + 1), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(need):
        table[b, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += n
    tree = default_tree(T, 4, 4)
    cache_len = torch.tensor(lens, dtype=torch.int32)
    q_pos = cache_len[:, None] + torch.as_tensor(tree.depth)[None]
    return (f(B, T, H, r), f(B, T, H, rd), f(nxt, bs, r), f(nxt, bs, rd),
            f(B, T, r), f(B, T, rd), torch.as_tensor(tree.ancestor_mask),
            cache_len, table), q_pos


@pytest.mark.parametrize("window", [None, 24])
def test_plain_version_computes_in_fp64_for_fp64_operands(window):
    """The plain version keeps fp64 operands in fp64 (an fp64 reference
    for the fp32 kernel on the card) and agrees with its fp32 run to
    fp32's rounding; fp32 operands are computed in fp32 as before."""
    from repro_torch.kernels.mla_attention.ref import (
        mla_attention_paged_plain)

    args, q_pos = _operands(3, [0, 37, 100])
    kw = dict(scale=1.0 / math.sqrt(48), q_pos=q_pos, window=window)
    out32 = mla_attention_paged_plain(*args, **kw)
    out64 = mla_attention_paged_plain(*(a.double() if a.dtype == torch.float32
                                        else a for a in args), **kw)
    assert out32.dtype == torch.float32 and out64.dtype == torch.float64
    assert torch.isfinite(out64).all()
    err = (out32.double() - out64).abs().max().item()
    assert 0 < err < 1e-5
