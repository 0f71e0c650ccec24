"""K3's bf16 body on wgmma with a TMA-fed K/V ring: the host-side rules
the wrapper keeps for the CUDA source, on the CPU.

``kernels/flash_attention/kernel.py`` mirrors constants of
``csrc/flash_attention.cu``'s bf16 body: the query tile (64 rows, one
consumer warpgroup; the granularity at which a chunk's rows equal the
whole prefill's bit for bit), the producer warp, the ring's stages, the
shared memory of each (build, key tile) and the blocks an SM each
instance is compiled for, and the register rule that keeps 128-key tiles
off the (256, 256) build.  Each is held here against the source's own
text or against numbers worked by hand.  The wrapper's TMA check
(``check_tma``) is a plain function of shape, strides and pointer.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as k3  # noqa: E402

CSRC = Path(k3.__file__).resolve().parents[2] / "csrc"
FWD = (CSRC / "flash_attention.cu").read_text()
WGMMA = (CSRC / "wgmma.cuh").read_text()
BODY = FWD[FWD.index("__device__ void flash_wgmma("):
           FWD.index("// fp32 body (3xTF32")]


def _constexpr(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", FWD).group(1))


def test_query_tile_is_a_warpgroup_and_the_chunk_granularity():
    """64 query rows a consumer warpgroup, each with its own key range, so
    a row's arithmetic is that of its 64-row tile whichever block holds
    it: a chunk at a multiple of 64 keeps the whole prefill's bits (C =
    256, the engine's chunk in phase 5b, is a multiple of it and of a
    two-warpgroup block's 128)."""
    from repro_torch.kernels.flash_attention import ops

    assert _constexpr("kMmaRows") == k3.MMA_ROWS == 64
    assert _constexpr("kMaxWarpgroups") == k3.MAX_WARPGROUPS == 2
    assert 256 % (k3.MMA_ROWS * k3.MAX_WARPGROUPS) == 0
    assert "const KeyRange kr = range_of(wgi);" in BODY
    assert "multiple of 64 (the query" in ops.flash_attention_bshd.__doc__


# (dv, key tile, warpgroups, threads): two warpgroups where O + S + P take
# at most 120 floats a thread, but at dv = 64
WARPGROUPS = [(64, 32, 1, 160), (64, 64, 1, 160), (64, 128, 1, 160),
              (80, 64, 2, 288), (80, 128, 1, 160), (128, 64, 2, 288),
              (128, 128, 1, 160), (256, 32, 1, 160), (256, 64, 1, 160)]


@pytest.mark.parametrize("dv,kn,wgs,threads", WARPGROUPS)
def test_warpgroups_and_threads(dv, kn, wgs, threads):
    assert k3.warpgroups(dv, kn) == wgs
    assert 128 * wgs + 32 == threads     # and the producer warp


def test_producer_warp_and_threads():
    assert _constexpr("kProducerWarps") == 1
    assert _constexpr("kTwoWgFloats") == k3.TWO_WG_FLOATS == 120
    assert ("return DV > 64 && acc_floats<DV, KN>() <= kTwoWgFloats ? "
            "kMaxWarpgroups") in FWD
    assert ("return 128 * warpgroups<DV, KN>() + 32 * kProducerWarps;"
            in FWD)
    assert "__launch_bounds__(wg_threads<DV, KN>(), 1)" in FWD
    # the producer is the warp past the consumers; one lane issues loads
    assert "if (warp >= 4 * WGS) {" in BODY
    assert "if (lane == 0 && n_u > 0) {" in BODY
    # each consumer warp gives every stage back: the empty barriers count
    # 4 a warpgroup
    assert "mbar_init(empty_k + 8 * i, 4 * WGS);" in BODY
    assert "mbar_init(empty_v + 8 * i, 4 * WGS);" in BODY
    assert "for (int u = 0; u < f; ++u) pass(u);" in BODY
    assert "for (int u = f + ntiles; u < n_u; ++u) pass(u);" in BODY


def test_ring_stages():
    assert _constexpr("kStages") == k3.STAGES == 2
    assert "const uint32_t round = (t / kStages - 1) & 1;" in BODY
    assert "if (t >= kStages) mbar_wait(empty_k + 8 * sg, round);" in BODY
    assert "if (t >= kStages) mbar_wait(empty_v + 8 * sg, round);" in BODY
    assert "mbar_wait(full_k + 8 * (u % kStages), (u / kStages) & 1);" \
        in BODY
    assert "mbar_wait(full_v + 8 * sg, ((f + t) / kStages) & 1);" in BODY


def test_both_products_on_wgmma_and_loads_through_tma():
    """S = Q K^T from shared memory, O += P V with A from registers; every
    K/V and q load a TMA copy completing on an mbarrier; no mma.sync
    tile and no cp.async in the bf16 body."""
    assert "wg::ss_t0<KN>(" in BODY and "wg::rs_t1<DV>(" in BODY
    assert BODY.count("tma_load(") == 3
    assert "mbarrier::complete_tx::bytes" in FWD
    assert "cp.async.bulk.tensor.4d" in FWD
    for old in ("tc::tile_mma", "load_rows", "cp_async", "ldsm"):
        assert old not in BODY, old
    assert "later work" not in FWD[:FWD.index("What is left (bf16)")]
    assert "wgmma (one\n// read of K/V per 64 rows)" not in FWD


def test_the_tensor_maps_are_encoded_without_libcuda():
    assert "cudaGetDriverEntryPoint" in FWD
    assert "cuTensorMapEncodeTiled" in FWD
    assert "__grid_constant__ CUtensorMap" in FWD
    assert "const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows)" \
        ", 1};" in FWD
    assert "encode_rows(&tq, a.q, a.B, a.Sq, a.Hq, DQK, kMmaRows)" in FWD
    assert "encode_rows(&tk, a.k, a.B, a.Skv, a.Hkv, DQK, KN)" in FWD
    assert "encode_rows(&tv, a.v, a.B, a.Skv, a.Hkv, DV, KN)" in FWD
    from repro_torch.kernels import build

    assert not any(f.startswith("-lcuda") for f in build.NVCC_FLAGS)


def test_wgmma_header_names_its_products():
    for n in (32, 64, 128):
        assert f"void ss_n{n}_t0(float (&d)[{n // 2}]" in WGMMA
        assert f"m64n{n}k16.f32.bf16.bf16" in WGMMA
    for n in (64, 80, 128, 192, 256):
        assert f"void rs_n{n}_t1(float (&d)[{n // 2}]" in WGMMA
        assert f"m64n{n}k16.f32.bf16.bf16" in WGMMA
    assert "ss_n{32,64,128}_t0" in WGMMA
    assert "rs_n{64,80,128,192,256}_t1" in WGMMA


# (dims, key tile, warpgroups, bytes): 1024 of slack + each warpgroup's 64
# rows of q x 128 bytes a 64-column block + 2 stages x KN rows x 128
# bytes x (q/k blocks + v blocks) + 4 mbarriers a stage and q's, 8 bytes
# each, worked by hand
SMEM = [((64, 64), 32, 1, 1024 + 8192 + 2 * 8192 + 72),
        ((64, 64), 64, 1, 1024 + 8192 + 2 * 16384 + 72),
        ((64, 64), 128, 1, 1024 + 8192 + 2 * 32768 + 72),
        ((80, 80), 64, 2, 1024 + 2 * 16384 + 2 * 32768 + 72),
        ((80, 80), 128, 1, 1024 + 16384 + 2 * 65536 + 72),
        ((128, 128), 32, 2, 1024 + 2 * 16384 + 2 * 16384 + 72),
        ((128, 128), 64, 2, 1024 + 2 * 16384 + 2 * 32768 + 72),
        ((128, 128), 128, 1, 1024 + 16384 + 2 * 65536 + 72),
        ((192, 128), 64, 2, 1024 + 2 * 24576 + 2 * 40960 + 72),
        ((192, 128), 128, 1, 1024 + 24576 + 2 * 81920 + 72),
        ((256, 256), 32, 1, 1024 + 32768 + 2 * 32768 + 72),
        ((256, 256), 64, 1, 1024 + 32768 + 2 * 65536 + 72)]


@pytest.mark.parametrize("dims,kn,wgs,nbytes", SMEM)
def test_smem(dims, kn, wgs, nbytes):
    assert k3.warpgroups(dims[1], kn) == wgs
    assert k3.mma_smem_bytes(*dims, kn) == nbytes <= 227 * 1024
    assert kn in k3.KEY_TILES[dims]
    assert "oK = oQ + warpgroups<DV, KN>() * kQBytes;" in FWD


def test_key_tiles_follow_the_accumulator_rule():
    """O, S and P in bf16 pairs take at most 176 floats a thread: (256,
    256) stops at 64 keys (128 + 64 + 32 at 128 would spill), every other
    build takes 32, 64 and 128; P V runs at N = DV, 80 included."""
    assert _constexpr("kAccFloats") == k3.ACC_FLOATS == 176
    assert "return DV / 2 + KN / 2 + KN / 4;" in FWD
    assert [k3.acc_floats(dv, n) for dv, n in ((256, 64), (256, 128),
                                               (80, 64), (64, 128))] \
        == [176, 224, 88, 128]
    assert k3.KEY_TILES == {(64, 64): (32, 64, 128), (80, 80): (32, 64, 128),
                            (128, 128): (32, 64, 128),
                            (256, 256): (32, 64),
                            (192, 128): (32, 64, 128)}
    assert not k3.tile_fits(256, 256, 128)
    assert "acc_floats<DV, KN>() <= kAccFloats;" in FWD
    assert "float o[DV / 2];" in BODY
    assert all(k3.DEFAULT_KEY_TILE[d] in k3.KEY_TILES[d] for d in k3.DIMS)


def test_the_products_overlap_the_softmax():
    """S_t and P_{t-1} V_{t-1} are issued together; the softmax of tile t
    runs after S_t alone is waited for; K and V stages are given back on
    barriers of their own."""
    loop = BODY[BODY.index("for (int t = 1; t < ntiles; ++t) {"):]
    order = [loop.index(x) for x in ("issue_s(t);", "issue_pv(t - 1);",
                                     "wg::wait<1>();",
                                     "softmax(t, corr, std::false_type{});",
                                     "wg::wait<0>();    // P_{t-1}",
                                     "pack();")]
    assert order == sorted(order)
    assert "give_k(u);" in loop and "give_v(u - 1);" in loop
    assert "mbar_arrive(empty_k + 8 * (u % kStages));" in BODY
    assert "mbar_arrive(empty_v + 8 * (u % kStages));" in BODY


def test_launch_build_takes_each_candidate():
    entry = FWD[FWD.index("int launch_build("):FWD.index("int launch_dims(")]
    cases = tuple(int(n) for n in re.findall(r"case (\d+):", entry))
    assert cases == k3.TILE_CANDIDATES


def _contig(shape):
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def test_tma_check_takes_the_builds():
    for dqk, dv in k3.DIMS:
        for shape in ((1, 300, 4, dqk), (2, 37, 1, dv)):
            k3.check_tma("q", shape, _contig(shape), 0x7f0000000000, 2)


@pytest.mark.parametrize("shape,strides,ptr,match", [
    ((1, 300, 4, 128), (300 * 4 * 128, 4 * 128, 128, 1), 0x1008,
     "16-byte boundary"),
    ((1, 300, 4, 128), (300 * 4 * 256, 4 * 256, 256, 1), 0x1000,
     "contiguous"),
    ((1, 300, 4, 128), (1, 4 * 128, 128, 300 * 4 * 128), 0x1000,
     "contiguous"),
    ((1, 300, 4, 12), (300 * 4 * 12, 4 * 12, 12, 1), 0x1000,
     "multiple of 16 bytes"),
])
def test_tma_check_raises(shape, strides, ptr, match):
    with pytest.raises(ValueError, match=match):
        k3.check_tma("k", shape, strides, ptr, 2)


def test_tma_check_ignores_strides_of_unit_dims():
    """A size-1 dimension's stride is free, as torch's is_contiguous has
    it (a (1, S, 1, D) kv head of gemma3)."""
    k3.check_tma("k", (1, 300, 1, 256), (7, 256, 3, 1), 0x2000, 2)


def test_the_wrapper_checks_a_bf16_view_on_meta():
    """The CUDA path's checks run on ``meta`` too: a bf16 operand sliced
    out of a wider tensor (not contiguous) is refused before any launch."""
    from repro_torch.kernels.flash_attention import ops

    q = torch.empty((1, 64, 4, 256), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 64, 1, 512), dtype=torch.bfloat16,
                    device="meta")[..., :256]
    with pytest.raises(ValueError, match="contiguous"):
        ops._check_cuda(q, k, k)
