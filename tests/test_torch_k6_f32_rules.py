"""K6's fp32 builds (3xTF32 on the tensor cores): the host-side rules the
wrappers keep for the CUDA sources, and a model of the new bodies'
arithmetic, on the CPU.

``csrc/linear_attn_chunk.cu`` (the chunk-parallel pass and the scan) and
``csrc/linear_attn_chunk_bwd.cu`` (each chunk's increment of the state's
gradient, its carry, the gradient pass, du's sum) run every product in
3xTF32 on ``mma.sync.m16n8k8`` in fp32: each operand split into a TF32
high part (truncated: ``tf32_mma.cuh::split``) and the TF32 of its
residual, three products (lo hi, hi lo, hi hi), a sum over positions in
fresh accumulators every 16 and fp32 adds.  The rules: the builds each C
entry point dispatches (fp32 and bf16, chunks 16 and 64, as
``kernel.CHUNKS`` and ``DTYPE_CODES``), the fp32 kernels' shared memory
a block against the card's 227 KB and the blocks an SM each design
assumes (its ``__launch_bounds__``), the scratch each launch allocates,
and the builds ``chip_smoke.py`` checks for spills and tensor cores.

The model (``model_forward``, ``model_backward``) repeats the kernels'
decomposition with every product in 3xTF32 (truncation on int32 views)
and is held, the differences taken in fp64, against JAX's
``decay_attention_chunked`` and ``jax.vjp`` of it (which compute in
fp32) and against the token recurrence and its autograd in fp64: max |o
- ref| / max |ref| within 1e-4 for the output and the final state,
relative L2 within 1e-4 for each gradient (K6's fp32 tolerances on the
card), with strong decay (log-decay down to -20 a step) and S not a
chunk multiple.  One TF32 pass alone misses them.  ``Arith`` also gives
the forms ``scripts/k6_f32_error_sources.py`` compares the kernels' with
(a rounding split, a fourth product lo lo, the tensor cores' accumulation
approximated, no split); each keeps the same tolerances.
"""
import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.linear_attn_chunk import kernel as k6  # noqa: E402
from repro_torch.kernels.linear_attn_chunk import ref  # noqa: E402

try:
    import jax
    import jax.numpy as jnp

    from repro.models.ssm import decay_attention_chunked as jax_chunked
except ImportError:                       # the card's machine has no JAX
    jax = None

torch.set_num_threads(2)
needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX")

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "src" / "repro_torch" / "csrc"
FWD = (CSRC / "linear_attn_chunk.cu").read_text()
BWD = (CSRC / "linear_attn_chunk_bwd.cu").read_text()
TF = (CSRC / "tf32_mma.cuh").read_text()
SMEM_LIMIT = 227 * 1024          # a block's dynamic shared memory
SM_SMEM = 228 * 1024             # an SM's, 1 KB of it reserved a block
GRADS = ("r", "k", "v", "w_log", "u", "initial_state")


def _constexpr(src: str, name: str) -> str:
    return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)


def _blocks_an_sm(nbytes: int) -> int:
    return SM_SMEM // (nbytes + 1024)


# ---------------------------------------------------------------------------
# the sources' rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src", [FWD, BWD], ids=["forward", "backward"])
def test_entry_points_dispatch_both_dtypes_and_chunks(src):
    entry = src[src.index('extern "C" int'):]
    assert re.findall(r"case (\d+): return launch_chunk<(\w+)>", entry) == [
        ("0", "float"), ("1", "bf16")]
    assert {torch.float32: 0, torch.bfloat16: 1} == k6.DTYPE_CODES
    chunks = re.findall(r"case (\d+): return launch<T, (\d+)>", src)
    assert [int(a) for a, b in chunks] == [int(b) for a, b in chunks]
    assert tuple(int(a) for a, _ in chunks) == k6.CHUNKS == (16, 64)


def test_sources_constants():
    assert _constexpr(FWD, "kD") == _constexpr(BWD, "kD") == "64"
    assert int(_constexpr(FWD, "kD")) == k6.HEAD_DIM
    assert _constexpr(FWD, "kP").startswith("kD + 4")
    assert _constexpr(BWD, "kQ").startswith("kD + 4")
    assert _constexpr(TF, "kPadP").startswith("8")
    assert _constexpr(FWD, "kThreads").startswith("512")
    assert _constexpr(BWD, "kTC").startswith("256")


def _fwd_f32_bytes(C: int) -> int:
    """(a)'s shared memory in fp32 (``Chunk<float, C>``): r, k, v, lcw,
    lcw_excl at stride 68, A at stride C + 8, the diagonal, u."""
    return 4 * (5 * C * 68 + C * (C + 8) + C + 64)


def _bwd_f32_bytes(C: int) -> int:
    """(c) fp32's (``GradF32<C>``): seven C x 68 tiles, S_in/dS_out (64 x
    68), four vectors of 64, two column sums a row tile."""
    return 4 * (7 * C * 68 + 64 * 68 + 4 * 64 + 2 * (C // 16) * 64)


def test_layouts_are_the_sources():
    assert ("static constexpr int CP = kBF ? C + 1 : C + tf::kPadP;"
            in FWD)
    assert ("static constexpr size_t floats = 5 * static_cast<size_t>(C) "
            "* kP +\n                                   static_cast<size_t>"
            "(C) * CP + C + kD;" in FWD)
    grad = BWD[BWD.index("struct GradF32 {"):]
    grad = grad[:grad.index("};")]
    assert "static constexpr int W = C == 64 ? 16 : 8;" in grad
    assert re.sub(r"\s+", " ", grad[grad.index("bytes ="):]).startswith(
        "bytes = sizeof(float) * (7 * static_cast<size_t>(C) * kQ + "
        "static_cast<size_t>(kD) * kQ + 4 * kD + 2 * "
        "static_cast<size_t>(RT) * kD);")
    assert ("return sizeof(float) * 3 * static_cast<size_t>(C) * kQ;"
            in BWD[BWD.index("inc_f32_smem_bytes()"):])


# (kernel, C, bytes worked by hand, blocks an SM the design assumes)
F32_SMEM = [("chunk", 16, 23_616, 2), ("chunk", 64, 105_984, 2),
            ("bwd_chunk", 16, 49_408, 1), ("bwd_chunk", 64, 142_336, 1),
            ("bwd_inc", 16, 13_056, None), ("bwd_inc", 64, 52_224, None)]


@pytest.mark.parametrize("kind,C,nbytes,blocks", F32_SMEM)
def test_f32_shared_memory_fits_the_design(kind, C, nbytes, blocks):
    """Each fp32 kernel's shared memory a block fits the 227 KB, and as
    many blocks fit an SM as its ``__launch_bounds__`` promises: two of
    the forward's (as bf16's, so its 16 warps run at 64 registers), one of
    the gradient pass at C = 64, whose 142 KB take 16 warps a block (four
    to a row tile) instead of bf16's two blocks of 8."""
    got = {"chunk": _fwd_f32_bytes, "bwd_chunk": _bwd_f32_bytes,
           "bwd_inc": lambda c: 4 * 3 * c * 68}[kind](C)
    assert got == nbytes <= SMEM_LIMIT
    if blocks is None:
        return
    assert _blocks_an_sm(nbytes) >= blocks
    if kind == "chunk":
        assert "__launch_bounds__(kThreads, 2)\n    linear_attn_chunk_kernel" \
            in FWD
        assert C < 64 or _blocks_an_sm(nbytes) == 2
    else:
        assert ("__launch_bounds__(GradF32<C>::W * 32, 1)\n"
                "    linear_attn_bwd_chunk_f32_kernel" in BWD)
        if C == 64:
            assert _blocks_an_sm(nbytes) == 1


def test_launches_pick_the_f32_kernels():
    launch = BWD[BWD.index("int launch(const Args& a"):]
    launch = launch[:launch.index("\n}\n")]
    flat = re.sub(r"\s+", " ", launch)
    assert ("kBF ? linear_attn_bwd_inc_kernel<C> : "
            "linear_attn_bwd_inc_f32_kernel<C>") in flat
    assert ("kBF ? linear_attn_bwd_chunk_tc_kernel<C> : "
            "linear_attn_bwd_chunk_f32_kernel<C>") in flat
    assert "linear_attn_bwd_carry_kernel<<<" in launch     # both dtypes
    assert "kBF ? kTC : GradF32<C>::W * 32" in flat
    # no fp32 body on the CUDA cores is left beside them
    for gone in ("linear_attn_bwd_scan_kernel", "struct Grad {",
                 "linear_attn_bwd_chunk_kernel"):
        assert gone not in BWD
    # every fp32 body takes its products through tf32_mma.cuh
    for src, name, n in ((BWD, "linear_attn_bwd_inc_f32_kernel(Args", 1),
                         (BWD, "linear_attn_bwd_chunk_f32_kernel(Args", 4)):
        body = src[src.index(name):]
        body = body[:body.index("\n}\n")]
        assert body.count("tf::mma3(") + body.count("dot64(") >= n


@pytest.mark.parametrize("B,S,H,chunk", [(1, 1536, 32, 64), (2, 100, 4, 16),
                                         (1, 37, 2, 64)])
def test_scratch_is_unchanged(B, S, H, chunk):
    """The fp32 launches take the bf16 launches' scratch: the forward's
    q_eff, o_intra, the increment and the decay; the backward's dS_out,
    the decay (the increment kernel writes it in both dtypes now) and
    du's partials with u."""
    nc = -(-S // chunk)
    q, o, ds, dc = k6.scratch(B, S, H, chunk, "meta")
    assert [t.shape for t in (q, o, ds, dc)] == [
        (B, H, nc, chunk, 64), (B, H, nc, chunk, 64), (B, H, nc, 64, 64),
        (B, H, nc, 64)]
    for with_u in (True, False):
        so, dec, part = k6.bwd_scratch(B, S, H, chunk, "meta", with_u)
        assert so.shape == (B, H, nc, 64, 64) and dec.shape == (B, H, nc,
                                                                 64)
        assert (part is None) != with_u
        assert all(t.dtype == torch.float32 for t in (q, o, ds, dc, so, dec))
    inc = BWD[BWD.index("linear_attn_bwd_inc_f32_kernel(Args"):]
    assert "p.decay[bhc * kD + tid] = expf(acc);" in inc[:inc.index("\n}\n")]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_rules",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # its dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_checks_every_new_instance():
    """The spill and tensor-core checks name each fp32 instance: the
    forward's two kernels and the backward's increment and gradient pass
    at both chunks, as ``ptxas_lines`` prints them."""
    cs = _chip_smoke()
    want = {f"linear_attn_{k}_kernel<f32, C={c}>" for k in ("chunk", "scan")
            for c in k6.CHUNKS}
    assert want <= cs.K6_BUILDS
    bwd = {f"linear_attn_bwd_{k}_kernel<C={c}>" for k in ("inc_f32",
                                                          "chunk_f32")
           for c in k6.CHUNKS}
    assert bwd <= cs.bwd_builds()
    for name in ("linear_attn_bwd_inc_f32_kernel",
                 "linear_attn_bwd_chunk_f32_kernel"):
        assert cs.KERNEL_PARAMS[name] == ("C",)
        assert f"{name}(Args p)" in BWD
        assert any(p.startswith(name) for p in cs.TENSOR_CORE_KERNELS)
    assert {"linear_attn_chunk_kernel<f32", "linear_attn_scan_kernel<f32"} \
        <= set(cs.TENSOR_CORE_KERNELS)
    # a mangled instance's name reads as the lists write it
    sym = ("_ZN12_GLOBAL__N_132linear_attn_bwd_chunk_f32_kernelILi64EEEv"
           "NS_4ArgsE")
    assert cs.kernel_name(sym) == "linear_attn_bwd_chunk_f32_kernel<C=64>"
    sym = "_ZN12_GLOBAL__N_123linear_attn_scan_kernelIfLi16EEEvNS_4ArgsE"
    assert cs.kernel_name(sym) == "linear_attn_scan_kernel<f32, C=16>"


# ---------------------------------------------------------------------------
# the model of the fp32 bodies' arithmetic
# ---------------------------------------------------------------------------


def tf32(x):
    """x truncated toward zero to TF32 (its low 13 mantissa bits cleared
    on an int32 view), as ``tf32_mma.cuh::tf32``."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def tf32_rna(x):
    """x rounded to the nearest TF32, ties away from zero, as
    ``cvt.rna.tf32.f32`` would (the split the kernels do not use)."""
    i = x.contiguous().view(torch.int32)
    sign = i & torch.tensor(-2 ** 31, dtype=torch.int32)
    return ((((i & 0x7FFFFFFF) + 4096) & -8192) | sign).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Arith:
    """How the model does a product.  ``passes``: 1, hi hi alone; 3, lo
    hi + hi lo + hi hi (the kernels); 4, lo lo too.  ``rounding``: the
    split's, "rz" (truncation, the kernels') or "rna"; "none", no split
    (each product an fp32 matmul).  ``accumulate``:
    "ieee", each 16-wide product an fp32 matmul; "rz", each mma.sync's k
    = 8 step summed exactly and rounded toward zero into its fp32
    accumulator, the small products and hi hi in chains of their own
    added at the end (an approximation of the tensor cores, which add
    without IEEE rounding)."""
    passes: int = 3
    rounding: str = "rz"
    accumulate: str = "ieee"


KERNEL = Arith()


def split(x, rounding="rz"):
    """``tf32_mma.cuh::split``: hi, and the TF32 of the residual."""
    cut = tf32 if rounding == "rz" else tf32_rna
    hi = cut(x)
    return hi, cut(x - hi)


def _toward_zero(x):
    """fp64 -> fp32 rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _chain(c, a, b):
    """c + a b over a k of 8 summed exactly, rounded toward zero."""
    return _toward_zero(c.double() + a.double() @ b.double())


def mm3(a, b, ar=KERNEL):
    """a @ b as ``ar`` does it; by default in 3xTF32 as the kernels: lo hi
    + hi lo (the small products) and hi hi, each product of TF32 values
    exact in fp32's sum."""
    if ar.rounding == "none":
        return a @ b
    ah, al = split(a, ar.rounding)
    bh, bl = split(b, ar.rounding)
    if ar.passes == 1:
        return ah @ bh
    if ar.accumulate == "ieee":
        small = al @ bh + ah @ bl
        return ah @ bh + (small + al @ bl if ar.passes == 4 else small)
    shape = (*torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]),
             a.shape[-2], b.shape[-1])
    small = big = torch.zeros(shape)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        small = _chain(small, al[..., ks], bh[..., ks, :])
        small = _chain(small, ah[..., ks], bl[..., ks, :])
        if ar.passes == 4:
            small = _chain(small, al[..., ks], bl[..., ks, :])
        big = _chain(big, ah[..., ks], bh[..., ks, :])
    return big + small


def mm3_pos(a, b, ar=KERNEL):
    """a @ b over a position axis: fresh accumulators every 16 positions,
    added in fp32, as the kernels sum across tiles."""
    out = 0.0
    for s0 in range(0, a.shape[-1], 16):
        out = out + mm3(a[..., s0:s0 + 16], b[..., s0:s0 + 16, :], ar)
    return out


def _chunks(t, chunk):
    """(B, S, H, d) -> fp32 (B, n, H, chunk, d), zero past S."""
    return ref._chunks(t, chunk).permute(0, 1, 3, 2, 4)


def _scores(rf, kf, L, E, ar):
    """A by sub-chunks of 16: diagonal blocks pairwise (CUDA cores), an
    off-diagonal block (t in i, s in j < i) in 3xTF32 over the channels
    through L at the end of sub-chunk j."""
    C = rf.shape[-2]
    A = torch.zeros((*rf.shape[:-1], C))
    tri = torch.ones((16, 16), dtype=torch.bool).tril(-1)
    for i in range(C // 16):
        si = slice(16 * i, 16 * i + 16)
        dlt = E[..., si, None, :] - L[..., None, si, :]
        a = (rf[..., si, None, :] * kf[..., None, si, :]
             * torch.exp(torch.clamp_max(dlt, 0.0))).sum(-1)
        A[..., si, si] = torch.where(tri, a, 0.0)
        for j in range(i):
            sj = slice(16 * j, 16 * j + 16)
            lr = L[..., 16 * j + 15:16 * j + 16, :]
            fr = rf[..., si, :] * torch.exp(torch.clamp_max(E[..., si, :]
                                                            - lr, 0.0))
            fk = kf[..., sj, :] * torch.exp(torch.clamp_max(
                lr - L[..., sj, :], 0.0))
            A[..., si, sj] = mm3(fr, fk.transpose(-1, -2), ar)
    return A


def model_forward(r, k, v, w, u, s0, chunk, ar=KERNEL):
    """The fp32 forward's arithmetic: (o, final state, states entering
    each chunk (B, H, n, 64, 64))."""
    B, S, H, d = k.shape
    rf, kf, vf, wf = (_chunks(t, chunk) for t in (r, k, v, w))
    L = torch.cumsum(wf, dim=-2)
    E = L - wf
    A = _scores(rf, kf, L, E, ar)
    o_intra = mm3_pos(A, vf, ar)
    if u is not None:
        o_intra = o_intra + (rf * u[:, None] * kf).sum(-1, keepdim=True) * vf
    q_eff = rf * torch.exp(E)
    last = L[..., -1:, :]
    k2 = kf * torch.exp(last - L)
    dS = mm3_pos(k2.transpose(-1, -2), vf, ar)
    decay = torch.exp(last[..., 0, :])[..., None]
    state = torch.zeros((B, H, d, d)) if s0 is None else s0.clone()
    outs, states = [], []
    for c in range(rf.shape[1]):
        states.append(state)
        outs.append(o_intra[:, c] + mm3(q_eff[:, c], state, ar))
        state = state * decay[:, c] + dS[:, c]
    o = torch.stack(outs, 1).permute(0, 1, 3, 2, 4).reshape(B, -1, H, d)
    return o[:, :S], state, torch.stack(states, 2)


def model_backward(r, k, v, w, u, states, do, d_state, chunk,
                   ar=KERNEL):
    """The fp32 backward's arithmetic: (dr, dk, dv, dw, du, d_s0)."""
    B, S, H, d = k.shape
    rf, kf, vf, wf, df = (_chunks(t, chunk) for t in (r, k, v, w, do))
    L = torch.cumsum(wf, dim=-2)
    E = L - wf
    last = L[..., -1:, :]
    T = lambda x: x.transpose(-1, -2)
    # (a) each chunk's increment, (b) its carry from the last chunk
    inc = mm3_pos(T(rf * torch.exp(E)), df, ar)
    decay = torch.exp(last[..., 0, :])[..., None]
    g = torch.zeros((B, H, d, d)) if d_state is None else d_state.clone()
    ds_out = [None] * rf.shape[1]
    for c in reversed(range(rf.shape[1])):
        ds_out[c] = g
        g = decay[:, c] * g + inc[:, c]
    ds_out = torch.stack(ds_out, 1)
    s_in = states.transpose(1, 2)
    # (c) the gradient pass
    A = _scores(rf, kf, L, E, ar)
    dr = mm3(df, T(s_in), ar) * torch.exp(E)
    k2 = kf * torch.exp(last - L)
    dv = mm3_pos(T(A), df, ar) + mm3(k2, ds_out, ar)
    dks = mm3(vf, T(ds_out), ar) * torch.exp(last - L)
    dA = torch.tril(mm3(df, T(vf), ar), -1)
    dk = dks.clone()
    tri = torch.ones((16, 16), dtype=torch.bool).tril(-1)[..., None]
    for i in range(chunk // 16):
        si = slice(16 * i, 16 * i + 16)
        fd = torch.where(tri, torch.exp(torch.clamp_max(
            E[..., si, None, :] - L[..., None, si, :], 0.0)), 0.0)
        da = dA[..., si, si, None] * fd
        dr[..., si, :] += (da * kf[..., None, si, :]).sum(-2)
        dk[..., si, :] += (da * rf[..., si, None, :]).sum(-3)
        for j in range(i):
            sj = slice(16 * j, 16 * j + 16)
            lr = L[..., 16 * j + 15:16 * j + 16, :]
            fk = kf[..., sj, :] * torch.exp(torch.clamp_max(
                lr - L[..., sj, :], 0.0))
            dr[..., si, :] += torch.exp(torch.clamp_max(
                E[..., si, :] - lr, 0.0)) * mm3(dA[..., si, sj], fk, ar)
    for j in range(chunk // 16 - 1):
        sj = slice(16 * j, 16 * j + 16)
        lr = L[..., 16 * j + 15:16 * j + 16, :]
        tmp = 0.0
        for i in range(j + 1, chunk // 16):
            si = slice(16 * i, 16 * i + 16)
            fr = rf[..., si, :] * torch.exp(torch.clamp_max(
                E[..., si, :] - lr, 0.0))
            tmp = tmp + mm3(T(dA[..., si, sj]), fr, ar)
        dk[..., sj, :] += torch.exp(torch.clamp_max(lr - L[..., sj, :],
                                                    0.0)) * tmp
    dov = (df * vf).sum(-1, keepdim=True)
    ge, gl = rf * dr, -kf * dk
    du = None
    if u is not None:
        uf = u[:, None]
        dv = dv + (rf * uf * kf).sum(-1, keepdim=True) * df
        dr = dr + uf * kf * dov
        dk = dk + uf * rf * dov
        du = (rf * kf * dov).sum(dim=(0, 1, 3))
    gl[..., -1, :] += (kf * dks).sum(-2) + decay[..., 0] * (
        ds_out * s_in).sum(-1)
    dw = (ge + gl).flip(-2).cumsum(-2).flip(-2) - ge
    back = lambda t: t.permute(0, 1, 3, 2, 4).reshape(B, -1, H, d)[:, :S]
    return back(dr), back(dk), back(dv), back(dw), du, g


# (S, chunk, use_u, use_s0, d_state, strong)
CASES = [(128, 64, True, True, True, False),
         (100, 64, True, False, True, False),
         (70, 16, False, True, False, False),
         (200, 64, True, True, True, True),
         (45, 16, True, True, True, True)]
IDS = [f"S{c[0]}-c{c[1]}{'-u' if c[2] else ''}{'-s0' if c[3] else ''}"
       f"{'-dS' if c[4] else ''}{'-strong' if c[5] else ''}" for c in CASES]


def _operands(S, chunk, use_u, use_s0, d_state, strong, B=2, H=2, d=64):
    rs = np.random.default_rng(S + chunk + 3 * strong)
    n = lambda *s: rs.standard_normal(s, dtype=np.float32)
    w = (-20.0 * rs.random((B, S, H, d), dtype=np.float32) if strong
         else -np.exp(n(B, S, H, d) * 0.5 - 1.0).astype(np.float32))
    x = {"r": n(B, S, H, d), "k": n(B, S, H, d), "v": n(B, S, H, d),
         "w_log": w, "u": n(H, d) * 0.1 if use_u else None,
         "initial_state": n(B, H, d, d) if use_s0 else None}
    return x, n(B, S, H, d), n(B, H, d, d) if d_state else None


def _jax(x, do, ds, chunk):
    """JAX's chunked function and its vjp (fp32): (o, final state, {name:
    gradient})."""
    given = [k for k in GRADS if x[k] is not None]
    fn = lambda *a: jax_chunked(
        *(dict(zip(given, a)).get(k) for k in GRADS), chunk=chunk)
    (o, st), vjp = jax.vjp(fn, *(jnp.asarray(x[k]) for k in given))
    cot = (jnp.asarray(do), jnp.zeros_like(st) if ds is None
           else jnp.asarray(ds))
    grads = dict(zip(given, (np.asarray(g) for g in vjp(cot))))
    return np.asarray(o), np.asarray(st), grads


def _fp64(x, do, ds):
    """The token recurrence in fp64 (S_t = diag(exp w_t) S_{t-1} + k_t
    v_t^T, o_t = r_t S_{t-1} + (r_t . u k_t) v_t) and its gradients by
    autograd: (o, final state, {name: gradient})."""
    t = {k: None if v is None else
         torch.from_numpy(v).double().requires_grad_() for k, v in x.items()}
    r, k, v, w, u, s0 = (t[n] for n in GRADS)
    B, S, H, d = k.shape
    state = torch.zeros((B, H, d, d), dtype=torch.float64) if s0 is None \
        else s0
    outs = []
    for i in range(S):
        o = torch.einsum("bhd,bhde->bhe", r[:, i], state)
        if u is not None:
            o = o + (r[:, i] * u * k[:, i]).sum(-1, keepdim=True) * v[:, i]
        outs.append(o)
        state = state * torch.exp(w[:, i])[..., None] + \
            k[:, i, :, :, None] * v[:, i, :, None, :]
    o = torch.stack(outs, 1)
    loss = (o * torch.from_numpy(do).double()).sum()
    if ds is not None:
        loss = loss + (state * torch.from_numpy(ds).double()).sum()
    given = [n for n in GRADS if t[n] is not None]
    grads = torch.autograd.grad(loss, [t[n] for n in given])
    return (o.detach().numpy(), state.detach().numpy(),
            {n: g.numpy() for n, g in zip(given, grads)})


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _model(x, do, ds, chunk, ar=KERNEL):
    t = {k: None if v is None else torch.from_numpy(v) for k, v in x.items()}
    o, st, states = model_forward(*(t[k] for k in GRADS), chunk, ar)
    grads = model_backward(t["r"], t["k"], t["v"], t["w_log"], t["u"],
                           states, torch.from_numpy(do),
                           None if ds is None else torch.from_numpy(ds),
                           chunk, ar)
    return o, st, dict(zip(GRADS, grads))


def test_truncation_is_the_sources():
    """``tf32`` clears the low 13 bits (toward zero), as the source's
    mask; hi + lo carries x to about 21 bits."""
    assert "return __float_as_uint(x) & 0xffffe000u;" in TF
    assert -8192 & 0xFFFFFFFF == 0xffffe000
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -10 + 2 ** -12), 3.0])
    assert tf32(x).tolist() == [1.0, -(1 + 2 ** -10), 3.0]
    y = torch.randn(10_000, generator=torch.Generator().manual_seed(0))
    hi, lo = split(y)
    assert torch.all((hi - y).abs() <= y.abs() * 2 ** -10)
    assert torch.all((hi + lo - y).abs() <= y.abs() * 2 ** -20)


def _hold(x, got, o, st, ref):
    """The model's results within K6's fp32 tolerances of ``ref``'s."""
    o_ref, st_ref, want = ref
    assert o.shape == o_ref.shape and np.isfinite(o.numpy()).all()
    assert _max_rel(o, o_ref) <= 1e-4 and _max_rel(st, st_ref) <= 1e-4
    for k in GRADS:
        if x[k] is None and k != "initial_state":
            assert got[k] is None, k
        elif k in want:
            assert _rel_l2(got[k], want[k]) <= 1e-4, k


@needs_jax
@pytest.mark.parametrize("S,chunk,use_u,use_s0,d_state,strong", CASES,
                         ids=IDS)
def test_model_matches_jax(S, chunk, use_u, use_s0, d_state, strong):
    x, do, ds = _operands(S, chunk, use_u, use_s0, d_state, strong)
    o, st, got = _model(x, do, ds, chunk)
    _hold(x, got, o, st, _jax(x, do, ds, chunk))


@pytest.mark.parametrize("S,chunk,use_u,use_s0,d_state,strong", CASES,
                         ids=IDS)
def test_model_matches_the_fp64_recurrence(S, chunk, use_u, use_s0,
                                           d_state, strong):
    x, do, ds = _operands(S, chunk, use_u, use_s0, d_state, strong)
    o, st, got = _model(x, do, ds, chunk)
    _hold(x, got, o, st, _fp64(x, do, ds))


def test_one_tf32_pass_misses_the_tolerance():
    """The same model with hi hi alone (one TF32 pass, ~3 decimal digits)
    falls outside the fp32 bounds the three passes keep."""
    x, do, ds = _operands(*CASES[0])
    o_ref, _, want = _fp64(x, do, ds)
    o, _, got = _model(x, do, ds, CASES[0][1], Arith(passes=1))
    worst = max([_max_rel(o, o_ref)] + [_rel_l2(got[k], want[k])
                                        for k in want])
    assert worst > 1e-4


def test_rounding_split():
    """``tf32_rna`` rounds to the nearest TF32, ties away from zero (the
    split the kernels do not take); hi + lo then carries x to about 22
    bits."""
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -12])
    assert tf32_rna(x).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0,
                                    1 + 2 ** -10]
    y = torch.randn(10_000, generator=torch.Generator().manual_seed(0))
    hi, lo = split(y, "rna")
    assert torch.all((hi - y).abs() <= y.abs() * 2 ** -11)
    assert torch.all((hi + lo - y).abs() <= y.abs() * 2 ** -22)


# the model's other arithmetics (scripts/k6_f32_error_sources.py)
VARIANTS = {"rna": Arith(rounding="rna"), "lo.lo": Arith(passes=4),
            "rz-acc": Arith(accumulate="rz"), "fp32": Arith(rounding="none")}


@pytest.mark.parametrize("name", VARIANTS)
def test_model_variants_match_the_fp64_recurrence(name):
    """Each form of the arithmetic, at strong decay, within K6's fp32
    tolerances of the fp64 recurrence."""
    chunk = CASES[3][1]
    x, do, ds = _operands(*CASES[3])
    o, st, got = _model(x, do, ds, chunk, VARIANTS[name])
    _hold(x, got, o, st, _fp64(x, do, ds))
