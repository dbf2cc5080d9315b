"""Parity of the port's kernels with the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version, so these
tests hold the plain versions (and the ported ``ref.py`` oracles) to the JAX
oracles, to the JAX two-segment twin ``fused_score/ops.py::_fused_jnp`` and
to the Pallas kernels in interpret mode, at 2e-5 on f32 operands (the
``tests/test_fke.py`` TOL: reassociated scale and softmax math) and 2e-2 on
bf16 ones for K1/K2; K3 (fused_ffn) and K4 (flash_decode) at 1e-5 on f32
and 5e-3 on bf16, the port's numeric contract (ROADMAP.md).  The CUDA kernels themselves are compared with the plain versions
by the ``cuda``-marked tests, which skip without a GPU (and by
``chip_smoke.py`` on the GPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_fa_ops
from repro.kernels.flash_attention import ref as j_fa_ref
from repro.kernels.flash_decode import ops as j_fd_ops
from repro.kernels.flash_decode import ref as j_fd_ref
from repro.kernels.fused_ffn import ops as j_ff_ops
from repro.kernels.fused_ffn import ref as j_ff_ref
from repro.kernels.fused_score import ops as j_fs_ops
from repro.kernels.fused_score import ref as j_fs_ref
from repro.serving.kv_cache import quantize_leaf as j_quantize_leaf
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_decode import ops as fd
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.kernels.fused_ffn import ops as ff
from repro_torch.kernels.fused_ffn import ref as ff_ref
from repro_torch.kernels.rwkv6_scan import ops as scan
from repro_torch.kernels.fused_score import ops as fs
from repro_torch.kernels.fused_score import ref as fs_ref
from repro_torch.serving.kv_cache import quantize_leaf

torch.set_num_threads(1)
TOL = 2e-5
BF16_TOL = 2e-2
F32_TOL = 1e-5       # K3 / K4, f32
KBF16_TOL = 5e-3     # K3 / K4, bf16


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# K2 flash_attention
# ---------------------------------------------------------------------------

FA_CASES = [
    # b, h, hkv, sq, d, mode, kw
    (2, 4, 2, 40, 16, "causal", {}),
    (1, 2, 2, 33, 32, "full", {}),
    (1, 4, 1, 50, 16, "sliding", dict(window=7)),
    (2, 2, 2, 45, 16, "sumi", dict(n_history=30)),
    (1, 2, 1, 20, 32, "sumi", dict(n_history=20)),     # encode: == causal
]


@pytest.mark.parametrize("case", FA_CASES,
                         ids=[f"{c[5]}-{c[3]}" for c in FA_CASES])
def test_flash_attention_plain_vs_jax_oracle(case):
    b, h, hkv, sq, d, mode, kw = case
    r = np.random.default_rng(sq)
    q, k, v = (r.normal(size=(b, n, sq, d)).astype(np.float32)
               for n in (h, hkv, hkv))
    exp = jax.jit(lambda q, k, v: j_fa_ref.reference(q, k, v, mode, **kw))(
        q, k, v)
    got = fa.flash_attention_bhsd(_t(q), _t(k), _t(v), mode, **kw)
    _close(got, exp)
    _close(fa_ref.reference(_t(q), _t(k), _t(v), mode, **kw), exp)
    assert fa.flash_attention.launches == 0


@pytest.mark.parametrize("mode,n_history", [("causal", 0), ("sumi", 24)])
def test_flash_attention_plain_vs_pallas_interpret(mode, n_history):
    r = np.random.default_rng(3)
    q, k, v = (r.normal(size=(1, 2, 40, 16)).astype(np.float32)
               for _ in range(3))
    exp = j_fa_ops.flash_attention_bhsd(q, k, v, mode, n_history=n_history,
                                        bq=16, bk=16, interpret=True)
    got = fa.flash_attention_bhsd(_t(q), _t(k), _t(v), mode,
                                  n_history=n_history)
    _close(got, exp)


@pytest.mark.parametrize("mode,q_offset", [("sumi", 12), ("causal", 9)])
def test_flash_attention_q_offset_vs_jax(mode, q_offset):
    """q_offset (cached-history layouts) against the JAX reference
    attention with the same offset."""
    from repro.models import attention as JA
    r = np.random.default_rng(4)
    sq = 10
    q = r.normal(size=(2, sq, 2, 16)).astype(np.float32)
    k, v = (r.normal(size=(2, sq + q_offset, 2, 16)).astype(np.float32)
            for _ in range(2))
    nh = q_offset if mode == "sumi" else 0
    exp = jax.jit(lambda q, k, v: JA.reference_attention(
        q, k, v, mode, n_history=nh, q_offset=q_offset))(q, k, v)
    got = fa.flash_attention(_t(q), _t(k), _t(v), mode, n_history=nh,
                             q_offset=q_offset)
    _close(got, exp)
    with pytest.raises(NotImplementedError):
        fa.flash_attention(_t(q), _t(k), _t(v), "full", q_offset=3)


def test_flash_attention_bf16_plain_vs_jax():
    r = np.random.default_rng(5)
    q, k, v = (jnp.asarray(r.normal(size=(1, 2, 30, 16)), jnp.bfloat16)
               for _ in range(3))
    exp = j_fa_ref.reference(q, k, v, "causal")
    got = fa.flash_attention_bhsd(*(_t(np.asarray(x, np.float32)).to(
        torch.bfloat16) for x in (q, k, v)), "causal")
    assert got.dtype == torch.bfloat16
    _close(got, exp, BF16_TOL)


# ---------------------------------------------------------------------------
# K1 fused_score
# ---------------------------------------------------------------------------

FS_CASES = [
    # b, m, h, hkv, d, s, u, dedup, pool dtype
    (2, 16, 4, 2, 32, 64, None, False, "native"),
    (3, 12, 4, 2, 16, 37, 2, True, "native"),       # ragged + dedup idx
    (2, 8, 2, 2, 16, 100, None, False, "int8"),
    (3, 20, 4, 1, 16, 51, 2, True, "int8"),         # gqa + ragged + idx
    (2, 16, 2, 2, 16, 33, None, False, "bf16"),
    (1, 5, 2, 2, 48, 7, None, False, "native"),     # tiny ragged tail
]


def _operands(case):
    b, m, h, hkv, d, s, u, dedup, dtype = case
    u = u or b
    r = np.random.default_rng(b * 131 + m * 17 + s)
    t = dict(q=r.normal(size=(b, m, h, d)),
             k_hist=r.normal(size=(u, s, hkv, d)),
             v_hist=r.normal(size=(u, s, hkv, d)),
             k_cand=r.normal(size=(b, m, hkv, d)),
             v_cand=r.normal(size=(b, m, hkv, d)))
    j = {k: jnp.asarray(v, jnp.float32) for k, v in t.items()}
    j.update(k_scale=None, v_scale=None)
    if dtype != "native":
        qk = j_quantize_leaf(j["k_hist"], dtype)
        qv = j_quantize_leaf(j["v_hist"], dtype)
        j.update(k_hist=qk.q, v_hist=qv.q, k_scale=qk.scale,
                 v_scale=qv.scale)
    j["row_index"] = jnp.asarray(r.integers(0, u, b), jnp.int32) \
        if dedup else None
    pt = {}
    for k, v in j.items():
        if v is None:
            pt[k] = None
        elif v.dtype == jnp.bfloat16:
            pt[k] = _t(np.asarray(v, np.float32)).to(torch.bfloat16)
        else:
            pt[k] = _t(np.array(v))
    return j, pt


def _ids(cases):
    return [f"{c[8]}-s{c[5]}-m{c[1]}" + ("-idx" if c[7] else "")
            for c in cases]


@pytest.mark.parametrize("mode", ["cached", "extend"])
@pytest.mark.parametrize("case", FS_CASES, ids=_ids(FS_CASES))
def test_fused_plain_vs_jax_twin(case, mode):
    """The plain version == the JAX two-segment twin (_fused_jnp) on the
    same stored operands, scales and dedup index."""
    j, t = _operands(case)
    u, hkv = j["k_hist"].shape[0], j["k_hist"].shape[2]
    exp = j_fs_ops._fused_jnp(
        j["q"], j["k_hist"], j["v_hist"], j["k_cand"], j["v_cand"],
        j_fs_ops._norm_scale(j["k_scale"], u, hkv),
        j_fs_ops._norm_scale(j["v_scale"], u, hkv), j["row_index"], None,
        mode)
    fn = fs.fused_cached_attention if mode == "cached" \
        else fs.fused_extend_attention
    got = fn(t["q"], t["k_hist"], t["v_hist"], t["k_cand"], t["v_cand"],
             k_scale=t["k_scale"], v_scale=t["v_scale"],
             row_index=t["row_index"])
    _close(got, exp)
    assert fs.fused_score.launches == 0


@pytest.mark.parametrize("mode", ["cached", "extend"])
@pytest.mark.parametrize("case", FS_CASES, ids=_ids(FS_CASES))
def test_fused_plain_vs_jax_oracle(case, mode):
    """The plain version and the ported oracle vs the JAX ``ref.py``
    oracle (dequantize -> gather -> concat -> reference attention); int8
    operands dequantize to f32 on both sides, so the f32 tolerance holds."""
    j, t = _operands(case)
    jref = j_fs_ref.cached_reference if mode == "cached" \
        else j_fs_ref.extend_reference
    tref = fs_ref.cached_reference if mode == "cached" \
        else fs_ref.extend_reference
    kw = dict(k_scale=j["k_scale"], v_scale=j["v_scale"],
              row_index=j["row_index"], kv_dtype=jnp.float32)
    exp = jax.jit(lambda *a: jref(*a, **kw))(
        j["q"], j["k_hist"], j["v_hist"], j["k_cand"], j["v_cand"])
    fn = fs.fused_cached_attention if mode == "cached" \
        else fs.fused_extend_attention
    got = fn(t["q"], t["k_hist"], t["v_hist"], t["k_cand"], t["v_cand"],
             k_scale=t["k_scale"], v_scale=t["v_scale"],
             row_index=t["row_index"])
    _close(got, exp)
    oracle = tref(t["q"], t["k_hist"], t["v_hist"], t["k_cand"],
                  t["v_cand"], k_scale=t["k_scale"], v_scale=t["v_scale"],
                  row_index=t["row_index"], kv_dtype=torch.float32)
    _close(oracle, exp)


def _packed_seg(b, m, u, align, seed):
    """A [B, M] segment-packed index: runs of one pool row starting on
    multiples of ``align``, the way the packer lays segments out, and the
    mask of the slots the segments fill (the holes are dead slots, seg
    0)."""
    r = np.random.default_rng(seed)
    seg = np.zeros((b, m), np.int32)
    live = np.zeros((b, m), bool)
    for row in range(b):
        off = 0
        while off < m:
            n = int(r.integers(1, 2 * align + 1))
            seg[row, off:off + n] = r.integers(0, u)
            live[row, off:off + n] = True
            off = -(-(off + n) // align) * align
    return seg, live


@pytest.mark.parametrize("case", FS_CASES, ids=_ids(FS_CASES))
def test_fused_packed_vs_jax_twin(case):
    """A 2-D (segment-packed) ``row_index`` in cached and decode modes: the
    plain version == the JAX two-segment twin with the same [B, M] index
    and per-row lengths."""
    j, t = _operands(case)
    b, m = j["q"].shape[:2]
    u, s, hkv = j["k_hist"].shape[:3]
    seg, _ = _packed_seg(b, m, u, 1, seed=b + m)
    lens = np.random.default_rng(m).integers(0, s + 1, u).astype(np.int32)
    args = (t["q"], t["k_hist"], t["v_hist"], t["k_cand"], t["v_cand"])
    kw = dict(k_scale=t["k_scale"], v_scale=t["v_scale"],
              row_index=torch.from_numpy(seg))
    for lengths in (None, lens):
        exp = j_fs_ops._fused_jnp(
            j["q"], j["k_hist"], j["v_hist"], j["k_cand"], j["v_cand"],
            j_fs_ops._norm_scale(j["k_scale"], u, hkv),
            j_fs_ops._norm_scale(j["v_scale"], u, hkv), jnp.asarray(seg),
            None if lengths is None else jnp.asarray(lengths), "cached")
        got = fs.fused_cached_attention(*args, **kw) if lengths is None \
            else fs.fused_decode_attention(*args, torch.from_numpy(lengths),
                                           **kw)
        _close(got, exp)


@pytest.mark.parametrize("align", [8, 16])
def test_fused_packed_vs_pallas_interpret(align):
    """The JAX kernel reads a packed index once per q block of ``bq`` =
    the declared alignment; on segments aligned to it (interpret mode) it
    agrees with the port's plain version, which takes any alignment."""
    j, t = _operands(FS_CASES[3])
    b, m = j["q"].shape[:2]
    m = 2 * align
    q = jnp.asarray(np.random.default_rng(5).normal(
        size=(b, m) + tuple(j["q"].shape[2:])), jnp.float32)
    kc = jnp.tile(j["k_cand"], (1, 2, 1, 1))[:, :m]
    vc = jnp.tile(j["v_cand"], (1, 2, 1, 1))[:, :m]
    seg, live = _packed_seg(b, m, j["k_hist"].shape[0], align, seed=align)
    prev = j_fs_ops.set_packed_alignment(align)
    try:
        exp = j_fs_ops.fused_cached_attention(
            q, j["k_hist"], j["v_hist"], kc, vc, k_scale=j["k_scale"],
            v_scale=j["v_scale"], row_index=jnp.asarray(seg),
            path="kernel", interpret=True)
    finally:
        j_fs_ops.set_packed_alignment(prev)
    got = fs.fused_cached_attention(
        _t(np.array(q)), t["k_hist"], t["v_hist"], _t(np.array(kc)),
        _t(np.array(vc)), k_scale=t["k_scale"], v_scale=t["v_scale"],
        row_index=torch.from_numpy(seg))
    _close(got[torch.from_numpy(live)], np.asarray(exp)[live])


def test_packed_alignment_declaration():
    """The port keeps the JAX module's alignment declaration (0 or a
    multiple of 8, returning the previous value); its kernel needs none, so
    no packed call is ever rerouted."""
    prev = fs.set_packed_alignment(16)
    try:
        assert fs.packed_alignment() == 16
        with pytest.raises(ValueError):
            fs.set_packed_alignment(12)
    finally:
        assert fs.set_packed_alignment(prev) == 16
    assert fs.packed_alignment() == prev and fs.packed_kernel_reroutes == 0


@pytest.mark.parametrize("case", [FS_CASES[1], FS_CASES[3]],
                         ids=_ids([FS_CASES[1], FS_CASES[3]]))
def test_fused_plain_vs_pallas_interpret(case):
    j, t = _operands(case)
    exp = j_fs_ops.fused_cached_attention(
        j["q"], j["k_hist"], j["v_hist"], j["k_cand"], j["v_cand"],
        k_scale=j["k_scale"], v_scale=j["v_scale"], row_index=j["row_index"],
        path="kernel", interpret=True)
    got = fs.fused_cached_attention(
        t["q"], t["k_hist"], t["v_hist"], t["k_cand"], t["v_cand"],
        k_scale=t["k_scale"], v_scale=t["v_scale"], row_index=t["row_index"])
    _close(got, exp)


EXT_CASES = [
    (2, 1, 2, 2, 16, 40, None, False, "bf16"),      # tail append, M = 1
    (3, 17, 4, 2, 16, 20, 2, True, "int8"),         # dedup idx, one past 16
    (2, 33, 4, 2, 32, 24, None, False, "native"),   # gqa, three q blocks
]


@pytest.mark.parametrize("case", EXT_CASES, ids=_ids(EXT_CASES))
def test_fused_extend_plain_vs_pallas_interpret(case):
    """``extend`` mode (causal suffix over a pooled prefix): the port's
    plain version == the JAX kernel in interpret mode on the same stored
    operands, scales and dedup index."""
    j, t = _operands(case)
    exp = j_fs_ops.fused_extend_attention(
        j["q"], j["k_hist"], j["v_hist"], j["k_cand"], j["v_cand"],
        k_scale=j["k_scale"], v_scale=j["v_scale"], row_index=j["row_index"],
        path="kernel", interpret=True)
    got = fs.fused_extend_attention(
        t["q"], t["k_hist"], t["v_hist"], t["k_cand"], t["v_cand"],
        k_scale=t["k_scale"], v_scale=t["v_scale"], row_index=t["row_index"])
    _close(got, exp)


@pytest.mark.parametrize("dedup", [False, True])
def test_fused_decode_lengths_vs_jax(dedup):
    """Per-pool-row ``lengths`` (including 0: a softmax over the self key
    alone) against the JAX decode oracle and twin; at ``lengths == S`` the
    decode call is bitwise the cached call."""
    case = (3, 10, 4, 2, 16, 24, 3 if dedup else None, dedup, "int8")
    j, t = _operands(case)
    u = j["k_hist"].shape[0]
    lens = np.array([0, 13, 24][:u], np.int32)
    exp = jax.jit(lambda *a: j_fs_ref.decode_reference(
        *a, k_scale=j["k_scale"], v_scale=j["v_scale"],
        row_index=j["row_index"], kv_dtype=jnp.float32))(
        j["q"], j["k_hist"], j["v_hist"], j["k_cand"], j["v_cand"],
        jnp.asarray(lens))
    twin = j_fs_ops.fused_decode_attention(
        j["q"], j["k_hist"], j["v_hist"], j["k_cand"], j["v_cand"],
        jnp.asarray(lens), k_scale=j["k_scale"], v_scale=j["v_scale"],
        row_index=j["row_index"], path="jnp")
    args = (t["q"], t["k_hist"], t["v_hist"], t["k_cand"], t["v_cand"])
    kw = dict(k_scale=t["k_scale"], v_scale=t["v_scale"],
              row_index=t["row_index"])
    got = fs.fused_decode_attention(*args, torch.from_numpy(lens), **kw)
    _close(got, exp)
    _close(got, twin)
    _close(fs_ref.decode_reference(*args, torch.from_numpy(lens),
                                   kv_dtype=torch.float32, **kw), exp)
    full = torch.full((u,), t["k_hist"].shape[1], dtype=torch.int32)
    assert torch.equal(fs.fused_decode_attention(*args, full, **kw),
                       fs.fused_cached_attention(*args, **kw))


def test_fused_rejects_packed_and_empty_history():
    """A 2-D (segment-packed) ``row_index`` scores each candidate against its
    own pool row in cached mode, and is rejected in extend mode (causal
    within the suffix) with the JAX package's ValueError; an empty history
    raises."""
    j, t = _operands(FS_CASES[0])
    args = (t["q"], t["k_hist"], t["v_hist"], t["k_cand"], t["v_cand"])
    b, m = t["q"].shape[:2]
    u = t["k_hist"].shape[0]
    seg = torch.arange(b * m, dtype=torch.int32).reshape(b, m) % u
    kw = dict(k_scale=t["k_scale"], v_scale=t["v_scale"])
    packed = fs.fused_cached_attention(*args, row_index=seg, **kw)
    for r in range(u):
        one = fs.fused_cached_attention(
            *args, row_index=torch.full((b,), r, dtype=torch.int32), **kw)
        assert torch.equal(packed[seg == r], one[seg == r])
    with pytest.raises(ValueError, match="causal"):
        fs.fused_extend_attention(*args, row_index=seg)
    with pytest.raises(ValueError):
        fs.fused_cached_attention(t["q"], t["k_hist"][:, :0],
                                  t["v_hist"][:, :0], t["k_cand"],
                                  t["v_cand"])


# ---------------------------------------------------------------------------
# K4 flash_decode
# ---------------------------------------------------------------------------

def _fd_operands(b, s, h, hkv, d, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    q = r.normal(size=(b, h, d)).astype(np.float32)
    k, v = (r.normal(size=(b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    j = [jnp.asarray(x, dtype) for x in (q, k, v)]
    t = [_t(x) if dtype == np.float32 else _t(x).to(torch.bfloat16)
         for x in (q, k, v)]
    return j, t


FD_CASES = [
    # b, s, h, hkv, d, lengths, window
    (3, 40, 4, 2, 16, [40, 17, 1], 0),
    (3, 40, 4, 2, 16, [40, 17, 3], 9),
    (2, 70, 8, 2, 32, [64, 70], 0),         # G = 4
    (2, 33, 2, 2, 64, [5, 33], 20),         # G = 1, S off the tile
]


@pytest.mark.parametrize("dtype,tol", [(np.float32, F32_TOL),
                                       (jnp.bfloat16, KBF16_TOL)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FD_CASES,
                         ids=[f"s{c[1]}-g{c[2] // c[3]}-w{c[6]}"
                              for c in FD_CASES])
def test_flash_decode_plain_vs_jax_oracle(case, dtype, tol):
    b, s, h, hkv, d, lens, window = case
    (jq, jk, jv), (tq, tk, tv) = _fd_operands(b, s, h, hkv, d, s + h,
                                              dtype)
    lengths = np.asarray(lens, np.int32)
    exp = jax.jit(lambda q, k, v, l: j_fd_ref.reference(
        q, k, v, l, window=window))(jq, jk, jv, lengths)
    got = fd.flash_decode(tq, tk, tv, _t(lengths), window=window)
    assert got.dtype == tq.dtype
    _close(got, exp, tol)
    _close(fd_ref.reference(tq, tk, tv, _t(lengths), window=window), exp,
           tol)
    assert fd.flash_decode.launches == 0


@pytest.mark.parametrize("window", [0, 7])
def test_flash_decode_plain_vs_pallas_interpret(window):
    """Against the Pallas kernel in interpret mode, a zero length
    included (both give zeros: ``acc / max(l, 1e-30)``)."""
    (jq, jk, jv), (tq, tk, tv) = _fd_operands(4, 50, 4, 2, 16, 9)
    lengths = np.asarray([0, 1, 23, 50], np.int32)
    exp = j_fd_ops.flash_decode(jq, jk, jv, jnp.asarray(lengths),
                                window=window, bk=16, interpret=True)
    got = fd.flash_decode(tq, tk, tv, _t(lengths), window=window)
    _close(got, exp, F32_TOL)
    assert not got[0].any()


def test_flash_decode_with_self_oracle_vs_jax():
    r = np.random.default_rng(12)
    b, m, s, h, hkv, d = 2, 3, 9, 4, 2, 8
    q = r.normal(size=(b, m, h, d)).astype(np.float32)
    kc, vc = (r.normal(size=(b, s, hkv, d)).astype(np.float32)
              for _ in range(2))
    ks, vs = (r.normal(size=(b, m, hkv, d)).astype(np.float32)
              for _ in range(2))
    lengths = np.asarray([9, 4], np.int32)
    exp = jax.jit(j_fd_ref.decode_with_self)(q, kc, vc, lengths, ks, vs)
    got = fd_ref.decode_with_self(_t(q), _t(kc), _t(vc), _t(lengths),
                                  _t(ks), _t(vs))
    _close(got, exp, F32_TOL)


SELF_CASES = [
    # b, m, s, h, hkv, d, lengths
    (4, 6, 20, 4, 2, 16, [0, 1, 9, 20]),      # empty, one, partial, full
    (4, 1, 20, 4, 4, 16, [0, 1, 9, 20]),      # M = 1 (append)
    (2, 5, 33, 8, 2, 32, [33, 12]),           # G = 4
]


def _self_operands(b, m, s, h, hkv, d, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    arrs = [r.normal(size=shape).astype(np.float32) for shape in (
        (b, m, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, m, hkv, d),
        (b, m, hkv, d))]
    j = [jnp.asarray(a, dtype) for a in arrs]
    t = [_t(a) if dtype == np.float32 else _t(a).to(torch.bfloat16)
         for a in arrs]
    return j, t


@pytest.mark.parametrize("dtype,tol", [(np.float32, F32_TOL),
                                       (jnp.bfloat16, KBF16_TOL)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SELF_CASES,
                         ids=[f"m{c[1]}-g{c[3] // c[4]}-d{c[5]}"
                              for c in SELF_CASES])
def test_flash_decode_with_self_plain_vs_jax_oracle(case, dtype, tol):
    """K4's self-slot form (plain version on the CPU) against the JAX
    ground truth ``flash_decode/ref.decode_with_self``."""
    b, m, s, h, hkv, d, lens = case
    (jq, jk, jv, jks, jvs), (tq, tk, tv, tks, tvs) = _self_operands(
        b, m, s, h, hkv, d, 21, dtype)
    lengths = np.asarray(lens, np.int32)
    exp = jax.jit(j_fd_ref.decode_with_self)(jq, jk, jv, lengths, jks, jvs)
    got = fd.flash_decode_with_self(tq, tk, tv, _t(lengths), tks, tvs)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, exp, tol)
    assert fd.flash_decode_with_self.launches == 0


def test_flash_decode_with_self_plain_padded_is_tight():
    """A cache padded with a non-zero fill gives bitwise the tight cache's
    output: each row sees its valid prefix alone."""
    _, (q, k, v, ks, vs) = _self_operands(3, 4, 17, 4, 2, 16, 22)
    lengths = torch.tensor([17, 6, 0], dtype=torch.int32)
    tight = fd.flash_decode_with_self(q, k, v, lengths, ks, vs)
    pad = torch.full((3, 9, 2, 16), 3.75)
    padded = fd.flash_decode_with_self(q, torch.cat([k, pad], 1),
                                       torch.cat([v, pad], 1), lengths, ks,
                                       vs)
    assert torch.equal(padded, tight)


def test_flash_decode_with_self_rejects_bad_operands():
    _, (q, k, v, ks, vs) = _self_operands(2, 3, 10, 4, 2, 16, 23)
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        fd.flash_decode_with_self(q, k, v, lengths[:1], ks, vs)
    with pytest.raises(ValueError):
        fd.flash_decode_with_self(q, k, v, lengths, ks[:, :2], vs)
    with pytest.raises(ValueError):                  # no fallback
        fd.flash_decode_with_self(*(t.to("meta") for t in (
            q, k, v, lengths, ks, vs)))


def test_flash_decode_rejects_bad_operands():
    (_, _, _), (tq, tk, tv) = _fd_operands(2, 10, 4, 2, 16, 1)
    with pytest.raises(ValueError):
        fd.flash_decode(tq, tk, tv, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        fd.flash_decode(tq[:, :3], tk, tv, torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):                  # no fallback
        fd.flash_decode(tq.to("meta"), tk.to("meta"), tv.to("meta"),
                        torch.ones(2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# K3 fused_ffn
# ---------------------------------------------------------------------------

def _ff_operands(t, d, f, act, norm, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    ops = {"x": r.normal(size=(t, d)),
           "w_up": r.normal(size=(d, f)) / np.sqrt(d),
           "w_down": r.normal(size=(f, d)) / np.sqrt(f),
           "w_gate": r.normal(size=(d, f)) / np.sqrt(d)
           if act == "swiglu" else None,
           "norm_scale": 0.1 * r.normal(size=(d,)) if norm else None}
    j = {k: None if v is None else jnp.asarray(v.astype(np.float32), dtype)
         for k, v in ops.items()}
    t_ = {k: None if v is None else (
        _t(v.astype(np.float32)) if dtype == np.float32
        else _t(v.astype(np.float32)).to(torch.bfloat16))
        for k, v in ops.items()}
    return j, t_


@pytest.mark.parametrize("dtype,tol", [(np.float32, F32_TOL),
                                       (jnp.bfloat16, KBF16_TOL)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ["gelu", "relu", "swiglu"])
@pytest.mark.parametrize("norm", [False, True], ids=["nonorm", "rmsnorm"])
def test_fused_ffn_plain_vs_jax(norm, act, dtype, tol):
    """The plain version (and the ported oracle) against the JAX oracle and
    the Pallas kernel in interpret mode, T and d_ff off the tiles."""
    j, t = _ff_operands(37, 64, 100, act, norm, 5, dtype)
    exp = jax.jit(lambda x, wu, wd, wg, ns: j_ff_ref.reference(
        x, wu, wd, w_gate=wg, norm_scale=ns, activation=act))(
        j["x"], j["w_up"], j["w_down"], j["w_gate"], j["norm_scale"])
    kern = j_ff_ops.fused_ffn_2d(j["x"], j["w_up"], j["w_down"],
                                 j["w_gate"], j["norm_scale"],
                                 activation=act, bt=16, bf=32,
                                 interpret=True)
    got = ff.fused_ffn_2d(t["x"], t["w_up"], t["w_down"], t["w_gate"],
                          t["norm_scale"], activation=act)
    assert got.dtype == t["x"].dtype
    _close(got, exp, tol)
    _close(got, kern, tol)
    _close(ff_ref.reference(t["x"], t["w_up"], t["w_down"],
                            w_gate=t["w_gate"], norm_scale=t["norm_scale"],
                            activation=act), exp, tol)
    assert ff.fused_ffn_2d.launches == 0


def test_fused_ffn_model_entry_and_checks():
    """``fused_ffn`` flattens leading axes; bad shapes and a missing gate
    raise."""
    j, t = _ff_operands(12, 32, 48, "gelu", False, 6)
    x = t["x"].reshape(3, 4, 32)
    params = {"w_up": t["w_up"], "w_down": t["w_down"]}
    got = ff.fused_ffn(x, params, activation="gelu")
    assert got.shape == x.shape
    torch.testing.assert_close(got.reshape(12, 32), ff.fused_ffn_plain(
        t["x"], t["w_up"], t["w_down"], activation="gelu"), rtol=0, atol=0)
    with pytest.raises(ValueError):
        ff.fused_ffn_2d(t["x"], t["w_up"], t["w_down"], activation="swiglu")
    with pytest.raises(ValueError):
        ff.fused_ffn_2d(t["x"], t["w_down"], t["w_down"], activation="gelu")
    with pytest.raises(ValueError):
        ff.fused_ffn_2d(t["x"], t["w_up"], t["w_down"], activation="tanh")


# ---------------------------------------------------------------------------
# the CUDA kernels themselves (GPU only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "causal", "sliding", "sumi"])
def test_flash_attention_kernel_vs_plain(cuda_device, mode):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2, 70, n, 64, generator=g, device=cuda_device)
               for n in (4, 2, 2))
    kw = dict(window=9) if mode == "sliding" else dict(n_history=40)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, mode, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, mode, **kw)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("hist", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["cached", "extend"])
def test_fused_score_kernel_vs_plain(cuda_device, hist, mode):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, kc, vc = (torch.randn(3, 37, n, 64, generator=g, device=cuda_device)
                 for n in (4, 4, 4))
    kf, vf = (torch.randn(2, 70, 4, 64, generator=g, device=cuda_device)
              for _ in range(2))
    ks = vs = None
    if hist == torch.int8:
        lk, lv = quantize_leaf(kf, "int8"), quantize_leaf(vf, "int8")
        kh, vh, ks, vs = lk.q, lv.q, lk.scale, lv.scale
    else:
        kh, vh = kf.to(hist), vf.to(hist)
    idx = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda_device)
    fn = fs.fused_cached_attention if mode == "cached" \
        else fs.fused_extend_attention
    got = fn(q, kh, vh, kc, vc, k_scale=ks, v_scale=vs, row_index=idx)
    torch.cuda.synchronize()
    want = fs.fused_score_plain(q, kh, vh, kc, vc, mode=mode,
                                k_scale=fs._norm_scale(ks, 2, 4),
                                v_scale=fs._norm_scale(vs, 2, 4),
                                row_index=idx)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 13])
def test_flash_decode_kernel_vs_plain(cuda_device, dtype, window):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q = torch.randn(5, 8, 64, generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn(5, 90, 2, 64, generator=g, device=cuda_device)
            .to(dtype) for _ in range(2))
    lengths = torch.tensor([0, 1, 45, 89, 90], dtype=torch.int32,
                           device=cuda_device)
    before = fd.flash_decode.launches
    got = fd.flash_decode(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == before + 1
    want = fd.flash_decode_plain(q, k, v, lengths, window=window)
    tol = TOL if dtype == torch.float32 else KBF16_TOL
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    # a cache padded with a non-zero fill decodes bitwise like the tight one
    pad = torch.full((5, 17, 2, 64), 3.75, dtype=dtype, device=cuda_device)
    padded = fd.flash_decode(q, torch.cat([k, pad], 1),
                             torch.cat([v, pad], 1), lengths, window=window)
    assert torch.equal(padded, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,norm", [("gelu", False), ("relu", True),
                                      ("swiglu", True)])
def test_fused_ffn_kernel_vs_plain(cuda_device, dtype, act, norm):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    t, d, f = 37, 256, 200
    x = torch.randn(t, d, generator=g, device=cuda_device).to(dtype)
    wu, wg = ((torch.randn(d, f, generator=g, device=cuda_device)
               / d ** 0.5).to(dtype) for _ in range(2))
    wd = (torch.randn(f, d, generator=g, device=cuda_device)
          / f ** 0.5).to(dtype)
    ns = (0.1 * torch.randn(d, generator=g, device=cuda_device)).to(dtype) \
        if norm else None
    wg = wg if act == "swiglu" else None
    before = ff.fused_ffn_2d.launches
    got = ff.fused_ffn_2d(x, wu, wd, wg, ns, activation=act)
    torch.cuda.synchronize()
    assert ff.fused_ffn_2d.launches == before + 1
    want = ff.fused_ffn_plain(x, wu, wd, wg, ns, activation=act)
    tol = TOL if dtype == torch.float32 else KBF16_TOL
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


# bf16 kernels on the card against their plain versions: chip_smoke.py's
# gate, two bf16 ulps of the output
CARD_BF16_ATOL, CARD_BF16_RTOL = 1e-3, 1.6e-2
# K2's path shapes: the encode pass (q/k/v [4, 257, 4, D]) and the pallas
# cached pass (q [4, 128, 4, D] after 257 history keys)
K2_SHAPES = {"encode": (257, 257, 0), "cached": (128, 385, 257)}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("mode", ["full", "causal", "sliding", "sumi"])
@pytest.mark.parametrize("shape", sorted(K2_SHAPES))
def test_flash_attention_bf16_kernel_vs_plain(cuda_device, shape, mode, d):
    sq, sk, off = K2_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q = torch.randn(4, sq, 4, d, generator=g, device=cuda_device)
    k, v = (torch.randn(4, sk, 4, d, generator=g, device=cuda_device)
            for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    kw = {"full": {}, "sliding": dict(window=40),
          "causal": dict(q_offset=off),
          "sumi": dict(n_history=257, q_offset=off)}[mode]
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, mode, **kw)
    again = fa.flash_attention(q, k, v, mode, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    assert torch.equal(got, again)      # one warp per row, fixed key order
    want = fa.flash_attention_plain(q, k, v, mode, **kw)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=CARD_BF16_ATOL, rtol=CARD_BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d,f", [(64, 200), (256, 1000)])
@pytest.mark.parametrize("act,norm", [("gelu", False), ("swiglu", True)])
def test_fused_ffn_bf16_rows_independent_of_t(cuda_device, act, norm, d, f):
    g = torch.Generator(device=cuda_device).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=cuda_device)
                * scale).to(torch.bfloat16)

    x = rnd(1028, d)
    wu, wd = rnd(d, f, scale=d ** -0.5), rnd(f, d, scale=f ** -0.5)
    wg = rnd(d, f, scale=d ** -0.5) if act == "swiglu" else None
    ns = rnd(d, scale=0.1) if norm else None
    big = ff.fused_ffn_2d(x, wu, wd, wg, ns, activation=act)
    small = ff.fused_ffn_2d(x[:5].contiguous(), wu, wd, wg, ns,
                            activation=act)
    again = ff.fused_ffn_2d(x, wu, wd, wg, ns, activation=act)
    torch.cuda.synchronize()
    # the d_ff split and the order of its partial sums depend on d_ff alone
    assert torch.equal(small, big[:5])
    assert torch.equal(again, big)
    want = ff.fused_ffn_plain(x, wu, wd, wg, ns, activation=act)
    torch.testing.assert_close(big.float(), want.float(),
                               atol=CARD_BF16_ATOL, rtol=CARD_BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("hist", ["int8", "bf16"])
def test_fused_score_bf16_bitwise_rules(cuda_device, hist):
    """K1's tensor-core kernel (bf16 q, cached mode): within the card's
    bf16 gate of the plain version, and bitwise — the rows of an M = 5
    call equal those of an M = 128 call, lengths == S equals no lengths, a
    padded history equals the tight one, two calls agree."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    b, m, u, s, h, hkv, d = 3, 128, 2, 70, 4, 2, 64

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device)

    q, kc, vc = (rnd(b, m, n, d).to(torch.bfloat16) for n in (h, hkv, hkv))
    kf, vf = rnd(u, s, hkv, d), rnd(u, s, hkv, d)
    ks = vs = None
    if hist == "int8":
        lk, lv = quantize_leaf(kf, "int8"), quantize_leaf(vf, "int8")
        kh, vh, ks, vs = lk.q, lv.q, lk.scale, lv.scale
        fill = torch.full((u, 9, hkv, d), 77, dtype=torch.int8,
                          device=cuda_device)
    else:
        kh, vh = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        fill = torch.full((u, 9, hkv, d), 3.75, dtype=torch.bfloat16,
                          device=cuda_device)
    idx = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda_device)
    kw = dict(k_scale=ks, v_scale=vs, row_index=idx)
    lens = torch.tensor([s, 33], dtype=torch.int32, device=cuda_device)
    full = fs.fused_cached_attention(q, kh, vh, kc, vc, **kw)
    part = fs.fused_decode_attention(q, kh, vh, kc, vc, lens, **kw)
    small = fs.fused_cached_attention(q[:, :5].contiguous(), kh, vh,
                                      kc[:, :5].contiguous(),
                                      vc[:, :5].contiguous(), **kw)
    at_s = fs.fused_decode_attention(q, kh, vh, kc, vc,
                                     torch.full_like(lens, s), **kw)
    padded = fs.fused_decode_attention(q, torch.cat([kh, fill], 1),
                                       torch.cat([vh, fill], 1), kc, vc,
                                       lens, **kw)
    again = fs.fused_decode_attention(q, kh, vh, kc, vc, lens, **kw)
    torch.cuda.synchronize()
    assert torch.equal(small, full[:, :5])
    assert torch.equal(at_s, full)
    assert torch.equal(padded, part)
    assert torch.equal(again, part)
    want = fs.fused_score_plain(q, kh, vh, kc, vc, mode="cached",
                                k_scale=fs._norm_scale(ks, u, hkv),
                                v_scale=fs._norm_scale(vs, u, hkv),
                                row_index=idx, lengths=lens)
    torch.testing.assert_close(part.float(), want.float(),
                               atol=CARD_BF16_ATOL, rtol=CARD_BF16_RTOL)


def _extend_operands(device, hist, b, m, u, s, h, hkv, d, seed):
    """bf16 q and suffix K / V as views of one [B, M, H + 2 Hkv, D]
    projection (strided, as the QKV projection hands them) and an int8 or
    bf16 prefix with its scales."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=device)

    qkv = rnd(b, m, h + 2 * hkv, d).to(torch.bfloat16)
    q, kc, vc = qkv[:, :, :h], qkv[:, :, h:h + hkv], qkv[:, :, h + hkv:]
    kf, vf = rnd(u, s, hkv, d), rnd(u, s, hkv, d)
    if hist == "int8":
        lk, lv = quantize_leaf(kf, "int8"), quantize_leaf(vf, "int8")
        return q, kc, vc, lk.q, lv.q, lk.scale, lv.scale
    return (q, kc, vc, kf.to(torch.bfloat16), vf.to(torch.bfloat16), None,
            None)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16, 17, 129])
@pytest.mark.parametrize("hist", ["int8", "bf16"])
def test_fused_score_extend_kernel_vs_plain(cuda_device, hist, m):
    """K1's extend-mode tensor-core kernel (bf16 q over an int8 or bf16
    prefix) on strided suffix operands: within the card's bf16 gate of the
    plain version, with and without lengths (one pool row's prefix 0)."""
    b, u, s, h, hkv, d = 3, 2, 70, 4, 2, 64
    q, kc, vc, kh, vh, ks, vs = _extend_operands(cuda_device, hist, b, m, u,
                                                 s, h, hkv, d, seed=m)
    idx = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda_device)
    kw = dict(mode="extend", k_scale=fs._norm_scale(ks, u, hkv),
              v_scale=fs._norm_scale(vs, u, hkv), row_index=idx)
    for lengths in (None, torch.tensor([0, 45], dtype=torch.int32,
                                       device=cuda_device)):
        before = fs.fused_score.launches
        got = fs.fused_score(q, kh, vh, kc, vc, lengths=lengths, **kw)
        torch.cuda.synchronize()
        assert fs.fused_score.launches == before + 1
        want = fs.fused_score_plain(q, kh, vh, kc, vc, lengths=lengths, **kw)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=CARD_BF16_ATOL, rtol=CARD_BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("hist", ["int8", "bf16"])
def test_fused_score_extend_bitwise_rules(cuda_device, hist):
    """K1's extend-mode kernel: the rows of an M = 5 call equal rows 0-4 of
    an M = 129 call (a row depends on the suffix rows up to it alone),
    lengths == S equals no lengths, a padded prefix equals the tight one,
    two calls agree — bitwise."""
    b, m, u, s, h, hkv, d = 3, 129, 2, 70, 4, 2, 64
    q, kc, vc, kh, vh, ks, vs = _extend_operands(cuda_device, hist, b, m, u,
                                                 s, h, hkv, d, seed=21)
    fill = torch.full((u, 9, hkv, d), 77 if hist == "int8" else 3.75,
                      dtype=kh.dtype, device=cuda_device)
    idx = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda_device)
    kw = dict(mode="extend", k_scale=fs._norm_scale(ks, u, hkv),
              v_scale=fs._norm_scale(vs, u, hkv), row_index=idx)
    lens = torch.tensor([0, 33], dtype=torch.int32, device=cuda_device)
    full = fs.fused_score(q, kh, vh, kc, vc, **kw)
    part = fs.fused_score(q, kh, vh, kc, vc, lengths=lens, **kw)
    small = fs.fused_score(q[:, :5], kh, vh, kc[:, :5], vc[:, :5], **kw)
    at_s = fs.fused_score(q, kh, vh, kc, vc, lengths=torch.full_like(lens, s),
                          **kw)
    padded = fs.fused_score(q, torch.cat([kh, fill], 1),
                            torch.cat([vh, fill], 1), kc, vc, lengths=lens,
                            **kw)
    again = fs.fused_score(q, kh, vh, kc, vc, lengths=lens, **kw)
    torch.cuda.synchronize()
    assert torch.equal(small, full[:, :5])
    assert torch.equal(at_s, full)
    assert torch.equal(padded, part)
    assert torch.equal(again, part)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_with_self_kernel_vs_plain(cuda_device, dtype):
    """K4's self-slot form on the card: within tolerance of its plain
    version (lengths 0 to full, GQA), a padded cache bitwise the tight one,
    the rows of an M = 5 call bitwise those of an M = 128 call, two calls
    bitwise."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    b, m, s, h, hkv, d = 4, 128, 90, 8, 2, 64

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(dtype)

    q, ks, vs = rnd(b, m, h, d), rnd(b, m, hkv, d), rnd(b, m, hkv, d)
    k, v = rnd(b, s, hkv, d), rnd(b, s, hkv, d)
    lengths = torch.tensor([0, 1, 45, 90], dtype=torch.int32,
                           device=cuda_device)
    before = fd.flash_decode_with_self.launches
    got = fd.flash_decode_with_self(q, k, v, lengths, ks, vs)
    pad = torch.full((b, 17, hkv, d), 3.75, dtype=dtype, device=cuda_device)
    padded = fd.flash_decode_with_self(q, torch.cat([k, pad], 1),
                                       torch.cat([v, pad], 1), lengths, ks,
                                       vs)
    small = fd.flash_decode_with_self(q[:, :5].contiguous(), k, v, lengths,
                                      ks[:, :5].contiguous(),
                                      vs[:, :5].contiguous())
    again = fd.flash_decode_with_self(q, k, v, lengths, ks, vs)
    torch.cuda.synchronize()
    assert fd.flash_decode_with_self.launches == before + 4
    assert torch.equal(padded, got)
    assert torch.equal(small, got[:, :5])
    assert torch.equal(again, got)
    want = fd.flash_decode_with_self_plain(q, k, v, lengths, ks, vs)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=CARD_BF16_ATOL, rtol=CARD_BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("window", [0, 21])
def test_flash_decode_bf16_deterministic(cuda_device, group, window):
    """K4's single-token form in bf16: within the card's bf16 gate of the
    plain version, two calls bitwise equal, a padded cache bitwise the
    tight one (the chunks and their warps depend on len and window
    alone)."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    b, s, hkv, d = 6, 170, 4, 64

    def rnd(*shape):
        return torch.randn(*shape, generator=g,
                           device=cuda_device).to(torch.bfloat16)

    q, k, v = rnd(b, hkv * group, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d)
    lengths = torch.tensor([170, 169, 33, 164, 1, 0], dtype=torch.int32,
                           device=cuda_device)
    got = fd.flash_decode(q, k, v, lengths, window=window)
    again = fd.flash_decode(q, k, v, lengths, window=window)
    pad = torch.full((b, 23, hkv, d), 3.75, dtype=torch.bfloat16,
                     device=cuda_device)
    padded = fd.flash_decode(q, torch.cat([k, pad], 1),
                             torch.cat([v, pad], 1), lengths, window=window)
    torch.cuda.synchronize()
    assert torch.equal(again, got)
    assert torch.equal(padded, got)
    want = fd.flash_decode_plain(q, k, v, lengths, window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=CARD_BF16_ATOL, rtol=CARD_BF16_RTOL)


# ---------------------------------------------------------------------------
# the text models' shapes: head dims between the kernels' instantiations
# (padded to the next one), K2 / K4 at head dim 256, K3's wide form (d
# past 256), K5 at head sizes under 32 / 64
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d", [48, 120, 240, 256])
@pytest.mark.parametrize("mode,window", [("causal", 0), ("sliding", 70)])
def test_flash_attention_bf16_padded_head_dims_vs_plain(cuda_device, d, mode,
                                                        window):
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q = torch.randn(2, 150, 4, d, generator=g, device=cuda_device)
    k, v = (torch.randn(2, 150, 2, d, generator=g, device=cuda_device)
            for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = fa.flash_attention(q, k, v, mode, window=window)
    again = fa.flash_attention(q, k, v, mode, window=window)
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.equal(got, again)
    want = fa.flash_attention_plain(q, k, v, mode, window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=CARD_BF16_ATOL, rtol=CARD_BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,hkv", [(120, 32, 8), (240, 16, 8)])
def test_flash_decode_bf16_padded_head_dims_vs_plain(cuda_device, d, h, hkv):
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q = torch.randn(4, h, d, generator=g, device=cuda_device)
    kc, vc = (torch.randn(4, 200, hkv, d, generator=g, device=cuda_device)
              for _ in range(2))
    q, kc, vc = (t.to(torch.bfloat16) for t in (q, kc, vc))
    lens = torch.tensor([200, 77, 1, 130], dtype=torch.int32,
                        device=cuda_device)
    got = fd.flash_decode(q, kc, vc, lens)
    torch.cuda.synchronize()
    want = fd.flash_decode_plain(q, kc, vc, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=KBF16_TOL,
                               rtol=BF16_TOL)


def _wide_operands(device, t, d, f, act, norm, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(t, d, generator=g, device=device).bfloat16()
    wu, wg = ((torch.randn(d, f, generator=g, device=device)
               / d ** 0.5).bfloat16() for _ in range(2))
    wd = (torch.randn(f, d, generator=g, device=device)
          / f ** 0.5).bfloat16()
    sc = (0.1 * torch.randn(d, generator=g, device=device)).bfloat16() \
        if norm else None
    return x, wu, wd, (wg if act == "swiglu" else None), sc


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4, ff.WIDE_DECODE_T, ff.WIDE_DECODE_T + 1,
                               300, 2100])
@pytest.mark.parametrize("act,norm", [("gelu", False), ("swiglu", False),
                                      ("relu", True)])
@pytest.mark.parametrize("d,f", [(3840, 1024), (1032, 1000)])
def test_fused_ffn_wide_vs_plain(cuda_device, t, act, norm, d, f):
    """d 3840 (the text models' width) with a cut d_ff, and d 1032 with
    d_ff 1000 (TMA's zero fill past d and d_ff): the wide form on both
    paths (T up to WIDE_DECODE_T and past it; at T 2100 two launches over
    one workspace), two calls bitwise, within the bf16 contract of the
    plain version; each call adds its kernels to the counter."""
    x, wu, wd, wg, sc = _wide_operands(cuda_device, t, d, f, act, norm, t)
    n0 = ff.fused_ffn_2d.launches
    got = ff.fused_ffn_2d(x, wu, wd, wg, sc, activation=act)
    again = ff.fused_ffn_2d(x, wu, wd, wg, sc, activation=act)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert ff.fused_ffn_2d.launches - n0 == 2 * ff.kernel_launches(
        t, d, norm, f=f, dtype=x.dtype)
    want = ff.fused_ffn_plain(x, wu, wd, wg, sc, activation=act)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=CARD_BF16_ATOL, rtol=CARD_BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("act,f", [("gelu", 15360), ("swiglu", 10240)])
def test_fused_ffn_wide_decode_path_repeats(cuda_device, act, f):
    """The decode path at the text models' d_ff with more CTAs than fit the
    card at once (T WIDE_DECODE_T: 2 m tiles x 240 / 160 slices): 20 calls,
    every one bitwise the first and within the bf16 contract.  A consumer
    that released a ring stage before its reads were done (no proxy fence
    before the arrival) let TMA overwrite the stage under it, and some
    calls went out of tolerance."""
    t, d = ff.WIDE_DECODE_T, 3840
    x, wu, wd, wg, _ = _wide_operands(cuda_device, t, d, f, act, False, 5)
    assert ff.wide_plan(t, f).path == "decode"
    want = ff.fused_ffn_plain(x, wu, wd, wg, activation=act)
    first = ff.fused_ffn_2d(x, wu, wd, wg, activation=act)
    torch.testing.assert_close(first.float(), want.float(),
                               atol=CARD_BF16_ATOL, rtol=CARD_BF16_RTOL)
    for _ in range(19):
        assert torch.equal(ff.fused_ffn_2d(x, wu, wd, wg, activation=act),
                           first)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_fused_ffn_wide_rows_bitwise_across_t(cuda_device, act):
    """The prefill path has no d_ff slices: the rows of a T 300 call are
    bitwise rows 0-299 of a T 2100 call (both in its first launch)."""
    x, wu, wd, wg, _ = _wide_operands(cuda_device, 2100, 3840, 1024, act,
                                      False, 7)
    big = ff.fused_ffn_2d(x, wu, wd, wg, activation=act)
    small = ff.fused_ffn_2d(x[:300].contiguous(), wu, wd, wg,
                            activation=act)
    torch.cuda.synchronize()
    assert ff.wide_plan(300, 1024).path == "prefill"
    assert torch.equal(small, big[:300])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [20, 48])
def test_rwkv6_scan_padded_head_sizes_vs_plain(cuda_device, d):
    g = torch.Generator(device=cuda_device).manual_seed(d)
    b, s, h = 2, 130, 4
    r, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda_device)
               .bfloat16() for _ in range(3))
    w_log = -torch.exp(torch.randn(b, s, h, d, generator=g,
                                   device=cuda_device))
    u = 0.5 * torch.randn(h, d, generator=g, device=cuda_device)
    st = 0.1 * torch.randn(b, h, d, d, generator=g, device=cuda_device)
    o, sf = scan.rwkv6_scan(r, k, v, w_log, u, st)
    torch.cuda.synchronize()
    po, psf = scan.rwkv6_scan_plain(r, k, v, w_log, u, st)
    assert o.shape == r.shape and sf.shape == (b, h, d, d)
    torch.testing.assert_close(o.float(), po.float(), atol=CARD_BF16_ATOL,
                               rtol=CARD_BF16_RTOL)
    torch.testing.assert_close(sf, psf, atol=1e-3, rtol=1e-3)
