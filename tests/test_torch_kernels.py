"""repro_torch kernels: the plain PyTorch versions against the reference's
Pallas kernels (interpret mode) and jnp oracles, the wrappers' CPU path,
and (on a machine with an NVIDIA GPU and nvcc) the CUDA kernels against
their plain versions.

Inputs are made with numpy from a seed and fed to both packages."""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.kernels.tatp_matmul.kernel import matmul as pallas_matmul
from repro.kernels.tatp_matmul.ref import matmul_ref as jax_matmul_ref
from repro.models.attention import local_attention as jax_local_attention
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.tatp_matmul import ops as gemm_ops
from repro_torch.kernels.tatp_matmul.ops import tatp_dot
from repro_torch.kernels.tatp_matmul.ref import matmul_ref

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    # the same tolerances as tests/test_kernels.py: different accumulation
    # order than the oracle -> small fp drift
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-3, atol=1e-3)


def _both(arr, dtype):
    """One numpy array as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(arr, _JNP[dtype])
    t = torch.from_numpy(np.asarray(arr, np.float32)).to(_TORCH[dtype])
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# tatp matmul: plain version vs the Pallas kernel and the jnp oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (256, 384, 512),
                                   (512, 256, 128), (128, 1024, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_ref_matches_pallas(m, n, k, dtype):
    rng = np.random.RandomState(0)
    aj, at = _both(rng.randn(m, n), dtype)
    bj, bt = _both(rng.randn(n, k), dtype)
    got = matmul_ref(at, bt)
    assert got.dtype == _TORCH[dtype] and got.shape == (m, k)
    pallas = pallas_matmul(aj, bj, bm=128, bn=128, bk=128, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(jax_matmul_ref(aj, bj)),
                               **_tol(dtype))


def test_matmul_ref_out_dtype():
    rng = np.random.RandomState(1)
    aj, at = _both(rng.randn(8, 16), "bfloat16")
    bj, bt = _both(rng.randn(16, 24), "bfloat16")
    got = matmul_ref(at, bt, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    ref = jax_matmul_ref(aj, bj, out_dtype=jnp.float32)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# flash attention: plain version vs the Pallas kernel and the jnp oracle
# ---------------------------------------------------------------------------

_ATTN_CASES = [
    # hq, hkv, causal, window, cap
    (4, 4, True, None, None),
    (4, 4, False, None, None),
    (4, 4, True, 32, None),
    (4, 4, True, None, 50.0),
    (8, 2, True, None, None),
    (4, 1, False, 16, 20.0),
]


@pytest.mark.parametrize("hq,hkv,causal,window,cap", _ATTN_CASES)
def test_attention_ref_matches_pallas(hq, hkv, causal, window, cap):
    rng = np.random.RandomState(2)
    s, d = 128, 64
    qj, qt = _both(rng.randn(1, hq, s, d), "float32")
    kj, kt = _both(rng.randn(1, hkv, s, d), "float32")
    vj, vt = _both(rng.randn(1, hkv, s, d), "float32")
    got = attention_ref(qt, kt, vt, causal=causal, window=window, cap=cap)
    pallas = flash_attention(qj, kj, vj, causal=causal, window=window,
                             cap=cap, bq=64, bk=64, interpret=True)
    ref = jax_attention(qj, kj, vj, causal=causal, window=window, cap=cap)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-3, atol=1e-3)


def test_attention_ref_matches_pallas_bf16():
    rng = np.random.RandomState(3)
    qj, qt = _both(rng.randn(1, 2, 128, 64), "bfloat16")
    kj, kt = _both(rng.randn(1, 2, 128, 64), "bfloat16")
    vj, vt = _both(rng.randn(1, 2, 128, 64), "bfloat16")
    got = attention_ref(qt, kt, vt, causal=True)
    assert got.dtype == torch.bfloat16
    pallas = flash_attention(qj, kj, vj, causal=True, bq=64, bk=64,
                             interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(jax_attention(qj, kj, vj)),
                               rtol=2e-2, atol=2e-2)


def test_attention_ref_fully_masked_rows_are_zero():
    """window=1 without causal on Sq > Skv leaves rows with no key: 0."""
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(1, 2, 8, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 2, 4, 16).astype(np.float32))
    out = attention_ref(q, k, k, causal=True, window=1)
    assert torch.isfinite(out).all()
    assert torch.equal(out[:, :, 4:], torch.zeros_like(out[:, :, 4:]))


@pytest.mark.parametrize("q_offset", [0, 3, 9, 16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("cap", [None, 5.0])
def test_attention_ref_offset_matches_local_attention(q_offset, causal,
                                                      window, cap):
    """Query row r at position r + q_offset against key c at c, in both
    masks: the reference's ``local_attention(q_offset=...)`` (6 queries, 10
    keys; at 16 without causal, window 4 leaves no key visible: 0)."""
    rng = np.random.RandomState(7)
    q = rng.randn(2, 6, 4, 16).astype(np.float32)  # [B, S, H, D]
    k = rng.randn(2, 10, 2, 16).astype(np.float32)
    v = rng.randn(2, 10, 2, 16).astype(np.float32)
    want = jax_local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, window=window, cap=cap,
                               q_offset=q_offset)
    t = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
    got, lse = attention_ref(*t, causal=causal, window=window, cap=cap,
                             q_offset=q_offset, return_lse=True)
    np.testing.assert_allclose(_np(got.transpose(1, 2)), _np(want),
                               rtol=1e-5, atol=1e-5)
    assert torch.isfinite(got).all()
    if q_offset == 16 and window and not causal:
        assert not got.any() and (lse <= -1e29).all()


@pytest.mark.parametrize("q_offset", [0, 3, 9, 16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("cap", [None, 5.0])
def test_attention_bwd_ref_offset_matches_jax_vjp(q_offset, causal, window,
                                                  cap):
    """The plain backward at a query offset: dq, dk and dv of
    ``attention_bwd_ref(q_offset=...)``, from ``attention_ref``'s row LSE
    at that offset, against ``jax.vjp`` of the reference's
    ``local_attention(q_offset=...)`` (6 queries, 10 keys; rows that see
    no key get dQ 0, keys that no row sees dK and dV 0)."""
    import jax

    rng = np.random.RandomState(9)
    q = rng.randn(2, 6, 4, 16).astype(np.float32)  # [B, S, H, D]
    k = rng.randn(2, 10, 2, 16).astype(np.float32)
    v = rng.randn(2, 10, 2, 16).astype(np.float32)
    do = rng.randn(2, 6, 4, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_local_attention(
        a, b, c, causal=causal, window=window, cap=cap, q_offset=q_offset),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    t = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, do)]
    kw = dict(causal=causal, window=window, cap=cap, q_offset=q_offset)
    o, lse = attention_ref(*t[:3], return_lse=True, **kw)
    got = attention_bwd_ref(*t[:3], o, lse, t[3], **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(_np(g.transpose(1, 2)), _np(w),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_attention_offset_on_cpu_and_under_autograd():
    """The wrapper passes ``q_offset`` to the plain version on the CPU;
    under autograd an offset raises (a ring round's backward at an offset
    is reached through ring attention's Functions)."""
    rng = np.random.RandomState(8)
    q = torch.from_numpy(rng.randn(1, 2, 6, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 2, 10, 16).astype(np.float32))
    kw = dict(causal=True, window=4, q_offset=5)
    assert torch.equal(attention(q, k, k, **kw), attention_ref(q, k, k, **kw))
    with pytest.raises(ValueError, match="query offset"):
        attention(q.requires_grad_(True), k, k, **kw)
    attention(q, k, k, causal=True, window=4)  # no offset: the Function


# ---------------------------------------------------------------------------
# wrappers: plain path on the CPU, no fallback anywhere else
# ---------------------------------------------------------------------------


def test_tatp_dot_cpu_uses_plain_version():
    rng = np.random.RandomState(5)
    a = torch.from_numpy(rng.randn(2, 3, 24).astype(np.float32))
    b = torch.from_numpy(rng.randn(24, 40).astype(np.float32))
    before = tatp_dot.launches
    got = tatp_dot(a, b)
    assert got.shape == (2, 3, 40)
    assert torch.equal(got, matmul_ref(a, b))
    assert tatp_dot.launches == before


def test_attention_cpu_uses_plain_version():
    rng = np.random.RandomState(6)
    q = torch.from_numpy(rng.randn(1, 4, 10, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 2, 10, 16).astype(np.float32))
    before = attention.launches
    got = attention(q, k, k, causal=True, window=4)
    assert torch.equal(got, attention_ref(q, k, k, causal=True, window=4))
    assert attention.launches == before


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor neither on the CPU nor on a CUDA device gets no plain-path
    fallback: the wrappers raise and count no launch."""
    a = torch.empty(4, 8, device="meta")
    b = torch.empty(8, 4, device="meta")
    with pytest.raises(ValueError):
        tatp_dot(a, b)
    q = torch.empty(1, 2, 8, 16, device="meta")
    before = (tatp_dot.launches, attention.launches)
    with pytest.raises(ValueError):
        attention(q, q, q)
    assert (tatp_dot.launches, attention.launches) == before


def test_build_names_one_library_per_source():
    paths = [_build._lib_path(n) for n in _build.SOURCES]
    assert len(set(paths)) == len(_build.SOURCES)
    for n, p in zip(_build.SOURCES, paths):
        assert p.parent == _build.BUILD_DIR and p.name.startswith(n + "-")
        assert (_build.CSRC / f"{n}.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# ---------------------------------------------------------------------------
# path selection: a pure function of dtype, shape, strides and alignment
# ---------------------------------------------------------------------------

# the prefill linears of the three main paths as (M, N, K): deepseek-7b at
# batch 4 x prompt 128, the SSM models at batch 4 x prompt 512
_MAIN_GEMMS = [(512, 4096, 4096), (512, 4096, 11008), (512, 11008, 4096),
               (2048, 1536, 6448), (2048, 3072, 1536), (2048, 2560, 10448),
               (2048, 5120, 2560), (2048, 2560, 2560), (2048, 2560, 10240),
               (2048, 10240, 2560)]
_BF16, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,n,lda,ldb,a_ptr,b_ptr,want", [
    # every main-path GEMM, contiguous operands from the allocator
    *[(_BF16, n, n, k, 1 << 20, 1 << 21, "wgmma") for _, n, k in _MAIN_GEMMS],
    # ragged but TMA-aligned: still wgmma
    (_BF16, 2560, 2560, 10448, 256, 512, "wgmma"),
    (_BF16, 256, 256, 11008, 256, 512, "wgmma"),
    # rows not a multiple of 16 bytes, or an unaligned base: wmma
    (_BF16, 203, 203, 301, 256, 512, "wmma"),
    (_BF16, 4096, 4100, 4096, 256, 512, "wmma"),
    (_BF16, 4096, 4096, 4096, 256 + 2, 512, "wmma"),
    (_BF16, 4096, 4096, 4096, 256, 512 + 8, "wmma"),
    (_BF16, 0, 8, 8, 256, 512, "wmma"),  # nothing to contract
    # fp32 keeps the SIMT kernel whatever the layout
    (_F32, 4096, 4096, 4096, 256, 512, "simt"),
    (_F32, 203, 203, 301, 4, 8, "simt"),
    # what no kernel takes
    (torch.float16, 64, 64, 64, 256, 512, ValueError),
    (torch.int8, 64, 64, 64, 256, 512, ValueError),
])
def test_tatp_dot_path(dtype, n, lda, ldb, a_ptr, b_ptr, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            gemm_ops._path(dtype, n, lda, ldb, a_ptr, b_ptr)
        return
    assert gemm_ops._path(dtype, n, lda, ldb, a_ptr, b_ptr) == want
    assert want in gemm_ops._PATHS and want in tatp_dot.launches_by_path


# the GEMM's operand layouts: (A transposed, B transposed) per product
_LAYOUT_PAIRS = {"forward": (False, False), "dgrad": (False, True),
                 "wgrad": (True, False), "both": (True, True)}


def _view(rows, cols, transposed, pad=0):
    """A [rows, cols] bf16 view (on the meta device: strides, no memory),
    row-major or the transpose of a [cols, rows] tensor, with ``pad``
    extra elements in each stored row."""
    kw = dict(dtype=_BF16, device="meta")
    if transposed:
        return torch.empty(cols, rows + pad, **kw)[:, :rows].t()
    return torch.empty(rows, cols + pad, **kw)[:, :cols]


@pytest.mark.parametrize("rows,cols,transposed,pad,want", [
    (4, 8, False, 0, (gemm_ops.ROWS, 8)),
    (4, 8, False, 3, (gemm_ops.ROWS, 11)),
    (4, 8, True, 0, (gemm_ops.TRANSPOSED, 4)),
    (4, 8, True, 5, (gemm_ops.TRANSPOSED, 9)),
    (1, 8, True, 0, (gemm_ops.ROWS, 8)),  # a lone row is its own layout
    (8, 1, False, 0, (gemm_ops.ROWS, 1)),
])
def test_tatp_dot_operand_layout(rows, cols, transposed, pad, want):
    t = _view(rows, cols, transposed, pad)
    assert gemm_ops._operand(t.shape, t.stride()) == want


def test_tatp_dot_operand_without_unit_stride_raises():
    t = torch.empty(6, 8, device="meta")[::2, ::2]
    with pytest.raises(ValueError, match="unit stride"):
        gemm_ops._operand(t.shape, t.stride())


# the backward products of the main path's linears: deepseek-7b's train
# step at batch 4 x seq 512 (M 2048), and its lm head (the dgrad stacks
# the three bf16 terms of the fp32 cotangent on M, the wgrad on the
# contraction)
_TRAIN_GEMMS = [(2048, 4096, 4096), (2048, 4096, 11008), (2048, 11008, 4096),
                (2048, 4096, 102400)]


@pytest.mark.parametrize("product", list(_LAYOUT_PAIRS))
@pytest.mark.parametrize("m,n,k", _MAIN_GEMMS + _TRAIN_GEMMS)
def test_tatp_dot_path_by_layout(product, m, n, k):
    """Every layout pair of every main-path linear's products picks wgmma:
    forward x @ w, dgrad dy @ w.T, wgrad x.T @ dy (here [N, M] @ [M, K])."""
    ta, tb = _LAYOUT_PAIRS[product]
    if product in ("wgrad", "both"):  # the output is the weight's [N, K]
        m, n = n, m
    a, b = _view(m, n, ta), _view(n, k, tb)
    (la, lda), (lb, ldb) = (gemm_ops._operand(t.shape, t.stride())
                            for t in (a, b))
    assert (la, lb) == (int(ta), int(tb))
    assert gemm_ops._path(_BF16, n, lda, ldb, 1 << 20, 1 << 21) == "wgmma"
    # a pitch TMA cannot describe in either layout: wmma
    a = _view(m, n, ta, pad=1)
    _, lda = gemm_ops._operand(a.shape, a.stride())
    assert gemm_ops._path(_BF16, n, lda, ldb, 1 << 20, 1 << 21) == "wmma"


# the tile width that timed best at each main-path shape on an H100 SXM
# (132 SMs; PERF.md)
@pytest.mark.parametrize("m,k,want", [
    (m, k, 256 if (m, k) in {(2048, 6448), (2048, 1536), (2048, 10448),
                             (2048, 10240)} else 128)
    for m, _, k in _MAIN_GEMMS
])
def test_tatp_dot_tile_n(m, k, want):
    assert gemm_ops._tile_n(m, k, 132) == want


@pytest.mark.parametrize("dtype,d,want", [
    (_BF16, 128, "mma"),  # deepseek-7b [4, 32, 128, 128]
    (_BF16, 80, "mma"),   # zamba2-2.7b [4, 32, 512, 80]
    (_BF16, 64, "mma"), (_BF16, 256, "mma"), (_BF16, 1, "mma"),
    (_BF16, 100, "mma"),
    (_F32, 128, "simt"), (_F32, 80, "simt"), (_F32, 256, "simt"),
    (_BF16, 257, ValueError), (_BF16, 0, ValueError),
    (_F32, 512, ValueError), (torch.float16, 64, ValueError),
])
def test_attention_path(dtype, d, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            flash_ops._path(dtype, d)
        return
    assert flash_ops._path(dtype, d) == want
    assert want in flash_ops._PATHS and want in attention.launches_by_path


@pytest.mark.parametrize("dtype,d,want", [
    (_BF16, 128, "mma"),  # deepseek-7b's train attention [4, 32, 512, 128]
    (_BF16, 80, "mma"), (_BF16, 64, "mma"), (_BF16, 1, "mma"),
    (_BF16, 129, "mma"), (_BF16, 256, "mma"),  # gemma's [4, 16, 512, 256]
    (_F32, 128, "simt"), (_F32, 256, "simt"),
    (_BF16, 257, ValueError), (torch.float16, 64, ValueError),
])
def test_attention_backward_path(dtype, d, want):
    # the backward takes the forward's path
    if want is ValueError:
        with pytest.raises(ValueError):
            flash_ops._path(dtype, d)
        return
    assert flash_ops._path(dtype, d) == want
    assert want in flash_ops.attention_bwd.launches_by_path


@pytest.mark.parametrize("lib,fn,argtypes", [
    # a, b, c; M, N, K, lda, ldb, ldc; the two operand layouts, in/out
    # dtype, path, tile_n; stream
    ("tatp_matmul", "tatp_matmul_launch",
     [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6 + [ctypes.c_int] * 6
     + [ctypes.c_void_p]),
    # q, k, v, o, lse; B, Hq, Hkv, Sq, Skv, D; 12 strides; scale, causal,
    # window, q_offset, cap, dtype, path; stream
    ("flash_attention", "flash_attention_launch",
     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 12
     + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    # q, k, v, o, do, lse, delta, dq, dk, dv; the six sizes; 24 strides;
    # scale, causal, window, q_offset, cap, delta_in, dtype, path; stream
    ("flash_attention_bwd", "flash_attention_bwd_launch",
     [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 24
     + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
    ("ssd", "ssd_intra_chunk_launch",
     [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 9
     + [ctypes.c_void_p]),
    # x, dt, a, B, C, dy, dst, dg, dx, ddt, da, dB, dC, scratch, counters;
    # BC, Q, H, P, N; 9 strides; stream
    ("ssd_bwd", "ssd_intra_chunk_bwd_launch",
     [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 9
     + [ctypes.c_void_p]),
])
def test_launcher_argtypes_match_c_signature(monkeypatch, lib, fn, argtypes):
    """The wrappers' ctypes argtypes against the C launchers' parameter
    lists, read from the sources (no compiler needed)."""
    src = (_build.CSRC / f"{lib}.cu").read_text()
    params = re.search(rf"int {fn}\(([^)]*)\)", src).group(1)
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
               "const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
               "int*": ctypes.c_void_p,
               "int64_t": ctypes.c_int64, "int": ctypes.c_int,
               "float": ctypes.c_float}
    parsed = [c_types[" ".join(p.split()[:-1])] for p in params.split(",")]
    assert parsed == argtypes

    class Fn:
        argtypes = None
        restype = None

    class Lib:
        pass

    stub = Lib()
    for name in re.findall(r"^(?:int|void) (\w+)\(", src, re.M):
        setattr(stub, name, Fn())
    monkeypatch.setattr(_build, "load", lambda name: stub)
    {"tatp_matmul": gemm_ops._lib, "flash_attention": flash_ops._lib,
     "flash_attention_bwd": flash_ops._bwd_lib, "ssd": ssd_ops._lib,
     "ssd_bwd": ssd_ops._bwd_lib}[lib]()
    assert getattr(stub, fn).argtypes == argtypes
    assert getattr(stub, fn).restype is ctypes.c_int


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,dtype,path", [
    (100, 200, 300, "float32", "simt"),
    (100, 203, 301, "bfloat16", "wmma"),
    (512, 4096, 1000, "bfloat16", "wgmma"),
    (77, 256, 11008, "bfloat16", "wgmma"),
    (2048, 2560, 10448, "bfloat16", "wgmma"),
])
def test_tatp_dot_kernel_matches_plain(cuda_device, m, n, k, dtype, path):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(m, n, generator=g, device=cuda_device).to(_TORCH[dtype])
    b = torch.randn(n, k, generator=g, device=cuda_device).to(_TORCH[dtype])
    before = tatp_dot.launches
    before_path = tatp_dot.launches_by_path[path]
    got = tatp_dot(a, b)
    torch.cuda.synchronize()
    assert tatp_dot.launches == before + 1
    assert tatp_dot.launches_by_path[path] == before_path + 1
    np.testing.assert_allclose(_np(got.cpu()), _np(matmul_ref(a, b).cpu()),
                               **_tol(dtype))


_KERNEL_ATTN_CASES = [
    # hq, hkv, s, causal, window, cap
    (4, 4, 100, True, None, None),
    (8, 2, 100, False, 16, None),
    (4, 4, 100, True, None, 50.0),
    (8, 2, 130, True, 32, 30.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,path", [("float32", "simt"),
                                        ("bfloat16", "mma")])
@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("hq,hkv,s,causal,window,cap", _KERNEL_ATTN_CASES)
def test_attention_kernel_matches_plain(cuda_device, hq, hkv, s, causal,
                                        window, cap, d, dtype, path):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2, h, s, d, generator=g, device=cuda_device)
               .to(_TORCH[dtype]) for h in (hq, hkv, hkv))
    before = attention.launches
    before_path = attention.launches_by_path[path]
    got = attention(q, k, v, causal=causal, window=window, cap=cap)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert attention.launches_by_path[path] == before_path + 1
    ref = attention_ref(q, k, v, causal=causal, window=window, cap=cap)
    np.testing.assert_allclose(_np(got.cpu()), _np(ref.cpu()), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False), (True, True)],
                         ids=["fwd", "dgrad", "wgrad", "both"])
@pytest.mark.parametrize("m,n,k,dtype,pad,path", [
    (100, 200, 300, "float32", 0, "simt"),
    (100, 203, 301, "bfloat16", 1, "wmma"),
    (104, 208, 304, "bfloat16", 0, "wgmma"),
    (512, 4096, 1000, "bfloat16", 0, "wgmma"),
])
def test_tatp_dot_kernel_layouts_match_plain(cuda_device, m, n, k, dtype,
                                             pad, path, ta, tb):
    """The four operand layout pairs on every path, read in place."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def operand(rows, cols, transposed):
        shape = (cols, rows + pad) if transposed else (rows, cols + pad)
        t = torch.randn(shape, generator=g, device=cuda_device).to(
            _TORCH[dtype])
        return t[:, :rows].t() if transposed else t[:, :cols]

    a, b = operand(m, n, ta), operand(n, k, tb)
    before = tatp_dot.launches_by_path[path]
    got = tatp_dot(a, b)
    torch.cuda.synchronize()
    assert tatp_dot.launches_by_path[path] == before + 1
    np.testing.assert_allclose(_np(got.cpu()), _np(matmul_ref(a, b).cpu()),
                               **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 80, 128, 196, 256])
@pytest.mark.parametrize("hq,hkv,s,causal,window,cap", _KERNEL_ATTN_CASES)
def test_attention_backward_kernel_matches_plain(cuda_device, hq, hkv, s,
                                                 causal, window, cap, d,
                                                 dtype):
    """dQ, dK, dV of the backward kernel (through ``attention``'s autograd
    Function) against autograd through the plain version; D 196 pads to
    256 with rows that are not 16-byte aligned."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(2, h, s, d, generator=g, device=cuda_device)
                   .to(_TORCH[dtype]) for h in (hq, hkv, hkv, hq))
    kw = dict(causal=causal, window=window, cap=cap)
    before = flash_ops.attention_bwd.launches
    grads = []
    for fn in (attention, attention_ref):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves, **kw), leaves, do))
    torch.cuda.synchronize()
    assert flash_ops.attention_bwd.launches == before + 1
    for got, ref in zip(*grads):
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(_np(got.cpu()), _np(ref.cpu()),
                                   **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal,cap", [(True, None), (False, None),
                                        (True, 30.0)])
def test_attention_backward_outside_delta_matches_own(cuda_device, causal,
                                                      cap, d, dtype):
    """The backward kernel with an outside delta (``delta_in``, as ring
    attention's rounds call it) at degree 1: delta = rowsum(dO O) from an
    fp32 O gives the plain version's gradients with that delta and the
    kernel's own-delta gradients, within the dtype's tolerance."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v, do = (torch.randn(2, h, 96, d, generator=g, device=cuda_device)
                   .to(_TORCH[dtype]) for h in (4, 2, 2, 4))
    kw = dict(causal=causal, cap=cap)
    with torch.no_grad():
        o, lse = attention(q, k, v, return_lse=True, **kw)
        o32 = attention_ref(q.float(), k.float(), v.float(), **kw)
    delta = (do.float() * o32).sum(-1).contiguous()
    before = flash_ops.attention_bwd.launches_delta_in
    outside = flash_ops.attention_bwd(q, k, v, o, lse, do, delta=delta, **kw)
    own = flash_ops.attention_bwd(q, k, v, o, lse, do, **kw)
    plain = attention_bwd_ref(q, k, v, o, lse, do, delta=delta, **kw)
    torch.cuda.synchronize()
    assert flash_ops.attention_bwd.launches_delta_in == before + 1
    for got, a, b in zip(outside, plain, own):
        assert got.dtype == a.dtype
        for want in (a, b):
            np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()),
                                       **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,path", [("float32", "simt"),
                                        ("bfloat16", "mma")])
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("q_offset", [1, 63, 64, 100, 300])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 96),
                                           (False, 96)])
def test_attention_kernel_offset_matches_plain(cuda_device, causal, window,
                                               q_offset, d, dtype, path):
    """Query rows at r + q_offset across tile edges (130 queries, 200
    keys; at 300 with the window every key lies outside it): the kernel
    against the plain version, rows that see no key exactly 0 with an LSE
    at or below -1e29."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn(2, 8, 130, d, generator=g, device=cuda_device)
    k, v = (torch.randn(2, 2, 200, d, generator=g, device=cuda_device)
            for _ in range(2))
    q, k, v = (t.to(_TORCH[dtype]) for t in (q, k, v))
    kw = dict(causal=causal, window=window, cap=30.0, q_offset=q_offset,
              return_lse=True)
    before = attention.launches_by_path[path]
    got, lse = attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert attention.launches_by_path[path] == before + 1
    ref, ref_lse = attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(_np(got.cpu()), _np(ref.cpu()), **_tol(dtype))
    empty = ref_lse <= -1e29
    assert torch.equal(empty, lse <= -1e29)
    assert not got[empty].any() and torch.isfinite(got).all()
    live = ~empty
    np.testing.assert_allclose(_np(lse[live].cpu()), _np(ref_lse[live].cpu()),
                               **_tol(dtype))


@pytest.mark.cuda
def test_attention_kernel_refuses_a_negative_offset(cuda_device):
    """No caller needs a negative offset: the wrapper raises before any
    launch; an offset under autograd raises too, and so does one whose
    positions (a query tile's last one up to 63 rows past the last row)
    would pass 2**31 - 1.  At that limit the kernel runs: every key lies
    before every query, so causal attention is unmasked."""
    from repro_torch.kernels.flash_attention.ops import (Q_OFFSET_MAX,
                                                         _forward)

    q = torch.randn(1, 2, 16, 64, device=cuda_device)
    before = attention.launches
    with pytest.raises(ValueError, match="q_offset"):
        attention(q, q, q, q_offset=-1)
    with pytest.raises(ValueError, match="query offset"):
        attention(q.clone().requires_grad_(True), q, q, q_offset=4)
    with pytest.raises(ValueError, match="q_offset"):
        attention(q, q, q, q_offset=Q_OFFSET_MAX - 16 + 1)
    with pytest.raises(RuntimeError, match="launch failed"):  # the C check
        _forward(q, q, q, True, None, None, None, False,
                 q_offset=Q_OFFSET_MAX - 16 + 1)
    assert attention.launches == before
    got = attention(q, q, q, causal=True, q_offset=Q_OFFSET_MAX - 16)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    np.testing.assert_allclose(_np(got.cpu()), _np(attention_ref(
        q, q, q, causal=False).cpu()), **_tol("float32"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,path", [("float32", "simt"),
                                        ("bfloat16", "mma")])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("q_offset", [0, 1, 63, 100, 300])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 96),
                                           (False, 96)])
def test_attention_backward_kernel_offset_matches_plain(
        cuda_device, causal, window, q_offset, d, dtype, path):
    """The backward kernel with an outside delta at a query offset (130
    queries, 200 keys, GQA 4:1, cap 30; at 300 with the window every key
    lies outside it), as ring attention's rounds call it: against the plain
    version with the same delta; rows that see no key get dQ exactly 0,
    keys that no row sees dK and dV exactly 0."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, do = (torch.randn(2, 8, 130, d, generator=g, device=cuda_device)
             .to(_TORCH[dtype]) for _ in range(2))
    k, v = (torch.randn(2, 2, 200, d, generator=g, device=cuda_device)
            .to(_TORCH[dtype]) for _ in range(2))
    kw = dict(causal=causal, window=window, cap=30.0, q_offset=q_offset)
    with torch.no_grad():
        o, lse = attention(q, k, v, return_lse=True, **kw)
    # a ring round's row LSE and delta come from all of a row's keys: any
    # finite values stand for them
    lse = torch.where(lse <= -1e29, torch.zeros_like(lse), lse)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    before = flash_ops.attention_bwd.launches_by_path[path]
    got = flash_ops.attention_bwd(q, k, v, o, lse, do, delta=delta, **kw)
    torch.cuda.synchronize()
    assert flash_ops.attention_bwd.launches_by_path[path] == before + 1
    want = attention_bwd_ref(q, k, v, o, lse, do, delta=delta, **kw)
    qpos = q_offset + torch.arange(130, device=cuda_device)[:, None]
    kpos = torch.arange(200, device=cuda_device)[None, :]
    pairs = torch.ones(130, 200, dtype=torch.bool, device=cuda_device)
    if causal:
        pairs &= kpos <= qpos
    if window:
        pairs &= qpos - kpos < window
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(_np(a.cpu()), _np(b.cpu()), err_msg=name,
                                   **_tol(dtype))
        unseen = ~pairs.any(1) if name == "dq" else ~pairs.any(0)
        assert not a[:, :, unseen].any(), name


@pytest.mark.cuda
def test_attention_backward_kernel_refuses_offsets(cuda_device):
    """The backward's offset refusals: a negative one, one without an
    outside delta, and one past the limit, in the wrapper and (past the
    limit) in the C launcher; at the limit the kernel runs and matches the
    plain version."""
    from repro_torch.kernels.flash_attention.ops import Q_OFFSET_MAX

    q = torch.randn(1, 2, 16, 64, device=cuda_device)
    with torch.no_grad():
        o, lse = attention(q, q, q, return_lse=True)
    delta = (q * o).sum(-1).contiguous()
    bwd = flash_ops.attention_bwd
    before = bwd.launches
    for off, dl in ((-1, delta), (4, None), (Q_OFFSET_MAX - 16 + 1, delta)):
        with pytest.raises(ValueError, match="offset"):
            bwd(q, q, q, o, lse, q, delta=dl, q_offset=off)
    lib = flash_ops._bwd_lib()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    st = [s for t in (q, q, q, o, q, dq, dk, dv) for s in t.stride()[:3]]
    for off, din in ((Q_OFFSET_MAX - 16 + 1, 1), (4, 0)):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(),
            q.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), 1, 2, 2, 16, 16, 64, *st, 0.125, 1,
            0, off, 0.0, din, 0, 0,
            torch.cuda.current_stream(cuda_device).cuda_stream)
        assert err != 0, off
    assert bwd.launches == before
    got = bwd(q, q, q, o, lse, q, delta=delta, causal=True,
              q_offset=Q_OFFSET_MAX - 16)
    torch.cuda.synchronize()
    assert bwd.launches == before + 1
    want = attention_bwd_ref(q, q, q, o, lse, q, delta=delta, causal=True,
                             q_offset=Q_OFFSET_MAX - 16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a.cpu()), _np(b.cpu()),
                                   **_tol("float32"))


@pytest.mark.cuda
def test_kernel_wrappers_never_return_detached_outputs(cuda_device):
    """Under autograd the GEMM wrapper raises (training calls it through
    its autograd.Functions), and flash attention and the SSD run their
    Functions: the output has a grad_fn and the backward runs the
    backward kernel once, with finite gradients."""
    a = torch.randn(64, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        tatp_dot(a, a.detach())
    with torch.no_grad():
        assert tatp_dot(a, a).grad_fn is None
    q = torch.randn(1, 2, 16, 64, device=cuda_device, requires_grad=True)
    o = attention(q, q.detach(), q.detach())
    assert o.grad_fn is not None
    before = flash_ops.attention_bwd.launches
    o.sum().backward()
    assert flash_ops.attention_bwd.launches == before + 1
    assert q.grad is not None and torch.isfinite(q.grad).all()
    x = torch.randn(2, 8, 2, 16, device=cuda_device, requires_grad=True)
    dt = torch.rand(2, 8, 2, device=cuda_device)
    a_ = -torch.ones(2, device=cuda_device)
    bm = torch.randn(2, 8, 16, device=cuda_device)
    y, st, g = ssd_ops.ssd_intra_chunk(x, dt, a_, bm, bm)
    assert y.grad_fn is not None and st.grad_fn is not None
    before = ssd_ops.ssd_intra_chunk_bwd.launches
    (y.sum() + st.sum() + g.sum()).backward()
    assert ssd_ops.ssd_intra_chunk_bwd.launches == before + 1
    assert x.grad is not None and torch.isfinite(x.grad).all()
