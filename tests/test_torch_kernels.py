"""repro_torch kernels: the plain PyTorch versions against the reference's
Pallas kernels (interpret mode) and jnp oracles, the wrappers' CPU path,
and (on a machine with an NVIDIA GPU and nvcc) the CUDA kernels against
their plain versions.

Inputs are made with numpy from a seed and fed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.kernels.tatp_matmul.kernel import matmul as pallas_matmul
from repro.kernels.tatp_matmul.ref import matmul_ref as jax_matmul_ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import attention_ref
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
@pytest.mark.parametrize("m,n,k,dtype", [(100, 200, 300, "float32"),
                                         (512, 4096, 1000, "bfloat16"),
                                         (77, 256, 11008, "bfloat16")])
def test_tatp_dot_kernel_matches_plain(cuda_device, m, n, k, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(m, n, generator=g, device=cuda_device).to(_TORCH[dtype])
    b = torch.randn(n, k, generator=g, device=cuda_device).to(_TORCH[dtype])
    before = tatp_dot.launches
    got = tatp_dot(a, b)
    torch.cuda.synchronize()
    assert tatp_dot.launches == before + 1
    np.testing.assert_allclose(_np(got.cpu()), _np(matmul_ref(a, b).cpu()),
                               **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,s,d,causal,window,cap", [
    (4, 4, 100, 64, True, None, None),
    (8, 2, 100, 128, False, 16, None),
    (4, 4, 100, 256, True, None, 50.0),
])
def test_attention_kernel_matches_plain(cuda_device, hq, hkv, s, d, causal,
                                        window, cap):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(2, hq, s, d, generator=g, device=cuda_device)
    k = torch.randn(2, hkv, s, d, generator=g, device=cuda_device)
    v = torch.randn(2, hkv, s, d, generator=g, device=cuda_device)
    before = attention.launches
    got = attention(q, k, v, causal=causal, window=window, cap=cap)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    ref = attention_ref(q, k, v, causal=causal, window=window, cap=cap)
    np.testing.assert_allclose(_np(got.cpu()), _np(ref.cpu()), rtol=1e-3,
                               atol=1e-3)
