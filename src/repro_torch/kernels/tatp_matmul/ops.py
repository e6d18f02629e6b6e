"""Public wrapper for the TATP per-round GEMM kernel (``csrc/tatp_matmul.cu``).

``tatp_dot`` is the drop-in for the ``dot`` hook of
:func:`repro_torch.core.tatp.ag_matmul_stream_w`, as
``repro.kernels.tatp_matmul.ops.tatp_dot`` is for the reference's.  For
tensors on the CPU it computes the plain version (:func:`matmul_ref`).  For
CUDA tensors it launches the hand-written kernel, which masks ragged edges
itself, so every shape runs on the kernel; anything the kernel does not
take raises.  There is no fallback on the GPU.

Each operand is read in place in one of two layouts, derived from its
strides by :func:`_operand`: rows contiguous (unit stride on the last dim,
as the forward's activations and weights) or transposed (unit stride on
the first dim, as the backward's ``w.T`` and ``x.T`` views).  The four
layout pairs are the forward (both rows), dgrad ``dy @ w.T`` (B
transposed) and wgrad ``x.T @ dy`` (A transposed), and both transposed;
every path takes all four.  Nothing is ever copied to make an operand
fit: a tensor with neither unit stride raises.

Which kernel runs is decided here, by :func:`_path`, a pure function of
the dtype, the operands' pitches and the pointers' alignment, and passed
to the launcher, which refuses (and this wrapper raises) if the path's
preconditions do not hold: ``"wgmma"`` (bf16 that TMA can describe:
16-byte aligned bases and pitches), ``"wmma"`` (any other bf16), ``"simt"``
(fp32).  Nothing is chosen by whether a build or a launch succeeded.

The wrapper is a forward function: on CUDA it raises when autograd would
need its gradient (grad mode on and an operand that requires grad), so a
kernel output is never silently detached.  Training reaches it through
the ``autograd.Function``s that call it for each product
(:func:`repro_torch.core.tatp.tatp_matmul`, the lm head).

``tatp_dot.launches`` counts the kernel's launches,
``tatp_dot.launches_by_path`` the same launches by path and
``tatp_dot.launches_by_layout`` by operand layout pair (``"fwd"``,
``"dgrad"``, ``"wgrad"``, ``"both"``: which of A and B were transposed).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tatp_matmul.ref import matmul_ref

# dtype and path codes shared with csrc/tatp_matmul.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"simt": 0, "wmma": 1, "wgmma": 2}

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


# operand layout codes shared with csrc/tatp_matmul.cu
ROWS, TRANSPOSED = 0, 1
# the products each layout pair serves, by (A's layout, B's layout)
_LAYOUT_PAIRS = {(ROWS, ROWS): "fwd", (ROWS, TRANSPOSED): "dgrad",
                 (TRANSPOSED, ROWS): "wgrad", (TRANSPOSED, TRANSPOSED): "both"}


def _lib():
    lib = _build.load("tatp_matmul")
    fn = lib.tatp_matmul_launch
    if fn.argtypes is None:  # else ctypes would pass 32-bit ints
        fn.argtypes = [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                       _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def _operand(shape, stride) -> tuple[int, int]:
    """(layout, pitch) of a 2-D operand of ``shape`` and ``stride``:
    ``ROWS`` with the stride between rows, or ``TRANSPOSED`` (unit stride
    on dim 0) with the stride between columns.  A dim of size 1 has no
    stride to honour; a lone row or column gets its length as pitch."""
    (r, c), (s0, s1) = shape, stride
    if s1 == 1 or c == 1:
        return ROWS, s0 if r > 1 else c
    if s0 == 1 or r == 1:
        return TRANSPOSED, s1 if c > 1 else r
    raise ValueError(
        f"tatp_matmul kernel needs unit stride on one dim of each operand, "
        f"got shape {tuple(shape)} strides {tuple(stride)}")


def _path(dtype, n, lda, ldb, a_ptr, b_ptr) -> str:
    """The kernel for operands of ``dtype`` with contraction ``n``,
    pitches ``lda``/``ldb`` (elements, in each operand's layout; see
    :func:`_operand`) at addresses ``a_ptr``/``b_ptr``."""
    if dtype == torch.float32:
        return "simt"
    if dtype != torch.bfloat16:
        raise ValueError(f"tatp_matmul kernel takes fp32 or bf16, got {dtype}")
    tma = (a_ptr % 16 == 0 and b_ptr % 16 == 0 and lda % 8 == 0
           and ldb % 8 == 0 and n >= 1)
    return "wgmma" if tma else "wmma"


# time of one 128 x 256 output tile over one 128 x 128 tile in the wgmma
# kernel, measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md)
_WIDE_TILE_COST = 1.7


def _tile_n(m, k, sms) -> int:
    """Output columns per block (128 or 256) of the persistent wgmma
    kernel for an ``m x k`` output on ``sms`` SMs: the one with the fewer
    waves of tiles, each wave weighted by its tile's cost; 128 on a tie."""
    def cost(tn, weight):
        tiles = -(-m // 128) * -(-k // tn)
        return -(-tiles // sms) * weight
    return 256 if cost(256, _WIDE_TILE_COST) < cost(128, 1.0) else 128


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tatp_dot(a: torch.Tensor, b: torch.Tensor, out_dtype=None):
    """``a[..., N] @ b[N, K]`` accumulated in fp32 and cast to
    ``out_dtype`` (default ``a.dtype``); the leading dims of ``a`` are
    flattened into the GEMM's M.

    On CUDA: both operands fp32 or both bf16, each with unit stride on one
    of its two (last) dims, output fp32 or bf16, allocated contiguous; not
    under autograd.
    """
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"tatp_matmul kernel needs both operands on one CUDA device, "
            f"got {a.device} and {b.device}"
        )
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise RuntimeError(
            "tatp_dot is not differentiable: under autograd call it through "
            "repro_torch.core.tatp.tatp_matmul (or another autograd.Function)"
        )
    if b.dim() != 2 or a.dim() < 1 or a.shape[-1] != b.shape[0]:
        raise ValueError(
            f"bad GEMM shapes {tuple(a.shape)} @ {tuple(b.shape)}"
        )
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise ValueError(
            f"tatp_matmul kernel takes fp32 or bf16 operands of one dtype, "
            f"got {a.dtype} and {b.dtype}"
        )
    if out_dtype not in _DTYPES:
        raise ValueError(f"tatp_matmul kernel cannot write {out_dtype}")
    n, k = b.shape
    # leading dims flattened as a view (raises rather than copies)
    a2 = a if a.dim() == 2 else a.view(-1, n)
    m = a2.shape[0]
    la, lda = _operand(a2.shape, a2.stride())
    lb, ldb = _operand(b.shape, b.stride())
    c = torch.empty((m, k), dtype=out_dtype, device=a.device)
    if m and k:
        path = _path(a.dtype, n, lda, ldb, a2.data_ptr(), b.data_ptr())
        lib = _lib()
        err = lib.tatp_matmul_launch(
            a2.data_ptr(), b.data_ptr(), c.data_ptr(),
            m, n, k, lda, ldb, c.stride(0), la, lb,
            _DTYPES[a.dtype], _DTYPES[out_dtype], _PATHS[path],
            _tile_n(m, k, _sm_count(a.device.index)),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
        _build.check(lib, err, f"tatp_matmul ({path})")
        tatp_dot.launches += 1
        tatp_dot.launches_by_path[path] += 1
        tatp_dot.launches_by_layout[_LAYOUT_PAIRS[la, lb]] += 1
    return c.reshape(*a.shape[:-1], k)


tatp_dot.launches = 0
tatp_dot.launches_by_path = dict.fromkeys(_PATHS, 0)
tatp_dot.launches_by_layout = dict.fromkeys(_LAYOUT_PAIRS.values(), 0)
