"""Public wrapper for the TATP per-round GEMM kernel (``csrc/tatp_matmul.cu``).

``tatp_dot`` is the drop-in for the ``dot`` hook of
:func:`repro_torch.core.tatp.ag_matmul_stream_w`, as
``repro.kernels.tatp_matmul.ops.tatp_dot`` is for the reference's.  For
tensors on the CPU it computes the plain version (:func:`matmul_ref`).  For
CUDA tensors it launches the hand-written kernel, which masks ragged edges
itself, so every shape runs on the kernel; anything the kernel does not
take raises.  There is no fallback on the GPU.

``tatp_dot.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tatp_matmul.ref import matmul_ref

# dtype codes shared with csrc/tatp_matmul.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _lib():
    lib = _build.load("tatp_matmul")
    fn = lib.tatp_matmul_launch
    if fn.argtypes is None:  # else ctypes would pass 32-bit ints
        fn.argtypes = [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                       _I, _I, _P]
        fn.restype = _I
    return lib


def tatp_dot(a: torch.Tensor, b: torch.Tensor, out_dtype=None):
    """``a[..., N] @ b[N, K]`` accumulated in fp32 and cast to
    ``out_dtype`` (default ``a.dtype``); the leading dims of ``a`` are
    flattened into the GEMM's M.

    On CUDA: both operands fp32 or both bf16, unit column stride (any row
    stride), output fp32 or bf16, allocated contiguous.
    """
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"tatp_matmul kernel needs both operands on one CUDA device, "
            f"got {a.device} and {b.device}"
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
    a2 = a.reshape(-1, n)  # a view for the activations the model passes
    if a2.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError("tatp_matmul kernel needs unit column stride")
    m = a2.shape[0]
    c = torch.empty((m, k), dtype=out_dtype, device=a.device)
    if m and k:
        lib = _lib()
        err = lib.tatp_matmul_launch(
            a2.data_ptr(), b.data_ptr(), c.data_ptr(),
            m, n, k, a2.stride(0), b.stride(0), c.stride(0),
            _DTYPES[a.dtype], _DTYPES[out_dtype],
            torch.cuda.current_stream(a.device).cuda_stream,
        )
        _build.check(lib, err, "tatp_matmul")
        tatp_dot.launches += 1
    return c.reshape(*a.shape[:-1], k)


tatp_dot.launches = 0
