"""Public wrapper for the flash-attention kernel (``csrc/flash_attention.cu``).

``attention`` keeps the reference's ``[B, H, S, D]`` layout
(``repro.kernels.flash_attention.ops.attention``).  For tensors on the CPU
it computes the plain version (:func:`attention_ref`).  For CUDA tensors
it launches the hand-written kernel, which takes any batch/head/sequence
strides (so ``[B, S, H, D]`` activations viewed as ``[B, H, S, D]`` need no
copy) and masks ragged sequence edges itself; anything the kernel does not
take raises.  There is no fallback on the GPU.

The kernel is chosen here, by :func:`_path`, a pure function of dtype and
head dim, and passed to the launcher, which refuses (and this wrapper
raises) if its preconditions do not hold: ``"mma"`` (bf16 on the tensor
cores, ``mma.sync``) or ``"simt"`` (fp32 on the CUDA cores, true fp32
products).  Nothing is chosen by whether a build or a launch succeeded.

``attention.launches`` counts the kernel's launches and
``attention.launches_by_path`` the same launches by path.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

# dtype and path codes shared with csrc/flash_attention.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"simt": 0, "mma": 1}
MAX_HEAD_DIM = 256

_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
    ctypes.c_float


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:  # else ctypes would pass 32-bit ints
        fn.argtypes = ([_P] * 4 + [_I] * 6 + [_I64] * 12
                       + [_F, _I, _I, _F, _I, _I, _P])
        fn.restype = _I
    return lib


def _path(dtype, d) -> str:
    """The kernel for q/k/v of ``dtype`` and head dim ``d``."""
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes D <= 256, got {d}")
    if dtype == torch.bfloat16:
        return "mma"
    if dtype == torch.float32:
        return "simt"
    raise ValueError(
        f"flash_attention kernel takes fp32 or bf16 q/k/v, got {dtype}")


def attention(q, k, v, *, causal=True, window=None, cap=None, scale=None):
    """q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D] -> [B, Hq, Sq, D].

    On CUDA: q/k/v one dtype (fp32 or bf16), unit stride on D, D <= 256,
    Hq a multiple of Hkv.  The output has q's dtype and q's memory layout.
    """
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_ref(q, k, v, causal=causal, window=window, cap=cap,
                             scale=scale)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(
            f"flash_attention kernel needs q/k/v on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"bad attention shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)}"
        )
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(
            f"q{tuple(q.shape)} does not match k/v{tuple(k.shape)} "
            f"(Hq must be a multiple of Hkv)"
        )
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention kernel takes fp32 or bf16 q/k/v of one dtype, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention kernel needs unit stride on D")
    if (window is not None and window <= 0) or (cap is not None and cap <= 0):
        raise ValueError(
            f"flash_attention kernel takes window > 0 and cap > 0, got "
            f"window={window}, cap={cap}"
        )
    path = _path(q.dtype, d)
    o = torch.empty_like(q)  # q's layout when q is dense, else contiguous
    if o.numel() == 0:
        return o
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, hq, hkv, sq, skv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        float(scale), int(bool(causal)),
        0 if window is None else int(window),
        0.0 if cap is None else float(cap),
        _DTYPES[q.dtype], _PATHS[path],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, f"flash_attention ({path})")
    attention.launches += 1
    attention.launches_by_path[path] += 1
    return o


attention.launches = 0
attention.launches_by_path = dict.fromkeys(_PATHS, 0)
