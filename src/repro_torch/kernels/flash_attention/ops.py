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

Under autograd (grad mode on and an input that requires grad),
:func:`attention` runs through an ``autograd.Function``: the forward also
writes each row's log-sum-exp, and the backward is the hand-written backward
kernel (:func:`attention_bwd`: dQ, dK and dV in q/k/v's dtype with fp32
accumulation, no atomics, so deterministic).  It takes the forward's path,
:func:`_path`: ``"mma"`` (bf16 on the tensor cores:
``wgmma`` at D 256, to which 128 < D < 256 is padded, and at D 80 and 128 with
16-byte aligned rows, ``mma.sync`` otherwise; delta = rowsum(dO O) formed from
P and dP in fp32, not from the rounded O) or ``"simt"`` (fp32 on the CUDA
cores).  For CPU tensors the same Function runs the plain versions of both
(:func:`attention_ref` with its log-sum-exp, and
:func:`attention_bwd_ref`).  Under the ``tatp_outputs`` remat policy the
Function saves its output and log-sum-exp (:mod:`repro_torch.core.remat`) and
the recompute builds its node from them, so no forward runs again.

``attention.launches`` counts the forward kernel's launches and
``attention.launches_by_path`` the same launches by path;
``attention_bwd.launches`` and ``attention_bwd.launches_by_path`` count
the backward's (one per backward call, which runs two kernels on the
tensor cores or three on the CUDA cores; two with an outside ``delta``).

Ring attention (``models/attention.py``) calls the forward with
``return_lse=True`` outside autograd and, in its own ``autograd.Function``,
:func:`attention_bwd` once a visible round with the ring's global row LSE
and an outside delta; a direct ``return_lse`` call under autograd raises.
Its rounds pass ``q_offset``, the first query's position past the first
key's, so the causal and window masks compare global positions, in the
forward and in its backward calls (which always bring an outside delta).
:func:`attention` under autograd is one whole attention, whose rows start at
its keys' start: a nonzero offset there raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import remat
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

# dtype and path codes shared with csrc/flash_attention.cuh
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"simt": 0, "mma": 1}
MAX_HEAD_DIM = 256
# the largest Sq + q_offset the kernels take: a query tile's last position
# (up to 63 rows past Sq - 1) stays below 2**31
Q_OFFSET_MAX = 2 ** 31 - 1 - 64

_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
    ctypes.c_float


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:  # else ctypes would pass 32-bit ints
        fn.argtypes = ([_P] * 5 + [_I] * 6 + [_I64] * 12
                       + [_F, _I, _I, _I, _F, _I, _I, _P])
        fn.restype = _I
    return lib


def _bwd_lib():
    """The backward's library (``csrc/flash_attention_bwd.cu``, built
    beside the forward's so the two compile in parallel)."""
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 10 + [_I] * 6 + [_I64] * 24
                       + [_F, _I, _I, _I, _F, _I, _I, _I, _P])
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


def attention(q, k, v, *, causal=True, window=None, cap=None, scale=None,
              return_lse=False, q_offset: int = 0):
    """q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D] -> [B, Hq, Sq, D].

    On CUDA: q/k/v one dtype (fp32 or bf16), unit stride on D, D <= 256,
    Hq a multiple of Hkv, ``q_offset`` >= 0.  The output has q's dtype and
    q's memory layout.  Under autograd the backward runs on the backward
    kernel.  With ``return_lse`` (not under autograd) it returns ``(o,
    lse)``, ``lse`` each row's fp32 log-sum-exp of the scaled (capped)
    scores, [B, Hq, Sq]: ring attention merges its rounds' outputs with
    it.  ``q_offset``: query row ``r`` sits at position ``r + q_offset``
    against key ``c`` at ``c`` in the causal and window masks; a row that
    sees no key gives 0 and an LSE of about -1e30.
    """
    cpu = all(t.device.type == "cpu" for t in (q, k, v))
    if not cpu:
        _check(q, k, v, window, cap, q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if return_lse:  # the ring's Function reaches the backward itself
            raise ValueError("the row LSE under autograd is reached "
                             "through ring attention's Functions")
        if q_offset:  # only ring attention's rounds pass one
            raise ValueError("attention under autograd takes no query "
                             "offset: a ring round's backward is reached "
                             "through ring attention's Functions")
        return _FlashAttention.apply(q, k, v, causal, window, cap, scale)
    if cpu:
        return attention_ref(q, k, v, causal=causal, window=window, cap=cap,
                             scale=scale, return_lse=return_lse,
                             q_offset=q_offset)
    o, lse = _forward(q, k, v, causal, window, cap, scale,
                      want_lse=return_lse, q_offset=q_offset)
    return (o, lse) if return_lse else o


def _check(q, k, v, window, cap, q_offset=0):
    """Raise on what the kernels do not take (for CUDA tensors)."""
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
    if not 0 <= q_offset <= Q_OFFSET_MAX - sq:  # positions stay ints
        raise ValueError(
            f"flash_attention kernel takes 0 <= q_offset <= "
            f"{Q_OFFSET_MAX} - Sq, got q_offset={q_offset}"
        )
    _path(q.dtype, d)


def _forward(q, k, v, causal, window, cap, scale, want_lse, q_offset=0):
    """One forward launch on checked tensors: (o, lse or None)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    path = _path(q.dtype, d)
    o = torch.empty_like(q)  # q's layout when q is dense, else contiguous
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if o.numel() == 0:
        return o, lse
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        0 if lse is None else lse.data_ptr(),
        b, hq, hkv, sq, skv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        float(scale), int(bool(causal)),
        0 if window is None else int(window), int(q_offset),
        0.0 if cap is None else float(cap),
        _DTYPES[q.dtype], _PATHS[path],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, f"flash_attention ({path})")
    attention.launches += 1
    attention.launches_by_path[path] += 1
    return o, lse


def attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None,
                  cap=None, scale=None, delta=None, q_offset: int = 0):
    """(dq, dk, dv) of :func:`attention` at ``do`` (o's shape), from the
    forward's ``o`` and ``lse`` ([B, Hq, Sq] fp32, contiguous), on the
    backward kernel.  CUDA tensors only; the gradients take q's, k's and
    v's dtypes and layouts.

    ``delta`` (a contiguous fp32 [B, Hq, Sq], rowsum(dO O) over all of a
    row's keys): the kernel reads it instead of forming its own (the C
    interface's ``delta_in``), so ``lse`` and ``delta`` may be a whole
    row's while ``k``/``v`` are one block of its keys, as in a ring
    attention round.  ``attention_bwd.launches_delta_in`` counts those
    calls.  ``q_offset`` (with ``delta`` only: a ring round's launch) as
    :func:`attention`'s: query row ``r`` at ``r + q_offset`` against key
    ``c`` at ``c``; a row that sees no key gets dQ 0, a key that no row
    sees dK and dV 0."""
    _check(q, k, v, window, cap, q_offset)
    if q_offset and delta is None:
        raise ValueError("the flash backward takes a query offset only with "
                         "an outside delta (a ring round's launch)")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o{tuple(o.shape)} / do{tuple(do.shape)} do not "
                         f"match q{tuple(q.shape)}")
    if do.dtype != q.dtype or o.dtype != q.dtype:
        raise ValueError(f"o and do must have q's dtype {q.dtype}")
    if o.stride(3) != 1 or do.stride(3) != 1:
        raise ValueError("flash_attention backward needs unit stride on D")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq)
            or not lse.is_contiguous()):
        raise ValueError("lse must be a contiguous fp32 [B, Hq, Sq]")
    if delta is not None and (delta.dtype != torch.float32
                              or tuple(delta.shape) != (b, hq, sq)
                              or not delta.is_contiguous()
                              or delta.device != q.device):
        raise ValueError("delta must be a contiguous fp32 [B, Hq, Sq] on "
                         "q's device")
    path = _path(q.dtype, d)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta_in = delta is not None
    if not delta_in:
        delta = torch.empty((b, hq, sq), dtype=torch.float32,
                            device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    lib = _bwd_lib()
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, skv, d,
        *(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]),
        float(scale), int(bool(causal)),
        0 if window is None else int(window), int(q_offset),
        0.0 if cap is None else float(cap), int(delta_in),
        _DTYPES[q.dtype], _PATHS[path],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, f"flash_attention backward ({path})")
    attention_bwd.launches += 1
    attention_bwd.launches_by_path[path] += 1
    attention_bwd.launches_delta_in += delta_in
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """:func:`attention` under autograd: the forward kernel with the row
    log-sum-exp saved, the backward kernel for the gradients (for CPU
    tensors their plain versions).  Under ``tatp_outputs`` the recompute
    takes the first pass's (o, lse) instead of running the forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, scale):
        opts = dict(causal=causal, window=window, cap=cap, scale=scale)

        def run():
            if q.device.type == "cpu":
                return attention_ref(q, k, v, return_lse=True, **opts)
            return _forward(q, k, v, causal, window, cap, scale,
                            want_lse=True)

        o, lse = remat.saved_or_run("attention", run)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = opts
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(3) != 1:
            do = do.contiguous()
        bwd = attention_bwd_ref if q.device.type == "cpu" else attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None


attention.launches = 0
attention.launches_by_path = dict.fromkeys(_PATHS, 0)
attention_bwd.launches = 0
attention_bwd.launches_by_path = dict.fromkeys(_PATHS, 0)
attention_bwd.launches_delta_in = 0
