"""Public wrappers for the Mamba-2 SSD intra-chunk kernel (``csrc/ssd.cu``)
and its backward kernel (``csrc/ssd_bwd.cu``).

:func:`ssd_intra_chunk` keeps the reference's layout
(``repro.kernels.ssd.kernel.ssd_intra_chunk``): the caller has already cut
the sequence into chunks, so its batch axis is ``B * nc``.  For tensors on
the CPU it computes the plain version (:func:`ssd_intra_chunk_ref`), and
autograd differentiates that.  For CUDA tensors it launches the
hand-written kernel, which reads its inputs through their strides (unit
stride on the last dim) and masks ragged edges itself; anything the
kernel does not take raises.  There is no fallback on the GPU, at any
chunk or head size.

For CUDA tensors under autograd (grad mode on and an input that requires
grad), :func:`ssd_intra_chunk` runs through an ``autograd.Function``: the
forward kernel, with the fp32 inputs saved, and the backward kernel
(:func:`ssd_intra_chunk_bwd`; no atomics, so the gradients are
deterministic).  The reference has no backward kernel: JAX differentiates
its jnp path; the backward's math is :func:`ssd_intra_chunk_bwd_ref`.

:func:`ssd_chunked` is the counterpart of
``repro.kernels.ssd.ops.ssd_chunked_fast``: the intra-chunk pass on the
kernel, then the inter-chunk recurrence and its output contraction in
torch (the reference also computes those outside its Pallas call), which
autograd differentiates around the Function.

``ssd_intra_chunk.launches`` counts the forward kernel's launches and
``ssd_intra_chunk_bwd.launches`` the backward's (one per backward call,
which runs its two kernels).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd.ref import (ssd_intra_chunk_bwd_ref,
                                         ssd_intra_chunk_ref)
from repro_torch.models.ssm import SSDOut, check_chunking, chunk_recurrence

MAX_HEAD_DIM = 64  # P
MAX_STATE = 256  # N

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _lib():
    lib = _build.load("ssd")
    fn = lib.ssd_intra_chunk_launch
    if fn.argtypes is None:  # else ctypes would pass 32-bit ints
        fn.argtypes = [_P] * 8 + [_I] * 5 + [_I64] * 9 + [_P]
        fn.restype = _I
    return lib


def _bwd_lib():
    lib = _build.load("ssd_bwd")
    fn = lib.ssd_intra_chunk_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 15 + [_I] * 5 + [_I64] * 9 + [_P]
        fn.restype = _I
        lib.ssd_intra_chunk_bwd_sizes.argtypes = [_I, _I, _I, _I, _P]
        lib.ssd_intra_chunk_bwd_sizes.restype = None
    return lib


def _unit_last(t):
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_intra_chunk(x, dt, a, bmat, cmat):
    """x: [B, Q, H, P] · dt: [B, Q, H] · a: [H] · bmat/cmat: [B, Q, N],
    one chunk per batch row.  Returns (y_intra [B,Q,H,P], states
    [B,H,P,N], decays [B,H]), fp32.

    On CUDA: fp32 inputs on one device, P <= 64, N <= 256.  Under
    autograd the backward runs on the backward kernel.
    """
    ts = (x, dt, a, bmat, cmat)
    if all(t.device.type == "cpu" for t in ts):
        return ssd_intra_chunk_ref(x, dt, a, bmat, cmat)
    _check(x, dt, a, bmat, cmat)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return _SSDIntraChunk.apply(x, dt, a, bmat, cmat)
    return _forward(x, dt, a, bmat, cmat)


def _check(x, dt, a, bmat, cmat):
    """Raise on what the kernels do not take (for CUDA tensors)."""
    ts = (x, dt, a, bmat, cmat)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(
            f"ssd kernel needs every input on one CUDA device, got "
            f"{[str(t.device) for t in ts]}"
        )
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(
            f"ssd kernel takes fp32 inputs, got {[t.dtype for t in ts]}"
        )
    if x.dim() != 4:
        raise ValueError(f"ssd kernel: x must be [B, Q, H, P], got "
                         f"{tuple(x.shape)}")
    b, q, h, p = x.shape
    n = bmat.shape[-1]
    if (tuple(dt.shape) != (b, q, h) or tuple(a.shape) != (h,)
            or tuple(bmat.shape) != (b, q, n)
            or tuple(cmat.shape) != (b, q, n)):
        raise ValueError(
            f"ssd kernel: shapes do not match x{tuple(x.shape)}: "
            f"dt{tuple(dt.shape)} a{tuple(a.shape)} B{tuple(bmat.shape)} "
            f"C{tuple(cmat.shape)}"
        )
    if not (0 < p <= MAX_HEAD_DIM and 0 < n <= MAX_STATE and q > 0):
        raise ValueError(
            f"ssd kernel takes 0 < P <= {MAX_HEAD_DIM} and 0 < N <= "
            f"{MAX_STATE} and Q > 0, got Q={q}, P={p}, N={n}"
        )


def _forward(x, dt, a, bmat, cmat):
    """One forward launch on checked tensors."""
    b, q, h, p = x.shape
    n = bmat.shape[-1]
    dev = x.device
    x, dt, bmat, cmat = (_unit_last(t) for t in (x, dt, bmat, cmat))
    a = a.contiguous()
    y = torch.empty((b, q, h, p), dtype=torch.float32, device=dev)
    st = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    g = torch.empty((b, h), dtype=torch.float32, device=dev)
    if b and h:
        _launch(x, dt, a, bmat, cmat, y, st, g,
                torch.cuda.current_stream(dev).cuda_stream)
        ssd_intra_chunk.launches += 1
    return y, st, g


ssd_intra_chunk.launches = 0


def _launch(x, dt, a, bmat, cmat, y, st, g, stream: int):
    """One launch on checked tensors (unit stride on every last dim,
    outputs contiguous)."""
    b, q, h, p = x.shape
    lib = _lib()
    err = lib.ssd_intra_chunk_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), y.data_ptr(), st.data_ptr(), g.data_ptr(),
        b, q, h, p, bmat.shape[-1],
        *x.stride()[:3], *dt.stride()[:2], *bmat.stride()[:2],
        *cmat.stride()[:2], stream,
    )
    _build.check(lib, err, "ssd")


def ssd_intra_chunk_bwd(x, dt, a, bmat, cmat, dy=None, dst=None, dg=None):
    """The gradients (dx [B,Q,H,P], ddt [B,Q,H], da [H], dB [B,Q,N], dC
    [B,Q,N]) of :func:`ssd_intra_chunk` at the cotangents dy [B,Q,H,P],
    dst [B,H,P,N] and dg [B,H] (each may be ``None``, read as zero), fp32.
    For tensors on the CPU the plain version
    (:func:`ssd_intra_chunk_bwd_ref`); for CUDA tensors the backward
    kernel, which takes what the forward kernel takes."""
    ts = (x, dt, a, bmat, cmat)
    if all(t.device.type == "cpu" for t in ts):
        return ssd_intra_chunk_bwd_ref(x, dt, a, bmat, cmat, dy, dst, dg)
    _check(x, dt, a, bmat, cmat)
    b, q, h, p = x.shape
    n = bmat.shape[-1]
    dev = x.device
    cots = []
    shapes = {"dy": (b, q, h, p), "dst": (b, h, p, n), "dg": (b, h)}
    for (name, shape), t in zip(shapes.items(), (dy, dst, dg)):
        if t is None:
            t = torch.zeros(shape, dtype=torch.float32, device=dev)
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(
                f"ssd backward: {name} must be fp32 {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
        cots.append(t.contiguous())
    x, dt, bmat, cmat = (_unit_last(t) for t in (x, dt, bmat, cmat))
    a = a.contiguous()
    dx = torch.empty((b, q, h, p), dtype=torch.float32, device=dev)
    ddt = torch.empty((b, q, h), dtype=torch.float32, device=dev)
    if not (b and h):
        return (dx, ddt, torch.zeros(h, device=dev),
                torch.zeros((b, q, n), device=dev),
                torch.zeros((b, q, n), device=dev))
    lib = _bwd_lib()
    sizes = (ctypes.c_int64 * 2)()
    lib.ssd_intra_chunk_bwd_sizes(b, q, h, n, sizes)
    n_scratch, n_count = sizes
    da = torch.empty(h, dtype=torch.float32, device=dev)
    db, dc = (torch.empty((b, q, n), dtype=torch.float32, device=dev)
              for _ in range(2))
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    count = torch.zeros(n_count, dtype=torch.int32, device=dev)
    err = lib.ssd_intra_chunk_bwd_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), *(t.data_ptr() for t in cots), dx.data_ptr(),
        ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
        scratch.data_ptr(), count.data_ptr(), b, q, h, p, n,
        *x.stride()[:3], *dt.stride()[:2], *bmat.stride()[:2],
        *cmat.stride()[:2], torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "ssd backward")
    ssd_intra_chunk_bwd.launches += 1
    return dx, ddt, da, db, dc


ssd_intra_chunk_bwd.launches = 0


class _SSDIntraChunk(torch.autograd.Function):
    """:func:`ssd_intra_chunk` on CUDA under autograd: the forward kernel
    with its fp32 inputs saved, the backward kernel for the gradients."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat):
        ctx.save_for_backward(x, dt, a, bmat, cmat)
        return _forward(x, dt, a, bmat, cmat)

    @staticmethod
    def backward(ctx, dy, dst, dg):
        return ssd_intra_chunk_bwd(*ctx.saved_tensors, dy, dst, dg)


def ssd_chunked(x, dt, a, bmat, cmat, chunk: int) -> SSDOut:
    """Chunked SSD with the intra-chunk pass on the kernel; see
    :func:`repro_torch.models.ssm.ssd_chunked` for the semantics.  The
    sequence length must be a multiple of ``chunk`` (never padded)."""
    b, l, h, p = x.shape
    n = bmat.shape[-1]
    nc = check_chunking(l, chunk)
    # [B, L, ...] -> [B * nc, chunk, ...]: views for the model's strided
    # slices, so the kernel reads them in place
    y_i, st, g = ssd_intra_chunk(
        x.reshape(b * nc, chunk, h, p), dt.reshape(b * nc, chunk, h), a,
        bmat.reshape(b * nc, chunk, n), cmat.reshape(b * nc, chunk, n))
    y_i = y_i.reshape(b, nc, chunk, h, p)
    st = st.reshape(b, nc, h, p, n)
    g = g.reshape(b, nc, h)

    h0 = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    hprevs, hfin = chunk_recurrence(g, st, h0)
    da = dt.float() * a[None, None, :]
    cum = torch.cumsum(da.reshape(b, nc, chunk, h), dim=2)
    y_x = torch.einsum("bcqn,bcqh,bchpn->bcqhp",
                       cmat.reshape(b, nc, chunk, n).float(),
                       torch.exp(cum), hprevs)
    y = (y_i + y_x).reshape(b, l, h, p)
    total_decay = torch.exp(torch.sum(da, dim=1))
    return SSDOut(y, hfin, total_decay)
