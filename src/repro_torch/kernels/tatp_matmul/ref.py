"""Plain PyTorch version of the TATP per-round GEMM (counterpart of
``repro.kernels.tatp_matmul.ref``): a product accumulated in fp32 and cast
to ``out_dtype`` (default: ``a``'s dtype)."""

import torch


def matmul_ref(a, b, out_dtype=None):
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)
