"""The bf16 flash backward's plain version against the reference's
gradient at a biting soft-cap, on the CPU.

``attention_bwd_ref`` runs on ``attention_ref``'s own bf16 output and row
log-sum-exp, as the kernel runs on the forward's.  The reference is
``jax.vjp`` of ``repro.models.attention.local_attention``, which computes
in fp32 throughout and never reads a rounded output.  With q scaled by
twice the cap the capped softmax is nearly one-hot, so dS = P (dP - delta)
cancels: a delta formed from the bf16 output puts its rounding (10-40 % of
dQ's RMS) into the gradient, while delta = rowsum(P dP) in fp32 stays
within an ulp.  Uncapped, that rounding still adds delta's error times the
P-weighted mean of K to each dQ row (~5 % of dQ's RMS in the causal case
here), which the tolerance below does not admit either.  The same inputs also run through ``attention`` in grad mode
(its autograd Function's CPU path).  Inputs are bf16 values made with numpy
from a seed; the port's [B, H, S, D] against the reference's [B, S, H, D].

Tolerance: 2 bf16 ulps of each gradient's RMS (an ulp of x is
2^(floor(log2 x) - 7)), absolute, plus one bf16 ulp of each element
relative (2^-8), since both sides round their fp32 gradient to bf16 and
two values a hair apart can round to neighbours."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

BF16_RTOL = 2.0 ** -8


def _ulp(x):
    """One bf16 ulp at magnitude ``x``."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _inputs(seed, b, hq, hkv, s, d, q_scale):
    """q, k, v, do as numpy fp32 arrays of bf16 values, [B, S, H, D]."""
    rng = np.random.RandomState(seed)

    def bf16(shape, scale=1.0):
        x = torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()

    return (bf16((b, s, hq, d), q_scale), bf16((b, s, hkv, d)),
            bf16((b, s, hkv, d)), bf16((b, s, hq, d)))


def _torch(a):
    return torch.from_numpy(a).to(torch.bfloat16).transpose(1, 2)


@pytest.mark.parametrize("how", ["attention_bwd_ref", "attention"])
@pytest.mark.parametrize("hq,hkv,s,d,cap,q_scale", [
    (4, 2, 64, 64, 30.0, 60.0),   # cap 30, q x 2 cap: nearly one-hot
    (4, 2, 48, 256, 30.0, 60.0),  # the same at gemma's head dim
    (4, 2, 64, 64, None, 1.0),    # uncapped
], ids=["cap30-d64", "cap30-d256", "nocap-d64"])
def test_bf16_backward_matches_reference(hq, hkv, s, d, cap, q_scale, how):
    q, k, v, do = _inputs(5, 2, hq, hkv, s, d, q_scale)
    kw = dict(causal=True, window=None, cap=cap)
    _, vjp = jax.vjp(
        lambda q, k, v: jattn.local_attention(q, k, v, **kw),
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jnp.bfloat16))
    qt, kt, vt, dot = (_torch(a) for a in (q, k, v, do))
    if how == "attention_bwd_ref":
        o, lse = attention_ref(qt, kt, vt, return_lse=True, **kw)
        assert o.dtype == torch.bfloat16
        got = attention_bwd_ref(qt, kt, vt, o, lse, dot, **kw)
    else:
        leaves = [t.requires_grad_(True) for t in (qt, kt, vt)]
        with torch.enable_grad():
            out = attention(*leaves, **kw)
        assert "FlashAttention" in type(out.grad_fn).__name__
        got = torch.autograd.grad(out, leaves, dot)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        g = g.transpose(1, 2).float().numpy()
        r = np.asarray(r.astype(jnp.float32))
        rms = float(np.sqrt(np.mean(r ** 2)))
        atol = 2 * _ulp(rms)
        err = np.abs(g - r)
        assert np.all(err <= atol + BF16_RTOL * np.abs(r)), (
            f"{name}: max err {err.max():.3g}, RMS {rms:.3g}, atol "
            f"{atol:.3g}")
