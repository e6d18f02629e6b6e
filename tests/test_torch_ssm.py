"""The repro_torch SSM slice against repro on the CPU: the SSD kernel's
plain version against the Pallas kernel (interpret mode) and the jnp
oracle, the SSD's plain backward against autograd and ``jax.vjp``, the
chunked SSD, the SSM decode step and convs, the Mamba-2 block on
converted weights, the reduced mamba2-780m and zamba2-2.7b models
(prefill plus greedy decode) and their one-shot serve, and the SSM leaves
of ``init_params``; on a machine with an NVIDIA GPU and nvcc, the SSD
kernel and its backward kernel against their plain versions.

Reduced configs (fp32): mamba2-780m 2 x ``M``, zamba2-2.7b ``MMS`` (d_model
64, d_inner 128, 8 SSM heads of 16, state 16, chunk 8).  Inputs are made
with numpy from a seed and fed to both packages."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.configs.base import ParallelConfig as JaxPar
from repro.core.dist import Dist as JaxDist
from repro.core.dist import make_mesh
from repro.kernels.ssd.kernel import ssd_intra_chunk as pallas_ssd
from repro.kernels.ssd.ref import ssd_intra_chunk_ref as jax_ssd_ref
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.dist import Dist
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import (ssd_intra_chunk_bwd_ref,
                                         ssd_intra_chunk_ref)
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.weights import params_from_jax

ARCHS = ("mamba2-780m", "zamba2-2.7b")
# logits and caches after a whole model: fp32, different summation order
MODEL_TOL = dict(rtol=5e-4, atol=5e-4)
# one module: fp32, different summation order
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(got, ref, **kw):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), **{**TOL, **kw})


def _ssd_inputs(rng, b, q, h, p, n):
    return (rng.randn(b, q, h, p), np.abs(rng.randn(b, q, h)) * 0.1,
            -(np.abs(rng.randn(h)) + 0.1), rng.randn(b, q, n),
            rng.randn(b, q, n))


# ---------------------------------------------------------------------------
# the SSD intra-chunk kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,p,n", [(8, 16, 16), (16, 64, 32), (8, 64, 128)])
def test_ssd_intra_chunk_ref_matches_pallas(h, p, n):
    """The shapes of tests/test_kernels.py's Pallas check."""
    ins = _ssd_inputs(np.random.RandomState(4), 3, 32, h, p, n)
    got = ssd_intra_chunk_ref(*map(_t, ins))
    pallas = pallas_ssd(*map(_j, ins), interpret=True)
    oracle = jax_ssd_ref(*map(_j, ins))
    for g, pr, o, name in zip(got, pallas, oracle, ("y", "state", "decay")):
        _close(g, pr, **TOL, err_msg=name)
        _close(g, o, **TOL, err_msg=name)


def test_ssd_intra_chunk_large_decay_is_finite():
    """cum falls to ~-400 over a 256-token chunk at a = -16, dt = 0.1: the
    masked decay must select (not multiply), so no inf * 0 = NaN."""
    rng = np.random.RandomState(5)
    x, _, _, bm, cm = _ssd_inputs(rng, 1, 256, 2, 16, 16)
    dt = np.full((1, 256, 2), 0.1)
    a = np.array([-16.0, -1.0])
    got = ssd_intra_chunk_ref(*map(_t, (x, dt, a, bm, cm)))
    ref = jax_ssd_ref(*map(_j, (x, dt, a, bm, cm)))
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        _close(g, r)


# (Q, H, P, N): one chunk of the reduced configs, ragged ones, and Q 64
_BWD_SHAPES = [(8, 8, 16, 16), (20, 3, 6, 5), (37, 2, 33, 70), (64, 4, 16, 8)]
_COTANGENTS = ("all", "dy", "dst", "dg")


def _cotangents(rng, b, q, h, p, n, which):
    cots = [rng.randn(b, q, h, p), rng.randn(b, h, p, n), rng.randn(b, h)]
    return [c if which in ("all", name) else None
            for c, name in zip(cots, ("dy", "dst", "dg"))]


@pytest.mark.parametrize("which", _COTANGENTS)
@pytest.mark.parametrize("q,h,p,n", _BWD_SHAPES)
def test_ssd_intra_chunk_bwd_ref_matches_autograd_and_jax(q, h, p, n, which):
    """The plain backward, written out, against torch autograd through
    ssd_intra_chunk_ref and jax.vjp of the reference's oracle, at moderate
    decays, with cotangents on all three outputs or on one alone."""
    rng = np.random.RandomState(20)
    b = 2
    ins = _ssd_inputs(rng, b, q, h, p, n)
    cots = _cotangents(rng, b, q, h, p, n, which)
    got = ssd_intra_chunk_bwd_ref(*map(_t, ins),
                                  *[None if c is None else _t(c)
                                    for c in cots])

    leaves = [_t(v).requires_grad_(True) for v in ins]
    outs = ssd_intra_chunk_ref(*leaves)
    total = sum((o * _t(c)).sum() for o, c in zip(outs, cots)
                if c is not None)
    auto = torch.autograd.grad(total, leaves, allow_unused=True)

    outs_j, vjp = jax.vjp(jax_ssd_ref, *map(_j, ins))
    ref = vjp(tuple(jnp.zeros_like(o) if c is None else _j(c)
                    for o, c in zip(outs_j, cots)))
    for name, g, t, r in zip(("dx", "ddt", "da", "dB", "dC"), got, auto,
                             ref):
        assert g.shape == _t(r).shape, name
        _close(g, np.zeros(g.shape) if t is None else t, err_msg=name)
        _close(g, r, err_msg=name)


def _ssd_intra_chunk(x, dt, a, bmat, cmat, select_after_exp=False):
    """ssd_intra_chunk_ref's ops in the inputs' dtype; with
    ``select_after_exp`` the decay is the reference's where(mask,
    exp(rel), 0), as the port's was."""
    q = x.shape[1]
    da = dt * a[None, None, :]
    cum = torch.cumsum(da, dim=1)
    rel = cum[:, :, None, :] - cum[:, None, :, :]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))[None, :, :, None]
    if select_after_exp:
        decay = torch.where(tri, torch.exp(rel), 0.0)
    else:
        decay = torch.exp(torch.where(tri, rel, -torch.inf))
    cb = torch.einsum("bqn,bsn->bqs", cmat, bmat)
    m = cb[..., None] * decay * dt[:, None, :, :]
    y = torch.einsum("bqsh,bshp->bqhp", m, x)
    dec_out = torch.exp(cum[:, -1:, :] - cum)
    st = torch.einsum("bsh,bsn,bshp->bhpn", dt * dec_out, bmat, x)
    return y, st, torch.exp(cum[:, -1, :])


def test_ssd_large_decay_gradients_are_finite():
    """At the published chunk of 256 and a = -16, exp(cum_q - cum_s)
    overflows above the diagonal.  The port's plain versions mask the
    exponent: their forward is bitwise what selecting after the exp gives,
    and their gradients are finite.  The reference selects after the exp,
    so jax.grad gives NaN dt and a gradients (ROADMAP.md C)."""
    rng = np.random.RandomState(21)
    b, q, h, p, n = 1, 256, 2, 16, 16
    x, _, _, bm, cm = _ssd_inputs(rng, b, q, h, p, n)
    dt = rng.uniform(0.5, 1.0, (b, q, h))
    a = np.array([-1.0, -16.0])
    ins = (x, dt, a, bm, cm)
    for got, old in zip(ssd_intra_chunk_ref(*map(_t, ins)),
                        _ssd_intra_chunk(*map(_t, ins),
                                         select_after_exp=True)):
        assert torch.equal(got, old)

    def loss_t(f):
        leaves = [_t(v).requires_grad_(True) for v in ins]
        out = f(*leaves)
        return torch.autograd.grad(sum(o.sum() for o in out), leaves)

    for f in (ssd_intra_chunk_ref, lambda *v: tssm.ssd_chunked(*v, q)):
        for name, g in zip(("x", "dt", "a", "B", "C"), loss_t(f)):
            assert torch.isfinite(g).all(), name
    ones = [_t(np.ones(s)) for s in ((b, q, h, p), (b, h, p, n), (b, h))]
    for got in ssd_intra_chunk_bwd_ref(*map(_t, ins), *ones):
        assert torch.isfinite(got).all()

    def loss_j(*v):
        return sum(o.sum() for o in jax_ssd_ref(*v))

    ref = jax.grad(loss_j, argnums=(0, 1, 2, 3, 4))(*map(_j, ins))
    finite = [bool(np.isfinite(np.asarray(g)).all()) for g in ref]
    assert finite == [True, False, False, True, True]


def _ssd_grads_f64(x, dt, a, bm, cm, dy, dst, dg):
    """Autograd of the intra-chunk pass in float64."""
    leaves = [torch.from_numpy(np.asarray(v, np.float64)).requires_grad_(True)
              for v in (x, dt, a, bm, cm)]
    total = sum((o * torch.from_numpy(np.asarray(c, np.float64))).sum()
                for o, c in zip(_ssd_intra_chunk(*leaves), (dy, dst, dg)))
    return torch.autograd.grad(total, leaves)


def test_ssd_intra_chunk_bwd_ref_is_accurate_at_large_decays():
    """At a = -16 over a 256-token chunk the decays fall ~1e-5 a step, so
    what reaches cum is ~1e-5 of the diagonal pairs' terms, which cancel
    exactly between the q and s sides.  The plain backward leaves those
    pairs out; every gradient, da included, stays within 1e-3 of a
    float64 evaluation (summed apart, da was off by ~10 %)."""
    rng = np.random.RandomState(24)
    b, q, h, p, n = 2, 256, 2, 16, 16
    x, _, _, bm, cm = _ssd_inputs(rng, b, q, h, p, n)
    dt = rng.uniform(0.5, 1.0, (b, q, h))
    a = np.array([-16.0, -16.0])
    cots = _cotangents(rng, b, q, h, p, n, "all")
    got = ssd_intra_chunk_bwd_ref(*map(_t, (x, dt, a, bm, cm)),
                                  *map(_t, cots))
    exact = _ssd_grads_f64(x, dt, a, bm, cm, *cots)
    for name, g, e in zip(("dx", "ddt", "da", "dB", "dC"), got, exact):
        err = (g.double() - e).abs().max() / e.abs().max()
        assert err <= 1e-3, (name, float(err))


def test_ssd_intra_chunk_cpu_uses_plain_version():
    ins = [_t(a) for a in _ssd_inputs(np.random.RandomState(6), 2, 8, 4,
                                      16, 16)]
    before = ssd_ops.ssd_intra_chunk.launches
    got = ssd_ops.ssd_intra_chunk(*ins)
    for g, r in zip(got, ssd_intra_chunk_ref(*ins)):
        assert torch.equal(g, r)
    assert ssd_ops.ssd_intra_chunk.launches == before


def test_ssd_intra_chunk_bwd_cpu_uses_plain_version():
    rng = np.random.RandomState(22)
    ins = [_t(a) for a in _ssd_inputs(rng, 2, 8, 4, 16, 16)]
    cots = [_t(c) for c in _cotangents(rng, 2, 8, 4, 16, 16, "all")]
    before = ssd_ops.ssd_intra_chunk_bwd.launches
    got = ssd_ops.ssd_intra_chunk_bwd(*ins, *cots)
    for g, r in zip(got, ssd_intra_chunk_bwd_ref(*ins, *cots)):
        assert torch.equal(g, r)
    assert ssd_ops.ssd_intra_chunk_bwd.launches == before


def test_ssd_wrapper_raises_off_cpu_and_cuda():
    """A tensor neither on the CPU nor on a CUDA device gets no plain-path
    fallback: the wrapper raises and counts no launch."""
    x = torch.empty(2, 8, 4, 16, device="meta")
    dt = torch.empty(2, 8, 4, device="meta")
    a = torch.empty(4, device="meta")
    bm = torch.empty(2, 8, 16, device="meta")
    before = (ssd_ops.ssd_intra_chunk.launches,
              ssd_ops.ssd_intra_chunk_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_ops.ssd_intra_chunk(x, dt, a, bm, bm)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_ops.ssd_intra_chunk_bwd(x, dt, a, bm, bm, x)
    assert (ssd_ops.ssd_intra_chunk.launches,
            ssd_ops.ssd_intra_chunk_bwd.launches) == before


# ---------------------------------------------------------------------------
# chunked SSD, decode step and convs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["kernel_backed", "oracle"])
def test_ssd_chunked_matches_reference(fn):
    """nc = 4 chunks, so the inter-chunk recurrence runs."""
    rng = np.random.RandomState(7)
    b, l, h, p, n, chunk = 2, 64, 8, 16, 16, 16
    ins = _ssd_inputs(rng, b, l, h, p, n)
    ref = jssm.ssd_chunked(*map(_j, ins), chunk)
    f = ssd_ops.ssd_chunked if fn == "kernel_backed" else tssm.ssd_chunked
    got = f(*map(_t, ins), chunk)
    for g, r, name in zip(got, ref, ("y", "state", "decay")):
        _close(g, r, err_msg=name)


def test_ssd_chunked_oracle_h_init():
    rng = np.random.RandomState(8)
    ins = _ssd_inputs(rng, 2, 32, 4, 16, 8)
    h0 = rng.randn(2, 4, 16, 8)
    ref = jssm.ssd_chunked(*map(_j, ins), 8, h_init=_j(h0))
    got = tssm.ssd_chunked(*map(_t, ins), 8, h_init=_t(h0))
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("f", [ssd_ops.ssd_chunked, tssm.ssd_chunked])
def test_ssd_chunked_never_pads(f):
    ins = [_t(a) for a in _ssd_inputs(np.random.RandomState(9), 1, 12, 2,
                                      16, 8)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        f(*ins, 8)


def test_ssd_decode_step():
    rng = np.random.RandomState(10)
    b, h, p, n = 3, 4, 16, 8
    ins = (rng.randn(b, h, p), np.abs(rng.randn(b, h)) * 0.1,
           -(np.abs(rng.randn(h)) + 0.1), rng.randn(b, n), rng.randn(b, n),
           rng.randn(h), rng.randn(b, h, p, n))
    state = _t(ins[-1])
    kept = state.clone()
    got = tssm.ssd_decode_step(*map(_t, ins[:-1]), state)
    ref = jssm.ssd_decode_step(*map(_j, ins))
    for g, r in zip(got, ref):
        _close(g, r)
    assert torch.equal(state, kept)


def test_causal_conv1d():
    rng = np.random.RandomState(11)
    x, w, bias = rng.randn(2, 9, 12), rng.randn(4, 12), rng.randn(12)
    got = tssm.causal_conv1d(_t(x), _t(w), _t(bias), axis="model",
                             axis_size=1)
    ref = jssm.causal_conv1d(_j(x), _j(w), _j(bias), axis="model",
                             axis_size=1)
    _close(got, ref)
    # over a ring the halo needs the ring's Dist (its runs against the
    # reference: tests/test_torch_ring_ssm.py)
    with pytest.raises(ValueError, match="needs its dist"):
        tssm.causal_conv1d(_t(x), _t(w), _t(bias), axis="model",
                           axis_size=2)


def test_conv_decode_step():
    rng = np.random.RandomState(12)
    xn, cache = rng.randn(2, 12), rng.randn(2, 3, 12)
    w, bias = rng.randn(4, 12), rng.randn(12)
    got = tssm.conv_decode_step(*map(_t, (xn, cache, w, bias)))
    ref = jssm.conv_decode_step(*map(_j, (xn, cache, w, bias)))
    for g, r in zip(got, ref):
        _close(g, r)


# ---------------------------------------------------------------------------
# the Mamba-2 block and whole models on converted weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    jparams = jax.jit(lambda k: jtf.init_params(k, jcfg))(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return arch, cfg, jcfg, jparams, params


def _ctxs(cfg, jcfg, phase):
    jctx = jtf.RunCtx(jcfg, JaxPar(strategy="tatp", remat=False),
                      JaxDist(make_mesh((1,), ("model",))), phase=phase)
    tctx = ttf.RunCtx(cfg, ParallelConfig(strategy="tatp", remat=False),
                      Dist(torch.device("cpu")), phase=phase)
    return jctx, tctx


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_mamba_block(model, phase):
    _, cfg, jcfg, jparams, params = model
    jctx, tctx = _ctxs(cfg, jcfg, phase)
    rng = np.random.RandomState(13)
    b, s = 2, (1 if phase == "decode" else 16)
    x = rng.randn(b, s, cfg.d_model)
    jp = {k: v[-1] for k, v in jparams["layers"]["u0"].items()}
    tp = {k: v[-1] for k, v in params["layers"]["u0"].items()}
    kw_j, kw_t = {}, {}
    if phase == "decode":
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        st = rng.randn(b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        cv = rng.randn(b, ttf.CONV_K - 1, conv_dim)
        kw_j = dict(cache={"state": _j(st), "conv": _j(cv)},
                    cache_len=jnp.asarray([5, 9]))
        kw_t = dict(cache={"state": _t(st), "conv": _t(cv)},
                    cache_len=torch.as_tensor([5, 9]))
    ref, ref_c = jax.jit(lambda p, x, kw: jtf.mamba_block(jctx, p, x, **kw))(
        jp, _j(x), kw_j)
    got, got_c = ttf.mamba_block(tctx, tp, _t(x), **kw_t)
    _close(got, ref)
    for n in ("state", "conv"):
        _close(got_c[n], ref_c[n])
    if phase == "decode":  # updated in place
        assert got_c["state"] is kw_t["cache"]["state"]
    else:
        assert got_c["state"].dtype == torch.float32
        assert got_c["conv"].is_contiguous()


def _prefill_and_decode(model, steps=4, b=2, s=16):
    _, cfg, jcfg, jparams, params = model
    jctx, tctx = _ctxs(cfg, jcfg, "decode")
    max_seq = s + steps
    toks = np.random.RandomState(14).randint(0, cfg.vocab_size, (b, s))
    jc, jl = jax.jit(lambda p, t: jlm.prefill(jctx, p, t))(
        jparams, {"tokens": jnp.asarray(toks)})
    tc, tl = tlm.prefill(tctx, params, {"tokens": torch.as_tensor(toks)})
    jbig = jax.tree.map(jnp.asarray, jlm.graft_cache_slots(
        jax.device_get(jlm.init_cache(jctx, b, max_seq)),
        jax.device_get(jc), slots=range(b)))
    tbig = tlm.graft_cache_slots(tlm.init_cache(tctx, b, max_seq), tc,
                                 slots=range(b))
    out = [((tl, jl), (tc, jc))]
    jt = jnp.argmax(jl[:, -1:, :], axis=-1).astype(jnp.int32) \
        % cfg.vocab_size
    tt = tl[:, -1:, :].argmax(dim=-1) % cfg.vocab_size
    step = jax.jit(lambda p, t, c, n: jlm.decode_step(jctx, p, t, c, n))
    toks_out = [(tt, jt)]
    for i in range(steps):
        n = s + i + 1
        jt, jlog, jbig = step(jparams, jt, jbig, jnp.full((b,), n,
                                                          jnp.int32))
        tt, tlog, tbig = tlm.decode_step(tctx, params, tt, tbig,
                                         torch.full((b,), n))
        snap = {k: {n: t.clone() for n, t in v.items()}
                for k, v in tbig.items()}  # tbig is updated in place
        out.append(((tlog, jlog), (snap, jbig)))
        toks_out.append((tt, jt))
    return out, toks_out


def test_reduced_model_prefill_and_decode(model):
    """Prefill plus 4 greedy decode steps: logits and every cache leaf
    within 5e-4, identical tokens."""
    out, toks = _prefill_and_decode(model)
    for (tl, jl), (tc, jc) in out:
        _close(tl, jl, **MODEL_TOL)
        for key, leaves in tc.items():
            assert set(leaves) == set(jc[key])
            for n, t in leaves.items():
                assert tuple(t.shape) == jc[key][n].shape, (key, n)
                _close(t, jc[key][n], **MODEL_TOL)
    for tt, jt in toks:
        assert np.array_equal(tt.numpy(), np.asarray(jt))


def test_graft_cache_slots_ssm_leaves(model):
    """Prompt-window caches grafted into permuted slots of a longer cache:
    K/V copy the window's head, SSM state and conv leaves whole rows."""
    _, cfg, jcfg, _, _ = model
    jctx, tctx = _ctxs(cfg, jcfg, "decode")
    rng = np.random.RandomState(16)
    small = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                         jax.device_get(jlm.init_cache(jctx, 2, 8)))
    tsmall = jax.tree.map(_t, small)
    ref = jlm.graft_cache_slots(jax.device_get(jlm.init_cache(jctx, 3, 12)),
                                small, slots=[2, 0])
    got = tlm.graft_cache_slots(tlm.init_cache(tctx, 3, 12), tsmall,
                                slots=[2, 0])
    assert set(got) == set(ref)
    for key, leaves in got.items():
        assert set(leaves) == set(ref[key])
        for n, t in leaves.items():
            assert tuple(t.shape) == ref[key][n].shape, (key, n)
            np.testing.assert_array_equal(t.numpy(), ref[key][n])


def test_param_shapes_and_conversion(model):
    arch, cfg, jcfg, jparams, params = model
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           jtf.param_shapes(jcfg))
    assert ttf.param_shapes(cfg) == jshapes
    assert ("shared" in params) == ("S" in cfg.layer_pattern)
    if "shared" in params:  # one unstacked set for every S slot
        assert params["shared"]["wq"].shape == (cfg.d_model, cfg.q_dim)
        np.testing.assert_array_equal(params["shared"]["mlp.w_up"].numpy(),
                                      np.asarray(jparams["shared"]
                                                 ["mlp.w_up"]))


def test_init_params_ssm_leaves():
    """The reference's SSM distributions (not zeros): a_log = log(1..16),
    d_skip = 1, dt_bias = softplus^-1 of a log-uniform [1e-3, 1e-1] draw,
    zero norm scales and conv bias, conv taps normal x 1/sqrt(CONV_K)."""
    from dataclasses import replace
    # 32 SSM heads, two reps of MMS
    cfg = replace(get_reduced("zamba2-2.7b"), ssm_head_dim=4, n_layers=6)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    blk = params["layers"]["u0"]
    nh = cfg.ssm_heads
    want_alog = torch.log(torch.linspace(1.0, 16.0, nh))
    for i in range(blk["a_log"].shape[0]):
        torch.testing.assert_close(blk["a_log"][i], want_alog)
    assert torch.equal(blk["d_skip"], torch.ones_like(blk["d_skip"]))
    dt0 = torch.nn.functional.softplus(blk["dt_bias"])
    assert dt0.min() >= 1e-3 * (1 - 1e-4) and dt0.max() <= 1e-1 * (1 + 1e-4)
    assert dt0.max() / dt0.min() > 5  # a spread, not one value
    assert not torch.equal(blk["dt_bias"][0], blk["dt_bias"][-1])
    for name in ("ln", "gln", "conv_b"):
        assert torch.count_nonzero(blk[name]) == 0, name
    assert abs(blk["conv_w"].std().item() - ttf.CONV_K ** -0.5) < 0.05
    assert abs(blk["in_proj"].std().item() - cfg.d_model ** -0.5) < 0.01
    shared = params["shared"]
    assert shared["wq"].dim() == 2 and torch.count_nonzero(
        shared["ln"]) == 0


def _serve_args(arch, **kw):
    base = dict(arch=arch, reduced=True, batch=2, prompt_len=16, gen=6,
                mesh=[1, 1], plan=None, auto_plan=False, plan_cache=None,
                device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def test_serve_matches_reference(model):
    from repro.launch.serve import serve as jax_serve
    from repro_torch.launch.serve import serve
    arch, _, _, _, params = model
    args = _serve_args(arch)
    ref = jax_serve(args)
    got = serve(args, params=params)
    assert got["generated_shape"] == ref["generated_shape"] == [2, 7]
    assert got["sample"] == ref["sample"]


def test_serve_prompt_not_a_chunk_multiple_raises():
    from repro_torch.launch.serve import serve
    with pytest.raises(ValueError, match="multiple of the chunk"):
        serve(_serve_args("mamba2-780m", prompt_len=12))


# ---------------------------------------------------------------------------
# on the card: the SSD kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bc,q,h,p,n,pad", [
    (8, 256, 48, 64, 128, None), (8, 256, 80, 64, 64, None),
    (6, 8, 8, 16, 16, None), (3, 100, 5, 20, 40, None),
    # H not a multiple of the kernel's head block
    (2, 256, 7, 64, 128, None), (2, 200, 7, 64, 64, None),
    # x, B and C column slices of one buffer whose row pitch is not a
    # multiple of 4 floats (the kernel's scalar loads)
    (2, 256, 7, 64, 128, 1), (3, 100, 5, 20, 40, 3), (2, 130, 3, 33, 256, 2),
])
def test_ssd_kernel_matches_plain(cuda_device, bc, q, h, p, n, pad):
    x, dt, a, bm, cm = [_t(v).to(cuda_device) for v in
                        _ssd_inputs(np.random.RandomState(15), bc, q, h, p,
                                    n)]
    if pad is not None:  # the same values, read through row pitch h*p+2n+pad
        buf = torch.zeros((bc, q, h * p + 2 * n + pad), dtype=x.dtype,
                          device=cuda_device)
        buf[..., :h * p] = x.reshape(bc, q, h * p)
        buf[..., h * p:h * p + n] = bm
        buf[..., h * p + n:h * p + 2 * n] = cm
        x = buf[..., :h * p].reshape(bc, q, h, p)
        bm, cm = buf[..., h * p:h * p + n], buf[..., h * p + n:h * p + 2 * n]
        assert x.stride(1) % 4 and bm.stride(1) % 4
    ins = [x, dt, a, bm, cm]
    before = ssd_ops.ssd_intra_chunk.launches
    got = ssd_ops.ssd_intra_chunk(*ins)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_intra_chunk.launches == before + 1
    for g, r in zip(got, ssd_intra_chunk_ref(*ins)):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("bc,q,h,p,n,pad", [
    (3, 100, 3, 48, 40, None), (2, 130, 3, 33, 70, 2),
    (6, 8, 8, 16, 16, None), (2, 200, 5, 64, 256, None),
    # H not a multiple of the kernel's head block of 4
    (2, 256, 7, 64, 128, 1),
])
def test_ssd_backward_kernel_matches_plain(cuda_device, bc, q, h, p, n, pad):
    """The backward kernel's five gradients against the plain backward,
    each within 1e-3 of its largest magnitude (fp32; da is a sum over the
    chunk rows and positions of terms that cancel)."""
    rng = np.random.RandomState(23)
    x, dt, a, bm, cm = [_t(v).to(cuda_device) for v in
                        _ssd_inputs(rng, bc, q, h, p, n)]
    if pad is not None:  # x, B and C column slices of one buffer
        buf = torch.zeros((bc, q, h * p + 2 * n + pad), device=cuda_device)
        buf[..., :h * p] = x.reshape(bc, q, h * p)
        buf[..., h * p:h * p + n] = bm
        buf[..., h * p + n:h * p + 2 * n] = cm
        x = buf[..., :h * p].reshape(bc, q, h, p)
        bm, cm = buf[..., h * p:h * p + n], buf[..., h * p + n:h * p + 2 * n]
    ins = [x, dt, a, bm, cm]
    cots = [_t(c).to(cuda_device)
            for c in _cotangents(rng, bc, q, h, p, n, "all")]
    before = ssd_ops.ssd_intra_chunk_bwd.launches
    got = ssd_ops.ssd_intra_chunk_bwd(*ins, *cots)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_intra_chunk_bwd.launches == before + 1
    for name, g, r in zip(("dx", "ddt", "da", "dB", "dC"), got,
                          ssd_intra_chunk_bwd_ref(*ins, *cots)):
        assert torch.isfinite(g).all(), name
        err = (g - r).abs().max() / r.abs().max()
        assert err <= 1e-3, (name, float(err))
