"""repro_torch's train slice against the reference on the CPU: the
synthetic data, the learning-rate schedule, AdamW, the cross-entropy, the
TATP linear's and the attention's gradients, the loss's gradients, a
3-step ``make_train_step`` trajectory, remat, the lm head's mixed-precision
backward, and the training CLI.  Reduced deepseek-7b (2 layers,
d_model 64, 4 heads of 16, fp32) on converted weights; inputs made with
numpy from a seed.

Tolerances: fp32 forward values and gradients of the same arithmetic in
another order, 1e-5 relative and absolute (1e-4 where a gradient sums
over the whole batch and vocab).  Parameters after k AdamW steps: Adam's
first updates are about lr * sign(g), so where g is ~0 two correct
implementations can differ by up to 2 * lr_t in an element; the final
parameters are compared at atol = 2 * sum(lr_t)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.configs.base import ParallelConfig as JaxPar
from repro.configs.base import ShapeConfig as JaxShape
from repro.core import tatp as jtatp
from repro.core.dist import Dist as JaxDist
from repro.core.dist import make_mesh
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import transformer as jtf
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.train_loop import make_train_step as jax_train_step
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.core import tatp
from repro_torch.core.dist import Dist
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.tatp_matmul.ref import matmul_ref
from repro_torch.models import lm
from repro_torch.models import transformer as ttf
from repro_torch.train import data, optimizer
from repro_torch.train.train_loop import loss_and_grads, make_train_step
from repro_torch.weights import params_from_jax

ARCH = "deepseek-7b"
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, **tol):
    np.testing.assert_allclose(_np(got), _np(ref), **(tol or TOL))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = get_reduced(ARCH), jax_reduced(ARCH)
    jparams = jax.tree.map(np.asarray,
                           jtf.init_params(jax.random.key(0), jcfg))
    return cfg, jcfg, jparams


def _ctxs(cfg, jcfg, remat=False):
    jctx = jtf.RunCtx(jcfg, JaxPar(strategy="tatp", remat=remat),
                      JaxDist(make_mesh((1,), ("model",))), phase="train")
    tctx = ttf.RunCtx(cfg, ParallelConfig(strategy="tatp", remat=remat),
                      Dist(CPU), phase="train", dot=matmul_ref,
                      attention=attention_ref)
    return jctx, tctx


def _batch(vocab, b=2, s=16, seed=3):
    toks = jdata._lcg_tokens(seed, b, s + 1, vocab)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# data and optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,b,s,vocab", [(0, 2, 9, 128), (100_003, 4, 33,
                                                            102400)])
def test_lcg_tokens_match_reference(seed, b, s, vocab):
    np.testing.assert_array_equal(data._lcg_tokens(seed, b, s, vocab),
                                  jdata._lcg_tokens(seed, b, s, vocab))


def test_host_batch_matches_reference(model):
    cfg, jcfg, _ = model
    shape = ShapeConfig("t", "train", 16, 4)
    ours = data.SyntheticDataset(cfg, shape, Dist(CPU), seed=2)
    ref = jdata.SyntheticDataset(jcfg, JaxShape("t", "train", 16, 4),
                                 JaxDist(make_mesh((1, 1),
                                                   ("data", "model"))),
                                 seed=2)
    for step in (0, 5):
        host, jhost = ours._host_batch(step), ref._host_batch(step)
        assert set(host) == set(jhost) == {"tokens", "labels"}
        for k in host:
            np.testing.assert_array_equal(host[k], jhost[k])
        dev = ours.batch(step)
        for k in host:
            np.testing.assert_array_equal(dev[k].numpy(), host[k])


@pytest.mark.parametrize("step", [0, 99, 100, 5050, 20_000])
def test_lr_schedule_matches_reference(step):
    cfg = optimizer.AdamWConfig()
    jcfg = jopt.AdamWConfig()
    want = float(jopt.lr_schedule(jcfg, jnp.asarray(step, jnp.int32)))
    assert optimizer.lr_schedule(cfg, step) == pytest.approx(want, rel=1e-6)


def _mixed_tree(rng, scale):
    return {"b": {"w": rng.randn(3, 5) * scale,
                  "ln": rng.randn(2, 5) * scale},
            "a": rng.randn(7) * scale, "c": rng.randn(4, 2, 3) * scale}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["clip-inactive", "clip-active"])
def test_adamw_update_matches_reference(grad_scale):
    """One update on a mixed 1-D / 2-D / 3-D tree, after one warm step so
    the moments are not zero; the grad norm is below (inactive) or far
    above (active) the clip."""
    rng = np.random.RandomState(0)
    p0 = _mixed_tree(rng, 1.0)
    grads = [_mixed_tree(rng, grad_scale) for _ in range(2)]
    cfg = optimizer.AdamWConfig(warmup_steps=3)
    jcfg = jopt.AdamWConfig(warmup_steps=3)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), p0)
    jo = jopt.AdamW(jcfg, (), None, 1)
    jstate = jo.init(jparams)
    params = jax.tree.map(_t, p0)
    o = optimizer.AdamW(cfg)
    state = o.init(params)
    for g in grads:
        jparams, jstate, jm = jo.update(
            jparams, jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), g),
            jstate)
        params, state, m = o.update(params, jax.tree.map(_t, g), state)
        _close(m["grad_norm"], jm["grad_norm"])
        _close(m["lr"], jm["lr"], rtol=1e-6, atol=0)
    assert (float(m["grad_norm"]) > cfg.grad_clip) == (grad_scale > 1)
    assert state.step == int(jstate.step) == 2
    for k, v in _flat(params).items():
        _close(v, _flat(jparams)[k], rtol=1e-6, atol=1e-6)
        _close(_flat(state.m)[k], _flat(jstate.m)[k])
        _close(_flat(state.v)[k], _flat(jstate.v)[k])


@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["clip-inactive", "clip-active"])
def test_adamw_grad_compress_matches_reference(grad_scale):
    """Three updates with int8 gradient compression and error feedback on
    one device (the reference runs it there too): the grad norm, the
    parameters, the moments and the residuals."""
    rng = np.random.RandomState(0)
    p0 = _mixed_tree(rng, 1.0)
    grads = [_mixed_tree(rng, grad_scale) for _ in range(3)]
    jo = jopt.AdamW(jopt.AdamWConfig(warmup_steps=3, grad_compress=True),
                    (), None, 1)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), p0)
    jstate = jo.init(jparams)
    o = optimizer.AdamW(optimizer.AdamWConfig(warmup_steps=3,
                                              grad_compress=True))
    params = jax.tree.map(_t, p0)
    state = o.init(params)
    for g in grads:
        jparams, jstate, jm = jo.update(
            jparams, jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), g),
            jstate)
        params, state, m = o.update(params, jax.tree.map(_t, g), state)
        _close(m["grad_norm"], jm["grad_norm"])
    for k, v in _flat(params).items():
        _close(v, _flat(jparams)[k], rtol=1e-6, atol=1e-6)
        for part in ("m", "v", "err"):
            _close(_flat(getattr(state, part))[k],
                   _flat(getattr(jstate, part))[k])
    assert any(float(e.abs().max()) > 0 for e in _flat(state.err).values())


# int8 compression under ZeRO-1 over two data ranks: the reference's AdamW
# under shard_map on 2 fake devices in a subprocess, the port's on 2 gloo
# ranks (this file run as a script), each rank with its own gradients
ZERO1_STEPS = 3


def _zero1_inputs():
    rng = np.random.RandomState(3)
    p0 = _mixed_tree(rng, 1.0)
    grads = [[_mixed_tree(rng, 0.5) for _ in range(2)]
             for _ in range(ZERO1_STEPS)]
    return p0, grads


def _zero1_reference(out_path):
    from jax.sharding import PartitionSpec as Ps

    devs = jax.devices()
    assert len(devs) == 2, devs
    mesh = make_mesh((2,), ("data",), devices=devs)
    o = jopt.AdamW(jopt.AdamWConfig(warmup_steps=3, grad_compress=True),
                   ("data",), "data", 2)
    p0, grads = _zero1_inputs()
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), p0)
    pspecs = jax.tree.map(lambda _: Ps(), params)
    ospecs = o.state_specs(pspecs)
    state = jax.jit(jax.shard_map(o.init, mesh=mesh, in_specs=(pspecs,),
                                  out_specs=ospecs, check_vma=False))(params)

    def update(p, g, st):
        p, st, m = o.update(p, jax.tree.map(lambda a: a[0], g), st)
        return p, st, m["grad_norm"]

    step = jax.jit(jax.shard_map(
        update, mesh=mesh,
        in_specs=(pspecs, jax.tree.map(lambda _: Ps("data"), params),
                  ospecs),
        out_specs=(pspecs, ospecs, Ps()), check_vma=False))
    res = {}
    for k, pair in enumerate(grads):
        g = jax.tree.map(lambda *a: jnp.asarray(np.stack(a), jnp.float32),
                         *pair)
        params, state, gn = step(params, g, state)
        res[f"grad_norm{k}"] = np.asarray(gn)
    for part, tree in (("p", params), ("m", state.m), ("v", state.v),
                       ("err", state.err)):
        for path, leaf in _flat(tree).items():
            res[f"{part}_{path}"] = np.asarray(leaf)
    np.savez(out_path, **res)


def _zero1_rank(rank, store_path, out_path):
    from repro_torch.core.dist import init_world, make_mesh_dist

    torch.set_num_threads(1)
    init_world("gloo", store=torch.distributed.FileStore(store_path, 2),
               rank=rank, world_size=2)
    dist = make_mesh_dist((2,), "cpu")
    o = optimizer.AdamW(optimizer.AdamWConfig(warmup_steps=3,
                                              grad_compress=True), dist)
    p0, grads = _zero1_inputs()
    params = jax.tree.map(_t, p0)
    state = o.init(params)
    res = {}
    for k, pair in enumerate(grads):
        params, state, m = o.update(params, jax.tree.map(_t, pair[rank]),
                                    state)
        res[f"grad_norm{k}"] = m["grad_norm"].numpy()
    for part, tree in (("p", params), ("m", state.m), ("v", state.v),
                       ("err", state.err)):
        for path, leaf in _flat(tree).items():
            res[f"{part}_{path}"] = leaf.numpy()
    np.savez(out_path, **res)
    torch.distributed.destroy_process_group()


def test_adamw_grad_compress_zero1_matches_reference(tmp_path):
    """ZeRO-1 over two data ranks: the residual slices all-gathered, the
    scale's absolute max pmaxed over ``data``, the dequantised gradients
    psum-scattered; each rank's master, moment and residual slices (the
    reference's 1-D concatenations over ``data``), the parameters and the
    grad norm after three updates."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    me = str(Path(__file__).resolve())
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, me, "zero1-reference", str(tmp_path / "ref.npz")],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen(
        [sys.executable, me, "zero1-rank", str(r), str(tmp_path / "store"),
         str(tmp_path / f"{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    ref = dict(np.load(tmp_path / "ref.npz"))
    for r in range(2):
        got = dict(np.load(tmp_path / f"{r}.npz"))
        for k in range(ZERO1_STEPS):
            _close(got[f"grad_norm{k}"], ref[f"grad_norm{k}"])
        for key, v in got.items():
            if key.startswith("p_"):
                _close(v, ref[key], rtol=1e-6, atol=1e-6)
            elif not key.startswith("grad_norm"):  # this rank's slice
                n = v.shape[0]
                _close(v, ref[key][r * n:(r + 1) * n])
        assert any(np.abs(v).max() > 0 for key, v in got.items()
                   if key.startswith("err_"))


def test_grad_compression_converges():
    """The twin of the reference's ``tests/test_train_infra.py`` test:
    int8 with error feedback tracks the uncompressed run within 0.35 of
    the last five losses' mean over 25 steps."""
    cfg = get_reduced(ARCH)
    dist = Dist(CPU)
    shape = ShapeConfig("t", "train", 64, 4)
    par = ParallelConfig(strategy="tatp", remat=False)
    losses = {}
    for compress in (False, True):
        bundle = make_train_step(cfg, par, dist, shape, optimizer.AdamWConfig(
            lr=1e-3, warmup_steps=10, total_steps=100,
            grad_compress=compress))
        params, state = bundle.init_fn(torch.Generator().manual_seed(0))
        ds = data.SyntheticDataset(cfg, shape, dist)
        losses[compress] = []
        for step in range(25):
            params, state, m = bundle.step_fn(params, state, ds.batch(step))
            losses[compress].append(float(m["loss"]))
    l1, l2 = losses[False], losses[True]
    assert abs(np.mean(l2[-5:]) - np.mean(l1[-5:])) < 0.35, (l1[-5:],
                                                             l2[-5:])


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------


def test_vocab_parallel_xent_matches_reference(model):
    """Padded columns (vocab 128 of 512) masked, a partial valid mask."""
    cfg, jcfg, _ = model
    jctx, tctx = _ctxs(cfg, jcfg)
    rng = np.random.RandomState(1)
    vp = ttf.padded_vocab(cfg)
    logits = rng.randn(2, 6, vp).astype(np.float32) * 3
    labels = rng.randint(0, cfg.vocab_size, (2, 6))
    valid = (rng.rand(2, 6) > 0.3).astype(np.float32)
    jn, jc = jlm.vocab_parallel_xent(jctx, jnp.asarray(logits),
                                     jnp.asarray(labels),
                                     jnp.asarray(valid))
    lt = _t(logits).requires_grad_(True)
    n, c = lm.vocab_parallel_xent(tctx, lt, torch.as_tensor(labels),
                                  _t(valid))
    _close(n, jn)
    _close(c, jc)
    n.backward()
    jg = jax.grad(lambda x: jlm.vocab_parallel_xent(
        jctx, x, jnp.asarray(labels), jnp.asarray(valid))[0])(
        jnp.asarray(logits))
    _close(lt.grad, jg)


@pytest.mark.parametrize("shape", [(2, 8, 64, 48), (40, 64, 32)],
                         ids=["3d", "2d"])
def test_tatp_matmul_grads_match_reference(shape):
    """dx and dw of the TATP linear's Function (matmul_ref as the dot)
    against jax.vjp of the reference's custom_vjp at ring degree 1."""
    rng = np.random.RandomState(2)
    *lead, n, k = shape
    x = rng.randn(*lead, n).astype(np.float32)
    w = (rng.randn(n, k) / np.sqrt(n)).astype(np.float32)
    dy = rng.randn(*lead, k).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda x, w: jtatp.tatp_matmul(x, w, "model", 1),
                         jnp.asarray(x), jnp.asarray(w))
    dx_ref, dw_ref = vjp(jnp.asarray(dy))
    xt, wt = (_t(a).requires_grad_(True) for a in (x, w))
    y = tatp.tatp_matmul(xt, wt, "model", 1, dot=matmul_ref)
    y.backward(_t(dy))
    _close(y, y_ref)
    _close(xt.grad, dx_ref)
    _close(wt.grad, dw_ref)
    assert y.grad_fn is not None
    with torch.no_grad():  # no autograd: the forward schedule alone
        assert tatp.tatp_matmul(xt, wt, "model", 1,
                                dot=matmul_ref).grad_fn is None
    # above ring degree 1: tests/test_torch_ring_grads.py


@pytest.mark.parametrize("hq,hkv,causal,window,cap", [
    (4, 4, True, None, None),
    (4, 4, False, None, None),
    (4, 2, True, 5, None),
    (4, 1, True, None, 20.0),
    (6, 2, True, 7, 30.0),
])
def test_attention_grads_match_reference(hq, hkv, causal, window, cap):
    """dQ, dK, dV of the plain attention (the CPU path of ``attention``,
    differentiated by autograd) against jax.vjp of local_attention; the
    port's [B, H, S, D] against the reference's [B, S, H, D]."""
    rng = np.random.RandomState(3)
    b, s, d = 2, 12, 16
    q = rng.randn(b, s, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    do = rng.randn(b, s, hq, d).astype(np.float32)
    kw = dict(causal=causal, window=window, cap=cap)
    o_ref, vjp = jax.vjp(lambda q, k, v: jattn.local_attention(q, k, v, **kw),
                         *(jnp.asarray(a) for a in (q, k, v)))
    grads_ref = vjp(jnp.asarray(do))
    qt, kt, vt = (_t(a).transpose(1, 2).requires_grad_(True)
                  for a in (q, k, v))
    o = attention_ref(qt, kt, vt, **kw)
    o.backward(_t(do).transpose(1, 2))
    _close(o.transpose(1, 2), o_ref)
    for got, ref in zip((qt.grad, kt.grad, vt.grad), grads_ref):
        _close(got.transpose(1, 2), ref)


def test_attention_fully_masked_rows_have_zero_grads():
    """Sq > Skv under a causal window: the last query rows see no key.
    Their outputs and gradients are 0, never NaN."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 10, 8, generator=g, requires_grad=True)
    k = torch.randn(1, 2, 4, 8, generator=g, requires_grad=True)
    v = torch.randn(1, 2, 4, 8, generator=g, requires_grad=True)
    o = attention_ref(q, k, v, causal=True, window=3)
    o.sum().backward()
    assert torch.isfinite(q.grad).all() and torch.isfinite(k.grad).all()
    assert (o[:, :, 6:] == 0).all() and (q.grad[:, :, 6:] == 0).all()


def _loss_grads_ref(jctx, jparams, batch):
    def f(p):
        nll, cnt, aux = jlm.loss_fn(jctx, p, batch)
        return nll / cnt + aux
    return jax.value_and_grad(f)(jax.tree.map(jnp.asarray, jparams))


def _loss_grads(tctx, params, batch):
    nll, cnt, grads = loss_and_grads(tctx, params, batch)
    return nll / cnt, _flat(grads)


def test_loss_fn_grads_match_reference(model):
    """The loss and every gradient leaf of loss_fn against jax.grad of the
    reference's, on converted weights."""
    cfg, jcfg, jparams = model
    jctx, tctx = _ctxs(cfg, jcfg)
    batch = _batch(cfg.vocab_size)
    loss_ref, g_ref = _loss_grads_ref(jctx, jparams, batch)
    params = params_from_jax(jparams, cfg, CPU)
    loss, grads = _loss_grads(
        tctx, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    _close(loss, loss_ref)
    g_ref = _flat(g_ref)
    assert set(grads) == set(g_ref)
    for name, g in grads.items():
        np.testing.assert_allclose(_np(g), _np(g_ref[name]), **GRAD_TOL,
                                   err_msg=name)


def test_loss_and_grads_leaves_params_as_it_found_them(model):
    """The train step's gradient half returns detached sums and gradients
    in the parameters' layout, and leaves no parameter requiring grad."""
    cfg, jcfg, jparams = model
    _, tctx = _ctxs(cfg, jcfg)
    params = params_from_jax(jparams, cfg, CPU)
    batch = {k: torch.as_tensor(v) for k, v in
             _batch(cfg.vocab_size).items()}
    nll, cnt, grads = loss_and_grads(tctx, params, batch)
    assert not nll.requires_grad and not cnt.requires_grad
    assert float(cnt) == batch["labels"].numel()
    assert set(_flat(grads)) == set(_flat(params))
    for name, p in _flat(params).items():
        assert not p.requires_grad, name
        assert _flat(grads)[name].shape == p.shape, name


def test_remat_gives_the_same_grads(model):
    cfg, jcfg, jparams = model
    batch = {k: torch.as_tensor(v) for k, v in
             _batch(cfg.vocab_size).items()}
    runs = []
    for remat in (False, True):
        _, tctx = _ctxs(cfg, jcfg, remat=remat)
        params = params_from_jax(jparams, cfg, CPU)
        runs.append(_loss_grads(tctx, params, batch))
    _close(runs[0][0], runs[1][0], rtol=0, atol=0)
    for name, g in runs[0][1].items():
        _close(runs[1][1][name], g, rtol=1e-6, atol=1e-7)


def test_remat_policy_tatp_outputs_raises(model):
    """remat_policy='tatp_outputs' runs (it raises nothing now): through
    the port's own GEMM and attention wrappers, which save their outputs,
    the loss and every gradient equal full remat's bitwise, and match
    jax.grad of the reference under its tatp_outputs policy."""
    from dataclasses import replace
    cfg, jcfg, jparams = model
    jctx, _ = _ctxs(cfg, jcfg, remat=True)
    jctx = jtf.RunCtx(jcfg, replace(jctx.par, remat_policy="tatp_outputs"),
                      jctx.dist, phase="train")
    batch = _batch(cfg.vocab_size)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    runs = {}
    for policy in ("full", "tatp_outputs"):
        tctx = ttf.RunCtx(cfg, ParallelConfig(strategy="tatp", remat=True,
                                              remat_policy=policy),
                          Dist(CPU), phase="train")
        runs[policy] = _loss_grads(tctx, params_from_jax(jparams, cfg, CPU),
                                   tb)
    (lf, gf), (lt, gt) = runs["full"], runs["tatp_outputs"]
    assert torch.equal(lf, lt)
    for name, g in gf.items():
        assert torch.equal(gt[name], g), name
    loss_ref, g_ref = _loss_grads_ref(jctx, jparams, batch)
    _close(lt, loss_ref)
    for name, g in _flat(g_ref).items():
        _close(gt[name], g, **GRAD_TOL)


def test_head_backward_matches_jax_in_bf16():
    """The lm head's mixed-precision backward: bf16 operands, fp32
    logits.  JAX meets the fp32 cotangent with the operands promoted to
    fp32; the port's exact three-term bf16 split of the cotangent gives
    the same dx and dw (bf16 results within one bf16 rounding)."""
    rng = np.random.RandomState(4)
    x = rng.randn(6, 32).astype(np.float32)
    w = (rng.randn(32, 40) * 0.2).astype(np.float32)
    g = (rng.randn(6, 40) * 1e-3).astype(np.float32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    y_ref, vjp = jax.vjp(lambda x, w: jnp.einsum(
        "md,dv->mv", x, w, preferred_element_type=jnp.float32), xb, wb)
    dx_ref, dw_ref = vjp(jnp.asarray(g))
    xt = _t(x, torch.bfloat16).requires_grad_(True)
    wt = _t(w, torch.bfloat16).requires_grad_(True)
    y = lm._HeadMatmul.apply(xt, wt, matmul_ref)
    y.backward(_t(g))
    assert y.dtype == torch.float32
    assert xt.grad.dtype == wt.grad.dtype == torch.bfloat16
    _close(y, y_ref, rtol=1e-6, atol=1e-6)
    # one bf16 ulp of the largest gradient
    for got, ref in ((xt.grad, dx_ref), (wt.grad, dw_ref)):
        ulp = float(np.abs(_np(ref)).max()) * 2.0 ** -8
        _close(got, ref, rtol=0, atol=ulp)


def test_bf16_terms_split_exactly():
    g = torch.randn(1000, generator=torch.Generator().manual_seed(5)) * 1e-2
    hi, mid, lo = lm._bf16_terms(g)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    np.testing.assert_allclose(total.numpy(), g.double().numpy(), rtol=2e-7,
                               atol=0)


# ---------------------------------------------------------------------------
# the train step and the CLI
# ---------------------------------------------------------------------------


def test_train_step_trajectory_matches_reference(model):
    """Three steps of make_train_step on the same converted weights and
    the same synthetic batches as the reference's make_train_step on a
    (1, 1) mesh: loss, tokens, grad norm and lr at every step, and the
    parameters after the third."""
    cfg, jcfg, _ = model
    b, s, steps = 2, 16, 3
    jdist = JaxDist(make_mesh((1, 1), ("data", "model")))
    jshape = JaxShape("t", "train", s, b)
    jbundle = jax_train_step(jcfg, JaxPar(strategy="tatp", remat=False),
                             jdist, jshape)
    jparams, jstate = jbundle.init_fn(jax.random.key(7))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    jdata_ = jdata.SyntheticDataset(jcfg, jshape, jdist)

    bundle = make_train_step(cfg, ParallelConfig(strategy="tatp",
                                                 remat=False),
                             Dist(CPU), ShapeConfig("t", "train", s, b),
                             dot=matmul_ref, attention=attention_ref)
    state = bundle.opt.init(params)
    tdata = data.SyntheticDataset(cfg, ShapeConfig("t", "train", s, b),
                                  Dist(CPU))
    lrs = []
    for step in range(steps):
        jparams, jstate, jm = jbundle.step_fn(
            jparams, jstate, jdata_.batch(step, jbundle.bspecs))
        params, state, m = bundle.step_fn(params, state, tdata.batch(step))
        assert set(m) == set(jm) == {"loss", "tokens", "grad_norm", "lr"}
        _close(m["loss"], jm["loss"])
        _close(m["tokens"], jm["tokens"], rtol=0, atol=0)
        _close(m["grad_norm"], jm["grad_norm"], rtol=1e-4, atol=1e-5)
        _close(m["lr"], jm["lr"], rtol=1e-6, atol=0)
        lrs.append(float(jm["lr"]))
    assert state.step == steps
    atol = 2 * sum(lrs)
    jflat = _flat(jax.tree.map(np.asarray, jparams))
    for name, p in _flat(params).items():
        assert not p.requires_grad
        np.testing.assert_allclose(_np(p), jflat[name], rtol=0, atol=atol,
                                   err_msg=name)


def test_train_step_lowers_loss_on_a_fixed_batch(model):
    cfg, _, jparams = model
    bundle = make_train_step(
        cfg, ParallelConfig(strategy="tatp", remat=False), Dist(CPU),
        ShapeConfig("t", "train", 16, 2),
        opt_cfg=optimizer.AdamWConfig(lr=1e-2, warmup_steps=1))
    params = params_from_jax(jparams, cfg, CPU)
    state = bundle.opt.init(params)
    batch = {k: torch.as_tensor(v) for k, v in
             _batch(cfg.vocab_size).items()}
    losses = []
    for _ in range(3):
        params, state, m = bundle.step_fn(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_train_main_prints_reference_keys(capsys):
    from repro_torch.launch.train import main
    main(["--arch", "deepseek-7b", "--reduced", "--device", "cpu",
          "--steps", "3", "--batch", "2", "--seq", "16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"first_loss", "last_loss", "steps", "mean_step_s",
                        "plan_hash", "mesh"}
    assert out["steps"] == 3 and out["mesh"] == [1, 1]
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


@pytest.mark.parametrize("flags,item", [
    (["--ckpt-dir", "ck", "--mesh", "1", "2"], None),
    (["--wafers", "2", "--mesh", "2", "1"], None),
    (["--strategy", "megatron", "--mesh", "1", "4", "--ckpt-dir", "ck"],
     None),
    (["--strategy", "fsdp", "--mesh", "1", "4"], "C5"),
    (["--arch", "olmoe-1b-7b", "--strategy", "megatron", "--mesh", "2",
      "2"], "C5"),
])
def test_train_unported_flags_raise(flags, item, monkeypatch):
    """Over several ranks (the mesh's, as ``torch.distributed.run`` would
    set them) sharded checkpoints, a stage's submesh and ``megatron``
    above model degree 1 pass the launch's checks and go on to join the
    world (their runs under torchrun: ``tests/test_torch_ring_launch.py``,
    ``tests/test_torch_ring_megatron.py``); what the reference itself
    cannot run (``fsdp`` above degree 1, MoE layers under ``megatron``)
    raises naming ROADMAP.md C5 before the rank joins."""
    import repro_torch.launch.train as launch
    from repro_torch.launch.train import main

    def joined(args):
        raise RuntimeError("joined the world")

    monkeypatch.setattr(launch, "join_world", joined)
    mesh = [int(f) for f in flags[flags.index("--mesh") + 1:][:2]]
    monkeypatch.setenv("WORLD_SIZE", str(mesh[0] * mesh[1]))
    argv = ["--reduced", "--device", "cpu", "--steps", "1", *flags]
    if item is None:
        with pytest.raises(RuntimeError, match="joined the world"):
            main(argv)
    else:
        with pytest.raises(NotImplementedError, match=item):
            main(argv)


def test_train_without_cuda_raises(monkeypatch):
    from repro_torch.launch.train import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("remat,n_dot,n_attn", [(True, 115, 8),
                                                (False, 87, 4)])
def test_train_step_calls_each_hook_once_per_product(remat, n_dot, n_attn):
    """One train step of a 4-layer dense model calls the GEMM hook for
    every linear's forward (again in the backward under remat), dgrad and
    wgrad, plus the lm head's three products, and the attention hook once
    per layer (twice under remat): the per-step launch counts the card
    checks (7 * 4 * (2 + 2) + 3 = 115 GEMMs with remat)."""
    from dataclasses import replace
    cfg = replace(get_reduced(ARCH), n_layers=4)
    calls = {"dot": 0, "attention": 0}

    def dot(a, b, out_dtype=None):
        calls["dot"] += 1
        return matmul_ref(a, b, out_dtype)

    def attention(*args, **kw):
        calls["attention"] += 1
        return attention_ref(*args, **kw)

    shape = ShapeConfig("t", "train", 16, 2)
    bundle = make_train_step(cfg, ParallelConfig(remat=remat), Dist(CPU),
                             shape, dot=dot, attention=attention)
    params, state = bundle.init_fn(torch.Generator().manual_seed(0))
    batch = data.SyntheticDataset(cfg, shape, Dist(CPU)).batch(0)
    bundle.step_fn(params, state, batch)
    assert calls == {"dot": n_dot, "attention": n_attn}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_tatp_matmul_grads_on_the_gemm_kernel(cuda_device, dtype, tol):
    """On the card the TATP linear's dgrad and wgrad run on the GEMM
    kernel (dgrad and wgrad layouts), against autograd through the plain
    product; the cotangent of a sum (expanded, no unit stride) too."""
    from repro_torch.kernels.tatp_matmul.ops import tatp_dot
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(256, 512, generator=g, device=cuda_device).to(dtype)
    w = (torch.randn(512, 384, generator=g, device=cuda_device)
         / 512 ** 0.5).to(dtype)
    grads = []
    before = dict(tatp_dot.launches_by_layout)
    for dot in (tatp_dot, matmul_ref):
        xt, wt = (t.detach().requires_grad_(True) for t in (x, w))
        y = tatp.tatp_matmul(xt, wt, "model", 1, dot=dot)
        y.float().sum().backward()
        grads.append((xt.grad.float(), wt.grad.float()))
    torch.cuda.synchronize()
    after = tatp_dot.launches_by_layout
    assert [after[k] - before[k] for k in ("fwd", "dgrad", "wgrad")] == \
        [1, 1, 1]
    for got, ref in zip(*grads):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=tol, atol=tol)


if __name__ == "__main__":
    import sys

    if sys.argv[1] == "zero1-reference":
        _zero1_reference(sys.argv[2])
    else:
        _zero1_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
