"""The decoder-only architectures beyond deepseek-7b against repro on the
CPU: gemma-7b (GeGLU, scaled embeddings, head dim 256 at full width),
gemma2-9b (alternating sliding-window ``L`` and global ``G`` layers,
attention and logit soft-caps), qwen2-72b (QKV bias, GQA) and
internvl2-1b (the vision prefix: ``prefix_embeds`` take the first
``frontend_tokens`` positions).  For each reduced config (fp32) on weights
converted from the reference's tree: prefill logits and caches, 4 greedy
decode steps, the loss and every gradient leaf (with and without remat),
the one-shot serve driver end to end, and the synthetic batch.  The
prompts run past the reduced sliding window (16) and past the frontend's
4 prefix positions.  Then the features one by one: the embedding scale
before the prefix, soft-capped decode attention, the soft-capped train
head, and the attention core at gemma2's full-width head layout (16 query
heads over 8 K/V heads of 256).

Tolerances (fp32), as the serving and train slices' tests: logits and
caches 5e-4, the loss 1e-5, gradients 1e-4, attention outputs 1e-5;
greedy tokens identical."""

import argparse
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.configs.base import ParallelConfig as JaxPar
from repro.configs.base import ShapeConfig as JaxShape
from repro.core.dist import Dist as JaxDist
from repro.core.dist import make_mesh
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import transformer as jtf
from repro.train import data as jdata
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.core.dist import Dist
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttf
from repro_torch.train import data
from repro_torch.train.train_loop import loss_and_grads
from repro_torch.weights import params_from_jax

ARCHS = ["gemma-7b", "gemma2-9b", "qwen2-72b", "internvl2-1b"]
TOL = dict(rtol=5e-4, atol=5e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
B, S, STEPS = 2, 24, 4  # S > the reduced window (16) and prefix (4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(ref), **tol, err_msg=msg)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg, jcfg = get_reduced(arch), jax_reduced(arch)
    jparams = jax.tree.map(np.asarray,
                           jtf.init_params(jax.random.key(0), jcfg))
    params = params_from_jax(jparams, cfg, CPU)
    return arch, cfg, jcfg, jparams, params


def _ctxs(cfg, jcfg, phase, remat=False):
    jctx = jtf.RunCtx(jcfg, JaxPar(strategy="tatp", remat=remat),
                      JaxDist(make_mesh((1,), ("model",))), phase=phase)
    tctx = ttf.RunCtx(cfg, ParallelConfig(strategy="tatp", remat=remat),
                      Dist(CPU), phase=phase)
    return jctx, tctx


def _prompt(cfg, b=B, s=S, seed=0):
    """Prompts and, with a frontend, the stub prefix embeddings, drawn as
    the serve driver draws them."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (b, s))}
    if cfg.frontend_tokens:
        out["prefix_embeds"] = data.stub_embeds(
            rng, (b, cfg.frontend_tokens, cfg.d_model), cfg.dtype)
    return out


def test_reduced_configs_exercise_their_features(model):
    arch, cfg, _, _, params = model
    full = get_config(arch)
    if full.sliding_window:
        assert cfg.pattern_for_layers() == "LG" and S > cfg.sliding_window
        assert cfg.attn_softcap == 50.0 and cfg.logit_softcap == 30.0
    if full.qkv_bias:
        assert {"bq", "bk", "bv"} <= set(params["layers"]["u0"])
    if full.frontend:
        assert 0 < cfg.frontend_tokens < S
    assert cfg.scale_embed == full.scale_embed
    assert cfg.n_kv_heads <= cfg.n_heads


def test_prefill_and_decode_match_reference(model):
    arch, cfg, jcfg, jparams, params = model
    jctx, tctx = _ctxs(cfg, jcfg, "decode")
    batch = _prompt(cfg)
    jc, jl = jax.jit(lambda p, bt: jlm.prefill(jctx, p, bt))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tc, tl = tlm.prefill(tctx, params,
                         {k: torch.as_tensor(v) for k, v in batch.items()})
    _close(tl, jl, TOL)
    assert set(tc) == set(jc)
    for key in tc:
        for n in ("k", "v"):
            _close(tc[key][n], jc[key][n], TOL, f"{key}/{n}")
    jcache = jax.tree.map(jnp.asarray, jlm.graft_cache_slots(
        jax.device_get(jlm.init_cache(jctx, B, S + STEPS)),
        jax.device_get(jc), slots=range(B)))
    tcache = tlm.graft_cache_slots(tlm.init_cache(tctx, B, S + STEPS), tc,
                                   slots=range(B))
    jt = jnp.argmax(jl[:, -1:, :], axis=-1).astype(jnp.int32) \
        % cfg.vocab_size
    tt = tl[:, -1:, :].argmax(dim=-1) % cfg.vocab_size
    step = jax.jit(lambda p, t, c, n: jlm.decode_step(jctx, p, t, c, n))
    for i in range(STEPS):
        n = S + i + 1
        jt, jlog, jcache = step(jparams, jt, jcache,
                                jnp.full((B,), n, jnp.int32))
        tt, tlog, tcache = tlm.decode_step(tctx, params, tt, tcache,
                                           torch.full((B,), n))
        _close(tlog, jlog, TOL, f"decode step {i}")
        assert np.array_equal(np.asarray(jt), tt.numpy())


@pytest.fixture(scope="module")
def grads_ref(model):
    """The reference's loss and gradients on one synthetic batch (B x S,
    the stub prefix included)."""
    arch, cfg, jcfg, jparams, _ = model
    jctx, _ = _ctxs(cfg, jcfg, "train")
    ds = jdata.SyntheticDataset(jcfg, JaxShape("t", "train", S, B),
                                JaxDist(make_mesh((1, 1), ("data",
                                                           "model"))),
                                seed=3)
    batch = ds._host_batch(1)

    def f(p):
        nll, cnt, aux = jlm.loss_fn(jctx, p, batch)
        return nll / cnt + aux

    loss, g = jax.value_and_grad(f)(jax.tree.map(jnp.asarray, jparams))
    return batch, loss, _flat(g)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(model, grads_ref, remat):
    arch, cfg, jcfg, jparams, params = model
    batch, loss_ref, g_ref = grads_ref
    _, tctx = _ctxs(cfg, jcfg, "train", remat=remat)
    ds = data.SyntheticDataset(cfg, ShapeConfig("t", "train", S, B),
                               Dist(CPU), seed=3)
    tb = ds.batch(1)
    assert set(tb) == set(batch)
    for k, v in batch.items():
        np.testing.assert_array_equal(tb[k].numpy(), v, err_msg=k)
    nll, cnt, grads = loss_and_grads(tctx, params, tb)
    _close(nll / cnt, loss_ref, LOSS_TOL)
    grads = _flat(grads)
    assert set(grads) == set(g_ref)
    for name, g in grads.items():
        _close(g, g_ref[name], GRAD_TOL, name)
    if cfg.qkv_bias:
        assert float(grads["layers/u0/bq"].abs().sum()) > 0


def test_serve_matches_reference(model):
    from repro.launch.serve import serve as jax_serve
    from repro_torch.launch.serve import serve
    arch, *_, params = model
    args = argparse.Namespace(arch=arch, reduced=True, batch=2,
                              prompt_len=S, gen=STEPS, mesh=[1, 1],
                              plan=None, auto_plan=False, plan_cache=None,
                              device="cpu")
    ref = jax_serve(args)
    got = serve(args, params=params)
    assert got["generated_shape"] == ref["generated_shape"] == [2, STEPS + 1]
    assert got["sample"] == ref["sample"]


@pytest.mark.parametrize("arch", ["internvl2-1b", "gemma2-9b"])
def test_host_batch_at_full_width_matches_reference(arch):
    """The synthetic batch of the full config (bf16 stub embeddings
    included) equals the reference's, value for value."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    ours = data.SyntheticDataset(cfg, ShapeConfig("t", "train", 8, 2),
                                 Dist(CPU), seed=1)
    ref = jdata.SyntheticDataset(jcfg, JaxShape("t", "train", 8, 2),
                                 JaxDist(make_mesh((1, 1),
                                                   ("data", "model"))),
                                 seed=1)
    for step in (0, 3):
        host, jhost = ours._host_batch(step), ref._host_batch(step)
        assert set(host) == set(jhost)
        for k in host:
            assert host[k].dtype == jhost[k].dtype, k
            np.testing.assert_array_equal(host[k], jhost[k], err_msg=k)
    dev = ours.batch(0)
    assert dev["tokens"].dtype == torch.int64
    if cfg.frontend:
        assert dev["prefix_embeds"].dtype == torch.float32


@pytest.mark.parametrize("name", ["train_4k", "prefill_32k", "decode_32k",
                                  "long_500k"])
def test_shapes_match_reference(name):
    """The dry-run's input shapes are the reference's, field for field,
    and each architecture runs the same of them (``long_500k`` only with
    sub-quadratic sequence mixing)."""
    from dataclasses import asdict

    from repro.configs import ARCHITECTURES as JAX_ARCHS
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.configs import shape_applicable as jax_applicable
    from repro.configs.base import SUBQUADRATIC_FAMILIES as JAX_SUBQ
    from repro_torch.configs import (ARCHITECTURES, SHAPES,
                                     SUBQUADRATIC_FAMILIES, shape_applicable)

    assert list(SHAPES) == list(JAX_SHAPES)
    assert asdict(SHAPES[name]) == asdict(JAX_SHAPES[name])
    assert SUBQUADRATIC_FAMILIES == JAX_SUBQ
    assert set(ARCHITECTURES) == set(JAX_ARCHS)
    for arch in ARCHITECTURES:
        assert shape_applicable(get_config(arch), SHAPES[name]) == \
            jax_applicable(jax_config(arch), JAX_SHAPES[name]), arch


# ---------------------------------------------------------------------------
# the features one by one
# ---------------------------------------------------------------------------


def test_prefix_replaces_scaled_embeddings():
    """internvl2's prefix takes the first frontend_tokens positions after
    the embedding scale (here forced on), as the reference's."""
    cfg = replace(get_reduced("internvl2-1b"), scale_embed=True)
    jcfg = replace(jax_reduced("internvl2-1b"), scale_embed=True)
    jctx, tctx = _ctxs(cfg, jcfg, "prefill")
    rng = np.random.RandomState(4)
    embed = rng.randn(512, cfg.d_model).astype(np.float32)
    toks = rng.randint(0, cfg.vocab_size, (2, 7))
    pref = rng.randn(2, cfg.frontend_tokens, cfg.d_model).astype(np.float32)
    ref = jlm.embed_tokens(jctx, jnp.asarray(embed), jnp.asarray(toks),
                           jnp.asarray(pref))
    got = tlm.embed_tokens(tctx, torch.as_tensor(embed),
                           torch.as_tensor(toks), torch.as_tensor(pref))
    _close(got, ref, dict(rtol=0, atol=0), "prefix")
    np.testing.assert_array_equal(got[:, :4].numpy(), pref)
    np.testing.assert_array_equal(got[:, 4:].numpy(),
                                  embed[toks[:, 4:]] * cfg.d_model ** 0.5)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_with_softcap(window):
    rng = np.random.RandomState(5)
    q, kc, vc = (rng.randn(2, 1, 4, 16) * 4, rng.randn(2, 12, 2, 16) * 4,
                 rng.randn(2, 12, 2, 16))
    cl = np.array([7, 12])
    from repro_torch.models import attention as tattn
    got = tattn.decode_attention(*(torch.as_tensor(t, dtype=torch.float32)
                                   for t in (q, kc, vc)),
                                 torch.as_tensor(cl), axis="model",
                                 axis_size=1, window=window, cap=2.0)
    ref = jattn.decode_attention(*(jnp.asarray(t, jnp.float32)
                                   for t in (q, kc, vc)),
                                 jnp.asarray(cl), axis="model", axis_size=1,
                                 window=window, cap=2.0)
    _close(got, ref, LOSS_TOL)


def test_softcapped_train_head_grads_match_reference():
    """logit_softcap through the train head's autograd.Function: the
    capped logits and the gradients of x and the tied embedding."""
    cfg, jcfg = get_reduced("gemma2-9b"), jax_reduced("gemma2-9b")
    jctx, tctx = _ctxs(cfg, jcfg, "train")
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, cfg.d_model).astype(np.float32) * 3
    emb = rng.randn(512, cfg.d_model).astype(np.float32)
    g = rng.randn(2, 5, 512).astype(np.float32)

    def jf(x, e):
        return jnp.sum(jlm.lm_head_logits(jctx, {"embed": e}, x) * g)

    ref, (jdx, jde) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(emb))
    tx, te = (torch.tensor(a, requires_grad=True) for a in (x, emb))
    logits = tlm.lm_head_logits(tctx, {"embed": te}, tx)
    assert float(logits.detach().abs().max()) < cfg.logit_softcap
    got = (logits * torch.as_tensor(g)).sum()
    got.backward()
    _close(got, ref, LOSS_TOL)
    _close(tx.grad, jdx, GRAD_TOL)
    _close(te.grad, jde, GRAD_TOL)


def test_attention_at_gemma2_full_head_layout():
    """16 query heads over 8 K/V heads of 256, window and soft-cap: the
    port's attention (its plain version on the CPU) and its gradients
    against the reference's local attention."""
    rng = np.random.RandomState(7)
    s, window, cap = 40, 16, 50.0
    q, k, v, do = (rng.randn(1, s, h, 256).astype(np.float32)
                   for h in (16, 8, 8, 16))

    def jf(q, k, v):
        o = jattn.local_attention(q, k, v, causal=True, window=window,
                                  cap=cap)
        return jnp.sum(o * do), o

    (_, ref), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = attention(tq.transpose(1, 2), tk.transpose(1, 2),
                    tv.transpose(1, 2), causal=True, window=window,
                    cap=cap).transpose(1, 2)
    (out * torch.as_tensor(do)).sum().backward()
    _close(out, ref, LOSS_TOL)
    for t, g in zip((tq, tk, tv), jg):
        _close(t.grad, g, LOSS_TOL)
