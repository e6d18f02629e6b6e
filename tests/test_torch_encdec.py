"""The encoder-decoder (seamless-m4t-large-v2) against repro on the CPU: the
parameter tree (the encoder's stacked blocks and final norm, one
cross-attention block per decoder rep) and its conversion, the encoder
alone, prefill (the decoder's self K/V and the cross K/V of the
encoder's output), 4 greedy decode steps reading the static cross cache,
the loss and every gradient leaf with and without remat, the
``tatp_outputs`` policy (the decoder's cross blocks replayed, the
encoder recomputed in full), the one-shot serve driver and the synthetic
batch (``enc_embeds``, the full config's bf16 stub too).

Reduced config: 2 encoder and 2 decoder layers, d_model 64, 4 heads of 16,
GELU MLP, 4 encoder frames by default (``frontend_tokens``); the tests
also run 12 frames against a 10-token decoder prompt, so the cross
attention is rectangular.  Tolerances (fp32), as the serving and train
slices' tests: logits and caches 5e-4, the loss 1e-5, gradients 1e-4;
greedy tokens identical."""

import argparse

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
from repro.models import lm as jlm
from repro.models import transformer as jtf
from repro.train import data as jdata
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.core import remat
from repro_torch.core.dist import Dist
from repro_torch.kernels.flash_attention.ops import attention as flash
from repro_torch.kernels.tatp_matmul.ops import tatp_dot
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttf
from repro_torch.train import data
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_loop import loss_and_grads
from repro_torch.weights import params_from_jax

ARCH = "seamless-m4t-large-v2"
TOL = dict(rtol=5e-4, atol=5e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
B, S, T, STEPS = 2, 10, 12, 4  # batch, decoder prompt, encoder frames


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(ref), **tol, err_msg=msg)


def _flat(tree):
    return {"/".join(k): v for k, v in tree_leaves(tree)}


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = get_reduced(ARCH), jax_reduced(ARCH)
    jparams = jax.tree.map(np.asarray,
                           jtf.init_params(jax.random.key(0), jcfg))
    params = params_from_jax(jparams, cfg, CPU)
    return cfg, jcfg, jparams, params


def _ctxs(cfg, jcfg, phase, remat=False, policy="full"):
    jctx = jtf.RunCtx(jcfg, JaxPar(strategy="tatp", remat=remat,
                                   remat_policy=policy),
                      JaxDist(make_mesh((1,), ("model",))), phase=phase)
    tctx = ttf.RunCtx(cfg, ParallelConfig(strategy="tatp", remat=remat,
                                          remat_policy=policy),
                      Dist(CPU), phase=phase)
    return jctx, tctx


def _serve_batch(cfg, frames=T):
    rng = np.random.RandomState(0)
    return {"tokens": rng.randint(0, cfg.vocab_size, (B, S)),
            "enc_embeds": data.stub_embeds(rng, (B, frames, cfg.d_model),
                                           cfg.dtype)}


def test_param_tree_and_conversion(model):
    cfg, jcfg, jparams, params = model
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jtf.param_shapes(jcfg))
    assert ttf.param_shapes(cfg) == jshapes
    assert cfg.n_enc_layers == 2 and cfg.n_layers == 2
    assert set(params["enc"]) == {"blocks", "final_ln"}
    assert params["enc"]["blocks"]["wq"].shape[0] == cfg.n_enc_layers
    assert set(params["cross"]) == {"wq", "wk", "wv", "wo", "ln"}
    for name, t in _flat(params).items():
        np.testing.assert_array_equal(
            t.numpy(), _flat_j(jparams)[name], err_msg=name)
    init = ttf.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    assert {n: tuple(t.shape) for n, t in _flat(init).items()} == \
        {n: tuple(t.shape) for n, t in _flat(params).items()}
    missing = {k: v for k, v in jparams.items() if k != "cross"}
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(missing, cfg, CPU)


def _flat_j(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_j(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_encoder_matches_reference(model):
    cfg, jcfg, jparams, params = model
    jctx, tctx = _ctxs(cfg, jcfg, "prefill")
    emb = _serve_batch(cfg)["enc_embeds"]
    ref = jlm._encoder(jctx, jax.tree.map(jnp.asarray, jparams),
                       jnp.asarray(emb))
    got = tlm._encoder(tctx, params, {"enc_embeds": torch.as_tensor(emb)})
    _close(got, ref, LOSS_TOL)


@pytest.mark.parametrize("frames", [4, T])
def test_prefill_and_decode_match_reference(model, frames):
    """Prefill's logits, self and cross caches, then 4 decode steps (their
    cross blocks read the static cache at the encoder's full length)."""
    cfg, jcfg, jparams, params = model
    jctx, tctx = _ctxs(cfg, jcfg, "decode")
    batch = _serve_batch(cfg, frames)
    jc, jl = jax.jit(lambda p, bt: jlm.prefill(jctx, p, bt))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tc, tl = tlm.prefill(tctx, params,
                         {k: torch.as_tensor(v) for k, v in batch.items()})
    _close(tl, jl, TOL)
    assert set(tc) == set(jc) == {"u0", "cross"}
    assert tuple(tc["cross"]["k"].shape) == (cfg.n_layers, B, frames,
                                             cfg.n_kv_heads, cfg.head_dim)
    for key in tc:
        for n in ("k", "v"):
            _close(tc[key][n], jc[key][n], TOL, f"{key}/{n}")
    jbig = jlm.init_cache(jctx, B, S + STEPS, enc_len=frames)
    tbig = tlm.init_cache(tctx, B, S + STEPS, enc_len=frames)
    assert {k: {n: tuple(t.shape) for n, t in v.items()}
            for k, v in tbig.items()} == \
        {k: {n: tuple(t.shape) for n, t in v.items()}
         for k, v in jbig.items()}
    jcache = jax.tree.map(jnp.asarray, jlm.graft_cache_slots(
        jax.device_get(jbig), jax.device_get(jc), slots=range(B)))
    tcache = tlm.graft_cache_slots(tbig, tc, slots=range(B))
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
    for n in ("k", "v"):  # the cross cache is read, never written
        _close(tcache["cross"][n], tc["cross"][n], dict(rtol=0, atol=0))


@pytest.fixture(scope="module")
def grads_ref(model):
    """The batch (the reference's synthetic one: 4 frames per row) and the
    reference's loss and gradients on it, without remat and under the
    tatp_outputs policy."""
    cfg, jcfg, jparams, _ = model
    ds = jdata.SyntheticDataset(jcfg, JaxShape("t", "train", S, B),
                                JaxDist(make_mesh((1, 1), ("data",
                                                           "model"))),
                                seed=3)
    batch = ds._host_batch(1)
    out = {}
    for policy in ("full", "tatp_outputs"):
        jctx, _ = _ctxs(cfg, jcfg, "train", remat=policy != "full",
                        policy=policy)

        def f(p):
            nll, cnt, aux = jlm.loss_fn(jctx, p, batch)
            return nll / cnt + aux

        loss, g = jax.value_and_grad(f)(jax.tree.map(jnp.asarray, jparams))
        out[policy] = (loss, _flat_j(g))
    return batch, out


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(model, grads_ref, remat):
    cfg, jcfg, _, params = model
    batch, ref = grads_ref
    loss_ref, g_ref = ref["full"]
    _, tctx = _ctxs(cfg, jcfg, "train", remat=remat)
    tb = data.SyntheticDataset(cfg, ShapeConfig("t", "train", S, B),
                               Dist(CPU), seed=3).batch(1)
    assert set(tb) == set(batch) == {"tokens", "labels", "enc_embeds"}
    for k, v in batch.items():
        np.testing.assert_array_equal(tb[k].numpy(), v, err_msg=k)
    nll, cnt, grads = loss_and_grads(tctx, params, tb)
    _close(nll / cnt, loss_ref, LOSS_TOL)
    grads = _flat(grads)
    assert set(grads) == set(g_ref)
    for name, g in grads.items():
        _close(g, g_ref[name], GRAD_TOL, name)
    for name in ("enc/blocks/wq", "cross/wk", "cross/wq"):
        assert float(grads[name].abs().sum()) > 0, name


def test_tatp_outputs_replays_cross_blocks_not_the_encoder(model, grads_ref):
    """Under tatp_outputs the decoder's reps replay their linears (the
    cross blocks' four included) and attention cores, while the encoder,
    checkpointed in full as the reference's plain jax.checkpoint, runs its
    linears and attention again in the backward, outside any replay; the
    loss and every gradient equal full remat's bitwise and match
    jax.grad of the reference under its tatp_outputs policy."""
    cfg, jcfg, _, params = model
    batch, ref = grads_ref
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    enc_lin = cfg.n_enc_layers * 6  # wq wk wv wo, w_up w_down (GELU)
    dec_lin = cfg.n_layers * (6 + 4)  # + the cross block's four
    runs = {}
    for policy in ("full", "tatp_outputs"):
        calls = dict(dot=0, dot_replayed=0, attention=0)

        def replaying():
            saved = remat.active()
            return saved is not None and saved.replaying

        def dot(a, b, out_dtype=None):
            calls["dot"] += 1
            calls["dot_replayed"] += replaying()
            return tatp_dot(a, b, out_dtype)

        def attention(*args, **kw):
            calls["attention"] += 1
            return flash(*args, **kw)

        tctx = ttf.RunCtx(cfg, ParallelConfig(strategy="tatp", remat=True,
                                              remat_policy=policy),
                          Dist(CPU), phase="train", dot=dot,
                          attention=attention)
        nll, cnt, grads = loss_and_grads(tctx, params, tb)
        runs[policy] = (nll / cnt, _flat(grads), dict(calls))
    (lf, gf, cf), (lt, gt, ct) = runs["full"], runs["tatp_outputs"]
    assert torch.equal(lf, lt)
    for name, g in gf.items():
        assert torch.equal(gt[name], g), name
    fwd = enc_lin + dec_lin + 1  # the head's product
    assert ct["dot"] == fwd + enc_lin + 2 * fwd
    assert cf["dot"] == ct["dot"] + dec_lin
    assert ct["dot_replayed"] == 0
    attn = cfg.n_enc_layers + 2 * cfg.n_layers
    assert cf["attention"] == ct["attention"] == 2 * attn
    loss_ref, g_ref = ref["tatp_outputs"]
    _close(lt, loss_ref, LOSS_TOL)
    for name, g in g_ref.items():
        _close(gt[name], g, GRAD_TOL, name)


def test_serve_matches_reference(model):
    from repro.launch.serve import serve as jax_serve
    from repro_torch.launch.serve import prompt_batch, serve
    cfg, _, _, params = model
    args = argparse.Namespace(arch=ARCH, reduced=True, batch=2,
                              prompt_len=S, gen=STEPS, mesh=[1, 1],
                              plan=None, auto_plan=False, plan_cache=None,
                              device="cpu")
    ref = jax_serve(args)
    got = serve(args, params=params)
    assert got["generated_shape"] == ref["generated_shape"] == [2, STEPS + 1]
    assert got["sample"] == ref["sample"]
    pb = prompt_batch(cfg, 2, S)
    assert set(pb) == {"tokens", "enc_embeds"}
    assert pb["enc_embeds"].shape == (2, cfg.frontend_tokens, cfg.d_model)


def test_host_batch_at_full_width_matches_reference():
    """The full config's synthetic batch (1024 bf16 stub frames a row)
    equals the reference's value for value."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    ours = data.SyntheticDataset(cfg, ShapeConfig("t", "train", 8, 2),
                                 Dist(CPU), seed=1)
    ref = jdata.SyntheticDataset(jcfg, JaxShape("t", "train", 8, 2),
                                 JaxDist(make_mesh((1, 1),
                                                   ("data", "model"))),
                                 seed=1)
    host, jhost = ours._host_batch(2), ref._host_batch(2)
    assert set(host) == set(jhost) == {"tokens", "labels", "enc_embeds"}
    for k in host:
        assert host[k].dtype == jhost[k].dtype, k
        np.testing.assert_array_equal(host[k], jhost[k], err_msg=k)
