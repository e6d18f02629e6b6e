"""repro_torch's train slice for the SSM models against the reference on
the CPU: ``loss_fn``'s loss and gradients, a 3-step ``make_train_step``
trajectory, remat, the training CLI and the hooks' calls per step, for
reduced mamba2-780m (2 x ``M``) and zamba2-2.7b (``MMSMMS``: two reps, so
the shared block's gradient gathers over two uses), d_model 64, 8 SSM
heads of 16, state 16, chunk 8, fp32, on converted weights.  Sequences
of 16 tokens are two chunks, so the inter-chunk recurrence's gradient
runs.

On the CPU the SSD's intra-chunk pass is its plain version, and autograd
differentiates it (on the card the backward kernel does; ``chip_smoke.py``
and the ``cuda`` tests of ``tests/test_torch_ssm.py`` hold it there).

Tolerances are ``tests/test_torch_train.py``'s: fp32 forward values and
gradients of the same arithmetic in another order, 1e-5 (1e-4 for the
gradients); parameters after k AdamW steps at atol = 2 * sum(lr_t)."""

import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.configs.base import ParallelConfig as JaxPar
from repro.configs.base import ShapeConfig as JaxShape
from repro.core.dist import Dist as JaxDist
from repro.core.dist import make_mesh
from repro.models import lm as jlm
from repro.models import transformer as jtf
from repro.train import data as jdata
from repro.train.train_loop import make_train_step as jax_train_step
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.core.dist import Dist
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.tatp_matmul.ref import matmul_ref
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.train import data
from repro_torch.train.train_loop import loss_and_grads, make_train_step
from repro_torch.weights import params_from_jax

ARCHS = ("mamba2-780m", "zamba2-2.7b")
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
# the chunked SSD hooks: the kernel-backed one (its plain intra-chunk pass
# on the CPU) and the plain oracle
SSD_HOOKS = {"kernel_backed": ssd_ops.ssd_chunked, "oracle": tssm.ssd_chunked}


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


def _configs(arch):
    """The reduced config, two reps of zamba2's ``MMS`` unit."""
    cfg, jcfg = get_reduced(arch), jax_reduced(arch)
    if arch == "zamba2-2.7b":
        cfg = replace(cfg, n_layers=2 * len(cfg.layer_pattern))
        jcfg = replace(jcfg, n_layers=2 * len(jcfg.layer_pattern))
    return cfg, jcfg


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg, jcfg = _configs(request.param)
    jparams = jax.tree.map(np.asarray,
                           jtf.init_params(jax.random.key(0), jcfg))
    return cfg, jcfg, jparams


def _ctxs(cfg, jcfg, remat=False, ssd="kernel_backed"):
    jctx = jtf.RunCtx(jcfg, JaxPar(strategy="tatp", remat=remat),
                      JaxDist(make_mesh((1,), ("model",))), phase="train")
    tctx = ttf.RunCtx(cfg, ParallelConfig(strategy="tatp", remat=remat),
                      Dist(CPU), phase="train", dot=matmul_ref,
                      attention=attention_ref, ssd=SSD_HOOKS[ssd])
    return jctx, tctx


def _batch(vocab, b=2, s=16, seed=3):
    toks = jdata._lcg_tokens(seed, b, s + 1, vocab)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _loss_grads(tctx, params, batch):
    nll, cnt, grads = loss_and_grads(tctx, params, batch)
    return nll / cnt, _flat(grads)


@pytest.mark.parametrize("ssd", sorted(SSD_HOOKS))
def test_loss_fn_grads_match_reference(model, ssd):
    """The loss and every gradient leaf of loss_fn against jax.grad of the
    reference's, on converted weights, with either chunked SSD hook."""
    cfg, jcfg, jparams = model
    jctx, tctx = _ctxs(cfg, jcfg, ssd=ssd)
    batch = _batch(cfg.vocab_size)

    def f(p):
        nll, cnt, aux = jlm.loss_fn(jctx, p, batch)
        return nll / cnt + aux

    loss_ref, g_ref = jax.value_and_grad(f)(jax.tree.map(jnp.asarray,
                                                         jparams))
    loss, grads = _loss_grads(tctx, params_from_jax(jparams, cfg, CPU),
                              _torch_batch(batch))
    _close(loss, loss_ref)
    g_ref = _flat(g_ref)
    assert set(grads) == set(g_ref)
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(_np(g), _np(g_ref[name]), **GRAD_TOL,
                                   err_msg=name)


def test_remat_gives_the_same_grads(model):
    cfg, jcfg, jparams = model
    batch = _torch_batch(_batch(cfg.vocab_size))
    runs = []
    for remat in (False, True):
        _, tctx = _ctxs(cfg, jcfg, remat=remat)
        runs.append(_loss_grads(tctx, params_from_jax(jparams, cfg, CPU),
                                batch))
    _close(runs[0][0], runs[1][0], rtol=0, atol=0)
    for name, g in runs[0][1].items():
        _close(runs[1][1][name], g, rtol=1e-6, atol=1e-7)


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

    shape = ShapeConfig("t", "train", s, b)
    bundle = make_train_step(cfg, ParallelConfig(strategy="tatp",
                                                 remat=False),
                             Dist(CPU), shape, dot=matmul_ref,
                             attention=attention_ref)
    state = bundle.opt.init(params)
    tdata = data.SyntheticDataset(cfg, shape, Dist(CPU))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_prints_reference_keys(capsys, arch):
    from repro_torch.launch.train import main
    main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
          "--batch", "2", "--seq", "16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"first_loss", "last_loss", "steps", "mean_step_s",
                        "plan_hash", "mesh"}
    assert out["steps"] == 3 and out["mesh"] == [1, 1]
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


# (arch, remat) -> hook calls per step.  Per Mamba-2 layer: in_proj and
# out_proj forward (again under remat), dgrad and wgrad, and one chunked
# SSD (again under remat); per shared block: its 6 linears (wq wk wv wo,
# w_up, w_down: gelu is not gated) the same way and one attention (again
# under remat); the lm head's forward, dgrad and wgrad once
_HOOK_CALLS = {
    ("mamba2-780m", True): dict(dot=2 * 8 + 3, attention=0, ssd=2 * 2),
    ("mamba2-780m", False): dict(dot=2 * 6 + 3, attention=0, ssd=2),
    ("zamba2-2.7b", True): dict(dot=4 * 8 + 2 * 24 + 3, attention=2 * 2,
                                ssd=4 * 2),
    ("zamba2-2.7b", False): dict(dot=4 * 6 + 2 * 18 + 3, attention=2,
                                 ssd=4),
}


@pytest.mark.parametrize("arch,remat", sorted(_HOOK_CALLS))
def test_train_step_calls_each_hook_once_per_product(arch, remat):
    """One train step calls the GEMM hook for every linear's forward
    (again in the backward under remat), dgrad and wgrad plus the lm
    head's three products, the attention hook once per shared block and
    the SSD hook once per Mamba-2 layer (each twice under remat): the
    per-step launch counts the card checks."""
    cfg, _ = _configs(arch)
    calls = {"dot": 0, "attention": 0, "ssd": 0}

    def dot(a, b, out_dtype=None):
        calls["dot"] += 1
        return matmul_ref(a, b, out_dtype)

    def attention(*args, **kw):
        calls["attention"] += 1
        return attention_ref(*args, **kw)

    def ssd(*args):
        calls["ssd"] += 1
        return ssd_ops.ssd_chunked(*args)

    shape = ShapeConfig("t", "train", 16, 2)
    bundle = make_train_step(cfg, ParallelConfig(remat=remat), Dist(CPU),
                             shape, dot=dot, attention=attention, ssd=ssd)
    params, state = bundle.init_fn(torch.Generator().manual_seed(0))
    batch = data.SyntheticDataset(cfg, shape, Dist(CPU)).batch(0)
    _, _, m = bundle.step_fn(params, state, batch)
    assert calls == _HOOK_CALLS[arch, remat]
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
