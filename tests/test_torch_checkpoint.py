"""repro_torch's checkpoint/restart and the ``tatp_outputs`` remat policy on
the CPU: the checkpoint round trip (bitwise, fp32, bf16 and the
optimizer's integer step), keep-k GC, a stale ``.tmp`` directory,
``LATEST`` and ``read_meta``, the manifest against the reference's for the
reduced deepseek-7b, the training CLI's simulated failure and restart
against a straight run (bitwise), and ``remat_policy="tatp_outputs"`` on
the reduced deepseek-7b and zamba2-2.7b: gradients bitwise equal to full
remat's, no forward GEMM or attention call in the backward's recompute
(counted through the RunCtx hooks), and jax.grad of the reference under
its ``tatp_outputs`` policy within the train tests' tolerance (1e-5 for
the loss, 1e-4 for the gradients)."""

import json
import os
import time

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
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.train_loop import make_train_step as jax_train_step
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.core import remat
from repro_torch.core.dist import Dist
from repro_torch.kernels.flash_attention.ops import attention as flash
from repro_torch.kernels.tatp_matmul.ops import tatp_dot
from repro_torch.models import lm
from repro_torch.models import transformer as ttf
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import SyntheticDataset
from repro_torch.train.optimizer import AdamWConfig, OptState, tree_leaves
from repro_torch.train.train_loop import loss_and_grads, make_train_step
from repro_torch.weights import params_from_jax

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _tree(dtype):
    g = torch.Generator().manual_seed(0)
    w = torch.randn(3, 5, generator=g).to(dtype)
    return {"b": {"w": w, "s": torch.randn((), generator=g).to(dtype)},
            "a": torch.arange(7, dtype=torch.int32)}


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return type(a) is type(b) and all(map(_equal, a, b))
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.device == b.device
                and torch.equal(a, b))
    return type(a) is type(b) and a == b


# ---------------------------------------------------------------------------
# the checkpoint module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip_is_bitwise(tmp_path, dtype):
    """Tensors of the dtype and an OptState's integer step come back
    bitwise, as new tensors of the template's dtypes; bf16 is stored as
    its bit patterns under the name "bfloat16"."""
    tree = (_tree(dtype), OptState(5, {"w": torch.ones(2)}, {}, {}, {}))
    ckpt.save(str(tmp_path), 5, tree)
    template = (_tree(dtype), OptState(0, {"w": torch.zeros(2)}, {}, {},
                                       {}))
    got, step = ckpt.restore(str(tmp_path), template)
    assert step == 5 and _equal(got, tree)
    assert got[0]["b"]["w"] is not tree[0]["b"]["w"]
    assert got[1].step == 5 and isinstance(got[1].step, int)
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        leaves = {x["key"]: x for x in json.load(f)["leaves"]}
    want = "bfloat16" if dtype == torch.bfloat16 else "float32"
    assert leaves["0/b/w"] == {"key": "0/b/w", "shape": [3, 5],
                               "dtype": want}
    assert leaves["1/.step"] == {"key": "1/.step", "shape": [],
                                 "dtype": "int32"}
    with np.load(tmp_path / "step_00000005" / "proc00.npz") as data:
        stored = data["0/b/w"]
    if dtype == torch.bfloat16:
        assert stored.dtype == np.uint16
        assert np.array_equal(stored, tree[0]["b"]["w"].view(
            torch.int16).numpy().view(np.uint16))


def test_non_blocking_save_copies_before_returning(tmp_path):
    """The optimizer updates in place: what save() wrote is the state at
    the call, whatever happens to the tensors afterwards."""
    tree = _tree(torch.float32)
    want = tree["b"]["w"].clone()
    ckpt.save(str(tmp_path), 1, tree, blocking=False)
    tree["b"]["w"].add_(1.0)
    for _ in range(500):
        if ckpt.latest_step(str(tmp_path)) == 1:
            break
        time.sleep(0.01)
    got, _ = ckpt.restore(str(tmp_path), _tree(torch.float32))
    assert torch.equal(got["b"]["w"], want)


def test_keep_k_gc(tmp_path):
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, {"x": torch.zeros(3)}, keep=2)
    steps = sorted(x for x in os.listdir(tmp_path) if x.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_stale_tmp_is_ignored_and_replaced(tmp_path):
    """A crashed writer's step_*.tmp is neither published nor collected
    as a step, and the next save of that step replaces it."""
    stale = tmp_path / "step_00000002.tmp"
    stale.mkdir()
    (stale / "junk").write_text("half a checkpoint")
    ckpt.save(str(tmp_path), 1, {"x": torch.ones(2)}, keep=1)
    assert ckpt.latest_step(str(tmp_path)) == 1 and stale.exists()
    ckpt.save(str(tmp_path), 2, {"x": torch.full((2,), 2.0)}, keep=1)
    assert not stale.exists()
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000002"]
    got, step = ckpt.restore(str(tmp_path), {"x": torch.zeros(2)})
    assert step == 2 and torch.equal(got["x"], torch.full((2,), 2.0))


def test_latest_read_meta_and_idempotent_resave(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None and ckpt.read_meta(d) == {}
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, {"x": torch.zeros(1)})
    ckpt.save(d, 3, {"x": torch.ones(1)}, meta={"plan_hash": "abc", "n": 2})
    ckpt.save(d, 7, {"x": torch.ones(1)})
    assert (tmp_path / "LATEST").read_text() == "step_00000007"
    assert ckpt.read_meta(d, 3) == {"plan_hash": "abc", "n": 2}
    assert ckpt.read_meta(d) == {}
    # re-saving a published step leaves it as it is
    ckpt.save(d, 3, {"x": torch.zeros(1)})
    got, _ = ckpt.restore(d, {"x": torch.zeros(1)}, step=3)
    assert torch.equal(got["x"], torch.ones(1))
    with pytest.raises(ValueError, match="does not match"):
        ckpt.restore(d, {"y": torch.zeros(1)})


def test_manifest_matches_reference(tmp_path):
    """(params, opt_state) of the reduced deepseek-7b: the same leaf keys,
    shapes and dtypes, in the same order, as repro.train.checkpoint.save
    writes for the reference's."""
    arch = "deepseek-7b"
    jb = jax_train_step(jax_reduced(arch),
                        JaxPar(strategy="tatp", remat=False),
                        JaxDist(make_mesh((1, 1), ("data", "model"))),
                        JaxShape("t", "train", 16, 2))
    jckpt.save(str(tmp_path / "ref"), 1, jb.init_fn(jax.random.key(0)))
    tb = make_train_step(get_reduced(arch), ParallelConfig(remat=False),
                         Dist(CPU), ShapeConfig("t", "train", 16, 2))
    ckpt.save(str(tmp_path / "port"), 1,
              tb.init_fn(torch.Generator().manual_seed(0)))
    man = {}
    for side in ("ref", "port"):
        with open(tmp_path / side / "step_00000001" / "manifest.json") as f:
            man[side] = json.load(f)
    assert man["port"]["leaves"] == man["ref"]["leaves"]
    assert len(man["port"]["leaves"]) > 50


def test_compressed_state_checkpoints_in_the_reference_layout(tmp_path):
    """With int8 gradient compression the optimizer state's ``err``
    leaves are the master's shape: the manifest's keys, shapes and dtypes
    are the reference's, the port restores its residuals bitwise and the
    reference's restore reads the same values."""
    arch = "deepseek-7b"
    jdist = JaxDist(make_mesh((1, 1), ("data", "model")))
    jb = jax_train_step(jax_reduced(arch),
                        JaxPar(strategy="tatp", remat=False), jdist,
                        JaxShape("t", "train", 16, 2),
                        jopt.AdamWConfig(grad_compress=True))
    jckpt.save(str(tmp_path / "ref"), 1, jb.init_fn(jax.random.key(0)))
    cfg = get_reduced(arch)
    tb = make_train_step(cfg, ParallelConfig(remat=False), Dist(CPU),
                         ShapeConfig("t", "train", 16, 2),
                         AdamWConfig(grad_compress=True))
    params, state = tb.init_fn(torch.Generator().manual_seed(0))
    ds = SyntheticDataset(cfg, ShapeConfig("t", "train", 16, 2), Dist(CPU))
    for step in range(2):
        params, state, _ = tb.step_fn(params, state, ds.batch(step))
    ckpt.save(str(tmp_path / "port"), 2, (params, state))
    man = {}
    for side, step in (("ref", 1), ("port", 2)):
        with open(tmp_path / side / f"step_{step:08d}" / "manifest.json") as f:
            man[side] = json.load(f)
    assert man["port"]["leaves"] == man["ref"]["leaves"]
    assert any(k.startswith("1/.err/") and len(v["shape"]) == 2
               for k, v in ((leaf["key"], leaf)
                            for leaf in man["port"]["leaves"]))
    (_, got), step = ckpt.restore(
        str(tmp_path / "port"),
        tb.init_fn(torch.Generator().manual_seed(1)))
    assert step == 2
    err = list(tree_leaves(state.err))
    for (k, v), (_, w) in zip(err, tree_leaves(got.err)):
        assert torch.equal(v, w), k
    template = jax.eval_shape(lambda: jb.init_fn(jax.random.key(0)))
    (_, jgot), _ = jckpt.restore(str(tmp_path / "port"), template, jdist,
                                 (jb.pspecs, jb.ospecs))
    jerr = jax.tree_util.tree_leaves(jgot.err)
    assert len(jerr) == len(err)
    for (k, v), j in zip(err, jerr):
        np.testing.assert_array_equal(v.numpy(), np.asarray(j),
                                      err_msg="/".join(k))
    assert any(float(v.abs().max()) > 0 for _, v in err)


# ---------------------------------------------------------------------------
# the training CLI's restart
# ---------------------------------------------------------------------------


def test_train_fail_at_step_and_restart_equals_straight_run(tmp_path,
                                                            capsys):
    """--fail-at-step 4 stops an 8-step run after the step-4 checkpoint; a
    rerun without it resumes there and ends in the state (parameters,
    masters, moments, step) of a straight 8-step run, bitwise."""
    from repro_torch.launch.train import main
    common = ["--arch", "deepseek-7b", "--reduced", "--device", "cpu",
              "--steps", "8", "--batch", "2", "--seq", "16",
              "--ckpt-every", "2", "--log-every", "100"]
    straight, failed = str(tmp_path / "straight"), str(tmp_path / "failed")
    main(common + ["--ckpt-dir", straight])
    with pytest.raises(RuntimeError, match="simulated node failure"):
        main(common + ["--ckpt-dir", failed, "--fail-at-step", "4"])
    assert ckpt.latest_step(failed) == 4
    capsys.readouterr()
    main(common + ["--ckpt-dir", failed])
    out = capsys.readouterr().out
    assert "resuming" in out
    assert json.loads(out.strip().splitlines()[-1])["steps"] == 4
    assert ckpt.latest_step(failed) == ckpt.latest_step(straight) == 8
    runs = [np.load(os.path.join(d, "step_00000008", "proc00.npz"))
            for d in (straight, failed)]
    assert runs[0].files == runs[1].files
    for k in runs[0].files:
        assert np.array_equal(runs[0][k], runs[1][k]), k
    assert int(runs[1]["1/.step"]) == 8


# ---------------------------------------------------------------------------
# remat_policy="tatp_outputs"
# ---------------------------------------------------------------------------


def _lcg_batch(vocab, b=2, s=16, seed=3):
    toks = jdata._lcg_tokens(seed, b, s + 1, vocab)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _flat(tree, prefix=""):
    return {"/".join(k): v for k, v in tree_leaves(tree)}


@pytest.mark.parametrize("arch,seq", [("deepseek-7b", 16),
                                      ("zamba2-2.7b", 16)])
def test_tatp_outputs_gradients_and_recompute(arch, seq, monkeypatch):
    """Full remat and tatp_outputs on the same weights and batch, through
    counting hooks around the port's own GEMM and attention wrappers and
    a count of the attention wrapper's forwards (its plain forward on the
    CPU): the loss and every gradient bitwise equal; the tatp_outputs
    recompute calls the GEMM hook not at all and calls the attention hook
    without running a forward (full remat's runs every linear and every
    attention forward of every rep again); and the gradients match
    jax.grad of the reference under its tatp_outputs policy."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    cfg, jcfg = get_reduced(arch), jax_reduced(arch)
    jparams = jax.tree.map(np.asarray, jtf.init_params(jax.random.key(0),
                                                       jcfg))
    batch = _lcg_batch(cfg.vocab_size, s=seq)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    runs = {}
    plain_fwd = flash_ops.attention_ref
    for policy in ("full", "tatp_outputs"):
        calls = {"dot": 0, "attention": 0, "dot_recompute": 0,
                 "attention_recompute": 0, "attention_fwd": 0,
                 "attention_fwd_recompute": 0}

        def in_recompute():
            saved = remat.active()
            return saved is not None and saved.replaying

        def attention_fwd(*args, **kw):
            calls["attention_fwd"] += 1
            calls["attention_fwd_recompute"] += in_recompute()
            return plain_fwd(*args, **kw)

        monkeypatch.setattr(flash_ops, "attention_ref", attention_fwd)

        def dot(a, b, out_dtype=None):
            calls["dot"] += 1
            calls["dot_recompute"] += in_recompute()
            return tatp_dot(a, b, out_dtype)

        def attention(*args, **kw):
            calls["attention"] += 1
            calls["attention_recompute"] += in_recompute()
            return flash(*args, **kw)

        par = ParallelConfig(strategy="tatp", remat=True,
                             remat_policy=policy)
        tctx = ttf.RunCtx(cfg, par, Dist(CPU), phase="train", dot=dot,
                          attention=attention)
        params = params_from_jax(jparams, cfg, CPU)
        flat = [p for _, p in tree_leaves(params)]
        for p in flat:
            p.requires_grad_(True)
        nll, cnt, aux = lm.loss_fn(tctx, params, tb)
        forward = dict(calls)
        loss = nll / cnt.detach() + aux
        grads = torch.autograd.grad(loss, flat)
        runs[policy] = (loss.detach(), grads, forward, dict(calls))
    lf, gf, ff, cf = runs["full"]
    lt, gt, ft, ct = runs["tatp_outputs"]
    assert torch.equal(lf, lt)
    for a, b in zip(gf, gt):
        assert torch.equal(a, b)
    assert ff == ft  # the first passes make the same calls
    # the linears (and the head) run their dgrad and wgrad either way; the
    # full recompute runs each rep's forward linears and attention again
    n_linear = ff["dot"] - 1
    assert ff["attention_fwd"] == ff["attention"] > 0
    assert ct["dot_recompute"] == ct["attention_fwd_recompute"] == 0
    assert ct["attention_recompute"] == ft["attention"]
    assert ct["attention_fwd"] == ft["attention_fwd"]
    assert ct["dot"] == ft["dot"] + 2 * (n_linear + 1)
    assert cf["dot"] == ct["dot"] + n_linear
    assert cf["attention_fwd"] == 2 * ff["attention_fwd"]

    jctx = jtf.RunCtx(jcfg, JaxPar(strategy="tatp", remat=True,
                                   remat_policy="tatp_outputs"),
                      JaxDist(make_mesh((1,), ("model",))), phase="train")

    def jloss(p):
        nll, cnt, aux = jlm.loss_fn(jctx, p, batch)
        return nll / cnt + aux

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jparams))
    np.testing.assert_allclose(float(lt), float(jl), **TOL)
    names = [n for n, _ in tree_leaves(params_from_jax(jparams, cfg, CPU))]
    jflat = _flat(jax.tree.map(np.asarray, jg))
    for name, g in zip(names, gt):
        np.testing.assert_allclose(g.numpy(), jflat["/".join(name)],
                                   **GRAD_TOL)


def test_tatp_outputs_with_moe_gives_full_remat_grads():
    """Both remat policies run the MoE blocks; their gradients agree
    bitwise (the router and the expert products are recomputed under
    either)."""
    cfg = get_reduced("olmoe-1b-7b")
    shape = ShapeConfig("t", "train", 16, 2)
    grads = []
    for policy in ("full", "tatp_outputs"):
        b = make_train_step(cfg, ParallelConfig(remat=True,
                                                remat_policy=policy),
                            Dist(CPU), shape)
        params, _ = b.init_fn(torch.Generator().manual_seed(0))
        batch = SyntheticDataset(cfg, shape, Dist(CPU)).batch(0)
        grads.append(loss_and_grads(b.ctx, params, batch))
    assert torch.equal(grads[0][0], grads[1][0])
    for (n, a), (_, b) in zip(tree_leaves(grads[0][2]),
                              tree_leaves(grads[1][2])):
        assert torch.equal(a, b), n


def test_unknown_remat_policy_raises():
    cfg = get_reduced("deepseek-7b")
    ctx = ttf.RunCtx(cfg, ParallelConfig(remat=True, remat_policy="dots"),
                     Dist(CPU), phase="train")
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    b = _lcg_batch(cfg.vocab_size)
    with pytest.raises(ValueError, match="remat_policy"):
        lm.loss_fn(ctx, params, {k: torch.as_tensor(v) for k, v in
                                 b.items()})


def test_saved_outputs_replay_in_order():
    """Each kind replays in its own call order, whatever the other kind
    recorded between; a tagged computation runs only outside a replay."""
    saved = remat.SavedOutputs()
    saved.run(lambda: [saved.put(kind, (kind, i)) for i in range(3)
                       for kind in ("linear", "attention")])
    assert len(saved) == 6 and remat.active() is None
    got = saved.run(lambda: [saved.take("attention") for _ in range(3)]
                    + [saved.take("linear") for _ in range(3)])
    assert got == [("attention", i) for i in range(3)] + [
        ("linear", i) for i in range(3)]
    with pytest.raises(RuntimeError, match="more saved linear outputs"):
        saved.run(lambda: [saved.take("linear") for _ in range(4)])
    with pytest.raises(RuntimeError, match="cannot record"):
        saved.run(lambda: saved.put("linear", 9))
    assert remat.active() is None

    ran = []
    rep = remat.SavedOutputs()
    first = rep.run(lambda: remat.saved_or_run(
        "linear", lambda: ran.append(1) or torch.ones(2)))
    again = rep.run(lambda: remat.saved_or_run(
        "linear", lambda: ran.append(2) or torch.zeros(2)))
    assert ran == [1] and torch.equal(first, again) and again is not first
    assert remat.saved_or_run("linear", lambda: 7) == 7


def test_flash_wrapper_on_cpu_runs_the_plain_backward():
    """Under autograd on the CPU, the flash wrapper's Function runs the
    plain forward with its log-sum-exp and the written-out plain backward;
    its gradients match autograd through the plain forward."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 4, 9, 16, generator=g, requires_grad=True)
    k = torch.randn(2, 2, 9, 16, generator=g, requires_grad=True)
    v = torch.randn(2, 2, 9, 16, generator=g, requires_grad=True)
    do = torch.randn(2, 4, 9, 16, generator=g)
    for kw in (dict(causal=True, window=None, cap=None),
               dict(causal=True, window=3, cap=5.0),
               dict(causal=False, window=None, cap=None)):
        o = flash(q, k, v, **kw)
        assert o.grad_fn is not None and "FlashAttention" in \
            type(o.grad_fn).__name__
        got = torch.autograd.grad(o, (q, k, v), do)
        want = torch.autograd.grad(attention_ref(q, k, v, **kw), (q, k, v),
                                   do)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
