"""The port's plan IR, pipeline schedule and plan verifier
(``repro_torch.core.plan``, ``core.schedule``, ``analysis.verify``)
against the reference's on the same inputs.

Plans compiled by both packages must be byte-identical JSON with equal
``plan_hash``, and a plan cached by either package must answer the
other's lookup.  Plan JSON carries the solve's wall-clock time
(``solver.search_time_s``), so the byte comparisons stop the solvers'
clocks (:func:`frozen_clocks`); nothing else is normalised.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.analysis import verify as rverify
from repro.configs import get_config as ref_config
from repro.configs import get_reduced as jax_reduced
from repro.configs.base import ParallelConfig as JaxPar
from repro.configs.base import ShapeConfig as JaxShape
from repro.core import plan as rplan
from repro.core import schedule as rsched
from repro.core.dist import Dist as JaxDist
from repro.core.dist import make_mesh
from repro.models import lm as jlm
from repro.models import transformer as jtf
from repro.train import data as jdata
from repro.train.train_loop import batch_specs
from repro.train.train_loop import make_serve_fns as jax_serve_fns
from repro.wafer import mapping as rmap
from repro.wafer import solver as rsolver
from repro.wafer import topology as rtopo
from repro_torch.analysis import verify as tverify
from repro_torch.configs import ARCHITECTURES, get_config, get_reduced
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.core import plan as tplan
from repro_torch.core import schedule as tsched
from repro_torch.core.dist import Dist
from repro_torch.launch.mesh import (make_mesh_dist, make_plan_dist,
                                     plan_mesh_shape)
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttf
from repro_torch.train import data
from repro_torch.train.train_loop import loss_and_grads, make_serve_fns
from repro_torch.wafer import mapping as tmap
from repro_torch.wafer import simulator as tsim
from repro_torch.wafer import solver as tsolver
from repro_torch.wafer import topology as ttopo
from repro_torch.weights import params_from_jax

REF = types.SimpleNamespace(plan=rplan, verify=rverify, topo=rtopo,
                            map=rmap, config=ref_config)
PORT = types.SimpleNamespace(plan=tplan, verify=tverify, topo=ttopo,
                             map=tmap, config=get_config)
DEAD_DIES = (3, 7, 12)
DEAD_LINKS = ((20, 21),)


@pytest.fixture
def frozen_clocks(monkeypatch):
    still = types.SimpleNamespace(time=lambda: 0.0)
    monkeypatch.setattr(rsolver, "time", still)
    monkeypatch.setattr(tsolver, "time", still)


def _wafer(pkg, degraded: bool):
    w = pkg.topo.Wafer(pkg.topo.WaferSpec())
    return w.with_faults(dies=DEAD_DIES, links=DEAD_LINKS) if degraded \
        else w


def _only_file(cache: str, prefix: str) -> str:
    (path,) = glob.glob(os.path.join(cache, f"{prefix}_*.json"))
    return path


def _same_entry(rcache: str, tcache: str, prefix: str):
    rpath, tpath = _only_file(rcache, prefix), _only_file(tcache, prefix)
    assert os.path.basename(rpath) == os.path.basename(tpath)
    with open(rpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()


def _compile(pkg, kind: str, arch: str, degraded: bool, cache: str):
    if kind == "plan":
        return pkg.plan.compile_plan(_wafer(pkg, degraded),
                                     pkg.config(arch), 4, 512,
                                     cache_dir=cache)
    if kind == "splan":
        return pkg.plan.compile_serve_plan(_wafer(pkg, degraded),
                                           pkg.config(arch), 4, 160,
                                           cache_dir=cache)
    wafers = [_wafer(pkg, False), _wafer(pkg, degraded)]
    return pkg.plan.compile_multiwafer_plan(wafers, pkg.config(arch), 4,
                                            512, cache_dir=cache)


# ---------------------------------------------------------------------------
# compiled plans: byte-identical JSON, equal hashes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
@pytest.mark.parametrize("kind", ("plan", "splan", "mwplan"))
def test_compiled_plans_match_reference(kind, arch, tmp_path,
                                        frozen_clocks):
    """``compile_plan`` (train, 4 × 512), ``compile_serve_plan`` (4
    slots × 160 tokens) and ``compile_multiwafer_plan`` (two wafers), on
    a pristine wafer and a degraded one (dead dies and a dead link)."""
    for degraded in (False, True):
        rc = str(tmp_path / f"ref{degraded}")
        tc = str(tmp_path / f"port{degraded}")
        r = _compile(REF, kind, arch, degraded, rc)
        t = _compile(PORT, kind, arch, degraded, tc)
        assert r.dumps() == t.dumps()
        assert r.plan_hash == t.plan_hash
        assert r.summary() == t.summary()
        _same_entry(rc, tc, kind)
        if kind == "plan":
            assert dataclasses.asdict(r.parallel_config()) == \
                dataclasses.asdict(t.parallel_config())
            assert t.mesh_shape_for(1) == (1, 1)
            for n in (1, 2, 8, 32):
                assert r.mesh_shape_for(n) == t.mesh_shape_for(n)
        if kind == "mwplan":
            assert (r.pp, r.stage_layers, r.n_micro, r.family) == \
                (t.pp, t.stage_layers, t.n_micro, t.family)
            assert [s.plan_hash for s in r.stages] == \
                [s.plan_hash for s in t.stages]


def test_gemma_serve_plan_prescribes_megatron(tmp_path):
    """gemma-7b's one-shot serve plan (4 × 160) is the one whose strategy
    is not ``tatp``: the launcher runs it at model degree 1."""
    t = tplan.compile_plan(_wafer(PORT, False), get_config("gemma-7b"), 4,
                           160, cache_dir=str(tmp_path), remat=False)
    assert t.degrees_tuple() == (1, 2, 2, 1)
    assert t.parallel_config().strategy == "megatron"
    assert t.mesh_shape_for(1) == (1, 1)


@pytest.mark.parametrize("n_wafers", (2, 4, 8))
def test_multiwafer_layer_splits_match_reference(n_wafers, tmp_path,
                                                 frozen_clocks):
    r = rplan.compile_multiwafer_plan(
        [_wafer(REF, False)] * n_wafers, ref_config("deepseek-7b"), 4, 512,
        cache_dir=str(tmp_path / "ref"))
    t = tplan.compile_multiwafer_plan(
        [_wafer(PORT, False)] * n_wafers, get_config("deepseek-7b"), 4,
        512, cache_dir=str(tmp_path / "port"))
    assert r.dumps() == t.dumps()
    assert t.stage_layers == {2: (15, 15), 4: (8, 8, 7, 7),
                              8: (4, 4, 4, 4, 4, 4, 3, 3)}[n_wafers]
    assert repr(r.pipeline_schedule()) == repr(t.pipeline_schedule())


def test_pipeline_schedules_match_reference():
    for family in ("gpipe", "1f1b"):
        for pp, m in ((1, 1), (2, 4), (4, 8), (8, 32), (3, 5)):
            r = rsched.pipeline_schedule(family, pp, m)
            t = tsched.pipeline_schedule(family, pp, m)
            assert repr(r) == repr(t), (family, pp, m)
            assert repr(rsched.simulate_pipeline(r)) == \
                repr(tsched.simulate_pipeline(t))
            fwd = [1.0 + 0.25 * i for i in range(pp)]
            bwd = [2.0 + 0.125 * i for i in range(pp)]
            assert rsched.pipeline_step_time(r, fwd, bwd, 0.0625) == \
                tsched.pipeline_step_time(t, fwd, bwd, 0.0625)
    for n in (2, 4, 8):
        assert repr(rsched.simulate(rsched.ring_schedule(n))) == \
            repr(tsched.simulate(tsched.ring_schedule(n)))
        assert repr(rsched.line_schedule(n)) == repr(tsched.line_schedule(n))


# ---------------------------------------------------------------------------
# one cache, two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ("plan", "splan", "mwplan"))
def test_cache_answers_across_packages(kind, tmp_path, frozen_clocks):
    """A plan the reference wrote is a cache hit for the port, and the
    other way round; the solver does not run on the hit."""
    for writer, reader, arch in ((REF, PORT, "deepseek-7b"),
                                 (PORT, REF, "olmoe-1b-7b")):
        cache = str(tmp_path / f"{arch}")
        written = _compile(writer, kind, arch, True, cache)
        reader.plan.reset_plan_stats()
        read = _compile(reader, kind, arch, True, cache)
        assert reader.plan.PLAN_STATS["cache_hits"] == 1
        assert reader.plan.PLAN_STATS["solver_calls"] == 0
        assert read.dumps() == written.dumps()
        assert read.plan_hash == written.plan_hash
    assert tplan.default_cache_dir() == rplan.default_cache_dir()


def test_default_cache_dir_reads_the_same_variable(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path))
    assert tplan.default_cache_dir() == rplan.default_cache_dir() \
        == str(tmp_path)
    assert tplan.PLAN_VERSION == rplan.PLAN_VERSION


@pytest.mark.parametrize("name", ("tierb", "stage1"))
def test_jitted_tier_settings_raise_a7(name, tmp_path, monkeypatch,
                                       frozen_clocks):
    """The reference's jitted-tier setting ``"jax"`` (ROADMAP.md item A7)
    raises ``ValueError`` in all three plan compilers, by argument
    (``tierb``) and through ``REPRO_TIERB`` / ``REPRO_STAGE1``, before
    anything is cached; the port's ``"torch:cpu"`` tier compiles the
    reference's numpy-tier plans byte for byte, with equal hashes."""
    w, cfg = _wafer(PORT, False), get_config("deepseek-7b")
    empty = str(tmp_path / "raised")
    if name == "tierb":
        with pytest.raises(ValueError, match="'torch'"):
            tplan.compile_plan(w, cfg, 4, 512, tierb="jax", cache_dir=empty)
        with pytest.raises(ValueError, match="'torch'"):
            tplan.compile_serve_plan(w, cfg, 4, 160, tierb="jax",
                                     cache_dir=empty)
    monkeypatch.setenv("REPRO_" + name.upper(), "jax")
    with pytest.raises(ValueError, match="'torch'"):
        tplan.compile_multiwafer_plan([w, w], cfg, 4, 512, cache_dir=empty)
    assert not glob.glob(os.path.join(empty, "*.json"))
    monkeypatch.delenv("REPRO_" + name.upper())
    want = {kind: _compile(REF, kind, "olmoe-1b-7b", True,
                           str(tmp_path / f"ref-{kind}"))
            for kind in ("plan", "splan", "mwplan")}
    monkeypatch.setenv("REPRO_" + name.upper(), "torch:cpu")
    calls = dict(tsim.TIER_CALLS)
    for kind, r in want.items():
        t = _compile(PORT, kind, "olmoe-1b-7b", True,
                     str(tmp_path / f"port-{kind}"))
        assert t.dumps() == r.dumps(), kind
        assert t.plan_hash == r.plan_hash, kind
    assert tsim.TIER_CALLS[name] > calls[name]
    if name == "tierb":
        monkeypatch.delenv("REPRO_TIERB")
        t = tplan.compile_serve_plan(
            _wafer(PORT, True), get_config("olmoe-1b-7b"), 4, 160,
            tierb="torch:cpu", cache_dir=str(tmp_path / "arg"))
        assert t.dumps() == want["splan"].dumps()


# ---------------------------------------------------------------------------
# the verifier: the same violations on the same corruptions
# ---------------------------------------------------------------------------


def _violations(vs):
    return [dataclasses.astuple(v) for v in vs]


def _both(fn, tmp_path):
    """``fn(pkg, plan, wafer, cfg)`` on each package's own deepseek-7b
    train plan; the two lists of violations."""
    out = []
    for pkg in (REF, PORT):
        w = _wafer(pkg, False)
        cfg = pkg.config("deepseek-7b")
        plan = pkg.plan.compile_plan(w, cfg, 512, 2048, use_cache=False,
                                     cache_dir=str(tmp_path / str(
                                         pkg is PORT)))
        out.append(_violations(fn(pkg, plan, w, cfg)))
    return out


CORRUPTIONS = {
    "clean": lambda pkg, p, w, cfg: pkg.verify.verify_plan(p, w, cfg),
    "stale-version": lambda pkg, p, w, cfg: pkg.verify.verify_plan(
        dataclasses.replace(p, version=pkg.plan.PLAN_VERSION - 1), w, cfg),
    "order-not-bijective": lambda pkg, p, w, cfg: pkg.verify.verify_plan(
        dataclasses.replace(p, device_order=p.device_order[:-1]
                            + (p.device_order[0],)), w, cfg),
    "order-not-snake": lambda pkg, p, w, cfg: pkg.verify.verify_plan(
        dataclasses.replace(p, device_order=tuple(
            reversed(p.device_order))), w, cfg),
    "mem-flag": lambda pkg, p, w, cfg: pkg.verify.verify_plan(
        dataclasses.replace(p, predicted=dict(
            p.predicted, mem_per_die=w.spec.hbm_cap * 4, oom=False)),
        w, cfg),
    "alive-dies": lambda pkg, p, w, cfg: pkg.verify.verify_plan(
        dataclasses.replace(p, failed_dies=(p.alive_dies[0],)), w, cfg),
    "oversubscribed": lambda pkg, p, w, cfg: pkg.verify.verify_plan(
        dataclasses.replace(p, dp=8, tp=6), w, cfg),
}


@pytest.mark.parametrize("corruption", sorted(CORRUPTIONS))
def test_verify_plan_matches_reference(corruption, tmp_path):
    r, t = _both(CORRUPTIONS[corruption], tmp_path)
    assert r == t
    assert (r == []) == (corruption == "clean")


def test_verify_degraded_hand_built_plan_matches_reference():
    """A hand-built plan on a 6 × 8 wafer with one dead die (the
    reference test's 47-die plan) and an oversubscribed variant."""
    out = []
    for pkg in (REF, PORT):
        w = pkg.topo.Wafer(pkg.topo.WaferSpec(rows=6, cols=8),
                           frozenset({0}))
        alive = sorted(w.alive_dies())
        order = tuple(d for d in pkg.map.snake_order(6, 8) if d in alive)
        plan = pkg.plan.WaferPlan(
            arch="deepseek-7b", batch=512, seq=2048, wafer_rows=6,
            wafer_cols=8, failed_dies=(0,), failed_links=(),
            alive_dies=tuple(alive), dp=4, tp=4, sp=1, tatp=2,
            seq_par=False, engine="tcme", space="temp", device_order=order)
        out.append((_violations(pkg.verify.verify_plan(plan, w)),
                    _violations(pkg.verify.verify_plan(
                        dataclasses.replace(plan, dp=8, tp=6), w))))
    assert out[0] == out[1]
    assert out[1][0] == [] and out[1][1]


def test_verify_serve_plan_matches_reference(tmp_path):
    out = []
    for pkg in (REF, PORT):
        w, cfg = _wafer(pkg, False), pkg.config("deepseek-7b")
        sp = pkg.plan.compile_serve_plan(w, cfg, 64, 4096,
                                         cache_dir=str(tmp_path / str(
                                             pkg is PORT)))
        small = pkg.topo.Wafer(dataclasses.replace(w.spec, hbm_cap=2e9))
        half = dataclasses.replace(
            sp, kv_budget_tokens=sp.max_batch * sp.max_seq // 2)
        over = dataclasses.replace(
            sp, kv_budget_tokens=sp.max_batch * sp.max_seq * 2)
        out.append([_violations(pkg.verify.verify_plan(p, ww, cfg))
                    for p, ww in ((sp, w), (sp, small), (half, w),
                                  (over, w))])
    assert out[0] == out[1]
    assert out[1][0] == [] and all(out[1][1:])


def _edited_entry(pkg, tmp_path, edit):
    """Compile into a fresh cache, rewrite the entry with ``edit`` at one
    path both packages use, and verify that file."""
    cache = str(tmp_path / str(pkg is PORT))
    pkg.plan.compile_plan(_wafer(pkg, False), pkg.config("deepseek-7b"),
                          512, 2048, cache_dir=cache)
    src = _only_file(cache, "plan")
    dst = tmp_path / "entry" / os.path.basename(src)
    dst.parent.mkdir(exist_ok=True)
    dst.write_text(edit(open(src).read()))
    plan, vs = pkg.verify.verify_plan_file(str(dst))
    return plan is None, _violations(vs)


def _json_edit(**kw):
    def edit(raw):
        d = json.loads(raw)
        d.update(kw)
        return json.dumps(d)
    return edit


FILE_EDITS = {
    "as-written": lambda raw: raw,
    "hash-drift": _json_edit(stream_dtype="fp8"),
    "unknown-key": _json_edit(totally_new_field=1),
    "stale-version": _json_edit(version=1),
    "truncated": lambda raw: raw[: len(raw) // 2],
}


@pytest.mark.parametrize("edit", sorted(FILE_EDITS))
def test_verify_plan_file_matches_reference(edit, tmp_path, frozen_clocks):
    r = _edited_entry(REF, tmp_path, FILE_EDITS[edit])
    t = _edited_entry(PORT, tmp_path, FILE_EDITS[edit])
    assert r == t
    assert (t[1] == []) == (edit == "as-written")


def test_truncated_cache_entry_quarantines_and_resolves(tmp_path,
                                                        frozen_clocks):
    """A half-written entry is quarantined and re-solved by either
    package, with the same counters and the same plan."""
    out = []
    for pkg in (REF, PORT):
        cache = str(tmp_path / str(pkg is PORT))
        w, cfg = _wafer(pkg, False), pkg.config("deepseek-7b")
        first = pkg.plan.compile_plan(w, cfg, 512, 2048, cache_dir=cache)
        path = _only_file(cache, "plan")
        blob = open(path).read()
        open(path, "w").write(blob[: len(blob) // 2])
        pkg.plan.reset_plan_stats()
        again = pkg.plan.compile_plan(w, cfg, 512, 2048, cache_dir=cache)
        assert again.plan_hash == first.plan_hash
        assert os.path.exists(path + ".bad") and os.path.exists(path)
        out.append((dict(pkg.plan.PLAN_STATS), again.dumps(),
                    open(path).read()))
    assert out[0] == out[1]
    assert out[1][0]["quarantined"] == 1 and out[1][0]["solver_calls"] == 1


# ---------------------------------------------------------------------------
# the reference linter's cache-key rules on the port's copies
# ---------------------------------------------------------------------------

_PORT_SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src",
                         "repro_torch")
_CACHE_KEY_COPIES = ("core/plan.py", "wafer/solver.py", "analysis/verify.py")


def test_cache_key_rules_hold_on_the_copies():
    """The copies keep the reference's cache-identity functions
    (``plan_cache_key``, ``plan_hash``, ``StepCostContext.resident``) so
    plan JSON stays byte-identical; the reference linter's cache-key and
    determinism rules, which judge exactly those functions, find nothing
    in them."""
    from repro.analysis.lint import (RULE_CACHE_KEY, RULE_DETERMINISM,
                                     lint_paths, lint_source)
    paths = [os.path.join(_PORT_SRC, p) for p in _CACHE_KEY_COPIES]
    rules = (RULE_CACHE_KEY, RULE_DETERMINISM)
    assert lint_paths(paths, rules) == []
    # the rule does read the copies: a wall-clock read in the port's
    # plan_cache_key is flagged
    src = open(paths[0]).read()
    bad = src.replace('        "v": PLAN_VERSION,\n',
                      '        "v": PLAN_VERSION, "t": time.time(),\n', 1)
    assert bad != src
    hits = lint_source(bad, paths[0], rules)
    assert [v.rule for v in hits] == [RULE_DETERMINISM]


# ---------------------------------------------------------------------------
# the strategies a plan prescribes, at model degree 1
# ---------------------------------------------------------------------------

STRATEGY_ARCHS = ("deepseek-7b", "gemma-7b")
B, S, STEPS = 2, 24, 4
LOGIT_TOL = dict(rtol=5e-4, atol=5e-4)  # as tests/test_torch_serve.py
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)  # as tests/test_torch_train.py
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module", params=[
    (a, s) for a in STRATEGY_ARCHS for s in ("megatron", "fsdp")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def strategy_model(request):
    """A reduced config (fp32) under ``strategy`` at degree 1 in both
    packages, on weights converted from the reference's tree."""
    arch, strategy = request.param
    cfg, jcfg = get_reduced(arch), jax_reduced(arch)
    jparams = jax.tree.map(np.asarray,
                           jtf.init_params(jax.random.key(0), jcfg))
    params = params_from_jax(jparams, cfg, torch.device("cpu"))
    jdist = JaxDist(make_mesh((1, 1), ("data", "model")))
    return dict(arch=arch, strategy=strategy, cfg=cfg, jcfg=jcfg,
                jparams=jparams, params=params, jdist=jdist,
                jpar=JaxPar(strategy=strategy, remat=False),
                par=ParallelConfig(strategy=strategy, remat=False),
                dist=Dist(torch.device("cpu")))


def test_strategy_param_layouts_agree_at_degree_one(strategy_model):
    """The reference lays a strategy's leaves out by ``param_specs``; at
    degree 1 no axis splits anything, so the tree and its shapes are the
    ``tatp`` ones and ``params_from_jax`` carries the weights across
    unchanged."""
    m = strategy_model
    specs = _flat(jtf.param_specs(m["jcfg"], m["strategy"]))
    assert set(specs) == set(_flat(jtf.param_specs(m["jcfg"], "tatp")))
    got = {k: _np(v) for k, v in _flat(m["params"]).items()}
    ref = _flat(m["jparams"])
    assert set(got) == set(ref) == set(specs)
    for k in got:
        assert got[k].shape == ref[k].shape and (got[k] == ref[k]).all(), k


def test_strategy_prefill_and_decode_match_reference(strategy_model):
    m = strategy_model
    cfg = m["cfg"]
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S))
    jsb = jax_serve_fns(m["jcfg"], m["jpar"], m["jdist"],
                        JaxShape("t", "decode", S + STEPS, B))
    jc, jl = jsb.prefill_fn(m["jparams"], {"tokens": jnp.asarray(toks)})
    sb = make_serve_fns(cfg, m["par"], m["dist"])
    tc, tl = sb.prefill_fn(m["params"], {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
    jctx = jtf.RunCtx(m["jcfg"], m["jpar"], m["jdist"], phase="decode")
    jcache = jax.tree.map(jnp.asarray, jlm.graft_cache_slots(
        jax.device_get(jlm.init_cache(jctx, B, S + STEPS)),
        jax.device_get(jc), slots=range(B)))
    tcache = tlm.graft_cache_slots(tlm.init_cache(sb.ctx, B, S + STEPS), tc,
                                   slots=range(B))
    jt = jnp.argmax(jl[:, -1:, :], axis=-1).astype(jnp.int32) \
        % cfg.vocab_size
    tt = tl[:, -1:, :].argmax(dim=-1) % cfg.vocab_size
    for i in range(STEPS):
        n = S + i + 1
        jt, jlog, jcache = jsb.decode_fn(m["jparams"], jt, jcache,
                                         jnp.full((B,), n, jnp.int32))
        tt, tlog, tcache = sb.decode_fn(m["params"], tt, tcache,
                                        torch.full((B,), n))
        np.testing.assert_allclose(_np(tlog), _np(jlog), **LOGIT_TOL,
                                   err_msg=f"decode step {i}")
        assert np.array_equal(np.asarray(jt), tt.numpy()), i


def test_strategy_train_grads_match_reference(strategy_model):
    """The loss and every gradient leaf of one train batch (remat on), the
    reference's taken through its shard_map as its train step does."""
    m = strategy_model
    jpar = JaxPar(strategy=m["strategy"], remat=True)
    shape = JaxShape("t", "train", S, B)
    jctx = jtf.RunCtx(m["jcfg"], jpar, m["jdist"], phase="train")
    batch = jdata.SyntheticDataset(m["jcfg"], shape, m["jdist"],
                                   seed=3)._host_batch(1)

    def local(p, b):
        def f(q):
            nll, cnt, aux = jlm.loss_fn(jctx, q, b)
            return nll / cnt + aux
        return jax.value_and_grad(f)(p)

    pspecs = jtf.param_specs(m["jcfg"], m["strategy"])
    fn = jax.jit(jax.shard_map(
        local, mesh=m["jdist"].mesh,
        in_specs=(pspecs, batch_specs(m["jcfg"], shape, jpar, m["jdist"])),
        out_specs=(P(), pspecs), check_vma=False))
    loss_ref, g_ref = fn(jax.tree.map(jnp.asarray, m["jparams"]),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    tctx = ttf.RunCtx(m["cfg"], dataclasses.replace(m["par"], remat=True),
                      m["dist"], phase="train")
    tb = data.SyntheticDataset(m["cfg"], ShapeConfig("t", "train", S, B),
                               m["dist"], seed=3).batch(1)
    nll, cnt, grads = loss_and_grads(tctx, m["params"], tb)
    np.testing.assert_allclose(_np(nll / cnt), _np(loss_ref), **LOSS_TOL)
    grads, g_ref = _flat(grads), _flat(g_ref)
    assert set(grads) == set(g_ref)
    for name, g in grads.items():
        np.testing.assert_allclose(_np(g), _np(g_ref[name]), **GRAD_TOL,
                                   err_msg=name)


def test_strategies_raise_a3_above_degree_one(tmp_path):


    class Ring(Dist):
        @property
        def model_degree(self) -> int:
            return 2

    cfg = get_reduced("deepseek-7b")
    # megatron's column- or row-parallel product is one local tile; fsdp
    # above degree 1 is a path the reference cannot run (ROADMAP.md C5)
    x, w = torch.randn(1, 2, 4), torch.randn(4, 3)
    ctx = ttf.RunCtx(cfg, ParallelConfig(strategy="megatron"),
                     Ring(torch.device("cpu")), phase="prefill")
    torch.testing.assert_close(ttf._linear(ctx, x, w), x @ w)
    ctx = ttf.RunCtx(cfg, ParallelConfig(strategy="fsdp"),
                     Ring(torch.device("cpu")), phase="prefill")
    with pytest.raises(NotImplementedError, match="C5"):
        ttf._linear(ctx, x, w)
    plan = tplan.compile_plan(_wafer(PORT, False), get_config("deepseek-7b"),
                              4, 512, cache_dir=str(tmp_path))
    assert plan.tatp == 8 and plan_mesh_shape(plan, 1) == (1, 1)
    assert make_plan_dist(plan, "cpu").model_degree == 1
    # on 8 ranks the plan's ring runs (the serve ring); a mesh that is
    # not the world's size raises
    assert plan_mesh_shape(plan, 8) == (1, 8)
    with pytest.raises(ValueError, match="world has 1 ranks"):
        make_mesh_dist(plan_mesh_shape(plan, 8), "cpu")


# ---------------------------------------------------------------------------
# plan-driven launches (--device cpu, reduced configs, a temporary cache)
# ---------------------------------------------------------------------------


def _train_main(capsys, argv):
    from repro_torch.launch.train import main
    main(["--arch", "deepseek-7b", "--reduced", "--device", "cpu",
          "--batch", "4", "--seq", "32", "--log-every", "100", *argv])
    lines = capsys.readouterr().out.strip().splitlines()
    return lines, json.loads(lines[-1])


def _ref_setup(capsys, **flags):
    """The reference launcher's ``setup`` (plan resolution, config cut and
    ParallelConfig) on the arguments ``_train_main`` passes; its log
    lines, config, ParallelConfig and plan."""
    from repro.launch import train as jtrain
    args = argparse.Namespace(
        arch="deepseek-7b", reduced=True, batch=4, seq=32, mesh=[1, 1],
        strategy="tatp", plan=None, auto_plan=False, plan_cache=None,
        failed_dies=None, wafers=1, stage=0, fail_wafer=0)
    for k, v in flags.items():
        setattr(args, k, v)
    cfg, _mesh, par, plan = jtrain.setup(args)
    return capsys.readouterr().out.strip().splitlines(), cfg, par, plan


def test_train_auto_plan_solves_then_hits_the_cache(capsys, tmp_path,
                                                    frozen_clocks):
    cache = ["--auto-plan", "--steps", "2", "--plan-cache",
             str(tmp_path / "port")]
    first, out1 = _train_main(capsys, cache)
    assert first[0].startswith("[plan] solved fresh (1 solver call): hash ")
    second, out2 = _train_main(capsys, cache)
    assert second[0] == "[plan] cache hit (solver skipped): hash " \
        + out1["plan_hash"]
    assert out1["plan_hash"] == out2["plan_hash"]
    assert out1["steps"] == 2 and out1["mesh"] == [1, 1]
    assert out1["first_loss"] == out2["first_loss"]
    ref, _, jpar, jplan = _ref_setup(capsys, auto_plan=True,
                                     plan_cache=str(tmp_path / "ref"))
    assert jplan.plan_hash == out1["plan_hash"]
    # the same log lines and summary, word for word
    n = len(ref)
    assert first[:n] == ref
    plan = tplan.WaferPlan.load(_only_file(str(tmp_path / "port"), "plan"))
    assert plan.summary().splitlines() == ref[1:]
    assert dataclasses.asdict(ParallelConfig(**dataclasses.asdict(jpar))) \
        == dataclasses.asdict(dataclasses.replace(
            plan.parallel_config(), remat=False))


def test_train_plan_file_replays_it(capsys, tmp_path):
    _, out = _train_main(capsys, ["--auto-plan", "--steps", "1",
                                  "--plan-cache", str(tmp_path)])
    path = _only_file(str(tmp_path), "plan")
    lines, again = _train_main(capsys, ["--plan", path, "--steps", "1"])
    assert lines[0] == f"[plan] loaded {path} (hash {out['plan_hash']})"
    assert again["plan_hash"] == out["plan_hash"]
    assert again["first_loss"] == out["first_loss"]


def test_train_wafers_stage_trains_its_layers(capsys, tmp_path,
                                              frozen_clocks):
    from repro_torch.launch.train import build_parser, setup
    argv = ["--wafers", "2", "--stage", "1", "--plan-cache",
            str(tmp_path / "port")]
    args = build_parser().parse_args(
        ["--arch", "deepseek-7b", "--reduced", "--device", "cpu",
         "--batch", "4", "--seq", "32", *argv])
    cfg, dist, par, plan = setup(args)
    assert plan.pp == 2 and cfg.n_layers == plan.stage_layers[1]
    assert par.remat is False and dist.model_degree == 1
    assert dataclasses.asdict(par) == dataclasses.asdict(
        dataclasses.replace(plan.stages[1].parallel_config(), remat=False))
    capsys.readouterr()
    lines, out = _train_main(capsys, argv + ["--steps", "2"])
    assert lines[0].startswith("[plan] cache hit (solver skipped): hash ")
    assert out["plan_hash"] == plan.plan_hash and out["steps"] == 2
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    ref, jcfg, _, jplan = _ref_setup(capsys, wafers=2, stage=1,
                                     plan_cache=str(tmp_path / "ref"))
    assert jplan.plan_hash == plan.plan_hash
    assert jcfg.n_layers == cfg.n_layers
    assert ref[1:] == plan.summary().splitlines()
    with pytest.raises(SystemExit, match="out of range"):
        _train_main(capsys, ["--wafers", "2", "--stage", "2",
                             "--plan-cache", str(tmp_path / "port")])


@pytest.mark.parametrize("wafers", (1, 2))
def test_degraded_relaunch_warns_of_plan_drift(capsys, tmp_path, wafers):
    """A restart under a re-solved plan warns in the reference's words;
    the manifest records the plan (and the stage of a pipeline)."""
    from repro_torch.train import checkpoint as ckpt
    ck = str(tmp_path / "ck")
    plan_flags = ["--auto-plan"] if wafers == 1 else \
        ["--wafers", "2", "--stage", "0"]
    common = plan_flags + ["--plan-cache", str(tmp_path / "plans"),
                           "--ckpt-dir", ck]
    _, out = _train_main(capsys, common + ["--steps", "2"])
    meta = ckpt.read_meta(ck)
    assert meta["plan_hash"] == out["plan_hash"]
    if wafers == 1:
        assert meta["plan_degrees"] == [1, 1, 1, 1]
        degraded = ["--failed-dies", "3,7,12"]
    else:
        assert (meta["stage"], meta["pp"], meta["stage_layers"]) == \
            (0, 2, [1, 1])
        degraded = ["--failed-dies", "3,9", "--fail-wafer", "1"]
    lines, again = _train_main(capsys, common + degraded + ["--steps", "3"])
    assert again["plan_hash"] != out["plan_hash"]
    assert lines[0].startswith("[plan] solved fresh")
    assert f"resuming from {ck}" in lines
    assert (f"[plan] WARNING: checkpoint was trained under plan "
            f"{out['plan_hash']} but this launch runs plan "
            f"{again['plan_hash']} (wafer degraded or re-solved); state "
            f"restores elastically onto the new mesh") in lines
    assert again["steps"] == 1
    if wafers == 2:
        old = tplan.MultiWaferPlan.load(sorted(glob.glob(os.path.join(
            str(tmp_path / "plans"), "mwplan_*.json")),
            key=os.path.getmtime)[0])
        new = tplan.MultiWaferPlan.load(sorted(glob.glob(os.path.join(
            str(tmp_path / "plans"), "mwplan_*.json")),
            key=os.path.getmtime)[-1])
        assert old.stages[0].plan_hash == new.stages[0].plan_hash
        assert old.stages[1].plan_hash != new.stages[1].plan_hash


def _serve_main(capsys, argv):
    from repro_torch.launch.serve import main
    main(["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
          "16", "--gen", "4", *argv])
    lines = capsys.readouterr().out.strip().splitlines()
    return lines, json.loads(lines[-1])


@pytest.mark.parametrize("arch", ("deepseek-7b", "gemma-7b"))
def test_serve_auto_plan_serves_as_the_legacy_flags(arch, capsys,
                                                    tmp_path):
    cache = ["--arch", arch, "--auto-plan", "--plan-cache", str(tmp_path)]
    lines, planned = _serve_main(capsys, cache)
    assert lines[0].startswith("[plan] solved fresh (1 solver call)")
    plan = tplan.WaferPlan.load(_only_file(str(tmp_path), "plan"))
    assert plan.remat is False and (plan.batch, plan.seq) == (2, 20)
    assert lines[1:-1] == plan.summary().splitlines()
    lines, again = _serve_main(capsys, cache)
    assert lines[0] == "[plan] cache hit (solver skipped): hash " \
        + plan.plan_hash
    _, legacy = _serve_main(capsys, ["--arch", arch])
    assert set(planned) == set(legacy) == {
        "generated_shape", "tokens_per_s", "ms_per_token", "sample"}
    assert planned["sample"] == again["sample"] == legacy["sample"]
    assert planned["generated_shape"] == [2, 5]


def test_serve_auto_plan_matches_reference(tmp_path):
    """The one-shot serve under ``--auto-plan`` against the reference's on
    the same arguments, its plan and its weights (converted)."""
    from repro.launch.serve import serve as jax_serve
    from repro_torch.launch.serve import serve
    args = argparse.Namespace(arch="deepseek-7b", reduced=True, batch=2,
                              prompt_len=16, gen=4, mesh=[1, 1], plan=None,
                              auto_plan=True, plan_cache=str(tmp_path),
                              device="cpu", serve=False, layers=None)
    ref = jax_serve(args)
    jparams = jax.tree.map(np.asarray, jtf.init_params(
        jax.random.key(0), jax_reduced("deepseek-7b")))
    got = serve(args, params=params_from_jax(
        jparams, get_reduced("deepseek-7b"), torch.device("cpu")))
    assert got["generated_shape"] == ref["generated_shape"]
    assert got["sample"] == ref["sample"]


ENGINE_ARGS = ["--reduced", "--serve", "--auto-plan", "--requests", "3",
               "--rate", "50", "--max-batch", "2", "--prompt-len", "8",
               "--max-new", "3"]


def _ref_engine_keys(tmp_path):
    """The keys of the reference's engine-mode JSON (its ``--sim`` run on
    the same arguments)."""
    from repro.launch.serve import serve_engine as jax_serve_engine
    from repro_torch.launch.serve import build_parser
    args = build_parser().parse_args(
        ENGINE_ARGS + ["--sim", "--plan-cache", str(tmp_path / "ref")])
    return set(jax_serve_engine(args))


def test_serve_engine_mode_prints_the_reference_keys(capsys, tmp_path):
    """``--serve`` on the CPU runs the engine on the port's executor and
    prints the reference's keys, ``"mode"`` being ``"torch"``."""
    from repro_torch.launch.serve import main
    keys = _ref_engine_keys(tmp_path)
    for layers in ([], ["--layers", "1"]):  # a cut in depth of the model
        cache = str(tmp_path / f"port{len(layers)}")
        main(ENGINE_ARGS + ["--device", "cpu", "--plan-cache", cache]
             + layers)
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[0].startswith("[plan] solved fresh")
        out = json.loads(lines[-1])
        assert set(out) == keys
        assert out["mode"] == "torch" and out["n_finished"] == 3
        assert out["generated_tokens"] == 9
        plan = tplan.ServePlan.load(_only_file(cache, "splan"))
        assert out["plan_hash"] == plan.plan_hash


@pytest.mark.parametrize("extra", ([], ["--fault-at", "0.02",
                                        "--readmission", "drain"],
                                   ["--fault-trace", "cascade:1",
                                    "--governor"]))
def test_serve_engine_sim_matches_reference(capsys, tmp_path, extra):
    """``--serve --sim`` prints the report the reference's
    ``serve_engine`` gives for the same arguments."""
    from repro.launch.serve import serve_engine as jax_serve_engine
    from repro_torch.launch.serve import build_parser, main
    argv = ENGINE_ARGS + ["--sim", "--requests", "12", "--rate", "4"] \
        + extra
    main(argv + ["--plan-cache", str(tmp_path / "port")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = jax_serve_engine(build_parser().parse_args(
        argv + ["--plan-cache", str(tmp_path / "ref")]))
    assert out["mode"] == "sim" and out["n_finished"] == 12
    assert out["n_replans"] == (1 if "--fault-at" in extra else 3 if extra
                                else 0)
    assert out == json.loads(json.dumps(ref))  # as the reference prints it


def test_serve_engine_mode_needs_a_gpu_or_device_cpu(monkeypatch, tmp_path):
    """Without a GPU ``--serve`` raises unless ``--device cpu`` is given."""
    from repro_torch.launch.serve import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(ENGINE_ARGS + ["--plan-cache", str(tmp_path)])
