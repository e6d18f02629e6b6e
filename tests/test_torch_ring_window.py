"""Sliding windows on the serve ring against the reference on the CPU.

As ``tests/test_torch_ring_zigzag.py``: the port's ranks are processes
joined by gloo (a ``FileStore`` under the test's temporary directory), the
reference runs ``shard_map`` on 4 fake CPU devices in a subprocess, both
sides run this file as a script on the same seeded numpy inputs and write
numpy outputs, which the tests compare (fp32 throughout):

* ``ring_attention``'s and ``zigzag_ring_attention``'s forward under a
  window at R = 2, 3 and 4, both orders, on the online-softmax loop and on
  the hook (the flash kernel's plain version here, each launch at its
  query offset), with windows that leave rounds whole, cut and empty, and
  one capped GQA case (1e-5); the hook's calls a rank equal the launches
  that hold a visible pair, counted from positions, and
  :meth:`_Ring.launches`' count;
* the reduced gemma2-9b (window 16, prompts of 32 tokens: past it) at
  (1, 4) and (2, 2): prefill logits and caches, and 4 decode steps at
  per-row positions, against the reference's ``make_serve_fns`` (2e-4,
  tokens identical);
* engine mode at (1, 4) across one migration: ``==`` the reference's
  ``JaxServeExecutor`` where it runs (max_seq 64, contexts within its
  per-rank block, as ``tests/test_torch_ring_engine.py`` gives it), and
  with prompts past the window against the port's one-rank engine
  (tokens identical, final caches within 1e-5)."""

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
ARCH = "gemma2-9b"
RINGS = (2, 3, 4)
ORDERS = (True, False)  # bidirectional, naive
AB, ASL, AH, AD = 2, 8, 4, 16  # batch, per-rank sequence, heads, head dim
# name: (causal, window, cap, kv heads).  With 8 positions a rank (zigzag:
# chunks of 4), window 3 cuts the own block and the next and empties the
# rest, 12 cuts three blocks, 40 covers every pair (no round masks by it)
CASES = {"w3": (True, 3, None, 4), "w12": (True, 12, None, 4),
         "w40": (True, 40, None, 4), "w8_capped_gqa": (True, 8, 0.5, 2),
         "w5_unmasked": (False, 5, None, 4)}
ZIGZAG_CASES = [n for n, (causal, *_) in CASES.items() if causal]
# the serves: batch, prompt (past the window of 16), decode steps, cache
B, P, GEN, MAX_SEQ = 4, 32, 4, 40
MESHES = ((1, 4), (2, 2))
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
TIMEOUT = 300
# engine mode: (prompt lengths, max_seq); the reference's executor runs
# at (1, 4) only where every context fits its per-rank block of max_seq /
# 4 positions, so the window does not bite there; past it the ranks are
# held to the one-rank engine
ENGINE_GEN = 8
FAULT = (0.1, 2, 4.5)  # fraction of dies, seed, engine time
ENGINE_REF = ((4, 8), 64)
ENGINE_PAST = ((24, 32), 48)


def _inputs():
    rng = np.random.RandomState(0)
    out = {}
    for r in RINGS:
        for name, (_, _, _, hkv) in CASES.items():
            s = r * ASL
            out[f"q{r}_{name}"] = rng.randn(AB, s, AH, AD).astype(np.float32)
            out[f"k{r}_{name}"] = rng.randn(AB, s, hkv, AD).astype(np.float32)
            out[f"v{r}_{name}"] = rng.randn(AB, s, hkv, AD).astype(np.float32)
    out["prompts"] = rng.randint(0, 128, (B, P))
    return out


def _np_params(shapes, rng=None):
    """Seeded weights for a parameter tree of leaf shapes (sorted walk)."""
    rng = rng or np.random.RandomState(1)
    out = {}
    for k in sorted(shapes):
        v = shapes[k]
        if isinstance(v, dict):
            out[k] = _np_params(v, rng)
            continue
        scale = 0.1 if k.endswith("ln") else (
            1.0 if k == "embed" else 1.0 / np.sqrt(v[-2]))
        out[k] = (rng.randn(*v) * scale).astype(np.float32)
    return out


def _step_len(t):
    """Decode step ``t``'s per-row cache_len (rows at different
    positions)."""
    return P + t + 1 + np.arange(B) % 2


def _visible_launches(r, i, zigzag, causal, window):
    """Rank ``i``'s launches that hold a visible pair, counted from the
    positions of every (query chunk, key chunk) pair of every block."""
    c = ASL // 2 if zigzag else ASL

    def chunks(rank):
        if zigzag:
            return (rank, 2 * r - 1 - rank)
        return (rank,)

    n = 0
    pos = np.arange(c)
    for j in range(r):
        for qc in chunks(i):
            for kc in chunks(j):
                d = (qc * c + pos)[:, None] - (kc * c + pos)[None, :]
                ok = np.ones_like(d, dtype=bool)
                if causal:
                    ok &= d >= 0
                if window is not None:
                    ok &= d < window
                n += bool(ok.any())
    return n


# ---------------------------------------------------------------------------
# shared by every side of engine mode (from tests/test_torch_ring_engine.py)
# ---------------------------------------------------------------------------


def on_mesh(plan, model):
    """``plan`` with its decode plan's ``tatp`` set to ``model``: on four
    devices the mesh ``(4 / model, model)``."""
    return dataclasses.replace(plan, plan=dataclasses.replace(
        plan.plan, tatp=model))


class Stepped:
    """Real-model calls on a virtual clock, each charged 1.0 s; a
    migration's plan is put back on the ring of four for the executor."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = 0

    def prefill(self, states):
        self.inner.prefill(states)
        self.calls += 1
        return 1.0

    def decode(self, states):
        self.inner.decode(states)
        self.calls += 1
        return 1.0

    def migrate(self, new_plan, mig, wafer=None):
        self.inner.migrate(on_mesh(new_plan, 4), mig, wafer)
        self.calls += 1
        return 1.0


def _packages(side):
    if side == "reference":
        from repro.configs import get_reduced
        from repro.core import plan
        from repro.serve import engine
        from repro.wafer import fault, topology
    else:
        from repro_torch.configs import get_reduced
        from repro_torch.core import plan
        from repro_torch.serve import engine
        from repro_torch.wafer import fault, topology
    return types.SimpleNamespace(plan=plan, eng=engine, fault=fault,
                                 topo=topology, reduced=get_reduced)


def _engine_setup(pkg, plens, max_seq, cache):
    """The config, the wafer, the plan for ``max_seq`` on the ring of four
    (solved afresh under ``cache``) and the requests: four at once (the
    first wants 2 tokens), a fifth into the slot it frees, a sixth after
    the fault."""
    cfg = pkg.reduced(ARCH)
    wafer = pkg.topo.Wafer(pkg.topo.WaferSpec())
    plan = pkg.plan.compile_serve_plan(wafer, cfg, 4, max_seq,
                                       cache_dir=str(cache), use_cache=False)
    spec = [(0, 0.0, 2), (1, 0.0, ENGINE_GEN), (2, 0.0, ENGINE_GEN),
            (3, 0.0, ENGINE_GEN), (4, 2.5, ENGINE_GEN),
            (5, 6.5, ENGINE_GEN)]
    reqs = [pkg.eng.Request(rid=rid, arrival=t,
                            prompt_len=plens[rid % len(plens)],
                            max_new_tokens=n) for rid, t, n in spec]
    return cfg, wafer, on_mesh(plan, 4), reqs


def _serve(pkg, plan, executor, reqs, cfg, wafer, cache):
    """Run the engine with the fault: the report, the recovery events and
    each finished request's ``(rid, prior tokens, tokens)``."""
    frac, seed, at = FAULT
    fault = pkg.fault.sample_die_faults(wafer, frac, seed=seed)
    eng = pkg.eng.ServeEngine(plan, executor, clock=pkg.eng.VirtualClock(),
                              cfg=cfg, wafer=wafer,
                              faults=[fault.as_event(at)],
                              plan_cache_dir=cache)
    rep = eng.run(reqs)
    streams = sorted([st.req.rid, st.req.prior_tokens, list(st.tokens)]
                     for st in eng.sched.finished)
    return {"report": rep.to_dict(),
            "events": [ev.to_dict() for ev in eng.events],
            "streams": streams}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _dump(path, obj):
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# the reference side (a subprocess on 4 fake devices)
# ---------------------------------------------------------------------------


def _reference(out_dir):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Ps

    sys.path.insert(0, str(SRC))
    from repro.configs import get_reduced
    from repro.configs.base import ParallelConfig, ShapeConfig
    from repro.core.dist import Dist, make_mesh
    from repro.launch.serve import JaxServeExecutor
    from repro.models import attention as attn
    from repro.models.transformer import param_shapes
    from repro.train.train_loop import make_serve_fns

    out_dir = Path(out_dir)
    x = _inputs()
    res = {}
    devs = jax.devices()
    assert len(devs) == 4, devs
    seq = Ps(None, "model")
    for r in RINGS:
        mesh = make_mesh((r,), ("model",), devices=devs[:r])

        def f(*ins, r=r):
            outs = []
            for n, name in enumerate(CASES):
                causal, window, cap, _ = CASES[name]
                q, k, v = ins[3 * n:3 * n + 3]
                for o in ORDERS:
                    outs.append(attn.ring_attention(
                        q, k, v, axis="model", axis_size=r, causal=causal,
                        window=window, cap=cap, bidirectional=o))
                    if name in ZIGZAG_CASES:
                        outs.append(attn.zigzag_ring_attention(
                            q, k, v, axis="model", axis_size=r,
                            window=window, cap=cap, bidirectional=o))
            return tuple(outs)

        keys = [(kind, name, o) for name in CASES for o in ORDERS
                for kind in ("ring", "zz")
                if kind == "ring" or name in ZIGZAG_CASES]
        ins = [x[f"{p}{r}_{name}"] for name in CASES for p in "qkv"]
        outs = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(seq,) * len(ins),
            out_specs=(seq,) * len(keys), check_vma=False))(*ins)
        for (kind, name, o), y in zip(keys, outs):
            res[f"{kind}{r}_{name}_{o}"] = np.asarray(y)

    # the reduced gemma2-9b's serve on each mesh, from the same weights
    cfg = get_reduced(ARCH)
    par = ParallelConfig(strategy="tatp", remat=False)
    shapes = jax.tree.map(lambda s: tuple(s.shape), param_shapes(cfg))
    params = jax.tree.map(jnp.asarray, _np_params(shapes))
    for shape in MESHES:
        tag = "x".join(map(str, shape))
        dist = Dist(make_mesh(shape, ("data", "model"), devices=devs))
        sb = make_serve_fns(cfg, par, dist, ShapeConfig("s", "decode",
                                                        MAX_SEQ, B))
        caches, logits = sb.prefill_fn(params, {
            "tokens": jnp.asarray(x["prompts"])})
        res[f"{tag}_prefill_logits"] = np.asarray(logits)
        big = {}
        for u, leaves in caches.items():
            big[u] = {}
            for n, t in leaves.items():
                t = np.asarray(t)
                res[f"{tag}_prefill_{u}.{n}"] = t
                z = np.zeros(t.shape[:2] + (MAX_SEQ,) + t.shape[3:], t.dtype)
                z[:, :, :P] = t
                big[u][n] = jnp.asarray(z)
        toks = jnp.argmax(logits[:, -1:, :], axis=-1).astype(jnp.int32) \
            % cfg.vocab_size
        steps = [np.asarray(toks)]
        for t in range(GEN):
            toks, lg, big = sb.decode_fn(params, toks, big,
                                         jnp.asarray(_step_len(t)))
            steps.append(np.asarray(toks))
        res[f"{tag}_tokens"] = np.concatenate(steps, axis=1)
        res[f"{tag}_decode_logits"] = np.asarray(lg)
        for u, leaves in big.items():
            for n, t in leaves.items():
                res[f"{tag}_decode_{u}.{n}"] = np.asarray(t)
    np.savez(out_dir / "ref.npz", **res)

    # engine mode at (1, 4), where the reference's executor runs
    pkg = _packages("reference")
    plens, seq_len = ENGINE_REF
    cfg, wafer, plan, reqs = _engine_setup(pkg, plens, seq_len,
                                           out_dir / "ref_solved")
    ex = JaxServeExecutor(plan, cfg)
    np.savez(out_dir / "params.tmp.npz",
             **_flat(jax.tree.map(np.asarray, ex.params)))
    os.replace(out_dir / "params.tmp.npz", out_dir / "params.npz")
    _dump(out_dir / "ref_engine.json",
          _serve(pkg, plan, Stepped(ex), reqs, cfg, wafer,
                 str(out_dir / "ref_plans")))


# ---------------------------------------------------------------------------
# the port's side (one process a rank, and the one-rank engine)
# ---------------------------------------------------------------------------


def _port_serve(dist, x, shape, res):
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import lm
    from repro_torch.models.transformer import param_shapes
    from repro_torch.train.train_loop import batch_rows, make_serve_fns
    from repro_torch.weights import params_from_jax, shard_params

    tag = "x".join(map(str, shape))
    cfg = get_reduced(ARCH)
    par = ParallelConfig(strategy="tatp", remat=False)
    params = shard_params(params_from_jax(_np_params(param_shapes(cfg)),
                                          cfg, "cpu"), cfg, "tatp", dist)
    sb = make_serve_fns(cfg, par, dist)
    with torch.no_grad():
        caches, logits = sb.prefill_fn(params, {
            "tokens": torch.as_tensor(x["prompts"])})
        res[f"{tag}_prefill_logits"] = logits.numpy()
        for u, leaves in caches.items():
            for n, t in leaves.items():
                res[f"{tag}_prefill_{u}.{n}"] = t.numpy()
        rows = len(range(B)[batch_rows(dist, B)])
        big = lm.graft_cache_slots(
            lm.init_cache(sb.ctx, rows, MAX_SEQ),
            lm.shard_prompt_cache(sb.ctx, caches, MAX_SEQ),
            slots=range(rows))
        toks = logits[:, -1:, :].argmax(dim=-1) % cfg.vocab_size
        steps = [toks]
        for t in range(GEN):
            toks, lg, big = sb.decode_fn(params, toks, big,
                                         torch.as_tensor(_step_len(t)))
            steps.append(toks)
    res[f"{tag}_tokens"] = torch.cat(steps, dim=1).numpy()
    res[f"{tag}_decode_logits"] = lg.numpy()
    res[f"{tag}_coords"] = np.array(dist.coords)
    for u, leaves in big.items():
        for n, t in leaves.items():
            res[f"{tag}_decode_{u}.{n}"] = t.numpy()


def _wait_for(path, seconds=TIMEOUT):
    import time
    t0 = time.time()
    while not Path(path).exists():
        if time.time() - t0 > seconds:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.2)


def _port_engine(name, plens, max_seq, rank, out_dir, link,
                 params_from=None):
    """One engine run over the world: rank 0 leads, the others follow."""
    from repro_torch.launch.serve import (LeaderExecutor, TorchServeExecutor,
                                          follow)
    from repro_torch.weights import params_from_jax, shard_params

    pkg = _packages("port")
    cfg, wafer, plan, reqs = _engine_setup(
        pkg, plens, max_seq, Path(out_dir) / f"solved_{name}_{rank}")
    ex = TorchServeExecutor(plan, cfg, device="cpu")
    if params_from is not None:
        _wait_for(params_from)
        full = params_from_jax(_unflat(dict(np.load(params_from))), cfg,
                               "cpu")
        ex.params = shard_params(full, cfg, ex.par.strategy, ex.dist)
    rec = {"mesh": list(ex.dist.mesh_shape)}
    if rank == 0:
        lead = LeaderExecutor(ex, link)
        stepped, err = Stepped(lead), None
        try:
            rec.update(_serve(pkg, plan, stepped, reqs, cfg, wafer,
                              str(Path(out_dir) / f"plans_{name}")))
        except Exception as e:
            err = e
            raise
        finally:
            lead.stop(err)
        rec["calls"] = stepped.calls
    else:
        rec["followed"] = follow(ex, link)
    rec["mesh_after"] = list(ex.dist.mesh_shape)
    caches = {k: v.numpy() for k, v in _flat(ex.global_cache()).items()}
    if rank == 0:
        np.savez(Path(out_dir) / f"port_{name}_caches.npz", **caches)
    _dump(Path(out_dir) / f"port_{name}_{rank}.json", rec)
    torch.distributed.barrier()


def _port_rank(world, rank, store_path, out_dir):
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.core.dist import init_world, make_mesh_dist
    from repro_torch.kernels.flash_attention.ops import attention as flash
    from repro_torch.launch.serve import CommandLink
    from repro_torch.models import attention as attn

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    init_world("gloo", store=torch.distributed.FileStore(store_path, world),
               rank=rank, world_size=world)
    x = _inputs()
    res = {}
    if world == 3:
        rings = {3: make_mesh_dist((1, 3), "cpu")}
    else:
        d14, d22 = make_mesh_dist((1, 4), "cpu"), make_mesh_dist((2, 2),
                                                                 "cpu")
        rings = {4: d14, 2: d22}
    calls = {"n": 0}

    def counted(*a, **kw):
        calls["n"] += 1
        return flash(*a, **kw)

    for r, dist in rings.items():
        i = dist.axis_index("model")
        res[f"launches{r}"] = np.array([
            [sum(len(attn._Ring("model", r, causal, None, True, 1.0,
                                "native", dist, None, zigzag=zz,
                                window=window).launches(i, j, ASL))
                 for j in range(r)) for zz in (False, True)]
            for causal, window, _, _ in CASES.values()])
        for name, (causal, window, cap, _) in CASES.items():
            q, k_, v_ = (torch.as_tensor(x[f"{p}{r}_{name}"])[
                :, i * ASL:(i + 1) * ASL] for p in "qkv")
            kinds = ("ring", "zz") if name in ZIGZAG_CASES else ("ring",)
            for kind in kinds:
                for o in ORDERS:
                    for hook, fn in (("loop", None), ("hook", counted)):
                        calls["n"] = 0
                        kw = dict(axis="model", axis_size=r, window=window,
                                  cap=cap, bidirectional=o, dist=dist,
                                  attention=fn)
                        if kind == "ring":
                            y = attn.ring_attention(q, k_, v_, causal=causal,
                                                    **kw)
                        else:
                            y = attn.zigzag_ring_attention(q, k_, v_, **kw)
                        key = f"{kind}{r}_{name}_{o}_{hook}"
                        res[key] = y.numpy()
                        res[f"{key}_calls"] = np.array(calls["n"])
    if world == 4:
        for shape, dist in zip(MESHES, (rings[4], rings[2])):
            _port_serve(dist, x, shape, res)
    np.savez(Path(out_dir) / f"{world}-{rank}.npz",
             **{k: np.asarray(v) for k, v in res.items()})
    if world == 4:
        link = CommandLink()
        plens, max_seq = ENGINE_REF
        _port_engine("ref", plens, max_seq, rank, out_dir, link,
                     params_from=Path(out_dir) / "params.npz")
        plens, max_seq = ENGINE_PAST
        _port_engine("past", plens, max_seq, rank, out_dir, link)
    torch.distributed.destroy_process_group()


def _single(out_dir):
    """The port's one-rank engine with prompts past the window (seed-0
    weights, as the four ranks draw them shard by shard)."""
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.launch.serve import TorchServeExecutor

    pkg = _packages("port")
    plens, max_seq = ENGINE_PAST
    cfg, wafer, plan, reqs = _engine_setup(pkg, plens, max_seq,
                                           Path(out_dir) / "one_solved")
    ex = TorchServeExecutor(plan, cfg, device="cpu")
    rec = _serve(pkg, plan, Stepped(ex), reqs, cfg, wafer,
                 str(Path(out_dir) / "one_plans"))
    np.savez(Path(out_dir) / "one_caches.npz",
             **{k: v.numpy() for k, v in _flat(ex.caches).items()})
    _dump(Path(out_dir) / "one.json", rec)


# ---------------------------------------------------------------------------
# the fixture: every side at once
# ---------------------------------------------------------------------------


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _finish(procs):
    for name, p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for _, q in procs:
                q.kill()
            raise AssertionError(f"{name} timed out")
        assert p.returncode == 0, (
            f"{name} failed:\n{out[-2000:]}\n{err[-4000:]}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring_window")
    me = str(Path(__file__).resolve())
    procs = [("the reference", subprocess.Popen(
        [sys.executable, me, "reference", str(d)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        cwd=d, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)),
        ("the one-rank engine", subprocess.Popen(
            [sys.executable, me, "single", str(d)], env=_env(), cwd=d,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))]
    ranks = []
    for world in (4, 3):
        for rank in range(world):
            ranks.append(f"{world}-{rank}")
            procs.append((f"port rank {world}-{rank}", subprocess.Popen(
                [sys.executable, me, "port", str(world), str(rank),
                 str(d / f"store{world}"), str(d)], env=_env(), cwd=d,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    try:
        _finish(procs)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
    port = {name: dict(np.load(d / f"{name}.npz")) for name in ranks}
    return d, dict(np.load(d / "ref.npz")), port


def _ring_ranks(port, r):
    """The ranks of one ring of size ``r`` in ring order: world 3 for R =
    3, the (1, 4) mesh for R = 4, data row 0 of the (2, 2) mesh for R =
    2 (global ranks 0 and 1)."""
    world = 3 if r == 3 else 4
    return [port[f"{world}-{k}"] for k in range(r)]


def _load(d, name):
    with open(d / name) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# ring attention's forward under a window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", RINGS)
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("bidirectional", ORDERS)
@pytest.mark.parametrize("hook", ["loop", "hook"])
def test_windowed_ring_attention_matches_reference(runs, r, name,
                                                   bidirectional, hook):
    _, ref, port = runs
    key = f"ring{r}_{name}_{bidirectional}"
    got = np.concatenate([p[f"{key}_{hook}"] for p in _ring_ranks(port, r)],
                         axis=1)
    np.testing.assert_allclose(got, ref[key], **TOL)


@pytest.mark.parametrize("r", RINGS)
@pytest.mark.parametrize("name", ZIGZAG_CASES)
@pytest.mark.parametrize("bidirectional", ORDERS)
@pytest.mark.parametrize("hook", ["loop", "hook"])
def test_windowed_zigzag_attention_matches_reference(runs, r, name,
                                                     bidirectional, hook):
    _, ref, port = runs
    key = f"zz{r}_{name}_{bidirectional}"
    got = np.concatenate([p[f"{key}_{hook}"] for p in _ring_ranks(port, r)],
                         axis=1)
    np.testing.assert_allclose(got, ref[key], **TOL)


@pytest.mark.parametrize("r", RINGS)
@pytest.mark.parametrize("kind", ["ring", "zz"])
def test_hook_launches_only_rounds_with_a_visible_pair(runs, r, kind):
    """The hook's calls on each rank: one a launch that holds a visible
    pair, counted from the positions, in both orders; the loop path calls
    no hook; and ``_Ring.launches`` gives the same count."""
    _, _, port = runs
    names = list(CASES) if kind == "ring" else ZIGZAG_CASES
    for i, p in enumerate(_ring_ranks(port, r)):
        for name in names:
            causal, window, _, _ = CASES[name]
            want = _visible_launches(r, i, kind == "zz", causal, window)
            row = list(CASES).index(name)
            assert p[f"launches{r}"][row][int(kind == "zz")] == want, name
            for o in ORDERS:
                key = f"{kind}{r}_{name}_{o}"
                assert int(p[f"{key}_hook_calls"]) == want, (key, i)
                assert int(p[f"{key}_loop_calls"]) == 0


def test_window_empties_rounds_in_these_cases():
    """The cases reach what they are there for: of rank 3's four rounds
    on a ring of four, window 3 leaves two, 12 three and 40 all; under
    zigzag window 3 leaves rank 0 fewer than its 2R + 1 launches."""
    assert _visible_launches(4, 3, False, True, 3) == 2
    assert _visible_launches(4, 3, False, True, 12) == 3
    assert _visible_launches(4, 3, False, True, 40) == 4
    assert _visible_launches(4, 0, True, True, 3) < 2 * 4 + 1


# ---------------------------------------------------------------------------
# the reduced gemma2-9b's serve on (1, 4) and (2, 2)
# ---------------------------------------------------------------------------


def _block(a, coords, shape, seq_axis=None, vocab=False):
    """The global reference array ``a``'s block for the rank at
    ``coords`` on ``shape``: rows (axis 0, or 1 for a cache leaf) over
    data, and the sequence or vocab axis over model."""
    d, m = coords
    nd, nm = shape
    row_axis = 1 if seq_axis == 2 else 0
    rows = a.shape[row_axis] // nd
    a = np.take(a, range(d * rows, (d + 1) * rows), axis=row_axis)
    ax = seq_axis if seq_axis is not None else (a.ndim - 1 if vocab
                                                else None)
    if ax is not None:
        n = a.shape[ax] // nm
        a = np.take(a, range(m * n, (m + 1) * n), axis=ax)
    return a


def _cache_keys(res, tag, phase):
    pre = f"{tag}_{phase}_"
    keys = [k for k in res if k.startswith(pre) and k != pre + "logits"]
    assert keys, f"no {phase} cache in {sorted(res)[:8]}"
    return keys


@pytest.mark.parametrize("shape", MESHES)
def test_gemma2_prefill_matches_reference(runs, shape):
    """Logits gathered over both axes; each rank's cache block."""
    _, ref, port = runs
    tag = "x".join(map(str, shape))
    for k in range(4):
        p = port[f"4-{k}"]
        c = tuple(p[f"{tag}_coords"])
        np.testing.assert_allclose(p[f"{tag}_prefill_logits"],
                                   ref[f"{tag}_prefill_logits"],
                                   err_msg="prefill logits", **MODEL_TOL)
        for key in _cache_keys(p, tag, "prefill"):
            np.testing.assert_allclose(
                p[key], _block(ref[key], c, shape, seq_axis=2),
                err_msg=key, **MODEL_TOL)


@pytest.mark.parametrize("shape", MESHES)
def test_gemma2_decode_steps_match_reference(runs, shape):
    """4 greedy steps at per-row positions past the window: identical
    tokens, each rank's logits block and cache block."""
    _, ref, port = runs
    tag = "x".join(map(str, shape))
    for k in range(4):
        p = port[f"4-{k}"]
        c = tuple(p[f"{tag}_coords"])
        np.testing.assert_array_equal(p[f"{tag}_tokens"],
                                      ref[f"{tag}_tokens"])
        np.testing.assert_allclose(
            p[f"{tag}_decode_logits"],
            _block(ref[f"{tag}_decode_logits"], c, shape, vocab=True),
            err_msg="decode logits", **MODEL_TOL)
        for key in _cache_keys(p, tag, "decode"):
            np.testing.assert_allclose(
                p[key], _block(ref[key], c, shape, seq_axis=2),
                err_msg=key, **MODEL_TOL)


# ---------------------------------------------------------------------------
# engine mode at (1, 4)
# ---------------------------------------------------------------------------


def _ranks(d, name):
    return [_load(d, f"port_{name}_{r}.json") for r in range(4)]


def _held_together(recs):
    """Every rank made every call rank 0 made, on (1, 4) throughout."""
    assert recs[0]["calls"] > 0
    assert all(rec["followed"] == recs[0]["calls"] for rec in recs[1:])
    for rec in recs:
        assert rec["mesh"] == rec["mesh_after"] == [1, 4]


def test_engine_matches_the_reference_executor(runs):
    """Token streams, the report and the recovery event ``==`` the
    reference's executor on 4 fake devices, across a migration."""
    d, _, _ = runs
    ref = _load(d, "ref_engine.json")
    recs = _ranks(d, "ref")
    rep, events = ref["report"], ref["events"]
    assert rep["n_finished"] == 6 and rep["n_replans"] == 1
    assert recs[0]["streams"] == ref["streams"]
    assert recs[0]["report"] == rep and recs[0]["events"] == events
    _held_together(recs)


def test_engine_past_the_window_matches_one_rank(runs):
    """Prompts of 24 and 32 tokens and 8 new ones under a window of 16:
    the four ranks' streams, report and recovery event equal the one-rank
    engine's, and the final caches agree within 1e-5."""
    d, _, _ = runs
    one = _load(d, "one.json")
    recs = _ranks(d, "past")
    assert one["report"]["n_finished"] == 6
    assert one["report"]["n_replans"] == 1
    assert recs[0]["streams"] == one["streams"]
    assert recs[0]["report"] == one["report"]
    assert recs[0]["events"] == one["events"]
    want = dict(np.load(d / "one_caches.npz"))
    got = dict(np.load(d / "port_past_caches.npz"))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    _held_together(recs)


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    elif sys.argv[1] == "single":
        _single(sys.argv[2])
    else:
        _port_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5])
