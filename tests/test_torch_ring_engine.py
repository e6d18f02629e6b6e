"""Engine mode over several ranks (``launch.serve --serve`` under
``torch.distributed.run``) on the CPU, fp32.

Rank 0 runs the continuous-batching engine and broadcasts each executor
call before it makes it; the other ranks make the same calls on their own
executors (``repro_torch.launch.serve.LeaderExecutor`` / ``follow``).
The port's four ranks are processes joined by gloo (a ``FileStore`` under
the test's temporary directory); the reference runs ``JaxServeExecutor``
on 4 fake CPU devices in a subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``); the port's
one-rank engine runs in a third.  All of them run this file as a script
and write what they saw; the tests compare it.  Step durations are fixed
on a virtual clock (:class:`Stepped`, the ``FixedDuration`` of
``tests/test_torch_serve_executor.py``), so every run makes the same
engine decisions.  Each run admits four requests, lets one finish, admits
a fifth into the freed slot 0 and then takes a die fault: the engine
replans and ``migrate`` moves the survivors (slot 0's request to slot 3,
the others down one).  The reduced configs' plans give ``(4, 1)`` on four
devices, so a run puts its plan, and the plan after the fault, on the
mesh it names by the decode plan's ``tatp`` (:func:`on_mesh`).

* deepseek-7b, olmoe-1b-7b and internvl2-1b at ``(1, 4)`` against the
  reference's executor on its weights: token streams, reports and
  recovery events ``==``;
* where the reference's executor fails (data degree above 1, Mamba-2 and
  the encoder-decoder above model degree 1: :data:`PORT_RUNS`' starting
  meshes), its failure is recorded, and the port's four ranks are held to
  its one-rank engine (seed-0 weights, drawn shard by shard on the ranks):
  tokens identical, the final caches within 1e-5; the migrations that
  change the mesh (``(1, 4)`` <-> ``(2, 2)``) reshard the caches and the
  weights, and move each survivor's cache rows bit for bit;
* the launcher under ``torch.distributed.run`` prints the reference's
  report keys on rank 0 only;
* an unsplittable prompt and a ``max_seq`` the ring cannot split raise on
  every rank before the mesh is built, gemma2-9b's windowed layers serve
  on every rank through the launcher (since the ring's windowed forward
  was ported), and a prompt the leader refuses mid-run ends every rank
  with its error; no rank hangs.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
WORLD = 4
TIMEOUT = 300
GEN = 8
FAULT = (0.1, 2, 4.5)  # fraction of dies, seed, engine time
TOL = dict(rtol=1e-5, atol=1e-5)
NO_DROPS = dict(capacity_factor=8.0, aux_coef=0.0)
# name: (arch, prompt lengths, max_seq, the mesh's model degree before and
# after the fault, config overrides).  The reference's executor passes its
# per-rank cache block (max_seq / 4 positions) to its decode as the global
# array, which shard_map splits over the ring again: at (1, 4) it runs only
# where that block splits by 4 and holds every context (64: 16 positions).
REF_RUNS = {
    "deepseek-7b": ("deepseek-7b", (4, 8), 64, 4, 4, {}),
    "olmoe-1b-7b": ("olmoe-1b-7b", (4, 8), 64, 4, 4, {}),
    "internvl2-1b": ("internvl2-1b", (8,), 64, 4, 4, {}),
}
PORT_RUNS = {
    "mamba2-780m_4x1": ("mamba2-780m", (32,), 40, 1, 1, {}),
    "mamba2-780m_1x4": ("mamba2-780m", (32,), 40, 4, 4, {}),
    "zamba2-2.7b_1x4": ("zamba2-2.7b", (32,), 40, 4, 4, {}),
    "seamless-m4t-large-v2_1x4": ("seamless-m4t-large-v2", (8, 12), 20, 4,
                                  4, {}),
    "olmoe-1b-7b_2x2": ("olmoe-1b-7b", (8, 12), 20, 2, 2, NO_DROPS),
    "deepseek-7b_1x4-2x2": ("deepseek-7b", (8, 12), 20, 4, 2, {}),
    "deepseek-7b_2x2-1x4": ("deepseek-7b", (8, 12), 20, 2, 4, {}),
}
# the runs that change the mesh at the fault
RESHARDS = ("deepseek-7b_1x4-2x2", "deepseek-7b_2x2-1x4")


# ---------------------------------------------------------------------------
# shared by every side
# ---------------------------------------------------------------------------


def on_mesh(plan, model):
    """``plan`` (a ServePlan of either package) with its decode plan's
    ``tatp`` set to ``model``: on four devices the mesh ``(4 / model,
    model)``."""
    return dataclasses.replace(plan, plan=dataclasses.replace(
        plan.plan, tatp=model))


class Stepped:
    """Real-model calls on a virtual clock, each charged 1.0 s; a
    migration's plan is put on the mesh of ring degree ``model`` for the
    executor (the engine keeps the plan it solved)."""

    def __init__(self, inner, model):
        self.inner, self.model = inner, model
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
        self.inner.migrate(on_mesh(new_plan, self.model), mig, wafer)
        self.calls += 1
        return 1.0


class FailsBetweenCalls(Stepped):
    """Rank 0's engine failing after its first prefill, between calls."""

    def __init__(self, inner):
        super().__init__(inner, 4)

    def decode(self, states):
        raise RuntimeError("the scheduler failed")


def _requests(eng, plens):
    """Four at once (the first wants 2 tokens), a fifth into the slot it
    frees, a sixth after the fault."""
    spec = [(0, 0.0, 2), (1, 0.0, GEN), (2, 0.0, GEN), (3, 0.0, GEN),
            (4, 2.5, GEN), (5, 6.5, GEN)]
    return [eng.Request(rid=rid, arrival=t, prompt_len=plens[rid % len(plens)],
                        max_new_tokens=n) for rid, t, n in spec]


def _setup(pkg, arch, plens, max_seq, model, overrides, cache):
    """The config, the fault-free wafer, the plan for ``max_seq`` on the
    mesh of ring degree ``model`` (solved afresh, written under the
    process's own ``cache``), and the requests, in package ``pkg``."""
    cfg = dataclasses.replace(pkg.reduced(arch), **overrides)
    wafer = pkg.topo.Wafer(pkg.topo.WaferSpec())
    plan = pkg.plan.compile_serve_plan(wafer, cfg, 4, max_seq,
                                       cache_dir=str(cache), use_cache=False)
    return cfg, wafer, on_mesh(plan, model), _requests(pkg.eng, plens)


def _serve(pkg, plan, executor, reqs, cfg, wafer, cache):
    """Run the engine with the fault; the report, the recovery events and
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


def _dump(path, obj):
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# the reference (4 fake devices)
# ---------------------------------------------------------------------------


def _reference(out_dir):
    import jax
    from repro.launch.serve import JaxServeExecutor

    out_dir = Path(out_dir)
    pkg = _packages("reference")
    assert len(jax.devices()) == WORLD
    solved = out_dir / "ref_solved"
    for name, (arch, plens, seq, before, after, over) in REF_RUNS.items():
        cfg, wafer, plan, reqs = _setup(pkg, arch, plens, seq, before, over,
                                        solved)
        ex = JaxServeExecutor(plan, cfg)
        np.savez(out_dir / f"params_{name}.tmp.npz",
                 **_flat(jax.tree.map(np.asarray, ex.params)))
        os.replace(out_dir / f"params_{name}.tmp.npz",
                   out_dir / f"params_{name}.npz")
        _dump(out_dir / f"ref_{name}.json",
              _serve(pkg, plan, Stepped(ex, after), reqs, cfg, wafer,
                     str(out_dir / f"ref_plans_{name}")))
    fails = {}
    for name, (arch, plens, seq, before, after, over) in PORT_RUNS.items():
        cfg, wafer, plan, reqs = _setup(pkg, arch, plens, seq, before, over,
                                        solved)
        try:
            ex = JaxServeExecutor(plan, cfg)
            _serve(pkg, plan, Stepped(ex, after), reqs, cfg, wafer,
                   str(out_dir / f"ref_plans_{name}"))
            fails[name] = ""
        except Exception as e:  # the failure this test records
            fails[name] = f"{type(e).__name__}: {e}"[:400]
    _dump(out_dir / "ref_fails.json", fails)


# ---------------------------------------------------------------------------
# the port: four ranks, and one
# ---------------------------------------------------------------------------


class GatherTracker:
    """Stands in for ``launch.serve._global_leaf`` and records, at each
    gather, how many global arrays of earlier gathers are still alive
    (``peak_alive``: 0 means one leaf's global array at a time)."""

    def __init__(self, fn):
        import weakref
        self.fn, self.ref = fn, weakref.ref
        self.alive, self.peak_alive, self.gathers = [], 0, 0

    def __call__(self, leaf, spec, dist):
        self.alive = [r for r in self.alive if r() is not None]
        self.peak_alive = max(self.peak_alive, len(self.alive))
        full, copies = self.fn(leaf, spec, dist)
        self.alive.append(self.ref(full))
        self.gathers += 1
        return full, copies


class Probe:
    """Around a rank's executor: each migration's survivors' global cache
    rows gathered before and after it (a collective on every rank) and
    compared bit for bit."""

    def __init__(self, inner):
        self.inner = inner
        self.moves = []

    def prefill(self, states):
        return self.inner.prefill(states)

    def decode(self, states):
        return self.inner.decode(states)

    def migrate(self, new_plan, mig, wafer=None):
        import torch
        olds = [o for _, o, _ in mig.survivors]
        news = [n for _, _, n in mig.survivors]
        before = _flat(self.inner.global_cache(olds))
        out = self.inner.migrate(new_plan, mig, wafer)
        after = _flat(self.inner.global_cache(news))
        self.moves.append(dict(
            self.inner.last_migration, survivors=len(olds),
            slots_moved=olds != news,
            exact=all(torch.equal(before[k], after[k]) for k in before)))
        return out


def _wait_for(path, seconds=TIMEOUT):
    import time
    t0 = time.time()
    while not Path(path).exists():
        if time.time() - t0 > seconds:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.2)


def _port_run(name, spec, rank, out_dir, link, params_from=None):
    """One engine run over the world: rank 0 leads, the others follow."""
    import torch
    from repro_torch.launch import serve as launch
    from repro_torch.launch.serve import (LeaderExecutor, TorchServeExecutor,
                                          follow)
    from repro_torch.weights import params_from_jax, shard_params

    arch, plens, seq, before, after, over = spec
    pkg = _packages("port")
    cfg, wafer, plan, reqs = _setup(pkg, arch, plens, seq, before, over,
                                    Path(out_dir) / f"solved_{rank}")
    ex = TorchServeExecutor(plan, cfg, device="cpu")
    if params_from is not None:
        _wait_for(params_from)
        full = params_from_jax(_unflat(dict(np.load(params_from))), cfg,
                               "cpu")
        ex.params = shard_params(full, cfg, ex.par.strategy, ex.dist)
    probe = Probe(ex)
    rec = {"mesh": list(ex.dist.mesh_shape)}
    tracker = launch._global_leaf = GatherTracker(launch._global_leaf)
    if rank == 0:
        lead = LeaderExecutor(probe, link)
        stepped, err = Stepped(lead, after), None
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
        rec["followed"] = follow(probe, link)
    launch._global_leaf = tracker.fn
    rec.update(moves=probe.moves, mesh_after=list(ex.dist.mesh_shape),
               link_calls=link.calls, gathers=tracker.gathers,
               peak_alive=tracker.peak_alive)
    caches = {k: v.numpy() for k, v in _flat(ex.global_cache()).items()}
    if rank == 0:
        np.savez(Path(out_dir) / f"port_{name}_caches.npz", **caches)
    _dump(Path(out_dir) / f"port_{name}_{rank}.json", rec)
    torch.distributed.barrier()


def _raises(case, rank, out_dir, link):
    """What each rank raised in ``case`` (nothing: "")."""
    import argparse

    from repro_torch.launch import serve as launch

    plans = Path(out_dir) / "plans"
    try:
        if case in ("leader", "engine"):
            pkg = _packages("port")
            cfg, wafer, plan, _ = _setup(
                pkg, "deepseek-7b", (8, 12), 20, 4, {},
                Path(out_dir) / f"solved_{rank}")
            reqs = _requests(pkg.eng, (8, 12))
            if case == "leader":  # a prompt the ring cannot split, mid-run
                reqs[4] = dataclasses.replace(reqs[4], prompt_len=10)
            ex = launch.TorchServeExecutor(plan, cfg, device="cpu")
            if rank == 0:
                lead = launch.LeaderExecutor(ex, link)
                stepped = Stepped(lead, 4) if case == "leader" \
                    else FailsBetweenCalls(lead)
                err = None
                try:
                    _serve(pkg, plan, stepped, reqs, cfg, wafer,
                           str(Path(out_dir) / f"{case}_plans"))
                except Exception as e:
                    err = e
                    raise
                finally:
                    lead.stop(err)
            else:
                launch.follow(ex, link)
        else:
            arch, plen, plan = {
                "prompt": ("deepseek-7b", 10, "deepseek_1x4.json"),
                "max_seq": ("deepseek-7b", 8, "deepseek_1x4_seq18.json"),
                "window": ("gemma2-9b", 8, "gemma2_1x4.json"),
                "chunked": ("deepseek-7b", 8, "deepseek_1x4.json")}[case]
            chunk = ["--prefill-chunk-tokens", "4"] if case == "chunked" \
                else []
            args = launch.build_parser().parse_args([
                "--serve", "--arch", arch, "--reduced", "--device", "cpu",
                "--plan", str(plans / plan), "--prompt-len", str(plen),
                "--max-new", str(GEN), "--requests", "2",
                "--plan-cache", str(Path(out_dir) / f"{case}_plans"),
                *chunk])
            assert isinstance(args, argparse.Namespace)
            launch.serve_engine(args)
        return ""
    except Exception as e:
        return f"{type(e).__name__}: {e}"


def _snake_collectives(rank, out_dir):
    """All-gather and all-to-all over the axes of the ``(2, 2)`` mesh in a
    plan's snake order (data row 1's ring is global ranks 3, 2: the
    reverse of its process group's numbering)."""
    import torch
    from repro_torch.core.dist import make_mesh_dist

    dist = make_mesh_dist((2, 2), "cpu", order=[0, 1, 3, 2])
    x = torch.arange(6.0).reshape(2, 3) + 10 * rank
    res = {"coords": list(dist.coords)}
    for axis in ("model", "data"):
        res[f"gather_{axis}"] = dist.all_gather(x, axis, dim=0).tolist()
        res[f"a2a_{axis}"] = dist.all_to_all(x, axis).tolist()
    _dump(Path(out_dir) / f"snake_{rank}.json", res)


def _port_rank(rank, store_path, out_dir):
    sys.path.insert(0, str(SRC))
    import torch
    torch.set_num_threads(1)
    from repro_torch.core.dist import init_world
    from repro_torch.launch.serve import CommandLink

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    init_world("gloo", store=torch.distributed.FileStore(store_path, WORLD),
               rank=rank, world_size=WORLD)
    link = CommandLink()
    _snake_collectives(rank, out_dir)
    raised = {case: _raises(case, rank, out_dir, link)
              for case in ("prompt", "max_seq", "window", "leader",
                           "engine", "chunked")}
    torch.distributed.barrier()  # nobody hangs after a raise
    _dump(Path(out_dir) / f"raised_{rank}.json", raised)
    for name, spec in REF_RUNS.items():
        _port_run(name, spec, rank, out_dir, link,
                  params_from=Path(out_dir) / f"params_{name}.npz")
    for name, spec in PORT_RUNS.items():
        _port_run(name, spec, rank, out_dir, link)
    torch.distributed.destroy_process_group()


def _single(out_dir):
    """The port's one-rank engine on :data:`PORT_RUNS` (seed-0 weights)."""
    sys.path.insert(0, str(SRC))
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.serve import TorchServeExecutor

    pkg = _packages("port")
    for name, (arch, plens, seq, before, after, over) in PORT_RUNS.items():
        cfg, wafer, plan, reqs = _setup(pkg, arch, plens, seq, before, over,
                                        Path(out_dir) / "one_solved")
        ex = TorchServeExecutor(plan, cfg, device="cpu")
        rec = _serve(pkg, plan, Stepped(ex, after), reqs, cfg, wafer,
                     str(Path(out_dir) / f"one_plans_{name}"))
        np.savez(Path(out_dir) / f"one_{name}_caches.npz",
                 **{k: v.numpy() for k, v in _flat(ex.caches).items()})
        _dump(Path(out_dir) / f"one_{name}.json", rec)


# ---------------------------------------------------------------------------
# the fixture: every side at once, then the comparisons
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


def _write_plans(d):
    """The ServePlan files the launcher's raises read: deepseek-7b's and
    gemma2-9b's plans on ``(1, 4)``, and deepseek-7b's with a ``max_seq``
    of 18."""
    sys.path.insert(0, str(SRC))
    pkg = _packages("port")
    d.mkdir()
    for name, arch, seq in (("deepseek_1x4", "deepseek-7b", 8 + GEN),
                            ("deepseek_1x4_seq18", "deepseek-7b", 18),
                            ("gemma2_1x4", "gemma2-9b", 8 + GEN)):
        plan = pkg.plan.compile_serve_plan(
            pkg.topo.Wafer(pkg.topo.WaferSpec()), pkg.reduced(arch), 4, seq,
            cache_dir=str(d / "solved"), use_cache=False)
        on_mesh(plan, 4).dump(str(d / f"{name}.json"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("engine")
    _write_plans(d / "plans")
    me = str(Path(__file__).resolve())
    procs = [("the reference", subprocess.Popen(
        [sys.executable, me, "reference", str(d)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        cwd=d, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)),
        ("the one-rank engine", subprocess.Popen(
            [sys.executable, me, "single", str(d)], env=_env(), cwd=d,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))]
    for rank in range(WORLD):
        procs.append((f"port rank {rank}", subprocess.Popen(
            [sys.executable, me, "port", str(rank), str(d / "store"),
             str(d)], env=_env(), cwd=d, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    _finish(procs)
    return d


def _load(d, name):
    with open(d / name) as f:
        return json.load(f)


def _ranks(d, name):
    return [_load(d, f"port_{name}_{r}.json") for r in range(WORLD)]


def _held_together(recs):
    """Every rank made every call rank 0 made."""
    assert recs[0]["calls"] > 0
    assert all(rec["followed"] == recs[0]["calls"] for rec in recs[1:])


# ---------------------------------------------------------------------------
# (i) against the reference at (1, 4)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(REF_RUNS))
def test_ranks_match_the_reference_executor(runs, name):
    """Token streams, the report and the recovery event ``==`` the
    reference's executor on 4 fake devices, across a migration (1, 4) ->
    (1, 4) that moves the survivors between slots; the weights stay and
    each rank grafts its own block."""
    ref = _load(runs, f"ref_{name}.json")
    recs = _ranks(runs, name)
    rep, events = ref["report"], ref["events"]
    assert rep["n_finished"] == 6 and rep["n_replans"] == 1
    assert events[0]["n_survivors"] == 4
    assert recs[0]["streams"] == ref["streams"]
    assert recs[0]["report"] == rep and recs[0]["events"] == events
    for rec in recs:
        assert rec["mesh"] == rec["mesh_after"] == [1, 4]
        (move,) = rec["moves"]
        assert move["slots_moved"] and move["exact"]
        assert (move["path"], move["weights"]) == ("graft", "kept")
    _held_together(recs)


# ---------------------------------------------------------------------------
# (ii) where the reference's executor fails: against the one-rank engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(PORT_RUNS))
def test_reference_executor_fails_where_the_ranks_run(runs, name):
    """The reference's executor fails on the run's starting mesh (its
    cache bookkeeping: global slots into a per-rank cache above data degree
    1, per-rank Mamba-2 heads and encoder K/V passed as global arrays above
    model degree 1); the port's ranks serve it."""
    fail = _load(runs, "ref_fails.json")[name]
    assert fail, f"the reference's executor ran {name}"
    assert _ranks(runs, name)[0]["report"]["n_finished"] == 6


@pytest.mark.parametrize("name", list(PORT_RUNS))
def test_ranks_match_the_one_rank_engine(runs, name):
    """Tokens, the report and the recovery event ``==`` the port's
    one-rank engine's; the final caches within 1e-5; every survivor's
    cache rows moved bit for bit."""
    one = _load(runs, f"one_{name}.json")
    recs = _ranks(runs, name)
    assert one["report"]["n_finished"] == 6
    assert one["report"]["n_replans"] == 1
    assert recs[0]["streams"] == one["streams"]
    assert recs[0]["report"] == one["report"]
    assert recs[0]["events"] == one["events"]
    want = dict(np.load(runs / f"one_{name}_caches.npz"))
    got = dict(np.load(runs / f"port_{name}_caches.npz"))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    for rec in recs:
        (move,) = rec["moves"]
        assert move["exact"] and move["survivors"] == 4
    _held_together(recs)


@pytest.mark.parametrize("name", RESHARDS)
def test_migration_across_meshes_reshards(runs, name):
    """(1, 4) <-> (2, 2): the survivors' rows go through the global view
    and the weights are re-cut leaf by leaf, so no gather starts while an
    earlier one's global array is alive; every rank ends on the new
    mesh."""
    _, _, _, before, after, _ = PORT_RUNS[name]
    for rec in _ranks(runs, name):
        assert rec["mesh"] == [4 // before, before]
        assert rec["mesh_after"] == [4 // after, after]
        (move,) = rec["moves"]
        assert (move["path"], move["weights"]) == ("reshard", "recut")
        assert move["bytes"] > 0 and move["slots_moved"]
        # the caches' leaves and every weight leaf went through the
        # gather, one global array alive at a time
        # (12 weight leaves, 2 cache leaves, the probe's 4 gathers)
        assert rec["gathers"] == 18 and rec["peak_alive"] == 0


def test_collectives_follow_the_plans_axis_order(runs):
    """Under the snake order a ring's axis order is not its process
    group's numbering: the all-gather's blocks and the all-to-all's
    destinations follow the axis."""
    res = [_load(runs, f"snake_{r}.json") for r in range(WORLD)]
    pos = {tuple(rec["coords"]): r for r, rec in enumerate(res)}
    assert pos == {(0, 0): 0, (0, 1): 1, (1, 0): 3, (1, 1): 2}
    x = [np.arange(6.0).reshape(2, 3) + 10 * r for r in range(WORLD)]
    for r, rec in enumerate(res):
        d, m = rec["coords"]
        for axis, members in (("model", [pos[d, j] for j in range(2)]),
                              ("data", [pos[j, m] for j in range(2)])):
            i = (m, d)[axis == "data"]
            np.testing.assert_array_equal(
                rec[f"gather_{axis}"], np.concatenate([x[g] for g in members]))
            np.testing.assert_array_equal(
                rec[f"a2a_{axis}"], np.stack([x[g][i] for g in members]))


# ---------------------------------------------------------------------------
# (iv) raises on every rank, and nobody hangs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case, want", [
    ("prompt", "ValueError: prompt length 10 is not a multiple of the ring "
               "degree 4"),
    ("max_seq", "ValueError: the plan's max_seq 18 does not split over its "
                "ring degree 4"),
    ("window", ""),
])
def test_launcher_raises_on_every_rank(runs, case, want):
    """The two ring splits raise on every rank; gemma2-9b's windowed
    layers on the ring raise on none (the launcher serves them)."""
    raised = [_load(runs, f"raised_{r}.json")[case] for r in range(WORLD)]
    for msg in raised:
        assert msg.startswith(want), raised
    if case == "window":
        assert raised == [""] * WORLD


def test_refused_call_ends_every_rank(runs):
    """A prompt the ring cannot split, admitted mid-run: every rank
    refuses the prefill before any collective, and none waits for
    another."""
    raised = [_load(runs, f"raised_{r}.json")["leader"] for r in range(WORLD)]
    for msg in raised:
        assert msg.startswith("ValueError: prompt length 10 is not a "
                              "multiple of the ring degree 4"), raised


def test_chunked_prefill_falls_back_as_on_one_rank(runs):
    """``--prefill-chunk-tokens``: the engine chunks only where its
    executor has a ``prefill_chunk``, which neither package's real
    executor has, so it prefills in one pass on four ranks as on one."""
    from repro_torch.launch.serve import LeaderExecutor, TorchServeExecutor
    raised = [_load(runs, f"raised_{r}.json")["chunked"]
              for r in range(WORLD)]
    assert raised == [""] * WORLD
    for cls in (LeaderExecutor, TorchServeExecutor):
        assert not hasattr(cls, "prefill_chunk")


def test_rank_0_error_ends_the_followers(runs):
    """An error on rank 0 between calls (here the engine's scheduler):
    its ``stop`` carries the error to the followers, which raise it."""
    raised = [_load(runs, f"raised_{r}.json")["engine"] for r in range(WORLD)]
    assert raised[0] == "RuntimeError: the scheduler failed", raised
    for msg in raised[1:]:
        assert msg == ("RuntimeError: rank 0 stopped the engine: "
                       "RuntimeError: the scheduler failed"), raised


# ---------------------------------------------------------------------------
# (iii) the launcher under torch.distributed.run
# ---------------------------------------------------------------------------


def _reference_keys(tmp_path):
    """The keys of the reference's engine report (its ``--sim`` run, on
    the port's parser: the flags are the reference's)."""
    sys.path.insert(0, str(SRC))
    from repro.launch import serve as ref_serve
    from repro_torch.launch.serve import build_parser
    args = build_parser().parse_args([
        "--serve", "--sim", "--reduced", "--auto-plan", "--requests", "2",
        "--plan-cache", str(tmp_path / "ref_plans")])
    return set(ref_serve.serve_engine(args))


@pytest.mark.parametrize("layout", ["auto-plan", "ring"])
def test_serve_cli_under_torchrun(tmp_path, layout):
    """Rank 0 alone prints one JSON line with the reference's keys
    (``"mode": "torch"``); ``--auto-plan``'s reduced plan runs at (4, 1),
    a plan file with ``tatp`` 4 on the ring at (1, 4) with a fault."""
    if layout == "auto-plan":
        flags = ["--auto-plan", "--plan-cache", str(tmp_path / "plans"),
                 "--layers", "2"]
    else:
        _write_plans(tmp_path / "plans")
        flags = ["--plan", str(tmp_path / "plans" / "deepseek_1x4.json"),
                 "--fault-at", "0.0"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(WORLD), "-m", "repro_torch.launch.serve",
           "--serve", "--reduced", "--device", "cpu", *flags,
           "--requests", "4", "--rate", "100", "--max-batch", "4",
           "--prompt-len", "8", "--max-new", str(GEN)]
    res = subprocess.run(cmd, env=_env(), cwd=tmp_path, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert set(out) == _reference_keys(tmp_path)
    assert out["mode"] == "torch" and out["n_finished"] == 4
    assert out["generated_tokens"] == 4 * GEN
    assert res.stdout.count("ServePlan[") == 1, res.stdout
    if layout == "ring":
        assert out["n_replans"] == 1


def test_sim_over_ranks_raises_before_joining(monkeypatch):
    sys.path.insert(0, str(SRC))
    from repro_torch.launch import serve as launch

    def joined(args):
        raise AssertionError("joined the world")

    monkeypatch.setattr(launch, "join_world", joined)
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="run it on one rank"):
        launch.main(["--serve", "--sim", "--reduced", "--auto-plan"])


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    elif sys.argv[1] == "single":
        _single(sys.argv[2])
    else:
        _port_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
