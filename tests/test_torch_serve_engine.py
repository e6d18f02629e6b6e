"""The port's serve engine, replan governor, KV-migration planner and
fault timelines (``repro_torch.serve``, ``repro_torch.wafer.fault``)
against the reference's on the same scenarios.

Each scenario runs once through each package: the cost-model executor
on a virtual clock, so every number in the report comes from the two
packages' copies of the scheduler, the cost engine's numpy tiers and
the planner.  Reports, recovery events and governor decisions must be
equal with ``==``, and so must the fault traces the generators draw.
"""

from __future__ import annotations

import dataclasses
import math
import types

import pytest

from repro.configs import get_config as ref_config
from repro.configs import get_reduced as ref_reduced
from repro.core import plan as rplan
from repro.serve import engine as reng
from repro.serve import governor as rgov
from repro.serve import migrate as rmig
from repro.wafer import fault as rfault
from repro.wafer import topology as rtopo
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import plan as tplan
from repro_torch.serve import engine as teng
from repro_torch.serve import governor as tgov
from repro_torch.serve import migrate as tmig
from repro_torch.wafer import fault as tfault
from repro_torch.wafer import topology as ttopo

REF = types.SimpleNamespace(plan=rplan, eng=reng, gov=rgov, mig=rmig,
                            fault=rfault, topo=rtopo, config=ref_config,
                            reduced=ref_reduced)
PORT = types.SimpleNamespace(plan=tplan, eng=teng, gov=tgov, mig=tmig,
                             fault=tfault, topo=ttopo, config=get_config,
                             reduced=get_reduced)
PKGS = (REF, PORT)


@pytest.fixture(autouse=True)
def _fresh_stats():
    for pkg in PKGS:
        pkg.plan.reset_plan_stats()
    yield
    for pkg in PKGS:
        pkg.plan.reset_plan_stats()


def _setup(pkg, cfg, cache, *, max_batch=8, max_seq=256, pressured=False):
    """A serve plan on a pristine wafer, or on one whose HBM just fits
    the pristine plan (``pressured``), so a die fault shrinks the
    contract and evicts sequences (the reference tests' setup)."""
    w = pkg.topo.Wafer(pkg.topo.WaferSpec())
    if pressured:
        probe = pkg.plan.compile_serve_plan(w, cfg, max_batch, max_seq,
                                            use_cache=False)
        w = pkg.topo.Wafer(pkg.topo.WaferSpec(
            hbm_cap=probe.predicted["mem_per_die"] * 1.05))
    plan = pkg.plan.compile_serve_plan(w, cfg, max_batch, max_seq,
                                       cache_dir=cache)
    return w, plan


def _run(pkg, cfg, w, plan, cache, reqs, **kw):
    """One engine run; its report, events and finished streams."""
    eng = pkg.eng.ServeEngine(plan, pkg.eng.CostModelExecutor(plan, cfg, w),
                              clock=pkg.eng.VirtualClock(), cfg=cfg,
                              wafer=w, plan_cache_dir=cache, **kw)
    rep = eng.run([pkg.eng.Request(**dataclasses.asdict(r)) for r in reqs])
    streams = sorted((st.req.rid, st.req.prior_tokens, tuple(st.tokens))
                     for st in eng.sched.finished)
    return {"report": rep.to_dict(),
            "events": [ev.to_dict() for ev in eng.events],
            "streams": streams}


def _both(tmp_path, scenario):
    """``scenario(pkg, cache)`` through each package, each with its own
    plan cache (so neither answers the other's solves)."""
    out = []
    for pkg in PKGS:
        cache = tmp_path / pkg.plan.__name__.split(".")[0]
        out.append(scenario(pkg, str(cache)))
    return out


def _poisson(n=24, rate=4.0, prompt=32, gen=16):
    return reng.poisson_arrivals(n, rate, seed=0, prompt_len=prompt,
                                 max_new_tokens=gen)


def _burst(n=24, prompt=200, gen=56):
    return [reng.Request(rid=i, arrival=0.0, prompt_len=prompt,
                         max_new_tokens=gen) for i in range(n)]


# ---------------------------------------------------------------------------
# engine scenarios
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ("deepseek-7b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"))
def test_fault_free_engine_matches_reference(tmp_path, arch):
    def scenario(pkg, cache):
        cfg = pkg.reduced(arch)
        w, plan = _setup(pkg, cfg, cache, max_batch=4, max_seq=64)
        return _run(pkg, cfg, w, plan, cache, _poisson(prompt=24))

    ref, port = _both(tmp_path, scenario)
    assert ref["report"]["n_finished"] == 24
    assert ref["report"]["n_replans"] == 0
    assert port == ref


@pytest.mark.parametrize("policy", ("live", "drain"))
def test_die_fault_replan_matches_reference(tmp_path, policy):
    """A 25 % die fault mid-decode on a pressured wafer: the replan
    shrinks the contract and evicts sequences under either readmission
    policy (the reference's ``test_mid_run_replan_invariants``)."""
    def scenario(pkg, cache):
        cfg = pkg.config("deepseek-7b")
        w, plan = _setup(pkg, cfg, cache, pressured=True)
        fault = pkg.fault.sample_die_faults(w, 0.25, seed=1)
        t_fault = plan.predicted["token_latency"] * 20
        return _run(pkg, cfg, w, plan, cache, _burst(),
                    faults=[fault.as_event(t_fault)], readmission=policy)

    ref, port = _both(tmp_path, scenario)
    (ev,) = ref["events"]
    assert ev["n_evicted"] > 0 and ref["report"]["n_finished"] == 24
    assert port == ref


@pytest.mark.parametrize("governed", (False, True))
@pytest.mark.parametrize("spec", ("flap:3", "cascade:5"))
def test_fault_trace_engine_matches_reference(tmp_path, spec, governed):
    """A seeded fault/repair timeline (``--fault-trace``) streamed at the
    engine, straight to replans or through the governor."""
    def scenario(pkg, cache):
        cfg = pkg.reduced("deepseek-7b")
        w, plan = _setup(pkg, cfg, cache)
        trace = pkg.fault.parse_fault_trace(spec, w)
        gov = pkg.gov.GovernorConfig(
            coalesce_s=0.05, hysteresis=0.0, backoff_base_s=0.2,
            replan_budget=2, window_s=1e9) if governed else None
        return _run(pkg, cfg, w, plan, cache, _poisson(),
                    faults=trace.events, governor=gov)

    ref, port = _both(tmp_path, scenario)
    rep = ref["report"]
    assert rep["n_finished"] == 24
    assert rep["n_replans"] > 0 and bool(rep["governor"]) == governed
    assert port == ref


def test_chunked_prefill_with_fault_matches_reference(tmp_path):
    """A link fault landing inside the first admission wave's chunked
    prefill (the reference's ``test_chunked_prefill_preempts_mid_
    prefill``): the preemption checkpoints partial prompts."""
    def scenario(pkg, cache):
        cfg = pkg.config("deepseek-7b")
        w, plan = _setup(pkg, cfg, cache)
        link = pkg.fault.working_mesh_links(w)[0]
        fault = pkg.eng.FaultEvent(time=plan.predicted["token_latency"] * 2,
                                   failed_links=(link,))
        partial = []

        def on_recovery(engine, rec):
            partial.extend(st.prefilled_tokens
                           for st in engine.sched.active.values()
                           if 0 < st.prefilled_tokens < st.req.prompt_len)

        out = _run(pkg, cfg, w, plan, cache, _burst(16, gen=24),
                   faults=[fault], prefill_chunk_tokens=16,
                   on_recovery=on_recovery)
        out["partial"] = partial
        return out

    ref, port = _both(tmp_path, scenario)
    assert ref["partial"] and ref["report"]["n_replans"] == 1
    assert port == ref


@pytest.mark.parametrize("no_ep", (False, True))
def test_moe_engine_matches_reference(tmp_path, no_ep):
    """olmoe-1b-7b reduced with a die fault: the router simulation's
    accounting (routed, dropped, per-expert and per-EP-group loads) is
    part of the report."""
    def scenario(pkg, cache):
        cfg = pkg.reduced("olmoe-1b-7b")
        w = pkg.topo.Wafer(pkg.topo.WaferSpec())
        plan = pkg.plan.compile_serve_plan(w, cfg, 16, 48, cache_dir=cache,
                                           allow_ep=not no_ep)
        fault = pkg.fault.sample_die_faults(w, 0.125, seed=0)
        return _run(pkg, cfg, w, plan, cache,
                    _poisson(n=24, rate=200.0, prompt=32, gen=16),
                    faults=[fault.as_event(
                        plan.predicted["token_latency"] * 10)])

    ref, port = _both(tmp_path, scenario)
    rep = ref["report"]
    assert rep["moe_routed_tokens"] > 0 and rep["expert_load"]
    assert port == ref


def test_kv_migration_plan_matches_reference(tmp_path):
    """``plan_kv_migration`` between a pristine and a degraded plan:
    survivors, evictions and the priced pause."""
    def scenario(pkg, cache):
        cfg = pkg.config("deepseek-7b")
        w, plan = _setup(pkg, cfg, cache, pressured=True)
        fault = pkg.fault.sample_die_faults(w, 0.25, seed=1)
        dw = w.with_faults(fault.failed_dies, ())
        new = pkg.plan.replan_serve(plan, cfg, w,
                                    failed_dies=fault.failed_dies,
                                    cache_dir=cache)
        states = []
        for i in range(plan.max_batch):
            st = pkg.eng.RequestState(pkg.eng.Request(
                rid=i, arrival=0.0, prompt_len=200, max_new_tokens=56))
            st.slot, st.admitted_at = i, 0.1 * i
            st.kv_reserved = 256
            st.tokens_done = st.prefilled_tokens = 2 + i
            states.append(st)
        mig = pkg.mig.plan_kv_migration(plan, new, states, cfg, dw)
        return dataclasses.asdict(mig), new.plan_hash

    ref, port = _both(tmp_path, scenario)
    assert ref[0]["evicted"]
    assert port == ref


# ---------------------------------------------------------------------------
# fault timelines (wafer/fault.py)
# ---------------------------------------------------------------------------


def _events(trace):
    return [dataclasses.astuple(ev) for ev in trace.events]


@pytest.mark.parametrize("frac", (0.0, 0.01, 0.125, 0.25))
@pytest.mark.parametrize("seed", (0, 3))
def test_sample_faults_match_reference(frac, seed):
    rw, tw = REF.topo.Wafer(REF.topo.WaferSpec()), \
        PORT.topo.Wafer(PORT.topo.WaferSpec())
    for name in ("sample_die_faults", "sample_link_faults"):
        a = getattr(REF.fault, name)(rw, frac, seed=seed)
        b = getattr(PORT.fault, name)(tw, frac, seed=seed)
        assert (b.failed_dies, b.failed_links) \
            == (a.failed_dies, a.failed_links)
        assert dataclasses.astuple(b.as_event(1.5)) \
            == dataclasses.astuple(a.as_event(1.5))
    assert PORT.fault.working_mesh_links(tw) \
        == REF.fault.working_mesh_links(rw)


@pytest.mark.parametrize("spec", ("flap:0", "flap:7", "cascade:0",
                                  "cascade:5"))
def test_parse_fault_trace_matches_reference(spec):
    a = REF.fault.parse_fault_trace(spec, REF.topo.Wafer(
        REF.topo.WaferSpec()))
    b = PORT.fault.parse_fault_trace(spec, PORT.topo.Wafer(
        PORT.topo.WaferSpec()))
    assert (b.kind, b.seed) == (a.kind, a.seed)
    assert _events(b) == _events(a) and b.to_dict() == a.to_dict()


def test_mttf_mttr_trace_matches_reference():
    kw = dict(seed=1, horizon_s=30.0, mttf_s=10.0, mttr_s=2.0, max_dies=4)
    a = REF.fault.FaultTrace.mttf_mttr(REF.topo.Wafer(REF.topo.WaferSpec()),
                                       **kw)
    b = PORT.fault.FaultTrace.mttf_mttr(
        PORT.topo.Wafer(PORT.topo.WaferSpec()), **kw)
    assert a.events and _events(b) == _events(a)


@pytest.mark.parametrize("writer", ("ref", "port"))
def test_trace_json_round_trips_across_packages(tmp_path, writer):
    """A trace file written by either package loads in the other to the
    same events (the ``--fault-trace FILE.json`` path)."""
    src, dst = (REF, PORT) if writer == "ref" else (PORT, REF)
    w = src.topo.Wafer(src.topo.WaferSpec())
    link = src.fault.working_mesh_links(w)[0]
    trace = src.fault.FaultTrace.flapping(w, seed=9, link=link, n_flaps=3)
    path = str(tmp_path / "trace.json")
    trace.to_json(path)
    back = dst.fault.parse_fault_trace(
        path, dst.topo.Wafer(dst.topo.WaferSpec()))
    assert back.to_dict() == trace.to_dict()
    assert _events(back) == _events(trace)
    final = trace.final_wafer(w)
    assert back.final_wafer(dst.topo.Wafer(dst.topo.WaferSpec())) \
        .failed_links == final.failed_links


# the reference's malformed traces (tests/test_serve_chaos.py)
MALFORMED = [
    ({"events": [{"time": 1.0, "repared_dies": [1]}]}, "repared_dies"),
    ({"events": [{"failed_dies": [1]}]}, "time"),
    ({"events": [{"time": "soon"}]}, "time"),
    ({"kind": "flapping"}, "events"),
    ({"events": [{"time": 1.0, "failed_links": [[1, 2, 3]]}]}, "links"),
]


@pytest.mark.parametrize("raw, hint", MALFORMED)
def test_trace_schema_rejects_what_reference_rejects(raw, hint):
    msgs = []
    for pkg in PKGS:
        with pytest.raises(ValueError, match="invalid fault trace") as exc:
            pkg.fault.FaultTrace.from_dict(raw)
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0] and hint in msgs[0]


def test_throughput_vs_fault_rate_matches_reference():
    rows = []
    for pkg in PKGS:
        w = pkg.topo.Wafer(pkg.topo.WaferSpec())
        rows.append(pkg.fault.throughput_vs_fault_rate(
            w, pkg.reduced("deepseek-7b"), 8, 128, kind="mixed",
            rates=(0.0, 0.2), engine="tcme"))
    assert rows[0][1]["alive"] < rows[0][0]["alive"]
    assert rows[1] == rows[0]


def test_predict_plan_throughput_matches_reference(tmp_path):
    def scenario(pkg, cache):
        cfg = pkg.config("deepseek-7b")
        w, plan = _setup(pkg, cfg, cache)
        dead = w.with_faults((3, 7), ())
        return [pkg.gov.predict_plan_throughput(plan, cfg, ww)
                for ww in (w, dead)]

    ref, port = _both(tmp_path, scenario)
    assert ref[0] > 0 and not math.isnan(ref[1])
    assert port == ref
