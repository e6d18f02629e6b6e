"""The port's engine-mode executor (``repro_torch.launch.serve.
TorchServeExecutor``) against the reference's ``JaxServeExecutor`` on
the CPU, fp32, on weights converted from the reference's tree.

Both executors serve the same requests through their package's
``ServeEngine``.  Step durations are fixed on a virtual clock (the
reference's ``FixedDuration`` stand-in, ``tests/test_serve_fault.py``),
so a fault lands at the same logical point in both runs and ``migrate``
runs.  Each request's token stream must be identical, and so must the
reports and recovery events.  Models: reduced deepseek-7b (attention
caches), zamba2-2.7b (SSM state, conv and attention caches grafted
together), seamless-m4t-large-v2 (encoder caches) and olmoe-1b-7b
(expert capacity couples the padded prefill rows).
"""

from __future__ import annotations

import dataclasses
import types

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.configs import get_reduced as ref_reduced
from repro.core import plan as rplan
from repro.launch.serve import JaxServeExecutor
from repro.serve import engine as reng
from repro.wafer import fault as rfault
from repro.wafer import topology as rtopo
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import plan as tplan
from repro_torch.launch.serve import TorchServeExecutor
from repro_torch.serve import engine as teng
from repro_torch.wafer import fault as tfault
from repro_torch.wafer import topology as ttopo
from repro_torch.weights import params_from_jax

REF = types.SimpleNamespace(plan=rplan, eng=reng, fault=rfault, topo=rtopo,
                            config=ref_config, reduced=ref_reduced)
PORT = types.SimpleNamespace(plan=tplan, eng=teng, fault=tfault,
                             topo=ttopo, config=get_config,
                             reduced=get_reduced)


class FixedDuration:
    """Real-model compute on a virtual clock: the executors keep wall
    time (they return None), so each call is charged 1.0 s and a fault
    lands at the same logical point in every run."""

    def __init__(self, inner):
        self.inner = inner

    def prefill(self, states):
        self.inner.prefill(states)
        return 1.0

    def decode(self, states):
        self.inner.decode(states)
        return 1.0

    def migrate(self, new_plan, mig, wafer=None):
        self.inner.migrate(new_plan, mig, wafer)
        return 1.0


def _executors(arch, plan_of):
    """The reference's executor and the port's on its weights:
    ``plan_of(pkg)`` gives each package's plan."""
    rplan_, tplan_ = plan_of(REF), plan_of(PORT)
    jex = JaxServeExecutor(rplan_, REF.reduced(arch))
    cfg = PORT.reduced(arch)
    params = params_from_jax(jax.tree.map(np.asarray, jex.params), cfg,
                             "cpu")
    tex = TorchServeExecutor(tplan_, cfg, device="cpu", params=params)
    return jex, tex


def _serve(pkg, plan, executor, reqs, cfg, wafer, cache, faults=(),
           clock=None):
    eng = pkg.eng.ServeEngine(
        plan, executor, clock=clock or pkg.eng.VirtualClock(), cfg=cfg,
        wafer=wafer, faults=faults, plan_cache_dir=cache)
    rep = eng.run([pkg.eng.Request(**dataclasses.asdict(r)) for r in reqs])
    streams = sorted((st.req.rid, st.req.prior_tokens, tuple(st.tokens))
                     for st in eng.sched.finished)
    return rep, eng.events, streams


def _mixed_reqs(plens, n=6, gen=12):
    """Two admission waves with mixed prompt lengths."""
    return [reng.Request(rid=i, arrival=0.0 if i < 4 else 4.5,
                         prompt_len=plens[i % len(plens)],
                         max_new_tokens=gen) for i in range(n)]


@pytest.mark.parametrize("arch, plens", [
    ("deepseek-7b", (6, 10)),
    ("zamba2-2.7b", (8, 16)),            # multiples of the reduced chunk
    ("seamless-m4t-large-v2", (6, 10)),
    ("olmoe-1b-7b", (6, 10)),
])
def test_executor_with_fault_matches_jax(tmp_path, arch, plens):
    """A die fault right after the first admission wave: the engine
    replans, ``migrate`` grafts the survivors into a fresh cache, and
    the second wave is prefilled on the new plan."""
    reqs = _mixed_reqs(plens)
    max_seq = max(plens) + 12

    def plan_of(pkg):
        w = pkg.topo.Wafer(pkg.topo.WaferSpec())
        return pkg.plan.compile_serve_plan(w, pkg.reduced(arch), 4, max_seq,
                                           cache_dir=str(tmp_path / "p"))

    jex, tex = _executors(arch, plan_of)
    out = []
    for pkg, ex in ((REF, jex), (PORT, tex)):
        w = pkg.topo.Wafer(pkg.topo.WaferSpec())
        fault = pkg.fault.sample_die_faults(w, 0.1, seed=2)
        rep, events, streams = _serve(
            pkg, ex.plan, FixedDuration(ex), reqs, pkg.reduced(arch), w,
            str(tmp_path / pkg.plan.__name__), [fault.as_event(1e-9)])
        out.append((rep.to_dict(), [ev.to_dict() for ev in events],
                    streams))
    (rep, events, streams), port = out
    assert rep["n_finished"] == 6 and rep["n_replans"] == 1
    assert events[0]["n_survivors"] == 4
    assert {len(s[2]) for s in streams} == {12}
    assert port[2] == streams
    assert port == out[0]


def test_executor_eviction_and_readmission_match_jax(tmp_path):
    """A plan solved for the full deepseek-7b on a wafer whose HBM just
    fits it, served by the reduced model: the die fault shrinks the
    contract to one slot, three sequences are evicted and re-admitted as
    continuations, and the survivor decodes on its grafted rows."""
    max_batch, max_seq = 8, 32

    def setup(pkg):
        cfg = pkg.config("deepseek-7b")
        probe = pkg.plan.compile_serve_plan(
            pkg.topo.Wafer(pkg.topo.WaferSpec()), cfg, max_batch, max_seq,
            use_cache=False)
        w = pkg.topo.Wafer(pkg.topo.WaferSpec(
            hbm_cap=probe.predicted["mem_per_die"] * 1.05))
        plan = pkg.plan.compile_serve_plan(
            w, cfg, max_batch, max_seq,
            cache_dir=str(tmp_path / pkg.plan.__name__))
        return cfg, w, plan

    setups = {id(pkg): setup(pkg) for pkg in (REF, PORT)}
    jex, tex = _executors("deepseek-7b",
                          lambda pkg: setups[id(pkg)][2])
    reqs = [reng.Request(rid=i, arrival=0.0, prompt_len=16,
                         max_new_tokens=8) for i in range(max_batch)]
    out = []
    for pkg, ex in ((REF, jex), (PORT, tex)):
        cfg, w, plan = setups[id(pkg)]
        fault = pkg.fault.sample_die_faults(w, 0.25, seed=1)
        rep, events, streams = _serve(
            pkg, plan, FixedDuration(ex), reqs, cfg, w,
            str(tmp_path / pkg.plan.__name__), [fault.as_event(1e-9)])
        out.append((rep.to_dict(), [ev.to_dict() for ev in events],
                    streams))
    rep, events, streams = out[0]
    assert events[0]["n_evicted"] > 0 and events[0]["n_survivors"] > 0
    assert rep["n_finished"] == max_batch
    assert out[1][2] == streams
    assert out[1] == out[0]


def test_torch_and_cost_model_agree_on_survivors(tmp_path):
    """Twin of the reference's ``test_jax_and_cost_model_agree_on_
    survivors``: same plan, same fault, same logical fault point (all
    four requests in flight).  The port's executor adopts the degraded
    plan the JAX executor and the cost model adopt, keeps the same
    survivors, and every request finishes on the grafted cache."""
    reqs = [reng.Request(rid=i, arrival=0.0, prompt_len=6,
                         max_new_tokens=12) for i in range(4)]

    def plan_of(pkg):
        return pkg.plan.compile_serve_plan(
            pkg.topo.Wafer(pkg.topo.WaferSpec()), pkg.reduced("deepseek-7b"),
            4, 32, cache_dir=str(tmp_path / pkg.plan.__name__))

    jex, tex = _executors("deepseek-7b", plan_of)
    runs = {}
    for name, pkg, ex in (("jax", REF, FixedDuration(jex)),
                          ("torch", PORT, FixedDuration(tex)),
                          ("cost", PORT, None)):
        w = pkg.topo.Wafer(pkg.topo.WaferSpec())
        cfg = pkg.reduced("deepseek-7b")
        plan = plan_of(pkg)
        ex = ex or pkg.eng.CostModelExecutor(plan, cfg, w)
        fault = pkg.fault.sample_die_faults(w, 0.1, seed=2)
        rep, events, _ = _serve(pkg, plan, ex, reqs, cfg, w,
                                str(tmp_path / pkg.plan.__name__),
                                [fault.as_event(1e-9)])
        runs[name] = (rep, events[0])
    (rep_t, ev_t), (rep_j, ev_j), (rep_c, ev_c) = \
        runs["torch"], runs["jax"], runs["cost"]
    assert ev_t.new_plan_hash == ev_j.new_plan_hash == ev_c.new_plan_hash
    assert ev_t.new_plan_hash != ev_t.old_plan_hash
    assert (ev_t.n_active, ev_t.n_survivors, ev_t.n_evicted) \
        == (ev_j.n_active, ev_j.n_survivors, ev_j.n_evicted) \
        == (ev_c.n_active, ev_c.n_survivors, ev_c.n_evicted)
    assert ev_t.n_survivors == 4 and ev_t.n_evicted == 0
    assert rep_t.n_finished == rep_j.n_finished == rep_c.n_finished == 4
    assert rep_t.generated_tokens == rep_c.generated_tokens == 48


def test_torch_executor_mixed_prompt_lengths(tmp_path):
    """Twin of the reference's ``test_jax_executor_mixed_prompt_
    lengths``: two prompt lengths admitted in one iteration on a wall
    clock (prefill groups by length); the tokens are the JAX
    executor's."""
    reqs = [reng.Request(rid=0, arrival=0.0, prompt_len=6, max_new_tokens=3),
            reng.Request(rid=1, arrival=0.0, prompt_len=10,
                         max_new_tokens=3)]

    def plan_of(pkg):
        return pkg.plan.compile_serve_plan(
            pkg.topo.Wafer(pkg.topo.WaferSpec()), pkg.reduced("deepseek-7b"),
            2, 16, use_cache=False)

    jex, tex = _executors("deepseek-7b", plan_of)
    streams = []
    for pkg, ex in ((REF, jex), (PORT, tex)):
        rep, _, s = _serve(pkg, ex.plan, ex, reqs, None, None, None,
                           clock=pkg.eng.WallClock())
        assert rep.n_finished == 2 and rep.generated_tokens == 6
        streams.append(s)
    assert streams[1] == streams[0]


def test_executor_slots_and_graft(tmp_path):
    """Slot bookkeeping as the reference's: prefill grafts a request's
    rows into its slot only, decode feeds each slot its last token at its
    context length, and an idle slot stays untouched."""
    cfg = get_reduced("deepseek-7b")
    plan = tplan.compile_serve_plan(ttopo.Wafer(ttopo.WaferSpec()), cfg, 4,
                                    24, use_cache=False)
    ex = TorchServeExecutor(plan, cfg, device="cpu")
    st = teng.RequestState(teng.Request(rid=7, arrival=0.0, prompt_len=8,
                                        max_new_tokens=4))
    st.slot = 2
    ex.prefill([st])
    k = ex.caches["u0"]["k"]
    assert k[:, 2, :8].abs().sum() > 0
    assert k[:, [0, 1, 3]].abs().sum() == 0 and k[:, 2, 8:].abs().sum() == 0
    assert ex.last_tok[2] == st.tokens[0] and len(st.tokens) == 1
    st.tokens_done = 1
    ex.decode([st])
    assert len(st.tokens) == 2 and ex.last_tok[2] == st.tokens[1]
    assert k[:, 2, 8].abs().sum() > 0  # the decode wrote position 8
    assert k[:, [0, 1, 3], 1:].abs().sum() == 0  # idle slots: position 0
